"""plade-tpu: plane-based point-cloud registration on an accelerator.

A from-scratch JAX/XLA/Pallas implementation of the capabilities of
chsl/PLADE (TGRS 2020) — plane extraction, plane-pair line descriptors,
descriptor matching, pose hypothesis clustering and verification — built
from fixed-shape padded pytrees, batched dense linear algebra, and
pair-level sharding over device meshes.

Matmul precision: on an NVIDIA GPU, JAX's default precision lets float32
matmuls run in TF32, which keeps a 10-bit mantissa.  This pipeline computes
*geometric* quantities with matmuls — plane-to-point distances, plane-normal
angle cosines, center-to-plane distances, squared distances via the
|q|^2 - 2 q.r + |r|^2 expansion where it remains — whose decision
thresholds (average-spacing multiples, cos 5 deg) sit below that
resolution for O(1) coordinates.  Registration is silently wrong without
full precision, so importing the package sets float32 matmuls as the
process-wide default; hot paths additionally request it explicitly.
"""
import jax as _jax

_jax.config.update("jax_default_matmul_precision", "highest")

__version__ = "0.1.0"

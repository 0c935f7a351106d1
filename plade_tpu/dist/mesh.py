"""Device meshes and sharded batch registration.

The reference has no distributed or even multi-threaded execution — batch
mode is a sequential loop over pairs on one CPU core (code/PLADE/main.cpp:
97-158; SURVEY section 2.3).  Here:

* **pairs axis = data parallelism**: independent registrations shard over
  the ``pairs`` mesh axis; zero communication between pairs.
* **intra-pair axis = model/sequence parallelism analog**: the padded point
  buffers of each cloud shard over the ``intra`` axis; XLA GSPMD inserts the
  collectives (psum for masked reductions such as inlier counts and overlap
  tallies), which run over NVLink between the cards of one host.
* **multi-host**: ``jax.distributed.initialize`` + the same mesh spanning
  hosts; pair results are fully sharded so only the small
  ``RegistrationResult`` leaves the device (all_gather on the pairs axis).

Everything is plain ``jit`` with ``NamedSharding`` annotations — no manual
collectives.  The cards of a host are joined all to all, so the mesh shape
follows the algorithm alone.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.config import PladeConfig
from ..core.types import Cloud, RegistrationResult
from ..pipeline import build_register_device_fn

PAIRS = "pairs"
INTRA = "intra"


def make_mesh(n_devices: int | None = None, intra: int = 1,
              devices=None) -> Mesh:
    """A ``(pairs, intra)`` mesh over the first ``n_devices`` devices."""
    if devices is None:
        devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    devices = devices[:n_devices]
    if n_devices % intra != 0:
        raise ValueError(f"n_devices={n_devices} not divisible by intra={intra}")
    arr = np.asarray(devices).reshape(n_devices // intra, intra)
    return Mesh(arr, (PAIRS, INTRA))


def batch_specs(cfg: PladeConfig):
    """PartitionSpecs for (tgt_batch, src_batch, keys): pair axis sharded,
    cloud point buffers additionally sharded over the intra axis."""
    cloud_spec = Cloud(points=P(PAIRS, INTRA), normals=P(PAIRS, INTRA),
                       count=P(PAIRS))
    return cloud_spec, cloud_spec, P(PAIRS)


def result_specs():
    return RegistrationResult(transform=P(PAIRS), score=P(PAIRS),
                              overlap=P(PAIRS), matched_planes=P(PAIRS),
                              success=P(PAIRS), match_saturated=P(PAIRS),
                              pen_overflow=P(PAIRS),
                              cluster_truncated=P(PAIRS))


@functools.lru_cache(maxsize=8)
def make_batch_register(cfg: PladeConfig, num_points: int, mesh: Mesh):
    """Jitted, mesh-sharded batched registration: (B-pairs in, B results
    out), B divisible by the pairs axis size."""
    step = build_register_device_fn(cfg, num_points)
    vstep = jax.vmap(step)
    tgt_spec, src_spec, key_spec = batch_specs(cfg)

    def shard(spec_tree):
        return jax.tree.map(lambda s: NamedSharding(mesh, s), spec_tree,
                            is_leaf=lambda x: isinstance(x, P))

    return jax.jit(
        vstep,
        in_shardings=(shard(tgt_spec), shard(src_spec), shard(key_spec)),
        out_shardings=shard(result_specs()),
    )


def register_batch(tgt_batch: Cloud, src_batch: Cloud, keys, cfg: PladeConfig,
                   mesh: Mesh | None = None) -> RegistrationResult:
    """Register a batch of pairs sharded over the mesh.

    ``tgt_batch``/``src_batch`` are Clouds with a leading batch axis; B must
    be a multiple of the pairs-axis size (pad with dummy pairs if needed).
    """
    if mesh is None:
        mesh = make_mesh()
    num_points = tgt_batch.points.shape[1]
    fn = make_batch_register(cfg, num_points, mesh)
    return fn(tgt_batch, src_batch, keys)


def stack_clouds(clouds: list[Cloud]) -> Cloud:
    """Stack same-shape Clouds along a new leading batch axis."""
    return jax.tree.map(lambda *xs: jnp.stack(xs), *clouds)


class PairOutcome(NamedTuple):
    """Per-pair batch result, including the truncation diagnostics the
    single-pair entry surfaces through its info dict (pipeline.py
    register_clouds) — batch callers (CLI --device-batch, eval harnesses)
    record these per pair instead of losing them to stdout."""
    transform: np.ndarray   # (4, 4)
    success: bool
    score: float
    overlap: float
    matched_planes: int
    cloud_capped: bool = False      # input subsampled to cfg.max_points
    match_saturated: int = 0        # dropped descriptor radius hits (rows)
    pen_overflow: int = 0           # dropped penetration tests
    cluster_truncated: int = 0      # hypotheses beyond the cluster prefix


def register_array_pairs(cloud_pairs, cfg: PladeConfig, seed: int = 0,
                         mesh: Mesh | None = None) -> "list[PairOutcome]":
    """Register a list of raw numpy cloud pairs through the sharded device
    pipeline in fixed-size mesh batches — the host-level entry every batch
    flow (CLI --device-batch, RESSO/scene evaluation) funnels through.

    ``cloud_pairs``: list of (tgt_pts, tgt_nrm, src_pts, src_nrm).
    Returns one PairOutcome per input pair.  No target/source swap is
    applied (the device fn mirrors the cloud-level reference overload,
    plade.cpp:638-662).  Pair i registers under the PRNG key
    ``fold_in(PRNGKey(seed), i)``, so its result does not depend on the
    mesh: one card and four give the same outcome per pair.
    """
    from ..core.types import pad_cloud
    from ..pipeline import _cap_cloud, _pad_size

    capped = []
    cap_flags = []
    max_n = 0
    for i, (tp, tn, sp, sn) in enumerate(cloud_pairs):
        tp, tn, t_capped = _cap_cloud(tp, tn, cfg.max_points, seed + 2 * i)
        sp, sn, s_capped = _cap_cloud(sp, sn, cfg.max_points,
                                      seed + 2 * i + 1)
        if t_capped or s_capped:
            print(f"[register_array_pairs] pair {i}: cloud capped to "
                  f"max_points={cfg.max_points}", flush=True)
        cap_flags.append(bool(t_capped or s_capped))
        max_n = max(max_n, tp.shape[0], sp.shape[0])
        capped.append((tp, tn, sp, sn))
    pad = _pad_size(max_n, maximum=cfg.max_points)

    if mesh is None:
        mesh = make_mesh()
    B0 = mesh.shape[PAIRS]
    base_key = jax.random.PRNGKey(seed)
    results = []
    for start in range(0, len(capped), B0):
        chunk = capped[start:start + B0]
        while len(chunk) < B0:
            chunk.append(chunk[0])  # pad the batch with a repeat
        tgt_b = stack_clouds([pad_cloud(c[0], c[1], pad) for c in chunk])
        src_b = stack_clouds([pad_cloud(c[2], c[3], pad) for c in chunk])
        keys = jnp.stack([jax.random.fold_in(base_key, start + i)
                          for i in range(B0)])
        res = register_batch(tgt_b, src_b, keys, cfg, mesh)
        T = np.asarray(res.transform)
        ok = np.asarray(res.success)
        sc = np.asarray(res.score)
        ov = np.asarray(res.overlap)
        mp = np.asarray(res.matched_planes)
        ms = np.asarray(res.match_saturated)
        po = np.asarray(res.pen_overflow)
        ct = np.asarray(res.cluster_truncated)
        for i in range(min(B0, len(capped) - start)):
            results.append(PairOutcome(
                T[i], bool(ok[i]), float(sc[i]), float(ov[i]), int(mp[i]),
                cloud_capped=cap_flags[start + i],
                match_saturated=int(ms[i]), pen_overflow=int(po[i]),
                cluster_truncated=int(ct[i])))
    return results

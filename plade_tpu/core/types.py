"""Fixed-shape pytree containers for the registration pipeline.

Every container is a ``(data, mask/count)`` pair padded to a static size so
the whole pipeline stays jit-compilable and vmappable over batches of pairs.
The reference uses ragged ``std::vector`` everywhere (code/PLADE/util.h:61-143);
this design replaces each with a padded buffer + validity mask.
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp


class Cloud(NamedTuple):
    """A padded point cloud. ``points[i]`` valid iff ``i < count``.

    Padding convention: invalid rows are filled with a far-away sentinel
    (BIG) so they never enter any radius neighborhood.
    """
    points: jnp.ndarray    # (N, 3) float32
    normals: jnp.ndarray   # (N, 3) float32 (zeros if absent)
    count: jnp.ndarray     # () int32

    @property
    def mask(self) -> jnp.ndarray:
        n = self.points.shape[0]
        return jnp.arange(n) < self.count


class PlaneSet(NamedTuple):
    """Extracted planes, padded to ``max_planes``.

    ``coeffs[k] = (nx, ny, nz, d)`` with unit normal and plane equation
    ``n.x + d = 0`` (reference PLANE: plane_extraction.h:44-50).
    ``point_plane`` maps each cloud point to its plane id (-1 = none).
    """
    coeffs: jnp.ndarray       # (P, 4) float32
    sizes: jnp.ndarray        # (P,) int32  — support point counts
    count: jnp.ndarray        # () int32    — number of valid planes
    point_plane: jnp.ndarray  # (N,) int32  — plane id per cloud point or -1

    @property
    def mask(self) -> jnp.ndarray:
        p = self.coeffs.shape[0]
        return jnp.arange(p) < self.count


class PlaneGeometry(NamedTuple):
    """Per-plane derived geometry (reference: plade.cpp:87-122).

    * ``ds_points``: downsampled in-plane points, padded to (P, M, 3)
    * ``corners``: the four OBB corners projected to the plane, (P, 4, 3)
    * ``centers`` / ``radii``: bounding circle of those corners
    """
    ds_points: jnp.ndarray   # (P, M, 3) float32 (BIG-padded)
    ds_counts: jnp.ndarray   # (P,) int32
    corners: jnp.ndarray     # (P, 4, 3) float32
    centers: jnp.ndarray     # (P, 3) float32
    radii: jnp.ndarray       # (P,) float32


class LineSet(NamedTuple):
    """Plane-pair intersection lines (reference INTERSECTION_LINE,
    util.h:70-78), padded to ``max_lines``.

    The live reference path only ever produces two-support-plane
    intersection lines (boundary lines are dead code — SURVEY 2.1.4j),
    so ``support`` always holds two valid plane ids for valid lines.
    """
    direction: jnp.ndarray  # (L, 3) float32 unit
    point: jnp.ndarray      # (L, 3) float32 — a point on the line
    support: jnp.ndarray    # (L, 2) int32   — supporting plane ids
    count: jnp.ndarray      # () int32

    @property
    def mask(self) -> jnp.ndarray:
        l = self.direction.shape[0]
        return jnp.arange(l) < self.count


class PairDescriptors(NamedTuple):
    """8-D pair-line descriptors (reference PAIRLINE, util.h:104-112).

    One row per ordered/unordered line pair retained for matching.
    ``line_vec1/2`` are the *canonicalized* line directions recomputed from
    the support-plane normals (util.cpp:533-567) — these feed hypothesis
    generation.  ``anchor`` is the closest point on line1 to line2
    (``linePoints1``), the translation anchor (util.cpp:604-624).
    """
    desc: jnp.ndarray       # (Q, 8) float32
    line_vec1: jnp.ndarray  # (Q, 3) float32
    line_vec2: jnp.ndarray  # (Q, 3) float32
    anchor: jnp.ndarray     # (Q, 3) float32
    line_idx: jnp.ndarray   # (Q, 2) int32 — original line indices
    count: jnp.ndarray      # () int32

    @property
    def mask(self) -> jnp.ndarray:
        q = self.desc.shape[0]
        return jnp.arange(q) < self.count


class PoseSet(NamedTuple):
    """A batch of rigid transform hypotheses."""
    R: jnp.ndarray     # (H, 3, 3) float32
    t: jnp.ndarray     # (H, 3) float32
    valid: jnp.ndarray # (H,) bool


class RegistrationResult(NamedTuple):
    """Output of one pair registration.

    ``match_saturated`` / ``pen_overflow`` are truncation diagnostics: the
    reference's descriptor search and penetration loop are unbounded
    (util.cpp:115, util.cpp:450-511) while the device pipeline compacts into
    static budgets — nonzero values mean matches/tests were dropped and the
    corresponding ``max_*`` config should be raised.
    """
    transform: jnp.ndarray   # (4, 4) float32 — source -> target
    score: jnp.ndarray       # () float32 — the quantity that RANKED the
    # winner: 0.2*planeFrac + 0.8*overlap, where overlap is the coarse
    # dsd-radius ratio (plade.cpp:561) when rescore is off, or the
    # tight-radius co-visible ratio when cfg.rescore_top_k > 0 (the
    # rescore argmax is what selects the returned pose — pipeline.py)
    overlap: jnp.ndarray     # () float32 — same convention as ``score``
    matched_planes: jnp.ndarray  # () int32
    success: jnp.ndarray     # () bool
    match_saturated: jnp.ndarray  # () int32 — query rows that kept fewer
    # descriptor radius hits than exist (match/matching.py; 0 = exact)
    pen_overflow: jnp.ndarray     # () int32 — penetration triples dropped
    # beyond max_penetration_tests (verify/penetration.py)
    cluster_truncated: jnp.ndarray  # () int32 — valid hypotheses beyond
    # the max_cluster_hypotheses prefix, excluded from pose clustering


#: sentinel coordinate for padded points — far outside any scene
BIG = 1.0e8


def pad_cloud(points, normals, size: int) -> Cloud:
    """Host-side helper: pad numpy arrays into a fixed-shape Cloud."""
    import numpy as np
    n = points.shape[0]
    if n > size:
        raise ValueError(f"cloud has {n} points > padded size {size}")
    p = np.full((size, 3), BIG, dtype=np.float32)
    p[:n] = points
    nm = np.zeros((size, 3), dtype=np.float32)
    if normals is not None:
        nm[:n] = normals
    return Cloud(points=jnp.asarray(p), normals=jnp.asarray(nm),
                 count=jnp.asarray(n, dtype=jnp.int32))


def se3_matrix(R: jnp.ndarray, t: jnp.ndarray) -> jnp.ndarray:
    """Assemble a 4x4 homogeneous transform from R (3,3) and t (3,)."""
    top = jnp.concatenate([R, t[:, None]], axis=1)
    bottom = jnp.array([[0.0, 0.0, 0.0, 1.0]], dtype=top.dtype)
    return jnp.concatenate([top, bottom], axis=0)

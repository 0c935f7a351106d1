"""Overlap scoring of candidate transforms.

Replaces ``ComputeOverlap`` (code/PLADE/util.h:611-647) and its calling loop
(plade.cpp:545-575): per candidate, the fraction of downsampled source
points that land within ``inlier_distance`` of a downsampled target point,
normalized by min(|source|, |target|) (the reference's MIN at util.h:644 —
so the ratio can exceed 1 when the source downsamples larger).

Design (per-query bucket walks are gather-bound, so both phases are dense):

  phase 1 — approximate, all candidates: one dense dilated voxel-occupancy
    bitmap over the target (cell == inlier radius, 27-neighborhood dilation
    via six axis-shift ORs).  Scoring a transformed source point is then a
    single gather.  The dilated test is a *superset* of the exact radius
    test: any point with a true neighbor within r passes.
  phase 2 — exact, top-K candidates by approximate count: blocked dense
    min-distance in diff form (knn/bruteforce.py).  The final ranking
    among the survivors is exact.

The reference's coarse-sphere pre-clip (util.h:622-636) is an optimization
with negligible semantic effect (it can only exclude target points farther
than the source radius from the source center) and is dropped.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..knn.bruteforce import _blocks, _block_dist_sq, min_dist_sq


def build_occupancy(tgt_points, tmask, radius, grid: int = 256,
                    cell_divisor: int = 1):
    """Dense dilated occupancy bitmap of the target cloud — a SUPERSET of
    the radius-``radius`` neighbor test for clamped queries.

    Returns (bitmap (grid^3,) bool, origin (3,), cell ()).

    ``cell_divisor`` trades bound tightness for dilation passes: the cell
    is ``radius / cell_divisor`` (stretched when the cloud exceeds
    ``grid`` cells per side) and the bitmap dilates by ``cell_divisor``
    cells per axis.  Superset proof: a query within ``radius`` of a
    target differs by at most ceil(radius/cell) <= cell_divisor cells per
    axis (cell >= radius/cell_divisor always).  divisor 1 bounds hits at
    ~2x radius; divisor 2 at ~1.5x — a tighter phase-1 bound means fewer
    exact chunks in the bound loop, which under vmap every batch lane
    pays (the loop runs to the slowest lane).
    """
    big = jnp.float32(1e30)
    pmin = jnp.min(jnp.where(tmask[:, None], tgt_points, big), axis=0)
    pmax = jnp.max(jnp.where(tmask[:, None], tgt_points, -big), axis=0)
    extent = jnp.max(pmax - pmin)
    cell = jnp.maximum(jnp.asarray(radius, jnp.float32) / cell_divisor,
                       extent / (grid - 1))
    ijk = jnp.clip(jnp.floor((tgt_points - pmin) / cell).astype(jnp.int32),
                   0, grid - 1)
    flat = (ijk[:, 0] * grid + ijk[:, 1]) * grid + ijk[:, 2]
    occ = jnp.zeros((grid * grid * grid,), jnp.bool_).at[
        jnp.where(tmask, flat, grid ** 3)].set(True, mode="drop")
    occ3 = occ.reshape(grid, grid, grid)

    def dilate(axis):
        def f(b):
            z = jnp.zeros_like(jnp.take(b, jnp.arange(1), axis=axis))
            fwd = jnp.concatenate(
                [jnp.take(b, jnp.arange(1, grid), axis=axis), z], axis=axis)
            bwd = jnp.concatenate(
                [z, jnp.take(b, jnp.arange(0, grid - 1), axis=axis)],
                axis=axis)
            return b | fwd | bwd
        return f

    for _ in range(cell_divisor):
        for axis in range(3):
            occ3 = dilate(axis)(occ3)
    return occ3.reshape(-1), pmin, cell


def approx_overlap_counts(bitmap, origin, cell, R, t, src_points, smask,
                          grid: int = 256):
    """(C,) counts of source points whose dilated voxel test passes, for all
    candidates at once (one big gather).

    Out-of-grid queries are CLAMPED to the boundary cells, not dropped.
    This is what makes the dilated test a true superset of the exact
    radius test: a query just below the grid origin can still have a true
    neighbor at the boundary (the target's own extreme point defines the
    origin), and since ``cell >= inlier radius`` any such neighbor's cell
    is the clamped boundary cell itself — dropping those queries broke
    both the phase-2 bound ("approx >= exact" failed in the boundary
    shell) and the co-visible denominator (an alias pushing points
    OUTSIDE the target's bbox got aligned > covisible and a ratio > 1,
    measured flipping the identity-pair argmax to a 120-degree cube
    symmetry).  Far-away queries clamp onto boundary cells and can only
    over-count — safe for an upper bound and for a denominator."""
    q = jnp.einsum("cij,sj->csi", R, src_points) + t[:, None, :]  # (C,S,3)
    ijk = jnp.clip(jnp.floor((q - origin) / cell).astype(jnp.int32),
                   0, grid - 1)
    flat = (ijk[..., 0] * grid + ijk[..., 1]) * grid + ijk[..., 2]
    hit = bitmap[flat] & smask[None, :]
    return jnp.sum(hit.astype(jnp.int32), axis=1)


def _unit(v):
    return v / jnp.maximum(jnp.linalg.norm(v, axis=-1, keepdims=True), 1e-12)


def oriented_min_dist_sq(q, qn, refs, rn, normal_cos, block: int = 2048):
    """Per-query squared distance to the nearest reference point whose
    normal agrees (``qn . rn >= normal_cos``); inf where none does.

    Diff-form distances and the normal dot are elementwise chains that XLA
    fuses into each block's min, like knn.bruteforce.min_dist_sq."""
    rb = _blocks(refs, block)
    # padded refs get zero normals: dot 0 never passes a positive gate
    rnb = jnp.pad(rn, ((0, rb.shape[0] * block - rn.shape[0]), (0, 0))) \
        .reshape(-1, block, 3)

    def step(carry, rrnn):
        rr, nn = rrnn
        dots = (qn[:, 0, None] * nn[None, :, 0]
                + qn[:, 1, None] * nn[None, :, 1]
                + qn[:, 2, None] * nn[None, :, 2])
        d2 = jnp.where(dots >= normal_cos, _block_dist_sq(q, rr), jnp.inf)
        return jnp.minimum(carry, jnp.min(d2, axis=1)), None

    init = jnp.full((q.shape[0],), jnp.inf, jnp.float32)
    out, _ = jax.lax.scan(step, init, (rb, rnb))
    return out


def exact_overlap_counts(R, t, src_points, smask, tgt_points, r2,
                         src_normals=None, tgt_normals=None,
                         normal_cos: float = 0.0):
    """Exact per-candidate inlier counts by dense nearest-neighbour search.
    R: (K,3,3), t: (K,3).

    All K transformed source clouds are concatenated into ONE query array,
    so the distance search runs once over (K*S, T) instead of K times.

    With ``normal_cos > 0`` and normals given, a source point only counts
    when some target point within radius ALSO agrees in normal direction
    (oriented overlap — see overlap_scores).
    """
    K = R.shape[0]
    S = src_points.shape[0]
    q = (jnp.einsum("kij,sj->ksi", R, src_points)
         + t[:, None, :]).reshape(K * S, 3)
    if normal_cos > 0.0 and src_normals is not None \
            and tgt_normals is not None:
        qn = jnp.einsum("kij,sj->ksi", R, _unit(src_normals)) \
            .reshape(K * S, 3)
        d2 = oriented_min_dist_sq(q, qn, tgt_points,
                                  _unit(tgt_normals), normal_cos) \
            .reshape(K, S)
    else:
        d2 = min_dist_sq(q, tgt_points).reshape(K, S)
    return jnp.sum(((d2 <= r2) & smask[None, :]).astype(jnp.int32), axis=1)


def overlap_scores(R, t, cand_valid, src_points, src_count,
                   tgt_points, tgt_count, inlier_distance,
                   plane_frac=None, face_weight: float = 0.2,
                   exact_k: int = 16, grid: int = 256,
                   src_normals=None, tgt_normals=None,
                   normal_cos: float = 0.0, return_approx: bool = False):
    """(C,) overlap ratios with a provably exact final argmax.

    ``return_approx=True`` additionally returns the phase-1 approximate
    ratios for ALL candidates (a dilated superset of the exact test, so
    an upper bound per candidate) — callers that need a full ranking
    (e.g. pose-diverse rescore selection) use these, since unevaluated
    candidates' exact entry is 0 by design.

    ``normal_cos > 0`` enables ORIENTED overlap: an exact-phase hit
    additionally requires a radius-neighbor whose normal agrees
    (``n_src_transformed . n_tgt >= normal_cos``).  DELIBERATE DEVIATION
    from the reference's position-only ComputeOverlap (util.h:611-647):
    under repetitive structure (RESSO building floors, the synthetic
    room rows), an aliasing pose can place the source onto a geometry
    replica and WIN the raw point-overlap argmax — walls coincide, so
    only surface orientation of the non-repeating structure tells the
    poses apart.  Gating hits on normal agreement deflates exactly those
    false hits while the true pose (normals agree by construction) keeps
    its score.  The dilated phase-1 bound stays valid: gating only
    shrinks exact counts, so approx >= exact still holds per candidate.
    Set 0.0 for the reference-exact score.

    Phase 1 ranks every candidate by an *upper bound* on the caller's
    combined score (the dilated-bitmap count is a superset of the exact
    radius test, so ``approx >= exact`` per candidate; the plane-fraction
    term is exact).  Phase 2 evaluates exact overlap in chunks of
    ``exact_k`` candidates down the ranking and stops as soon as the best
    exact combined score meets the next chunk's upper bound — at which
    point no unevaluated candidate can win the caller's argmax (its
    combined score is bounded by its rank bound).  Unevaluated candidates
    return 0 overlap.

    An upper-bound *ranking* alone does NOT guarantee the true winner sits
    in the first chunk (a candidate with inflated approximate score can
    evict it), hence the bound loop; typically one chunk suffices.

    ``plane_frac`` (C,) lets the bound use the caller's full score
    ``face_weight * plane_frac + (1-face_weight) * overlap``; None ranks
    and bounds by overlap alone.
    """
    C = R.shape[0]
    tmask = jnp.arange(tgt_points.shape[0]) < tgt_count
    smask = jnp.arange(src_points.shape[0]) < src_count
    r = jnp.asarray(inlier_distance, jnp.float32)
    # divisor 2: bound ~1.5x radius instead of ~2x — fewer bound-loop
    # chunks, which every vmapped lane pays (see build_occupancy)
    bitmap, origin, cell = build_occupancy(tgt_points, tmask, r, grid,
                                           cell_divisor=2)
    counts = approx_overlap_counts(bitmap, origin, cell, R, t,
                                   src_points, smask, grid)
    denom = jnp.maximum(jnp.minimum(src_count, tgt_count), 1).astype(
        jnp.float32)
    approx = counts.astype(jnp.float32) / denom
    pf = jnp.zeros(C, jnp.float32) if plane_frac is None else plane_frac
    fw = 0.0 if plane_frac is None else face_weight
    bound = fw * pf + (1.0 - fw) * approx
    bound = jnp.where(cand_valid, bound, -jnp.inf)

    K = min(exact_k, C)
    nchunks = (C + K - 1) // K
    order = jnp.argsort(-bound)                       # (C,) desc by bound
    pad = nchunks * K - C
    order_p = jnp.concatenate([order, jnp.zeros(pad, order.dtype)]) \
        if pad else order
    bound_sorted = jnp.concatenate(
        [bound[order], jnp.full(pad + K, -jnp.inf, jnp.float32)])

    def cond(state):
        i, _, best = state
        # next chunk's best upper bound; -inf once exhausted
        next_bound = bound_sorted[i * K]
        return (i < nchunks) & (best < next_bound)

    def body(state):
        i, out, best = state
        sel = jax.lax.dynamic_slice(order_p, (i * K,), (K,))
        exact = exact_overlap_counts(R[sel], t[sel], src_points, smask,
                                     tgt_points, r * r,
                                     src_normals=src_normals,
                                     tgt_normals=tgt_normals,
                                     normal_cos=normal_cos)
        ovr = exact.astype(jnp.float32) / denom
        # duplicate indices from the padded tail rewrite the same value
        out = out.at[sel].set(jnp.where(cand_valid[sel], ovr, 0.0))
        combined = jnp.where(cand_valid[sel],
                             fw * pf[sel] + (1.0 - fw) * ovr, -jnp.inf)
        # padded slots alias candidate 0 across chunk boundaries; its exact
        # score is identical each time, so the max is unaffected
        live = jnp.arange(K) + i * K < C
        combined = jnp.where(live, combined, -jnp.inf)
        return i + 1, out, jnp.maximum(best, jnp.max(combined))

    init = (jnp.int32(0), jnp.zeros(C, jnp.float32),
            jnp.float32(-jnp.inf))
    _, out, _ = jax.lax.while_loop(cond, body, init)
    result = jnp.where(cand_valid, out, 0.0)
    if return_approx:
        return result, jnp.where(cand_valid, approx, 0.0)
    return result

"""Batched greedy RANSAC plane extraction.

Accelerator reformulation of the Schnabel Efficient-RANSAC plane detector
the reference wraps (code/3rd_party/ransac/RansacShapeDetector.cpp:456-969;
wrapper code/PLADE/plane_extraction.cpp:61-200).  The reference engine is a
lazy, sequential candidate tournament with octree subset scoring — shaped
for a single CPU core.  On an accelerator, scoring every candidate against
every point is a small dense matmul, so the design becomes:

  per greedy round (lax.while_loop):
    1. draw S candidate planes among unassigned points.  Half are
       *seed-normal* proposals (plane through a point with its normal — a
       cheap proposal with no reference counterpart, excellent where
       normals are clean); half are the reference's *3-point
       locality-stratified* draws (RansacShapeDetector.cpp:89-191): pick a
       sampling level from an adaptively reweighted distribution
       (UpdateLevelWeights, :61-87), draw two more unassigned points within
       that level's cell radius of an anchor, init the plane from the cross
       product (Plane::Init, Plane.cpp:29-38), and verify all three sample
       normals against it (FlatNormalThreshPointCompatibilityFunc)
    2. score new candidates AND the persistent candidate pool on a strided
       point subset (the reference's subset scoring: Candidate::
       ImproveBounds on stratified octrees), scaled back to full-cloud
       estimates; merge the top ``ransac_pool`` by estimate into the pool
       (the reference's lazy candidate tournament)
    3. exactly rescore the pool's top ``ransac_exact_lanes`` estimates
       against ALL points in one (N x A) pass (inlier: dist < eps and
       |n.n_hat| > normal_thresh and unassigned — ScoreComputer.h:10-43).
       Acceptance acts on these same-round exact counts, never on
       estimates: a lane is eligible once its overlook failure probability
       (1 - p_hit)^drawn falls below ``ransac_overlook_prob``
       (CandidateFailureProbability, RansacShapeDetector.h:62-68), where
       ``drawn`` accumulates valid generated candidates and decays by
       (1 - k/N_free)^3 on each acceptance (RansacShapeDetector.cpp:
       674-676).  The reference estimates p_hit = k/(N * levels * 4) for
       pure 3-point octree draws; the seed-normal half here recovers a
       k-inlier plane with probability ~ k/(2 N_free) per draw, so
       p_hit = k/(4 N_free) (factor 2 slack for normal quality) — fewer
       draws for the same confidence.  Lanes whose exact count falls below
       min_support are stale estimates and leave the pool
    4. MULTI-ACCEPT: all eligible lanes whose exact inlier sets do not
       conflict (shared inliers <= ``ransac_conflict_frac`` of the smaller
       set, measured by one (A x A) mask-matmul) are accepted in the same
       round, in exact-count order — the batched reshaping of the reference's
       one-per-iteration greedy loop.  Points claimed by several accepted
       lanes go to the largest (exclusive assignment); a lane whose
       exclusive trimmed support then fails min_support is suppressed and
       banned exactly as a single-accept failure would be
    5. per accepted lane (vmapped): refit <=3 times on its 3*eps band,
       keeping a refit only while the Gaussian-weighted global score
       improves (weigh(d, eps) = exp(-9 d^2 / (2 eps^2)), ScoreComputer.h:
       10-16; improvement gate RansacShapeDetector.cpp:633-655), then trim
       to the largest connected component on a 2-D occupancy bitmap in
       plane coordinates with a morphological close, mirroring
       BitmapPrimitiveShape::ConnectedComponent (BitmapPrimitiveShape.cpp:
       97-271): cell size = bitmap_reso * scale, dilate+erode cross, CC by
       3x3 min-label propagation iterated to its fixpoint (an exact
       labelling), keep the component with most
       points.  Bitmap occupancy uses every ``ransac_trim_subset``-th
       point (membership of ALL points stays exact via their cell labels)
    6. once (1 - min_support/(4 N_free))^drawn < overlook_prob — no plane
       of min_support plausibly remains — halve min_support while fewer
       than min_planes planes exist (the reference auto-tuner's re-run,
       plade.cpp:602-635, capped at ransac_max_trials halvings; unlike
       the reference's fresh runs, ``drawn`` carries across halvings —
       see the deliberate-deviation note at the halving site) or finish.  Lanes debunked at the current
       support level (exact count below it) turn DORMANT in the pool
       rather than being re-checked every round; halving wakes them, so a
       plane already drawn at a higher level is accepted at the lower one
       without waiting to be re-drawn (the reference's re-run redraws
       everything from scratch — same semantics, fewer draws)

Deliberate deviation: plane normals are oriented along the mean normal of
their support points.  The reference intended this (correct_normal,
plane_extraction.cpp:43-58) but a bug (count never incremented -> NaN mean)
makes it a no-op, leaving signs arbitrary; consistent orientation makes the
pair-line descriptors sign-stable across clouds and strictly improves
matching recall.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core.config import PladeConfig
from ..core.types import BIG, PlaneSet

_EPS = 1e-12


def _normalize(v):
    return v / jnp.maximum(jnp.linalg.norm(v, axis=-1, keepdims=True), _EPS)


def _plane_basis(normal):
    """Two orthonormal in-plane axes for a unit normal (3,)."""
    h = jnp.where(jnp.abs(normal[0]) > 0.9,
                  jnp.array([0.0, 1.0, 0.0]), jnp.array([1.0, 0.0, 0.0]))
    u = _normalize(jnp.cross(normal, h))
    v = jnp.cross(normal, u)
    return u, v


def _fit_plane(points, weights):
    """Weighted LS plane through points: centroid + smallest covariance
    eigenvector (Plane::LeastSquaresFit semantics, Plane.cpp:169-191)."""
    w = weights / jnp.maximum(jnp.sum(weights), 1.0)
    c = jnp.sum(points * w[:, None], axis=0)
    d = (points - c) * jnp.sqrt(w)[:, None]
    cov = d.T @ d
    from ..geometry.eig3 import smallest_eigvec3
    return smallest_eigvec3(cov), c


class ExtractStats(NamedTuple):
    """Termination diagnostics of one greedy extraction run — the device
    observability analog of the reference's per-run console prints
    (RansacShapeDetector's drawn-candidate accounting, plade.cpp:629-632)."""
    rounds: jnp.ndarray        # () int32 — greedy rounds executed
    drawn: jnp.ndarray         # () f32 — drawn counter at termination
    trials: jnp.ndarray        # () int32 — support halvings used
    min_support: jnp.ndarray   # () int32 — final support threshold


class _State(NamedTuple):
    key: jnp.ndarray
    assigned: jnp.ndarray      # (N,) bool
    point_plane: jnp.ndarray   # (N,) int32
    coeffs: jnp.ndarray        # (P, 4)
    sizes: jnp.ndarray         # (P,) int32
    num_planes: jnp.ndarray    # () int32
    min_support: jnp.ndarray   # () int32 — current support threshold
    drawn: jnp.ndarray         # () f32 — valid candidates drawn (decayed)
    trials: jnp.ndarray        # () int32 — support halvings used
    exh_streak: jnp.ndarray    # () int32 — consecutive exhaustion rounds
    rounds: jnp.ndarray        # () int32 — greedy rounds executed
    pool_n: jnp.ndarray        # (C, 3) — candidate pool plane normals
    pool_d: jnp.ndarray        # (C,)   — candidate pool plane offsets
    pool_valid: jnp.ndarray    # (C,) bool
    pool_dormant: jnp.ndarray  # (C,) bool — exact-debunked at this support
    # level; retained for the next halving instead of being re-drawn
    pool_exact: jnp.ndarray    # (C,) int32 — last exact count of a
    # dormant entry (0 when never exactly checked); upper-bounds what any
    # dormant plane can contribute, which lets halving JUMP past levels
    # nothing can satisfy
    level_probs: jnp.ndarray   # (L,) f32 — 3-point sampling level weights
    ban_n: jnp.ndarray         # (K, 3) — trim-failed planes (ring buffer)
    ban_d: jnp.ndarray         # (K,)
    ban_loose: jnp.ndarray     # (K,) bool — loose-tolerance ban (trim-fail
    # family: every refit of a fragmented structure differs slightly, so
    # the match window must be wide; debunk bans stay tight to avoid
    # blocking genuinely distinct nearby planes)
    ban_count: jnp.ndarray     # () int32 — total bans pushed (ring cursor)
    done: jnp.ndarray          # () bool


def _trim_bitmap(uv, inlier, cell, grid: int, t_sub: int = 1):
    """Phase 1 of the CC trim (per lane, vmapped): occupancy histogram of
    the inlier points' in-plane cells.  Returns (occ_counts (grid*grid,),
    flat cell index per point (N,)).

    The cell is stretched when the plane's extent exceeds ``grid`` cells —
    the reference sizes its bitmap exactly to extent/cell
    (BitmapPrimitiveShape.cpp:97-130), typically a few dozen cells per
    side, so a small fixed grid loses nothing on ordinary planes and only
    coarsens the trim for extreme aspect ratios.

    ``t_sub``: bitmap occupancy and component sizes are accumulated from
    every t_sub-th point (the scatter-adds are the trim's hot ops); every
    point's own membership test stays exact — its cell's component label
    is a gather."""
    big = jnp.float32(1e30)
    umin = jnp.min(jnp.where(inlier[:, None], uv, big), axis=0)
    umax = jnp.max(jnp.where(inlier[:, None], uv, -big), axis=0)
    extent = jnp.max(umax - umin)
    cell = jnp.maximum(jnp.maximum(cell, _EPS), extent / (grid - 1))
    ij = jnp.floor((uv - umin) / cell).astype(jnp.int32)
    ij = jnp.clip(ij, 0, grid - 1)
    flat = ij[:, 0] * grid + ij[:, 1]
    occ_counts = _hist_scatter(ij[::t_sub], inlier[::t_sub], grid)
    return occ_counts, flat


def _hist_scatter(ij, weight, grid: int):
    """(grid*grid,) occupancy histogram: scatter-add of ``weight`` (bool)
    at each point's flat cell ``ij[:, 0] * grid + ij[:, 1]``."""
    fs = ij[:, 0] * grid + ij[:, 1]
    return jnp.zeros((grid * grid,), jnp.int32).at[fs].add(
        weight.astype(jnp.int32))


def _cc_labels(occ_counts, grid: int):
    """Exact connected-component labels of the closed occupancy bitmap:
    (grid*grid,) counts -> (grid*grid,) labels, each occupied cell
    labelled with the smallest flat index in its 8-connected component,
    empty cells with grid*grid.

    One step is a 3x3 min-label stencil followed by four pointer jumps
    (each jump squares the propagation distance); steps repeat until the
    labels stop changing.  At that fixpoint every component holds one
    label, and labels only ever point at cells of their own component, so
    the result equals a flood fill whatever the component's shape.  The
    grid^2 bound on steps is a safety cap: each step that changes a label
    lowers it, so the fixpoint arrives far sooner."""
    occ = (occ_counts > 0).reshape(grid, grid)

    def cross(b, op, pad_val):
        # morphological close with the cross structuring element
        # (DilateCross/ErodeCross, BitmapPrimitiveShape.cpp:133-141)
        p = jnp.pad(b, 1, constant_values=pad_val)
        return op(op(op(op(b, p[:-2, 1:-1]), p[2:, 1:-1]),
                     p[1:-1, :-2]), p[1:-1, 2:])

    closed = cross(cross(occ, jnp.logical_or, False),
                   jnp.logical_and, True) | occ
    idx = jnp.arange(grid * grid, dtype=jnp.int32).reshape(grid, grid)
    inf_label = jnp.int32(grid * grid)
    labels0 = jnp.where(closed, idx, inf_label)

    def prop(lab):
        p = jnp.pad(lab, ((1, 1), (0, 0)), constant_values=inf_label)
        m = jnp.minimum(jnp.minimum(p[:-2], p[1:-1]), p[2:])
        p = jnp.pad(m, ((0, 0), (1, 1)), constant_values=inf_label)
        m = jnp.minimum(jnp.minimum(p[:, :-2], p[:, 1:-1]), p[:, 2:])
        m = jnp.where(closed, m, inf_label)
        flat = m.reshape(-1)
        for _ in range(4):
            safe = jnp.minimum(flat, grid * grid - 1)
            flat = jnp.minimum(
                flat, jnp.where(flat < inf_label, flat[safe], inf_label))
        return flat.reshape(grid, grid)

    def cond(state):
        _, changed, step = state
        return changed & (step < grid * grid)

    def body(state):
        lab, _, step = state
        new = prop(lab)
        return new, jnp.any(new != lab), step + 1

    labels, _, _ = jax.lax.while_loop(
        cond, body, (labels0, jnp.asarray(True), jnp.int32(0)))
    return labels.reshape(-1)


def _trim_select(occ_counts, flat_labels, flat, inlier, grid: int):
    """Phase 3 (per lane, vmapped): keep inliers of the largest component.
    Component sizes are the per-cell occupancy summed by label — a
    (cells x cells) eq-reduce, never a per-point pass."""
    iota = jnp.arange(grid * grid, dtype=jnp.int32)
    comp_counts = jnp.sum(
        jnp.where(flat_labels[:, None] == iota[None, :],
                  occ_counts[:, None], 0), axis=0)
    best_label = iota[jnp.argmax(comp_counts)]
    point_labels = flat_labels[flat]
    return inlier & (point_labels == best_label)


def _largest_component_masks(uv, inl, cell, grid: int, t_sub: int = 1):
    """CC trim for ALL lanes: uv (N, A, 2), inl (N, A) -> kept (N, A).
    Every phase vmaps per lane; under vmap the CC fixpoint loop runs until
    the slowest lane has converged."""
    occ, flat = jax.vmap(
        lambda uv_a, in_a: _trim_bitmap(uv_a, in_a, cell, grid, t_sub),
        in_axes=1)(uv, inl)                                 # (A, g*g), (A, N)
    labels = jax.vmap(lambda o: _cc_labels(o, grid))(occ)
    return jax.vmap(
        lambda o, la, fl, in_a: _trim_select(o, la, fl, in_a, grid),
        in_axes=(0, 0, 0, 1), out_axes=1)(occ, labels, flat, inl)


def build_extract_fn(cfg: PladeConfig, num_points: int,
                     max_extract: int | None = None):
    """Build the (un-jitted) extraction function for a fixed cloud size —
    composable inside larger jitted programs (pipeline.register_pair_device)."""
    max_extract = max_extract or cfg.max_planes
    S = cfg.ransac_candidates_per_round
    S_cell = S // 2                       # 3-point locality-stratified draws
    S_seed = S - S_cell                   # seed-normal proposals
    C = cfg.ransac_pool
    L = cfg.ransac_levels
    grid = cfg.bitmap_grid
    import math as _math
    log_overlook = _math.log(cfg.ransac_overlook_prob)
    hi = jax.lax.Precision.HIGHEST

    R_SUB = max(1, cfg.ransac_score_subset)
    T_SUB = max(1, cfg.ransac_trim_subset)
    D_SUB = max(R_SUB, cfg.ransac_draw_subset)
    A = min(cfg.ransac_exact_lanes, C)
    A_CHK = min(max(cfg.ransac_check_lanes, A), C)
    CONFLICT_FRAC = cfg.ransac_conflict_frac

    def round_body(state: _State, points, normals, valid, eps, bitmap_eps,
                   extent, floor_support, min_planes, max_trials):
        min_support = state.min_support
        # FLAT mode (ransac_flat_support): acceptance and termination run
        # against a SELECTION-AWARE dynamic threshold — the largest
        # schedule level at which the planes recorded so far already
        # number >= min_planes (floor until then).  The a-posteriori
        # selection (select_planes_device = the reference auto-tuner's
        # schedule, plade.cpp:602-635) will discard anything below that
        # level, so extracting it is pure waste; gating acceptance on it
        # also stops sub-threshold acceptances from resetting the
        # exhaustion streak forever (measured: without this, flat mode
        # extracted 52 planes / 45 rounds of which selection kept 14).
        # The threshold only ever rises (planes are only added), so the
        # termination claim "no plane >= support_now remains" certifies
        # the final selection outcome.
        if cfg.ransac_flat_support:
            th_sched = jnp.asarray(_support_thresholds(cfg), jnp.int32)
            pvalid = jnp.arange(state.sizes.shape[0]) < state.num_planes
            cnt_th = jnp.sum((state.sizes[None, :] >= th_sched[:, None])
                             & pvalid[None, :], axis=1)
            okth = cnt_th >= min_planes
            support_now = jnp.maximum(
                jnp.where(jnp.any(okth), th_sched[jnp.argmax(okth)],
                          min_support),
                min_support)
        else:
            support_now = min_support
        key, k1, k_lvl, k_g2, k_g3 = jax.random.split(state.key, 5)
        free = valid & ~state.assigned
        free_f = jnp.maximum(jnp.sum(free.astype(jnp.float32)), 1.0)
        # strided scoring subset (reference: Candidate::ImproveBounds scores
        # on stratified subset octrees; exact scores only for the pool)
        pts_sub = points[::R_SUB]
        nrm_sub = normals[::R_SUB]
        free_sub = free[::R_SUB]
        n_sub = pts_sub.shape[0]

        # ---- candidate generation --------------------------------------
        # S distinct uniform anchors among free points via the Gumbel top-k
        # trick: one noise vector + one top-k, instead of categorical's S
        # independent 131k-gumbel draws (which dominated the round cost)
        g = jax.random.uniform(k1, (free.shape[0],))
        scores = jnp.where(free, g, -1.0)
        _, seeds = jax.lax.approx_max_k(scores.reshape(1, -1), S)
        seeds = seeds[0]
        anchor_n = _normalize(normals[seeds])
        anchor_p = points[seeds]
        anchor_free = free[seeds]

        # seed-normal proposals: plane through the anchor with its normal
        seed_n = anchor_n[:S_seed]
        seed_d = -jnp.sum(seed_n * anchor_p[:S_seed], axis=-1)
        seed_ok = anchor_free[:S_seed]

        # 3-point draws from an adaptively-weighted locality level
        # (RansacShapeDetector::DrawSamplesStratified + GenerateCandidates);
        # companion points come from the draw subset — an unbiased draw
        # (coarser than the scoring subset: the (N_draw x S_cell) anchor-
        # distance block is the widest per-round array)
        pts_draw = points[::D_SUB]
        nrm_draw = normals[::D_SUB]
        free_draw = free[::D_SUB]
        n_draw = pts_draw.shape[0]
        ap = anchor_p[S_seed:]                                  # (S_cell, 3)
        an = anchor_n[S_seed:]
        thr = cfg.ransac_normal_thresh
        lvl = jax.random.categorical(
            k_lvl, jnp.log(jnp.maximum(state.level_probs, 1e-9)),
            shape=(S_cell,))
        radius = extent * (0.87 / (2.0 ** (lvl.astype(jnp.float32) + 1.0)))
        # (N_draw, S_cell) anchor distances: cross term as a matmul
        d2a = (jnp.sum(pts_draw * pts_draw, -1)[:, None]
               - 2.0 * jnp.dot(pts_draw, ap.T, precision=hi)
               + jnp.sum(ap * ap, -1)[None, :])
        within = (d2a <= (radius * radius)[None, :]) & free_draw[:, None]
        # two independent uniform picks per cell via shared gumbel noise
        # (degenerate coincidences collapse the cross product and are
        # rejected below)
        g2 = jax.random.uniform(k_g2, (n_draw,))
        g3 = jax.random.uniform(k_g3, (n_draw,))
        pick2 = jnp.argmax(jnp.where(within, g2[:, None], -1.0), axis=0)
        pick3 = jnp.argmax(jnp.where(within, g3[:, None], -1.0), axis=0)
        p2, p3 = pts_draw[pick2], pts_draw[pick3]
        cross = jnp.cross(p2 - ap, p3 - ap)
        cnorm = jnp.linalg.norm(cross, axis=-1)
        cn = cross / jnp.maximum(cnorm, _EPS)[:, None]
        # verify all three sample normals against the plane (the
        # FlatNormalThreshPointCompatibilityFunc check on the samples)
        nok = (jnp.abs(jnp.sum(cn * an, -1)) > thr) \
            & (jnp.abs(jnp.sum(cn * _normalize(nrm_draw[pick2]), -1)) > thr) \
            & (jnp.abs(jnp.sum(cn * _normalize(nrm_draw[pick3]), -1)) > thr)
        enough = jnp.sum(within.astype(jnp.int32), axis=0) >= 3
        cell_ok = anchor_free[S_seed:] & enough & nok & (cnorm > 1e-10)
        cell_d = -jnp.sum(cn * ap, axis=-1)

        cand_n = jnp.concatenate([seed_n, cn], axis=0)          # (S, 3)
        cand_d = jnp.concatenate([seed_d, cell_d], axis=0)
        cand_ok = jnp.concatenate([seed_ok, cell_ok], axis=0)

        # candidates matching a banned plane (one whose trimmed support
        # failed min_support at this level) are rejected at generation —
        # the analog of the reference permanently shrinking such candidates
        # in its tournament.  The ban list clears on every support halving.
        def banned_mask(nmat, dvec):
            dots = nmat @ state.ban_n.T                          # (., K)
            sgn = jnp.sign(dots + 1e-30)
            dd = jnp.abs(dvec[:, None] * sgn - state.ban_d[None, :])
            # trim-fail bans match loosely (each refit of a fragmented
            # structure lands a few degrees away — measured: tight bans
            # let the same structure burn an accept lane 9 rounds in a
            # row); debunk bans stay tight so a genuinely distinct plane
            # a few eps away is not collateral
            thr_dot = jnp.where(state.ban_loose, 0.995, 0.999)[None, :]
            thr_dd = jnp.where(state.ban_loose, 6.0, 3.0)[None, :] * eps
            near = (jnp.abs(dots) > thr_dot) & (dd < thr_dd)
            live = jnp.arange(state.ban_n.shape[0]) < \
                jnp.minimum(state.ban_count, state.ban_n.shape[0])
            return jnp.any(near & live[None, :], axis=1)

        cand_drawn = cand_ok            # pre-ban: feeds the drawn counter
        cand_ok = cand_ok & ~banned_mask(cand_n, cand_d)

        # ---- subset scoring (matmuls in full f32 — eps sits near the
        # bf16/TF32 noise of O(1) coordinates).  Fresh candidates AND pool entries score on
        # the strided subset; acceptance never acts on these estimates —
        # the top-A lanes below are rescored exactly in the same round.
        def inlier_counts(pts, nrms, fr, nmat, dvec):
            dd = jnp.abs(jnp.dot(pts, nmat.T, precision=hi) + dvec[None, :])
            nd = jnp.abs(jnp.dot(nrms, nmat.T, precision=hi))
            ok = (dd < eps) & (nd > thr) & fr[:, None]
            return jnp.sum(ok.astype(jnp.int32), axis=0)

        all_n = jnp.concatenate([cand_n, state.pool_n], axis=0)  # (S+C, 3)
        all_d = jnp.concatenate([cand_d, state.pool_d], axis=0)
        all_ok = jnp.concatenate([cand_ok, state.pool_valid], axis=0)
        all_dormant = jnp.concatenate(
            [jnp.zeros((S,), jnp.bool_), state.pool_dormant])
        all_exact = jnp.concatenate(
            [jnp.zeros((S,), jnp.int32), state.pool_exact])
        # bans clear lingering live pool copies too — but never a dormant
        # entry: debunked lanes are banned from RE-DRAWING, while their
        # dormant pool original must survive for the next halving.  NB the
        # ``drawn`` counter uses the PRE-ban cand_ok: a draw landing on a
        # known-too-small plane is still a draw — it is evidence toward
        # the overlook bound (without it the counter starves on scenes
        # where every surface has already been debunked at this level)
        all_ok &= ~banned_mask(all_n, all_d) | all_dormant
        counts = jnp.where(
            all_ok, inlier_counts(pts_sub, nrm_sub, free_sub,
                                  all_n, all_d) * R_SUB, 0)

        # ---- sampling-level reweighting (UpdateLevelWeights, factor .5) -
        contrib = jnp.where(cell_ok, counts[S_seed:S].astype(jnp.float32),
                            0.0)
        level_scores = jnp.zeros((L,), jnp.float32).at[lvl].add(contrib)
        probs = state.level_probs
        raw = jnp.where(probs > 1e-9, level_scores / jnp.maximum(probs, 1e-9),
                        0.0)
        mixed = 0.9 * raw + 0.1 * jnp.sum(raw) / L
        msum = jnp.sum(mixed)
        normed = jnp.where(msum > 0, mixed / jnp.maximum(msum, 1e-9),
                           jnp.full((L,), 1.0 / L))
        new_level_probs = 0.5 * probs + 0.5 * normed

        # ---- pool dedup before the merge: a candidate whose plane
        # matches a STRONGER one (higher estimate, ties by lower index)
        # within the tight ban tolerance is dropped.  Without this the
        # pool fills with duplicates of the few biggest remaining planes
        # and the check lanes see only 1-2 DISTINCT planes per round, so
        # accept waves stay narrow no matter how wide A is (measured:
        # 26 rounds -> the accept spread dominated).  One (S+C)^2 matmul.
        dup_dots = jnp.dot(all_n, all_n.T, precision=hi)
        dup_dd = jnp.abs(all_d[:, None] * jnp.sign(dup_dots + 1e-30)
                         - all_d[None, :])
        dup_near = (jnp.abs(dup_dots) > 0.999) & (dup_dd < 3.0 * eps)
        SC = counts.shape[0]
        dup_key = counts * SC - jnp.arange(SC, dtype=jnp.int32)
        stronger = dup_near & (dup_key[None, :] > dup_key[:, None]) \
            & all_ok[None, :]
        # dormant entries are retained (they carry the exact-count memory
        # across halvings in staged mode); only live entries dedup
        dup = jnp.any(stronger, axis=1) & ~all_dormant
        all_ok &= ~dup
        counts = jnp.where(all_ok, counts, 0)

        # ---- pool merge: keep the top C by estimate; dormancy rides along
        _, top_idx = jax.lax.top_k(counts, C)
        top_counts = counts[top_idx]
        pool_n = all_n[top_idx]
        pool_d = all_d[top_idx]
        pool_valid = all_ok[top_idx] & (top_counts > 0)
        pool_dormant = all_dormant[top_idx]
        pool_exact = all_exact[top_idx]

        drawn = state.drawn + jnp.sum(cand_drawn.astype(jnp.float32))

        # P_fail(k) = (1 - k/(4 N_free))^dr in log space; see module
        # docstring for the p_hit derivation vs the reference's
        # k/(N * levels * 4) (CandidateFailureProbability)
        def log_pfail(k_f, dr):
            p = jnp.clip(k_f / (4.0 * free_f), 0.0, 0.999999)
            return dr * jnp.log1p(-p)

        # ---- exact check lanes: rescore the pool's top-A_CHK live
        # estimates on ALL points in one (N, A_CHK) matmul — acceptance
        # AND debunking act on these, same round.  Checking a lane is one
        # extra matmul column (nearly free); refit/trim are per-lane
        # heavy, so only the top A selected lanes proceed below.  The
        # wide check set drains noisy subset estimates many lanes per
        # round — the extraction tail otherwise spends ~10 rounds
        # debunking a full pool two lanes at a time
        lane_key = jnp.where(pool_valid & ~pool_dormant, top_counts, -1)
        lane_est, lane_sel = jax.lax.top_k(lane_key, A_CHK)
        lane_n = pool_n[lane_sel]                              # (A_CHK, 3)
        lane_d = pool_d[lane_sel]
        lane_live = (lane_est > 0)
        dd_l = jnp.abs(jnp.dot(points, lane_n.T, precision=hi)
                       + lane_d[None, :])
        nd_l = jnp.abs(jnp.dot(normals, lane_n.T, precision=hi))
        Mmask = (dd_l < eps) & (nd_l > thr) & free[:, None]    # (N, A_CHK)
        exact = jnp.where(lane_live,
                          jnp.sum(Mmask.astype(jnp.int32), axis=0), 0)

        # priority = exact count descending
        lane_order = jnp.argsort(-exact)
        lane_n = lane_n[lane_order]
        lane_d = lane_d[lane_order]
        lane_sel = lane_sel[lane_order]
        lane_live = lane_live[lane_order]
        exact = exact[lane_order]
        Mmask = Mmask[:, lane_order]

        eligible = lane_live & (exact >= support_now) \
            & (log_pfail(exact.astype(jnp.float32), drawn) <= log_overlook)

        # ---- multi-accept: greedy selection of non-conflicting lanes ----
        # conflict = shared exact inliers > frac * the smaller support
        # (one (A_CHK, A_CHK) mask-matmul); static size, the greedy pass
        # unrolls.  At most A lanes are kept (refit/trim width)
        Mf = Mmask.astype(jnp.float32)
        shared = jnp.dot(Mf.T, Mf, precision=hi)           # (A_CHK, A_CHK)
        smaller = jnp.minimum(exact[:, None], exact[None, :])
        conflict = shared > CONFLICT_FRAC * jnp.maximum(
            smaller.astype(jnp.float32), 1.0)
        conflict &= ~jnp.eye(A_CHK, dtype=bool)
        sel_lane = jnp.zeros((A_CHK,), jnp.bool_)
        for a in range(A_CHK):
            clash = jnp.any(sel_lane & conflict[a])
            sel_lane = sel_lane.at[a].set(eligible[a] & ~clash)
        sel_rank = jnp.cumsum(sel_lane.astype(jnp.int32)) - sel_lane
        sel_lane &= sel_rank < A

        # compact the <= A selected lanes into A static slots (priority
        # order preserved — slot indices ascend in exact-count order)
        slot = jnp.sort(jnp.where(sel_lane, jnp.arange(A_CHK), A_CHK))[:A]
        slot_ok = slot < A_CHK                                  # (A,)
        slot_safe = jnp.minimum(slot, A_CHK - 1)
        sel_n = lane_n[slot_safe]                               # (A, 3)
        sel_d = lane_d[slot_safe]
        # chk-space scatter index for mapping slot results back (invalid
        # slots drop)
        back_idx = jnp.where(slot_ok, slot_safe, A_CHK)

        # ---- refit selected lanes (vmapped Gaussian-gated LS) ----------
        def wscore_l(n_, d_):
            # GlobalWeightedScore on the 3*eps band: Gaussian weight with
            # sigma = band/3 (weigh(), ScoreComputer.h:10-16)
            dd = jnp.abs(jnp.dot(points, n_.T, precision=hi) + d_[None, :])
            nd = jnp.abs(jnp.dot(normals, n_.T, precision=hi))
            comp = (dd < 3.0 * eps) & (nd > thr) & free[:, None]
            w = jnp.exp(-dd * dd / ((2.0 / 9.0) * (3.0 * eps) ** 2))
            return jnp.sum(jnp.where(comp, w, 0.0), axis=0)

        def refit(_, carry):
            n_, d_, sc_ = carry                       # (A,3), (A,), (A,)
            dd = jnp.abs(jnp.dot(points, n_.T, precision=hi) + d_[None, :])
            nd = jnp.abs(jnp.dot(normals, n_.T, precision=hi))
            band = (dd < 3.0 * eps) & (nd > thr) & free[:, None]
            n2, c2 = jax.vmap(lambda w: _fit_plane(points, w), in_axes=1)(
                band.astype(jnp.float32))
            n2 = jnp.where(jnp.sum(n2 * n_, -1, keepdims=True) < 0, -n2, n2)
            d2 = -jnp.sum(n2 * c2, axis=-1)
            sc2 = wscore_l(n2, d2)
            better = sc2 > sc_
            return (jnp.where(better[:, None], n2, n_),
                    jnp.where(better, d2, d_), jnp.maximum(sc2, sc_))

        ln, ld, _ = jax.lax.fori_loop(
            0, cfg.ransac_refit_rounds, refit,
            (sel_n, sel_d, wscore_l(sel_n, sel_d)))
        dd_f = jnp.abs(jnp.dot(points, ln.T, precision=hi) + ld[None, :])
        nd_f = jnp.abs(jnp.dot(normals, ln.T, precision=hi))
        inl = (dd_f < 3.0 * eps) & (nd_f > thr) & free[:, None]  # (N, A)

        # largest-connected-component trim per lane
        uvec, vvec = jax.vmap(_plane_basis)(ln)
        uv = jnp.stack([jnp.dot(points, uvec.T, precision=hi),
                        jnp.dot(points, vvec.T, precision=hi)], axis=-1)
        kept = _largest_component_masks(uv, inl, bitmap_eps, grid,
                                        T_SUB)                   # (N, A)

        # exclusive assignment: sequential greedy over lanes in priority
        # (exact-count) order — each lane claims its kept points not yet
        # claimed by a previously ACCEPTED lane; a lane whose claimed
        # support fails min_support releases its points to lower lanes,
        # exactly like the reference's one-at-a-time loop (a trim-failed
        # lane there never removed points).  A is small and static, so
        # the loop unrolls
        owner = jnp.full((points.shape[0],), A, jnp.int32)       # (N,)
        excl_support = jnp.zeros((A,), jnp.int32)
        ok_support = jnp.zeros((A,), jnp.bool_)
        for a in range(A):
            my = kept[:, a] & slot_ok[a] & (owner == A)
            cnt = jnp.sum(my.astype(jnp.int32))
            ok_a = slot_ok[a] & (cnt >= support_now)
            owner = jnp.where(my & ok_a, a, owner)
            excl_support = excl_support.at[a].set(cnt)
            ok_support = ok_support.at[a].set(ok_a)
        excl = owner[:, None] == jnp.arange(A)[None, :]          # (N, A)
        rank = jnp.cumsum(ok_support.astype(jnp.int32)) - ok_support
        room = max_extract - state.num_planes
        accept_lane = ok_support & (rank < room)
        n_acc = jnp.sum(accept_lane.astype(jnp.int32))

        # lanes that failed their exclusive trimmed support AND lanes whose
        # exact count fell below min_support (debunked estimates) are
        # banned, so freshly drawn duplicates cannot burn lanes retrying
        # them at this support level (exact counts only ever decrease, so
        # the ban is sound; it clears on halving).  Slot results scatter
        # back to chk-space first; trim-failed slots ban their REFIT
        # coefficients (the plane actually tested)
        trim_fail_slot = slot_ok & ~ok_support                  # (A,)
        accept_chk = jnp.zeros((A_CHK,), jnp.bool_).at[back_idx].set(
            accept_lane, mode="drop")
        trim_fail = jnp.zeros((A_CHK,), jnp.bool_).at[back_idx].set(
            trim_fail_slot, mode="drop")
        debunked = lane_live & (exact < support_now)
        to_ban = trim_fail | debunked
        ban_src_n = lane_n.at[back_idx].set(ln, mode="drop")
        ban_src_d = lane_d.at[back_idx].set(ld, mode="drop")
        K_ban = state.ban_n.shape[0]
        tf_rank = jnp.cumsum(to_ban.astype(jnp.int32)) - to_ban
        ban_idx = jnp.where(to_ban,
                            jnp.mod(state.ban_count + tf_rank, K_ban), K_ban)
        ban_n = state.ban_n.at[ban_idx].set(ban_src_n, mode="drop")
        ban_d = state.ban_d.at[ban_idx].set(ban_src_d, mode="drop")
        ban_loose = state.ban_loose.at[ban_idx].set(trim_fail, mode="drop")
        ban_count = state.ban_count + jnp.sum(to_ban.astype(jnp.int32))
        # a trim-failed slot bans its PRE-refit fit too: fresh draws of the
        # fragmented structure resemble the raw fit, not the refit plane
        # the first push recorded, and each escapee burns an accept lane
        # on the same trim outcome
        tf2_rank = jnp.cumsum(trim_fail_slot.astype(jnp.int32)) \
            - trim_fail_slot
        ban_idx2 = jnp.where(trim_fail_slot,
                             jnp.mod(ban_count + tf2_rank, K_ban), K_ban)
        ban_n = ban_n.at[ban_idx2].set(sel_n, mode="drop")
        ban_d = ban_d.at[ban_idx2].set(sel_d, mode="drop")
        ban_loose = ban_loose.at[ban_idx2].set(
            jnp.ones_like(trim_fail_slot), mode="drop")
        ban_count = ban_count + jnp.sum(trim_fail_slot.astype(jnp.int32))

        # orient normals along the mean support-point normal (intended
        # correct_normal semantics; see module docstring)
        mean_n = jnp.einsum("na,ni->ai", excl.astype(jnp.float32), normals,
                            precision=hi)
        flip = jnp.sum(mean_n * ln, axis=-1) < 0
        ln_o = jnp.where(flip[:, None], -ln, ln)
        ld_o = jnp.where(flip, -ld, ld)

        # commit all accepted lanes: plane ids in priority order
        pid = jnp.where(accept_lane, state.num_planes + rank, max_extract)
        new_coeffs = state.coeffs.at[pid].set(
            jnp.concatenate([ln_o, ld_o[:, None]], axis=-1), mode="drop")
        new_sizes = state.sizes.at[pid].set(excl_support, mode="drop")
        acc_pt = jnp.any(excl & accept_lane[None, :], axis=1)    # (N,)
        new_assigned = state.assigned | acc_pt
        new_point_plane = jnp.where(acc_pt, pid[jnp.minimum(owner, A - 1)],
                                    state.point_plane)
        num_planes = state.num_planes + n_acc

        # pool bookkeeping: accepted and trim-failed lanes leave the pool;
        # debunked lanes (estimate ranked them in but exact < min_support)
        # turn dormant and wait for the next halving; conflict-deferred
        # and not-yet-confident lanes stay live
        drop = accept_chk | trim_fail
        pool_valid = pool_valid.at[lane_sel].set(
            pool_valid[lane_sel] & ~drop, mode="drop")
        pool_dormant = pool_dormant.at[lane_sel].set(
            pool_dormant[lane_sel] | debunked, mode="drop")
        pool_exact = pool_exact.at[lane_sel].set(
            jnp.where(debunked, exact, pool_exact[lane_sel]), mode="drop")

        # drawn decays per acceptance to reflect point removal; sequential
        # against a SHRINKING free count, matching the reference's
        # one-acceptance-at-a-time decay (RansacShapeDetector:674) — a
        # same-base product would leave drawn slightly overconfident when
        # two lanes accept in one round.  A is static; the loop unrolls
        free_rem = free_f
        dec_prod = jnp.float32(1.0)
        for a in range(A):
            k_a = excl_support[a].astype(jnp.float32)
            factor = jnp.where(
                accept_lane[a],
                (1.0 - jnp.minimum(k_a / jnp.maximum(free_rem, 1.0),
                                   0.999)) ** 3, 1.0)
            dec_prod = dec_prod * factor
            free_rem = free_rem - jnp.where(accept_lane[a], k_a, 0.0)
        drawn = drawn * dec_prod

        # ---- overlook-probability termination / auto-tune halving ------
        # exhausted: even a plane of exactly ``support_now`` would have
        # been found by now w.p. 1 - overlook_prob (in the staged mode
        # support_now == min_support, the current halving level; in flat
        # mode it is the selection-aware dynamic threshold — see its
        # definition at the top of the round).  The claim is contradicted
        # while a live >= support_now candidate exists: an exactly-checked
        # lane deferred by a conflict, or a live pool estimate that lane
        # capacity hasn't exactly checked yet (each such entry is checked
        # within a few rounds — checked lanes always leave the live set
        # one way or another, so this cannot livelock).  The streak of two
        # keeps the single-round race (fresh draw entering the pool as the
        # bound fires) from terminating past it.
        pending_lane = jnp.any(eligible & ~accept_chk & ~trim_fail) \
            | jnp.any(lane_live & (exact >= support_now)
                      & ~eligible & ~accept_chk & ~trim_fail)
        in_lanes = jnp.zeros((C,), jnp.bool_).at[lane_sel].set(
            True, mode="drop")
        # pool estimates are subset counts (std ~ sqrt(k * R_SUB) near k);
        # gate pending on a one-sigma LOWER confidence bound so a true
        # >= support_now plane whose noisy estimate dips below the
        # threshold still holds termination open (the overlook bound
        # otherwise under-counts misses — subset noise is extra risk on
        # top of the configured overlook probability)
        ms_f = support_now.astype(jnp.float32)
        est_lcb = ms_f - jnp.sqrt(jnp.maximum(ms_f, 1.0) * R_SUB)
        pending_pool = jnp.any(pool_valid & ~pool_dormant & ~in_lanes
                               & (top_counts.astype(jnp.float32) >= est_lcb))
        pending = pending_lane | pending_pool
        # fewer free points than support_now leaves nothing to find — a
        # certainty, not a probability; without this the drawn counter
        # stalls at 0 (no valid candidates can be generated) and the
        # overlook bound never fires, burning rounds to the hard cap
        n_free_now = jnp.sum(free.astype(jnp.int32)) \
            - jnp.sum(acc_pt.astype(jnp.int32))
        no_room = n_free_now < support_now
        exh_cond = ((log_pfail(support_now.astype(jnp.float32), drawn)
                     <= log_overlook) | no_room) & (n_acc == 0) & ~pending
        exh_streak = jnp.where(exh_cond, state.exh_streak + 1, 0)
        # flat mode fires on the first exhausted round: the race the
        # 2-streak guarded (a fresh >= threshold draw arriving as the
        # bound fires) is covered because pending_pool/est_lcb are
        # computed AFTER this round's draws merge into the pool — any
        # such draw holds termination open by itself.  Staged mode keeps
        # the streak (its halving cascade re-checks dormant state, where
        # the lcb guard alone was measured too eager in round 3)
        exhausted = exh_streak >= (1 if cfg.ransac_flat_support else 2)
        need_more = num_planes < min_planes
        can_halve = (min_support > floor_support) & (state.trials < max_trials)
        halve = exhausted & need_more & can_halve
        # LEVEL JUMP: with ``drawn`` kept across halvings (below), the
        # current evidence may already exclude several of the next levels
        # — a level L is skippable when (1-L/(4N))^drawn <= overlook AND
        # no dormant plane's recorded exact count reaches L.  Jumping
        # straight past skippable levels saves the 2-round exhaustion
        # streak each would otherwise cost (measured: the polyhedron
        # cloud burned ~6 rounds walking 10000->1250 one level at a time)
        d_max = jnp.max(jnp.where(pool_valid & pool_dormant, pool_exact, 0))
        new_support = jnp.maximum(min_support // 2, floor_support)
        for _ in range(6):
            skippable = (log_pfail(new_support.astype(jnp.float32), drawn)
                         <= log_overlook) \
                & (new_support > d_max) & (new_support > floor_support)
            new_support = jnp.where(
                halve & skippable,
                jnp.maximum(new_support // 2, floor_support), new_support)
        new_support = jnp.where(halve, new_support, min_support)
        # each halving wakes dormant planes and clears bans for re-checking
        # at the lower support threshold.  DELIBERATE DEVIATION from the
        # reference's full re-run (which restarts its draw counter from
        # zero): ``drawn`` is KEPT across halvings.  Every draw since the
        # last free-set change is a valid Bernoulli trial against planes
        # of ANY support k at the current free set — p_hit depends only on
        # k — so the accumulated evidence transfers to the lower threshold
        # unchanged (the bound (1-k/(4N))^drawn just gets evaluated at the
        # smaller k, correctly requiring more draws before it fires).
        # Resetting would re-pay ~log(overlook)/log1p(-k/4N) draws per
        # level; keeping them collapses the halving cascade to ~1 round
        # per level.  Acceptance decay (above) already discounts draws
        # that predate free-set shrinkage, exactly as the reference does.
        pool_dormant = jnp.where(halve,
                                 jnp.zeros_like(pool_dormant), pool_dormant)
        rounds = state.rounds + 1
        done = (exhausted & ~(need_more & can_halve)) \
            | (num_planes >= max_extract) \
            | (rounds >= cfg.ransac_max_rounds)
        return _State(
            key=key,
            assigned=new_assigned,
            point_plane=new_point_plane,
            coeffs=new_coeffs,
            sizes=new_sizes,
            num_planes=num_planes,
            min_support=new_support,
            drawn=drawn,
            trials=jnp.where(halve, state.trials + 1, state.trials),
            exh_streak=jnp.where(halve, 0, exh_streak),
            rounds=rounds,
            pool_n=pool_n,
            pool_d=pool_d,
            pool_valid=pool_valid,
            pool_dormant=pool_dormant,
            pool_exact=jnp.where(halve, jnp.zeros_like(pool_exact),
                                 pool_exact),
            level_probs=new_level_probs,
            ban_n=ban_n,
            ban_d=ban_d,
            ban_loose=ban_loose,
            # bans are per-support-level: a plane too small for this level
            # may be perfectly valid after halving
            ban_count=jnp.where(halve, 0, ban_count),
            done=done,
        )

    def extract(points, normals, count, key, floor_support,
                init_support=None, min_planes=None):
        """points/normals: (N, 3) BIG-padded; count: () int32.

        Returns a PlaneSet padded to ``max_extract`` planes, greedy order.
        The support threshold starts at ``init_support`` (default: the
        reference's 10000) and halves down to ``floor_support`` whenever
        the overlook bound says nothing of the current support remains
        while fewer than ``min_planes`` planes exist — the device-resident
        form of the reference auto-tuner (plade.cpp:602-635).
        """
        if init_support is None:
            # flat-support mode: start at the floor (see
            # PladeConfig.ransac_flat_support for the soundness argument);
            # otherwise the reference's staged halving from 10000
            init_support = (cfg.ransac_min_allowed_support
                            if cfg.ransac_flat_support
                            else cfg.ransac_init_min_support)
        if min_planes is None:
            min_planes = cfg.min_planes
        valid = jnp.arange(num_points) < count
        safe_pts = jnp.where(valid[:, None], points, 0.0)
        big = jnp.float32(1e30)
        pmin = jnp.min(jnp.where(valid[:, None], points, big), axis=0)
        pmax = jnp.max(jnp.where(valid[:, None], points, -big), axis=0)
        scale = jnp.max(pmax - pmin)  # PointCloud::getScale (PointCloud.h:94)
        eps = cfg.ransac_dist_thresh * scale
        bitmap_eps = cfg.ransac_bitmap_reso * scale

        init = _State(
            key=key,
            assigned=jnp.zeros((num_points,), jnp.bool_),
            point_plane=jnp.full((num_points,), -1, jnp.int32),
            coeffs=jnp.zeros((max_extract, 4), jnp.float32),
            sizes=jnp.zeros((max_extract,), jnp.int32),
            num_planes=jnp.asarray(0, jnp.int32),
            min_support=jnp.maximum(jnp.asarray(init_support, jnp.int32),
                                    jnp.asarray(floor_support, jnp.int32)),
            drawn=jnp.asarray(0.0, jnp.float32),
            trials=jnp.asarray(0, jnp.int32),
            exh_streak=jnp.asarray(0, jnp.int32),
            rounds=jnp.asarray(0, jnp.int32),
            pool_n=jnp.zeros((C, 3), jnp.float32),
            pool_d=jnp.zeros((C,), jnp.float32),
            pool_valid=jnp.zeros((C,), jnp.bool_),
            pool_dormant=jnp.zeros((C,), jnp.bool_),
            pool_exact=jnp.zeros((C,), jnp.int32),
            level_probs=jnp.full((L,), 1.0 / L, jnp.float32),
            # ban ring must outlast many rounds of wide-lane debunking:
            # at A_CHK=8 debunks/round a 32-ring wraps in ~4 rounds and
            # debunked planes get redrawn forever (measured: rounds 34->57)
            ban_n=jnp.zeros((256, 3), jnp.float32),
            ban_d=jnp.zeros((256,), jnp.float32),
            ban_loose=jnp.zeros((256,), jnp.bool_),
            ban_count=jnp.asarray(0, jnp.int32),
            done=jnp.asarray(False),
        )

        def cond(s):
            return ~s.done

        def body(s):
            return round_body(s, safe_pts, normals, valid, eps, bitmap_eps,
                              scale,
                              jnp.asarray(floor_support, jnp.int32),
                              jnp.asarray(min_planes, jnp.int32),
                              jnp.asarray(cfg.ransac_max_trials, jnp.int32))

        final = jax.lax.while_loop(cond, body, init)
        planes = PlaneSet(coeffs=final.coeffs, sizes=final.sizes,
                          count=final.num_planes,
                          point_plane=final.point_plane)
        stats = ExtractStats(rounds=final.rounds, drawn=final.drawn,
                             trials=final.trials,
                             min_support=final.min_support)
        return planes, stats

    return extract


def make_extractor(cfg: PladeConfig, num_points: int,
                   max_extract: int | None = None):
    """Jitted standalone extraction for fixed cloud size."""
    return jax.jit(build_extract_fn(cfg, num_points, max_extract))


def auto_extract(points, normals, count, key, cfg: PladeConfig,
                 num_points: int):
    """Plane extraction with the reference's auto-tuning semantics
    (plade.cpp:602-635): aim for 10..40 planes; min support starts at
    10000, halves down to 200 until >= 10 planes; >40 planes keeps the
    largest 40.

    Device reformulation: extract once greedily with the floor support (200)
    and up to 64 planes, then select the support threshold a posteriori —
    one device pass instead of up to 10 detector re-runs.
    """
    extractor = _cached_extractor(cfg, num_points)
    planes, _ = extractor(points, normals, count, key,
                          cfg.ransac_min_allowed_support)
    return select_planes(planes, cfg)


@functools.lru_cache(maxsize=8)
def _cached_extractor(cfg: PladeConfig, num_points: int):
    return make_extractor(cfg, num_points, max_extract=64)


def _support_thresholds(cfg: PladeConfig) -> list[int]:
    """The reference's halving schedule: 10000, 5000, ..., >= floor
    (plade.cpp:607-633)."""
    ts = []
    t = cfg.ransac_init_min_support
    while t >= cfg.ransac_min_allowed_support:
        ts.append(t)
        t //= 2
    return ts


def select_planes_device(planes: PlaneSet, cfg: PladeConfig) -> PlaneSet:
    """Device-side (jittable) variant of :func:`select_planes` — the same
    auto-tune semantics as the reference's extract() loop (plade.cpp:602-635)
    expressed as masked reductions, so the whole pipeline can stay on
    device for batched/sharded execution.
    """
    P0 = planes.coeffs.shape[0]
    P = cfg.max_planes
    sizes = planes.sizes
    valid = jnp.arange(P0) < planes.count
    th = jnp.asarray(_support_thresholds(cfg), jnp.int32)          # (T,)
    cnt = jnp.sum((sizes[None, :] >= th[:, None]) & valid[None, :], axis=1)
    okth = cnt >= cfg.min_planes
    chosen = jnp.where(jnp.any(okth), th[jnp.argmax(okth)],
                       jnp.int32(cfg.ransac_min_allowed_support))
    keep = valid & (sizes >= chosen)
    # largest max_planes by support, then restored to greedy order
    order = jnp.argsort(-jnp.where(keep, sizes, -1))
    kept = order[:P]
    kept_valid = keep[kept]
    kk = jnp.sort(jnp.where(kept_valid, kept, P0))
    new_valid = kk < P0
    kk_safe = jnp.minimum(kk, P0 - 1)
    coeffs = jnp.where(new_valid[:, None], planes.coeffs[kk_safe], 0.0)
    out_sizes = jnp.where(new_valid, sizes[kk_safe], 0)
    remap = jnp.full((P0 + 1,), -1, jnp.int32).at[
        jnp.where(new_valid, kk_safe, P0)].set(
        jnp.arange(P, dtype=jnp.int32), mode="drop")
    pp = planes.point_plane
    new_pp = jnp.where(pp >= 0, remap[jnp.clip(pp, 0, P0)], -1)
    return PlaneSet(coeffs=coeffs, sizes=out_sizes,
                    count=jnp.sum(new_valid.astype(jnp.int32)),
                    point_plane=new_pp.astype(jnp.int32))


def select_planes_pinned(planes: PlaneSet, cfg: PladeConfig) -> PlaneSet:
    """Selection for the explicit min-support overload (plade.cpp:583-599).

    The reference pins the RANSAC support threshold and applies **no**
    auto-tune halving or post-selection — every extracted plane is used.
    Extraction already enforced support >= the pinned value (it ran with
    floor == init == the pinned support), so this only trims to the
    ``max_planes`` buffer (largest by support, greedy order restored) and
    remaps point-plane ids.
    """
    import numpy as np
    sizes = np.asarray(planes.sizes)
    n = int(planes.count)
    keep = np.arange(n)
    if n > cfg.max_planes:
        order = np.argsort(-sizes[:n], kind="stable")
        keep = np.sort(order[: cfg.max_planes])
    P = cfg.max_planes
    coeffs = np.zeros((P, 4), np.float32)
    out_sizes = np.zeros((P,), np.int32)
    remap = np.full((max(n, 1) + 1,), -1, np.int32)
    for new_id, old_id in enumerate(keep):
        coeffs[new_id] = np.asarray(planes.coeffs)[old_id]
        out_sizes[new_id] = sizes[old_id]
        remap[old_id] = new_id
    point_plane = np.asarray(planes.point_plane)
    new_point_plane = np.where(point_plane >= 0, remap[point_plane], -1)
    return PlaneSet(coeffs=jnp.asarray(coeffs),
                    sizes=jnp.asarray(out_sizes),
                    count=jnp.asarray(len(keep), jnp.int32),
                    point_plane=jnp.asarray(new_point_plane.astype(np.int32)))


def select_planes(planes: PlaneSet, cfg: PladeConfig) -> PlaneSet:
    """Post-selection implementing the auto-tune support thresholds.

    Planes arrive in greedy (size-biased) order with support >= the floor.
    Choose the largest min-support threshold from the reference's halving
    schedule (10000, 5000, ..., >=200) that leaves >= min_planes planes;
    keep at most max_planes (the reference keeps the largest 40,
    plade.cpp:611-620).
    """
    import numpy as np
    sizes = np.asarray(planes.sizes)
    n = int(planes.count)
    sizes = sizes[:n]
    thresholds = []
    t = cfg.ransac_init_min_support
    while t >= cfg.ransac_min_allowed_support:
        thresholds.append(t)
        t //= 2
    chosen = cfg.ransac_min_allowed_support
    for t in thresholds:
        if int((sizes >= t).sum()) >= cfg.min_planes:
            chosen = t
            break
    keep = np.where(sizes >= chosen)[0]
    # keep the largest max_planes by support
    if len(keep) > cfg.max_planes:
        order = np.argsort(-sizes[keep], kind="stable")
        keep = np.sort(keep[order[: cfg.max_planes]])
    P = cfg.max_planes
    coeffs = np.zeros((P, 4), np.float32)
    out_sizes = np.zeros((P,), np.int32)
    remap = np.full((n + 1,), -1, np.int32)
    for new_id, old_id in enumerate(keep):
        coeffs[new_id] = np.asarray(planes.coeffs)[old_id]
        out_sizes[new_id] = sizes[old_id]
        remap[old_id] = new_id
    point_plane = np.asarray(planes.point_plane)
    new_point_plane = np.where(point_plane >= 0, remap[point_plane], -1)
    return PlaneSet(coeffs=jnp.asarray(coeffs),
                    sizes=jnp.asarray(out_sizes),
                    count=jnp.asarray(len(keep), jnp.int32),
                    point_plane=jnp.asarray(new_point_plane.astype(np.int32)))

"""Descriptor matching, pose hypotheses, pose clustering, plane consistency.

Device-side replacement for ``MatchingLines`` (code/PLADE/util.cpp:31-520):

* the nine ANN KD-trees (only the 8-D 2-2 tree is live) become one blocked
  dense distance computation with a fixed 0.04 radius (util.cpp:115) and a
  static-size match compaction;
* per-match rigid hypotheses use closed-form frame alignment
  (ComputeTransformationUsingTwoVecAndOnePoint, util.cpp:604-624);
* ``ClusterTransformation``'s conditional Euclidean clustering over the 6-D
  (translation, Euler-angle) embedding (util.cpp:1245-1277) becomes grid
  binning at the same tolerances — the fixed-shape approximation of
  single-linkage clustering;
* cluster representatives are screened by the bounding-center check and the
  plane-consistency count (util.cpp:352-401), fully batched.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core.types import PairDescriptors
from ..geometry.transforms import euler_angles, rotation_from_two_vecs


class Matches(NamedTuple):
    q_idx: jnp.ndarray   # (M,) int32 — query row
    t_idx: jnp.ndarray   # (M,) int32 — target row
    valid: jnp.ndarray   # (M,) bool
    count: jnp.ndarray   # () int32 (pre-cap true count)
    saturated: jnp.ndarray  # () int32 — query rows that KEPT fewer radius
    # hits than truly exist (per-query cap or sort-unit approximation):
    # an exact drop counter vs the reference's unbounded-k search
    # (util.cpp:115).  0 certifies the match set radius-exact.


def match_descriptors(query: PairDescriptors, target: PairDescriptors,
                      radius: float, max_matches: int,
                      block: int = 512, per_query: int = 64) -> Matches:
    """All (query, target) descriptor pairs within ``radius`` (8-D
    Euclidean), compacted into a fixed-size buffer.

    Streams over query blocks so the (Q, T) distance matrix is never
    materialized; the cross term is a matmul.  Per-row neighbors are
    selected with ``lax.approx_min_k`` (an exact top-k on GPU and CPU) capped at
    ``per_query`` matches per query row, then the (Q, per_query) survivor
    grid is compacted once with a cumsum + small scatter.  (The reference's
    fixed-radius search is unbounded-k — util.cpp:115 — but real queries
    have a handful of radius-neighbors, so a dense rank-order scatter over
    all Q x T cells would be mostly wasted work.)

    Two approximations vs the reference's exact unbounded search:

    * rows with more than ``per_query`` true radius hits keep only the
      nearest ``per_query``;
    * ``approx_min_k`` at default recall over the 2k+4 oversample is not
      guaranteed exact where it is approximate — a true radius match can
      fall outside the approximate top-(2k+4) when many near-tie
      distances crowd one sort tile.  On GPU and CPU it lowers to an
      exact top-k, so there the oversample and the patch pass below are
      redundant (ROADMAP Design 3).

    Both are CORRECTED and surfaced exactly: the true radius-hit count
    per row is an extra cheap reduction over the block distance matrix
    (materialized anyway); rows that kept fewer hits than exist (up to
    128 of them) get an exact second pass — their full distance rows are
    recomputed and exactly sorted, which is trivial at that row count.
    ``saturated`` counts the rows still short AFTER the patch — nonzero
    only when a row's true hit count exceeds ``per_query`` or more than
    128 rows needed patching.  Zero saturation certifies the match set
    radius-exact vs the reference's unbounded search.
    """
    Q = query.desc.shape[0]
    T = target.desc.shape[0]
    r2 = jnp.float32(radius * radius)
    nblocks = (Q + block - 1) // block
    qd = jnp.pad(query.desc, ((0, nblocks * block - Q), (0, 0)),
                 constant_values=1e6)
    td = target.desc
    tt = jnp.sum(td * td, axis=-1)
    k = min(per_query, T)

    # modest oversample: the exact patch pass below catches and fixes
    # EVERY row where the approximation dropped a hit, so the oversample
    # only controls how many rows need patching (PATCH budget), not
    # correctness; k+8 halves the sort-unit volume vs the former 2k+4
    k_over = min(k + 8, T)

    def body(_, qblock):
        qq = jnp.sum(qblock * qblock, axis=-1, keepdims=True)
        d2 = qq - 2.0 * jnp.dot(qblock, td.T,
                                preferred_element_type=jnp.float32,
                                precision=jax.lax.Precision.HIGHEST) \
            + tt[None, :]
        # oversample 2k+4 at default recall and keep the exact k smallest
        # of those: a true entry is missed only if it falls outside the
        # approximate top-(2k+4) (the reference's fixed-radius search is
        # exact, util.cpp:115); exact already on GPU and CPU
        vals_o, idx_o = jax.lax.approx_min_k(d2, k_over)
        order = jnp.argsort(vals_o, axis=-1)[:, :k]
        vals = jnp.take_along_axis(vals_o, order, axis=1)
        idx = jnp.take_along_axis(idx_o, order, axis=1)
        # exact radius-hit count per row: the drop certificate (docstring)
        nh = jnp.sum((d2 <= r2).astype(jnp.int32), axis=-1)
        return None, (vals, idx, nh)

    blocks = qd.reshape(nblocks, block, qd.shape[-1])
    _, (vals, idx, nh) = jax.lax.scan(body, None, blocks)
    vals = vals.reshape(nblocks * block, k)[:Q]
    idx = idx.reshape(nblocks * block, k)[:Q]
    nh = nh.reshape(nblocks * block)[:Q]

    # exact patch pass (docstring): rows that kept fewer radius hits than
    # truly exist get their full distance row recomputed and EXACTLY
    # sorted — a (PATCH, T) matmul + top_k, trivial at PATCH=128 rows
    PATCH = min(128, Q)
    kept0 = jnp.sum((vals <= r2).astype(jnp.int32), axis=1)
    bad = nh > kept0
    bidx = jnp.nonzero(bad, size=PATCH, fill_value=Q)[0]
    qb = query.desc[jnp.minimum(bidx, Q - 1)]
    d2b = jnp.sum(qb * qb, -1, keepdims=True) \
        - 2.0 * jnp.dot(qb, td.T, preferred_element_type=jnp.float32,
                        precision=jax.lax.Precision.HIGHEST) \
        + tt[None, :]
    nvb, ib = jax.lax.top_k(-d2b, k)
    # padding entries carry bidx == Q (out of bounds) and drop; real rows
    # write their exact top-k
    vals = vals.at[bidx].set(-nvb, mode="drop")
    idx = idx.at[bidx].set(ib, mode="drop")

    hit = vals <= r2                                     # (Q, k)
    hi = hit.astype(jnp.int32)
    flat_hit = hi.reshape(-1)
    dest = jnp.cumsum(flat_hit) - flat_hit               # rank-order position
    write = hit.reshape(-1) & (dest < max_matches)
    dest_safe = jnp.where(write, dest, max_matches)
    qi = jnp.broadcast_to(jnp.arange(Q, dtype=jnp.int32)[:, None],
                          (Q, k)).reshape(-1)
    buf_q = jnp.zeros(max_matches + 1, jnp.int32).at[dest_safe].set(
        jnp.where(write, qi, 0), mode="drop")
    buf_t = jnp.zeros(max_matches + 1, jnp.int32).at[dest_safe].set(
        jnp.where(write, idx.reshape(-1).astype(jnp.int32), 0), mode="drop")
    total = jnp.sum(hi)
    m = jnp.arange(max_matches) < jnp.minimum(total, max_matches)
    kept_hits = jnp.sum(hi, axis=1)
    return Matches(q_idx=buf_q[:max_matches], t_idx=buf_t[:max_matches],
                   valid=m, count=total,
                   saturated=jnp.sum((nh > kept_hits).astype(jnp.int32)))


def stitch_hypotheses(segments):
    """Front-compact hypothesis segments into one (R, t, valid) buffer.

    ``segments``: list of ``(R (Mi,3,3), t (Mi,3), count ())`` where each
    segment's valid rows already sit in a front prefix (the
    match_descriptors compaction convention).  The segments are copied at
    the running valid count with ``dynamic_update_slice`` so ALL valid
    rows land in one prefix — required by cluster_poses' small-count tier
    dispatch, which only looks at the first ``small`` rows (concatenating
    raw padded buffers instead would park later segments' hypotheses
    behind the first buffer's invalid tail, silently dropping them
    whenever the total count fits a tier).

    Returns (R, t, valid, total).
    """
    H = sum(int(s[0].shape[0]) for s in segments)
    R0, t0, c0 = segments[0]
    R = jax.lax.dynamic_update_slice(
        jnp.zeros((H, 3, 3), R0.dtype), R0, (0, 0, 0))
    t = jax.lax.dynamic_update_slice(
        jnp.zeros((H, 3), t0.dtype), t0, (0, 0))
    total = jnp.minimum(c0, R0.shape[0]).astype(jnp.int32)
    for Ri, ti, ci in segments[1:]:
        # write start = running count <= sum of previous segment sizes,
        # so start + Mi <= H always: no dynamic_update_slice clamping
        R = jax.lax.dynamic_update_slice(R, Ri, (total, 0, 0))
        t = jax.lax.dynamic_update_slice(t, ti, (total, 0))
        total = total + jnp.minimum(ci, Ri.shape[0]).astype(jnp.int32)
    valid = jnp.arange(H) < total
    return R, t, valid, total


def hypothesis_poses(query: PairDescriptors, target: PairDescriptors,
                     matches: Matches):
    """(R, t) per match: R aligns the canonicalized source line directions
    onto the target's; t = target_anchor - R @ source_anchor
    (util.cpp:303-327, 604-624)."""
    qv1 = query.line_vec1[matches.q_idx]
    qv2 = query.line_vec2[matches.q_idx]
    tv1 = target.line_vec1[matches.t_idx]
    tv2 = target.line_vec2[matches.t_idx]
    R = rotation_from_two_vecs(qv1, qv2, tv1, tv2)
    qa = query.anchor[matches.q_idx]
    ta = target.anchor[matches.t_idx]
    t = ta - jnp.einsum("mij,mj->mi", R, qa)
    return R, t


class Clusters(NamedTuple):
    rep: jnp.ndarray      # (C,) int32 — hypothesis index of representative
    size: jnp.ndarray     # (C,) int32 — cluster member count
    valid: jnp.ndarray    # (C,) bool


def cluster_poses(R: jnp.ndarray, t: jnp.ndarray, valid: jnp.ndarray,
                  dist_tol, euler_tol, max_clusters: int,
                  chunk: int = 1024) -> Clusters:
    """Exact single-linkage pose clustering over the 6-D (t, euler)
    embedding, in fixed shape.

    Callers bound the hypothesis buffer to a static prefix
    (cfg.max_cluster_hypotheses) before calling — valid matches are
    front-compacted by match_descriptors/stitch_hypotheses, so the prefix
    covers every live hypothesis whenever the total fits (overflow is
    counted loudly upstream).  One code path, no data-dependent
    dispatch: a dynamic ``lax.cond`` tier (round 4) executed BOTH
    branches under vmap, running the full-buffer sweep for every batch
    lane.

    Matches the reference semantics (ClusterTransformation +
    EnforceSimilarity, util.cpp:1232-1277): hypotheses are linked when
    their translations are within ``dist_tol`` (Euclidean, the CEC cluster
    tolerance = lengthThreshold/2) AND their Euler-angle vectors differ by
    less than ``euler_tol`` (squared-norm < angleThreshold/2); clusters are
    the connected components of that graph.  The representative is the
    smallest hypothesis index in the component (PCL's BFS seeds clusters
    at the first unvisited index, so ``cluster.indices[0]`` is exactly the
    component minimum); clusters rank by size descending (the reference's
    sort at util.cpp:337-355).

    Fixed shape: min-label propagation over the adjacency (materialized
    once for H <= 8192; recomputed in (chunk x H) matmul blocks above
    that); two pointer jumps (labels <- labels[labels]) per sweep square
    the effective propagation distance; a while_loop runs sweeps until
    the labeling is a fixed point — exact connected components, no
    grid-boundary splits.  Dense clumps converge in 2-3 sweeps.
    """
    return _cluster_impl(R, t, valid, dist_tol, euler_tol, max_clusters,
                         chunk)


def _cluster_impl(R: jnp.ndarray, t: jnp.ndarray, valid: jnp.ndarray,
                  dist_tol, euler_tol, max_clusters: int,
                  chunk: int = 1024) -> Clusters:
    H = R.shape[0]
    # the packed scatter-argmin below stores the member index in the low 16
    # bits — a config raising max_matches past 2^16 would silently corrupt
    # representatives, so fail loudly at trace time instead
    assert H <= 65536, (
        f"cluster_poses packs indices into 16 bits; H={H} > 65536 "
        "(lower cfg.max_matches or widen the packing)")
    roll, pitch, yaw = euler_angles(R)
    e = jnp.stack([roll, pitch, yaw], axis=-1)
    tt = jnp.sum(t * t, axis=-1)
    ee = jnp.sum(e * e, axis=-1)
    d2t_tol = jnp.asarray(dist_tol, jnp.float32) ** 2
    d2e_tol = jnp.asarray(euler_tol, jnp.float32) ** 2
    idx = jnp.arange(H, dtype=jnp.int32)
    hi = jax.lax.Precision.HIGHEST

    if H <= 8192:
        # hot path (the tier dispatch lands nearly every real pair here):
        # materialize the (H, H) adjacency ONCE — two matmuls + two
        # compares — so each sweep is a single masked min-reduce instead
        # of a sequential lax.map over chunked distance blocks recomputed
        # every sweep (one 4096^2 bool is 16 MB, a bandwidth triviality)
        d2t_full = tt[:, None] - 2.0 * jnp.dot(t, t.T, precision=hi) \
            + tt[None, :]
        d2e_full = ee[:, None] - 2.0 * jnp.dot(e, e.T, precision=hi) \
            + ee[None, :]
        adj_full = (d2t_full <= d2t_tol) & (d2e_full < d2e_tol) \
            & valid[:, None] & valid[None, :]

        def sweep(labels):
            new = jnp.min(jnp.where(adj_full, labels[None, :], H), axis=1)
            lab = jnp.minimum(labels, new.astype(jnp.int32))
            lab = jnp.minimum(lab, lab[lab])     # pointer jump x2
            return jnp.minimum(lab, lab[lab])
    else:
        chunk = min(chunk, H)
        nchunks = (H + chunk - 1) // chunk
        Hp = nchunks * chunk
        pad = Hp - H

        def pad0(x):
            return jnp.pad(x, ((0, pad),) + ((0, 0),) * (x.ndim - 1)) \
                if pad else x

        t_p = pad0(t).reshape(nchunks, chunk, 3)
        e_p = pad0(e).reshape(nchunks, chunk, 3)
        tt_p = pad0(tt).reshape(nchunks, chunk)
        ee_p = pad0(ee).reshape(nchunks, chunk)
        v_p = pad0(valid).reshape(nchunks, chunk)

        def sweep(labels):
            def one(args):
                tr, er, ttr, eer, vr = args
                d2t = ttr[:, None] - 2.0 * jnp.dot(tr, t.T, precision=hi) \
                    + tt[None, :]
                d2e = eer[:, None] - 2.0 * jnp.dot(er, e.T, precision=hi) \
                    + ee[None, :]
                adj = (d2t <= d2t_tol) & (d2e < d2e_tol) \
                    & vr[:, None] & valid[None, :]
                return jnp.min(jnp.where(adj, labels[None, :], H), axis=1)

            new = jax.lax.map(
                one, (t_p, e_p, tt_p, ee_p, v_p)).reshape(Hp)[:H]
            lab = jnp.minimum(labels, new.astype(jnp.int32))
            lab = jnp.minimum(lab, lab[lab])     # pointer jump x2
            return jnp.minimum(lab, lab[lab])

    def cond(state):
        labels, prev, it = state
        return jnp.any(labels != prev) & (it < 32)

    def body(state):
        labels, _, it = state
        return sweep(labels), labels, it + 1

    init = sweep(idx)
    labels, _, _ = jax.lax.while_loop(cond, body, (init, idx, jnp.int32(1)))

    counts = jnp.zeros(H, jnp.int32).at[labels].add(
        valid.astype(jnp.int32), mode="drop")

    # representative = member nearest the cluster's 6-D centroid.
    # DELIBERATE DEVIATION: the reference takes ``cluster.indices[0]`` —
    # an arbitrary (insertion-order) member, often a fringe pose whose
    # sloppy alignment then fails verification downstream; the centroid
    # mode is the density peak the clustering exists to find.
    vf = valid.astype(jnp.float32)[:, None]
    cnt_f = jnp.maximum(counts.astype(jnp.float32), 1.0)
    tmean = (jnp.zeros((H, 3)).at[labels].add(t * vf, mode="drop")
             / cnt_f[:, None])[labels]
    emean = (jnp.zeros((H, 3)).at[labels].add(e * vf, mode="drop")
             / cnt_f[:, None])[labels]
    d = jnp.sum((t - tmean) ** 2, -1) / jnp.maximum(d2t_tol, 1e-12) \
        + jnp.sum((e - emean) ** 2, -1) / jnp.maximum(d2e_tol, 1e-12)
    # scatter-argmin via packed (quantized distance, index) int32 keys:
    # distance ranks in the high bits, the index tie-breaks (and is
    # recovered by masking).  H <= 2^16 indices, 2^15 distance bins.
    imax = jnp.iinfo(jnp.int32).max
    q = jnp.clip(d * 4096.0, 0.0, 32766.0).astype(jnp.int32)
    packed = jnp.where(valid, (q << 16) | idx, imax)
    best = jnp.full((H,), imax, jnp.int32).at[labels].min(
        packed, mode="drop")
    rep_of_root = best & jnp.int32(0xFFFF)

    k = min(max_clusters, H)
    top_counts, top_root = jax.lax.top_k(counts, k)
    if k < max_clusters:
        top_counts = jnp.pad(top_counts, (0, max_clusters - k))
        top_root = jnp.pad(top_root, (0, max_clusters - k))
    cvalid = top_counts > 0
    rep = jnp.where(cvalid, rep_of_root[top_root], 0)
    return Clusters(rep=rep.astype(jnp.int32), size=top_counts,
                    valid=cvalid)


def plane_consistency(R, t, cvalid,
                      src_coeffs, src_centers, src_radii, src_pmask,
                      tgt_coeffs, tgt_centers, tgt_radii, tgt_pmask,
                      src_bounding_center, tgt_bounding_center,
                      max_radius, length_threshold, cos_angle_threshold):
    """Per-candidate consistent-plane count + matched pair mask.

    Mirrors util.cpp:352-401: candidates whose transformed bounding center
    leaves the target radius are zeroed; a source plane counts (once) if
    some target plane has matching normal direction, small symmetric
    center-to-plane distance, and overlapping bounding circles.

    Returns (counts (C,), pair_mask (C, Ps, Pt) bool).
    """
    # transformed source planes: normal R n, offset d - (Rn).t
    ns = src_coeffs[:, :3]
    ds = src_coeffs[:, 3]
    rn = jnp.einsum("cij,pj->cpi", R, ns)                   # (C, Ps, 3)
    rd = ds[None, :] - jnp.einsum("cpi,ci->cp", rn, t)      # (C, Ps)
    sc = jnp.einsum("cij,pj->cpi", R, src_centers) + t[:, None, :]

    nt = tgt_coeffs[:, :3]
    dt = tgt_coeffs[:, 3]

    ang = jnp.einsum("cpi,qi->cpq", rn, nt)                 # (C, Ps, Pt)
    d_a = jnp.abs(jnp.einsum("qi,cpi->cpq", nt, sc) + dt[None, None, :])
    d_b = jnp.abs(jnp.einsum("cpi,qi->cpq", rn, tgt_centers) + rd[..., None])
    c2pd = 0.5 * (d_a + d_b)
    center_dist = jnp.linalg.norm(sc[:, :, None, :] - tgt_centers[None, None, :, :],
                                  axis=-1)
    rad_sum = src_radii[None, :, None] + tgt_radii[None, None, :]

    ok = (ang >= cos_angle_threshold) & (c2pd <= length_threshold) \
        & (center_dist <= rad_sum) \
        & src_pmask[None, :, None] & tgt_pmask[None, None, :]

    # bounding-center sanity (util.cpp:359-363)
    tc = jnp.einsum("cij,j->ci", R, src_bounding_center) + t
    center_ok = jnp.linalg.norm(tc - tgt_bounding_center, axis=-1) <= max_radius

    matched_src = jnp.any(ok, axis=2)                        # (C, Ps)
    counts = jnp.sum(matched_src.astype(jnp.int32), axis=1)
    counts = jnp.where(cvalid & center_ok, counts, 0)
    # "break" on first target match: keep only the first matching target
    first = jnp.argmax(ok, axis=2)
    pair_mask = (jnp.arange(ok.shape[2])[None, None, :] == first[..., None]) & ok
    pair_mask &= (cvalid & center_ok)[:, None, None]
    return counts, pair_mask


def select_candidates(counts, cluster_order_rank, max_candidates: int):
    """Order candidates by (match count desc, cluster-size rank asc) and
    keep the top ``max_candidates`` with count >= 2 (util.cpp:404-459)."""
    C = counts.shape[0]
    eligible = counts >= 2
    # composite sort key: primary -counts, secondary original rank
    key = jnp.where(eligible, counts.astype(jnp.int32) * C - cluster_order_rank,
                    jnp.int32(-1))
    order = jnp.argsort(-key)
    sel = order[:max_candidates]
    sel_valid = eligible[sel]
    return sel.astype(jnp.int32), sel_valid

"""Plane-penetration candidate filter.

Replicates ``AreTwoPlanesPenetrable`` (code/PLADE/util.cpp:1279-1458) and its
calling loop (util.cpp:465-511): a candidate transform is rejected when some
transformed source plane's point set crosses through a target plane (points
on both sides beyond ``minDistance``) along the clipped intersection segment
of their bounding quads.

Device reformulation in three phases:

  1. dense cheap geometry over all (candidate, src plane, tgt plane)
     triples: skip test, plane-plane line, clipping against both 4-corner
     quads, segment overlap — a few hundred flops per triple;
  2. compaction of the triples that actually need point counting into a
     static test budget; each test walks the segment with a fixed number of
     samples and counts plane-side points of both clouds (the KD-tree
     radius queries of the reference become dense (points x samples)
     distance blocks, chunked with lax.map);
  3. scatter of per-test verdicts back to candidates: rejected if any
     triple penetrates.

Reference quirks preserved: the pair-skip condition compares the normals'
dot product against the *angle* threshold (radians, not its cosine —
util.cpp:489); side 1 requires both point counts >= minPointsNum (OR-skip,
util.cpp:1408) while side 2 requires only one (AND-skip, util.cpp:1446);
the imbalance ratio uses min(pos, neg+1) (util.cpp:1412).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry.lines import intersect_planes
from ..geometry.transforms import normalize

_EPS = 1e-12


def _clip_line_with_quad(u, p0, corners):
    """Intersect line (u, p0) with the 4 edges of the (..., 4, 3) quad.

    Returns (pts (..., 2, 3), ok) following util.cpp:1300-1351: ok requires
    exactly two edge hits; zero hits means 'no penetration possible'
    (handled by caller through n_hits).
    """
    nxt = jnp.roll(corners, -1, axis=-2)                    # (..., 4, 3)
    e = normalize(nxt - corners)
    # least-squares intersection of (u, p0) with each edge line = midpoint
    # of the mutual closest points (ComputeIntersectionPointOf23DLine)
    uu = jnp.broadcast_to(u[..., None, :], e.shape)
    pp = jnp.broadcast_to(p0[..., None, :], e.shape)
    not_parallel = jnp.abs(jnp.sum(uu * e, -1)) <= 0.9999
    w0 = pp - corners
    b = jnp.sum(uu * e, -1)
    d = jnp.sum(uu * w0, -1)
    f = jnp.sum(e * w0, -1)
    denom = jnp.maximum(1.0 - b * b, 1e-9)
    s = (b * f - d) / denom
    tt = (f - b * d) / denom
    ip = 0.5 * (pp + s[..., None] * uu + corners + tt[..., None] * e)
    between = jnp.sum((corners - ip) * (nxt - ip), -1) <= 0.0
    hit = not_parallel & between                            # (..., 4)
    n_hits = jnp.sum(hit.astype(jnp.int32), -1)
    # first two hits in edge order
    rank = jnp.cumsum(hit.astype(jnp.int32), axis=-1) - 1
    sel0 = (rank == 0) & hit
    sel1 = (rank == 1) & hit
    pt0 = jnp.sum(jnp.where(sel0[..., None], ip, 0.0), axis=-2)
    pt1 = jnp.sum(jnp.where(sel1[..., None], ip, 0.0), axis=-2)
    return jnp.stack([pt0, pt1], axis=-2), n_hits


class PenTests(NamedTuple):
    cand: jnp.ndarray     # (K,) int32 candidate index
    src: jnp.ndarray      # (K,) int32 source plane
    tgt: jnp.ndarray      # (K,) int32 target plane
    start: jnp.ndarray    # (K, 3)
    direc: jnp.ndarray    # (K, 3)
    length: jnp.ndarray   # (K,)
    valid: jnp.ndarray    # (K,) bool
    overflow: jnp.ndarray # () int32 — triples needing a point test beyond
    # the ``max_tests`` budget (dropped).  The reference's penetration loop
    # is unbounded (util.cpp:450-511); a nonzero overflow means candidates
    # may have escaped rejection and the budget should be raised.


def build_tests(R, t, cand_valid,
                src_coeffs, src_corners, src_centers, src_pmask,
                tgt_coeffs, tgt_corners, tgt_centers, tgt_pmask,
                length_threshold, angle_threshold, max_tests: int) -> PenTests:
    """Phase 1+2: dense geometry + compaction of triples needing point
    counting.  Corners are the per-plane projected OBB quads
    (plade.cpp:110-117)."""
    C = R.shape[0]
    Ps = src_coeffs.shape[0]
    Pt = tgt_coeffs.shape[0]

    ns = src_coeffs[:, :3]
    ds = src_coeffs[:, 3]
    rn = jnp.einsum("cij,pj->cpi", R, ns)                       # (C,Ps,3)
    rd = ds[None, :] - jnp.einsum("cpi,ci->cp", rn, t)
    sc = jnp.einsum("cij,pj->cpi", R, src_centers) + t[:, None, :]
    rcorners = jnp.einsum("cij,pkj->cpki", R, src_corners) + t[:, None, None, :]

    nt = tgt_coeffs[:, :3]
    dt = tgt_coeffs[:, 3]

    # skip: nearly-coincident matched pair (util.cpp:487-492, dot vs ANGLE)
    d_a = jnp.abs(jnp.einsum("qi,cpi->cpq", nt, sc) + dt[None, None, :])
    d_b = jnp.abs(jnp.einsum("cpi,qi->cpq", rn, tgt_centers) + rd[..., None])
    c2pd = 0.5 * (d_a + d_b)
    dotn = jnp.einsum("cpi,qi->cpq", rn, nt)
    skip = (c2pd < length_threshold) & (dotn > angle_threshold)

    # plane-plane intersection line
    p1 = jnp.concatenate([rn, rd[..., None]], axis=-1)          # (C,Ps,4)
    p1b = jnp.broadcast_to(p1[:, :, None, :], (C, Ps, Pt, 4))
    p2b = jnp.broadcast_to(
        jnp.concatenate([nt, dt[:, None]], -1)[None, None, :, :],
        (C, Ps, Pt, 4))
    u, p0, line_ok = intersect_planes(p1b, p2b)

    q1 = jnp.broadcast_to(rcorners[:, :, None, :, :], (C, Ps, Pt, 4, 3))
    q2 = jnp.broadcast_to(tgt_corners[None, None, :, :, :], (C, Ps, Pt, 4, 3))
    pts1, n1 = _clip_line_with_quad(u, p0, q1)
    pts2, n2 = _clip_line_with_quad(u, p0, q2)
    clip_ok = (n1 == 2) & (n2 == 2)

    # overlap of the two clipped spans along the line (util.cpp:1353-1373)
    direc = normalize(pts1[..., 1, :] - pts1[..., 0, :])
    allpts = jnp.concatenate([pts1, pts2], axis=-2)             # (...,4,3)
    proj = jnp.sum((allpts - pts1[..., 0:1, :]) * direc[..., None, :], -1)
    order = jnp.argsort(proj, axis=-1)
    tags = order // 2                                           # 0 = quad1
    overlap_ok = tags[..., 0] != tags[..., 1]
    lo = jnp.take_along_axis(proj, order[..., 1:2], axis=-1)[..., 0]
    hi = jnp.take_along_axis(proj, order[..., 2:3], axis=-1)[..., 0]
    start = pts1[..., 0, :] + lo[..., None] * direc
    length = hi - lo

    need = (~skip) & line_ok & clip_ok & overlap_ok
    need &= cand_valid[:, None, None] & src_pmask[None, :, None] \
        & tgt_pmask[None, None, :]

    flat = need.reshape(-1)
    total = C * Ps * Pt
    n_need = jnp.sum(flat.astype(jnp.int32))
    idx = jnp.nonzero(flat, size=max_tests, fill_value=total)[0]
    ok = idx < total
    idx_safe = jnp.minimum(idx, total - 1)
    ci = idx_safe // (Ps * Pt)
    si = (idx_safe // Pt) % Ps
    ti = idx_safe % Pt
    return PenTests(
        cand=ci.astype(jnp.int32), src=si.astype(jnp.int32),
        tgt=ti.astype(jnp.int32),
        start=start.reshape(total, 3)[idx_safe],
        direc=direc.reshape(total, 3)[idx_safe],
        length=length.reshape(total)[idx_safe],
        valid=ok,
        overflow=jnp.maximum(n_need - max_tests, 0),
    )


def _d2(a, b):
    """Batched squared distances (k,M,3) x (k,S,3) -> (k,M,S); the cross
    term is a batched GEMM."""
    aa = jnp.sum(a * a, axis=-1)                                # (k,M)
    bb = jnp.sum(b * b, axis=-1)                                # (k,S)
    cross = jnp.einsum("kmi,ksi->kms", a, b,
                       preferred_element_type=jnp.float32,
                       precision=jax.lax.Precision.HIGHEST)
    return jnp.maximum(aa[..., None] - 2.0 * cross + bb[:, None, :], 0.0)


def run_tests(tests: PenTests, R, t,
              src_plane_pts, src_plane_counts,
              tgt_plane_pts, tgt_plane_counts,
              src_coeffs, tgt_coeffs,
              search_radius, min_points: int, min_distance,
              n_samples: int, chunk: int = 512, max_ratio: float = 5.0,
              small_points: int = 512):
    """Phase 2b: the point-counting walk for each compacted test.

    Tests whose BOTH planes have at most ``small_points`` downsampled
    points run in a separate pass over sliced (k, small_points, 3)
    buffers — per-plane points are front-packed, so the slice is exact —
    cutting the distance-block volume ~4x for those tests (the full
    ``max_plane_points`` buffer is mostly padding for small planes;
    measured plane counts on the flagship span 200..2048).

    Returns per-test ``penetrable`` (K,) bool.
    """
    ns = src_coeffs[:, :3]
    ds = src_coeffs[:, 3]

    def make_one_chunk(src_pts, tgt_pts):
        def one_chunk(tc):
            cand, src, tgt, start, direc, length, valid = tc
            Rt = R[cand]                                       # (k,3,3)
            tt = t[cand]
            cloud1 = jnp.einsum("kij,kmj->kmi", Rt, src_pts[src]) \
                + tt[:, None, :]                               # (k,M,3)
            m1 = jnp.arange(cloud1.shape[1])[None, :] \
                < src_plane_counts[src][:, None]
            cloud2 = tgt_pts[tgt]                              # (k,M,3)
            m2 = jnp.arange(cloud2.shape[1])[None, :] \
                < tgt_plane_counts[tgt][:, None]

            # transformed source plane (normal, offset) and target plane
            rn = jnp.einsum("kij,kj->ki", Rt, ns[src])
            rd = ds[src] - jnp.sum(rn * tt, -1)
            ntg = tgt_coeffs[tgt, :3]
            dtg = tgt_coeffs[tgt, 3]

            ks = jnp.arange(n_samples, dtype=jnp.float32)
            s_pos = ks[None, :] * search_radius                 # (k,S)
            s_ok = s_pos < length[:, None]
            samples = start[:, None, :] \
                + s_pos[..., None] * direc[:, None, :]

            def side(points, pmask, other, omask, pn, pd):
                # occupancy of the *other* cloud per sample (>=2 in r/2)
                d2o = _d2(other, samples)                       # (k,M,S)
                occ = jnp.sum((d2o <= (search_radius / 2) ** 2)
                              & omask[..., None], axis=1) >= 2  # (k,S)
                sample_live = s_ok & occ
                d2p = _d2(points, samples)                      # (k,M,S)
                near = jnp.any((d2p <= search_radius ** 2)
                               & sample_live[:, None, :],
                               axis=2) & pmask                  # (k,M)
                signed = jnp.einsum("kmi,ki->km", points, pn) + pd[:, None]
                pos = jnp.sum((near & (signed > min_distance))
                              .astype(jnp.int32), 1)
                neg = jnp.sum((near & (signed < -min_distance))
                              .astype(jnp.int32), 1)
                return pos, neg

            # side 1: source points vs target plane (util.cpp:1383-1415)
            pos1, neg1 = side(cloud1, m1, cloud2, m2, ntg, dtg)
            ratio1 = jnp.maximum(pos1, neg1) / jnp.maximum(
                jnp.minimum(pos1, neg1 + 1), 1)
            side1 = (pos1 >= min_points) & (neg1 >= min_points) \
                & (ratio1 <= max_ratio)
            # side 2: target points vs source plane (util.cpp:1417-1453)
            pos2, neg2 = side(cloud2, m2, cloud1, m1, rn, rd)
            ratio2 = jnp.maximum(pos2, neg2) / jnp.maximum(
                jnp.minimum(pos2, neg2 + 1), 1)
            side2 = ((pos2 >= min_points) | (neg2 >= min_points)) \
                & (ratio2 <= max_ratio)
            return side1 & side2 & valid

        return one_chunk

    K = tests.cand.shape[0]
    chunk = min(chunk, K)
    nchunks = (K + chunk - 1) // chunk
    pad = nchunks * chunk - K
    per_test = (tests.cand, tests.src, tests.tgt, tests.start, tests.direc,
                tests.length, tests.valid)      # overflow scalar excluded

    M = src_plane_pts.shape[1]
    Ms = min(small_points, M)
    is_small = (src_plane_counts[tests.src] <= Ms) \
        & (tgt_plane_counts[tests.tgt] <= Ms)

    def run_group(sel, one_chunk):
        """Front-compact the selected tests, run their live chunks
        (while_loop skips all-padding chunks; the reference loop is
        exactly as long as its live tests, util.cpp:450-511), and
        scatter verdicts back to the global test order."""
        n_sel = jnp.sum(sel.astype(jnp.int32))
        idx = jnp.nonzero(sel, size=K, fill_value=K)[0]
        safe = jnp.minimum(idx, K - 1)
        g = jax.tree.map(lambda x: x[safe], per_test)
        g = g[:-1] + (g[-1] & (idx < K),)      # valid &= in-range
        padded = jax.tree.map(
            lambda x: jnp.concatenate(
                [x, jnp.zeros((pad,) + x.shape[1:], x.dtype)]) if pad else x,
            g)
        tc = jax.tree.map(
            lambda x: x.reshape((nchunks, chunk) + x.shape[1:]), padded)
        nlive = (n_sel + chunk - 1) // chunk

        def cond(state):
            i, _ = state
            return i < nlive

        def body(state):
            i, out = state
            tci = jax.tree.map(
                lambda x: jax.lax.dynamic_index_in_dim(x, i,
                                                       keepdims=False),
                tuple(tc))
            res = one_chunk(tci)
            return i + 1, jax.lax.dynamic_update_slice(out, res,
                                                       (i * chunk,))

        _, peng = jax.lax.while_loop(
            cond, body,
            (jnp.int32(0), jnp.zeros((nchunks * chunk,), jnp.bool_)))
        return jnp.zeros((K,), jnp.bool_).at[idx].set(peng[:K], mode="drop")

    pen = run_group(tests.valid & is_small,
                    make_one_chunk(src_plane_pts[:, :Ms],
                                   tgt_plane_pts[:, :Ms]))
    pen |= run_group(tests.valid & ~is_small,
                     make_one_chunk(src_plane_pts, tgt_plane_pts))
    return pen


def rejected_candidates(tests: PenTests, penetrable, num_candidates: int):
    """Phase 3: a candidate is rejected if any of its tests penetrates."""
    hits = jnp.zeros(num_candidates, jnp.int32).at[tests.cand].add(
        (penetrable & tests.valid).astype(jnp.int32))
    return hits > 0

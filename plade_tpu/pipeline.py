"""End-to-end pair registration pipeline.

Device counterpart of the 550-line core ``registration`` overload
(code/PLADE/plade.cpp:31-580); see SURVEY section 3.1 for the reference
call stack.  The per-pair flow:

  prepare_cloud (per cloud):  downsample -> OBB -> per-plane geometry ->
                              plane-pair intersection lines
  register_pair:              pair-line descriptors (both sides) ->
                              radius-0.04 dense descriptor match ->
                              closed-form pose hypotheses -> 6-D pose-bin
                              clustering -> plane-consistency screening ->
                              top-200 candidates -> penetration filter ->
                              voxel-hash overlap scoring -> argmax of
                              0.2 * planeFrac + 0.8 * overlap

Everything between (and including) descriptor construction and final
scoring is one jit-compiled, fixed-shape program per config — vmappable
over batches of pairs and shardable over a device mesh (dist/).
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .core.config import PladeConfig
from .core.types import (BIG, Cloud, LineSet, PlaneGeometry, PlaneSet,
                         RegistrationResult, pad_cloud, se3_matrix)
from .descriptors.pairlines import pair_descriptors
from .extract import ransac
from .geometry.lines import intersect_planes, project_points_to_plane
from .geometry.obb import compute_obb
from .geometry.voxel import voxel_downsample, voxel_downsample_by_plane
from .knn.bruteforce import average_spacing
from .match import matching
from .verify import overlap as overlap_mod
from .verify import penetration


def _line_confidence(lines: LineSet, geom: PlaneGeometry, dsd,
                     cfg: PladeConfig) -> jnp.ndarray:
    """(L,) per-line confidence = min over the two supporting planes of
    ``|plane ds points| * dsd^2 / mean-squared line-to-plane distance``.

    Mirrors ComputeMeanDistanceOfLine2Plane (util.h:389-426): project the
    plane's bounding corners onto the line, walk the projected span at
    ``line_conf_interval`` steps (stretched so ``line_conf_samples`` cover
    the span), and average the squared nearest-neighbor distance into the
    plane's downsampled points; confidence per plade.cpp:153-160."""
    S = cfg.line_conf_samples
    u = lines.direction                                      # (L, 3)
    p = lines.point
    sup = lines.support                                      # (L, 2)
    corners = geom.corners[sup]                              # (L, 2, 4, 3)
    tproj = jnp.sum((corners - p[:, None, None, :])
                    * u[:, None, None, :], -1)               # (L, 2, 4)
    lo = jnp.min(tproj, axis=-1)
    hi = jnp.max(tproj, axis=-1)
    span = hi - lo
    step = jnp.maximum(jnp.float32(cfg.line_conf_interval), span / S)
    pos = lo[..., None] + jnp.arange(S, dtype=jnp.float32) \
        * step[..., None]                                    # (L, 2, S)
    smask = pos < hi[..., None]
    smask = smask.at[..., 0].set(True)                       # >= 1 sample
    q = p[:, None, None, :] + pos[..., None] * u[:, None, None, :]

    cnt = geom.ds_counts[sup]                                # (L, 2)
    hiP = jax.lax.Precision.HIGHEST

    def one(args):
        qc, supc, cntc = args                                # (c,2,S,3) ...
        pts = geom.ds_points[supc]                           # (c,2,M,3)
        M = pts.shape[2]
        pmask = jnp.arange(M)[None, None, :] < cntc[..., None]
        d2 = (jnp.sum(qc * qc, -1)[..., None]
              - 2.0 * jnp.einsum("lksi,lkmi->lksm", qc, pts, precision=hiP)
              + jnp.sum(pts * pts, -1)[..., None, :])        # (c,2,S,M)
        d2 = jnp.where(pmask[..., None, :], d2, jnp.inf)
        return jnp.min(d2, axis=-1)                          # (c,2,S)

    L = u.shape[0]
    c = max(1, min(32, L))
    nch = (L + c - 1) // c
    padn = nch * c - L

    def padc(x):
        return jnp.pad(x, ((0, padn),) + ((0, 0),) * (x.ndim - 1)) \
            if padn else x

    d2min = jax.lax.map(one, (padc(q).reshape((nch, c) + q.shape[1:]),
                              padc(sup).reshape(nch, c, 2),
                              padc(cnt).reshape(nch, c, 2)))
    d2min = d2min.reshape((nch * c, 2, S))[:L]
    nsamp = jnp.maximum(jnp.sum(smask.astype(jnp.float32), -1), 1.0)
    mean_d2 = jnp.sum(jnp.where(smask, d2min, 0.0), -1) / nsamp  # (L, 2)
    conf = cnt.astype(jnp.float32) * dsd * dsd \
        / jnp.maximum(mean_d2, 1e-12)
    conf = jnp.where(cnt > 0, conf, 0.0)
    return jnp.min(conf, axis=-1)


class PreparedCloud(NamedTuple):
    ds: Cloud                    # downsampled full cloud
    bounding_center: jnp.ndarray # (3,)
    bounding_radius: jnp.ndarray # ()
    planes: PlaneSet
    geom: PlaneGeometry
    lines: LineSet


def _prepare_cloud_impl(cloud: Cloud, planes: PlaneSet, dsd,
                        cfg: PladeConfig) -> PreparedCloud:
    # cloud-level downsample + PCA bounding box (plade.cpp:77-84);
    # normals carried for ICP's point-to-plane correspondences
    ds = voxel_downsample(cloud.points, cloud.mask, dsd, cfg.max_ds_points,
                          normals=cloud.normals)
    box = compute_obb(ds.points, ds.mask)
    # enclosing-sphere radius (OBB half-diagonal) — see
    # PladeConfig.line_radius_factor for the deviation rationale vs the
    # reference's max-extent/2 (plade.cpp:84)
    sphere_radius = cfg.line_radius_factor * 0.5 * jnp.linalg.norm(box.extents)

    # per-plane geometry (plade.cpp:87-122): all planes voxel-downsampled in
    # one sorted pass, OBBs batched
    P = planes.coeffs.shape[0]
    pts, counts = voxel_downsample_by_plane(
        cloud.points, cloud.mask, planes.point_plane, dsd, P,
        cfg.max_plane_points)
    pmasks = jnp.arange(cfg.max_plane_points)[None, :] < counts[:, None]
    pboxes = compute_obb(pts, pmasks)
    corners = jax.vmap(project_points_to_plane)(
        pboxes.corners[:, :4], planes.coeffs)
    centers = 0.5 * (corners[:, 0] + corners[:, 2])
    radii = 0.5 * jnp.linalg.norm(corners[:, 0] - corners[:, 2], axis=-1)
    geom = PlaneGeometry(ds_points=pts, ds_counts=counts, corners=corners,
                         centers=centers, radii=radii)

    # plane-pair intersection lines (plade.cpp:130-172)
    coeffs = planes.coeffs
    ii, jj = jnp.meshgrid(jnp.arange(P), jnp.arange(P), indexing="ij")
    tri = jj > ii
    direction, point, lvalid = intersect_planes(coeffs[ii], coeffs[jj],
                                                cfg.plane_pair_max_cos)
    lvalid &= tri & planes.mask[ii] & planes.mask[jj]
    # reject lines far from the bounding center (plade.cpp:137-142; radius
    # relaxed to the enclosing sphere, see line_radius_factor)
    w = point - box.center
    along = jnp.sum(w * direction, axis=-1)
    dist = jnp.sqrt(jnp.maximum(jnp.sum(w * w, -1) - along * along, 0.0))
    lvalid &= dist <= sphere_radius

    flat = lvalid.reshape(-1)
    total = P * P
    idx = jnp.nonzero(flat, size=cfg.max_lines, fill_value=total)[0]
    ok = idx < total
    idx_safe = jnp.minimum(idx, total - 1)
    li = idx_safe // P
    lj = idx_safe % P
    lines = LineSet(
        direction=jnp.where(ok[:, None], direction.reshape(total, 3)[idx_safe], 0.0),
        point=jnp.where(ok[:, None], point.reshape(total, 3)[idx_safe], BIG),
        support=jnp.where(ok[:, None], jnp.stack([li, lj], -1), 0).astype(jnp.int32),
        count=jnp.sum(flat.astype(jnp.int32)).clip(max=cfg.max_lines),
    )
    if cfg.min_line_confidence > 0.0:
        # line-confidence cull (plade.cpp:144-162; the reference computes
        # this but ships with the threshold commented out — see
        # PladeConfig.min_line_confidence)
        conf = _line_confidence(lines, geom, dsd, cfg)
        keep2 = lines.mask & (conf >= cfg.min_line_confidence)
        L = cfg.max_lines
        idx2 = jnp.nonzero(keep2, size=L, fill_value=L)[0]
        ok2 = idx2 < L
        safe2 = jnp.minimum(idx2, L - 1)
        lines = LineSet(
            direction=jnp.where(ok2[:, None], lines.direction[safe2], 0.0),
            point=jnp.where(ok2[:, None], lines.point[safe2], BIG),
            support=jnp.where(ok2[:, None], lines.support[safe2],
                              0).astype(jnp.int32),
            count=jnp.sum(keep2.astype(jnp.int32)),
        )
    return PreparedCloud(ds=ds, bounding_center=box.center,
                         bounding_radius=sphere_radius, planes=planes,
                         geom=geom, lines=lines)


@functools.partial(jax.jit, static_argnames=("cfg",))
def prepare_cloud(cloud: Cloud, planes: PlaneSet, dsd, cfg: PladeConfig):
    return _prepare_cloud_impl(cloud, planes, dsd, cfg)


def _register_pair_impl(tgt: PreparedCloud, src: PreparedCloud, dparams,
                        cfg: PladeConfig) -> RegistrationResult:
    scale, length_threshold, dsd = dparams
    cos10 = math.cos(cfg.line_pair_min_angle)
    tgt_desc = pair_descriptors(tgt.lines, tgt.planes.coeffs[:, :3], scale,
                                cfg.max_target_pairs, ordered=True,
                                min_angle_cos=cos10, pad_value=-1e6)
    src_desc = pair_descriptors(src.lines, src.planes.coeffs[:, :3], scale,
                                cfg.max_query_pairs, ordered=False,
                                min_angle_cos=cos10, pad_value=1e6)
    matches = matching.match_descriptors(
        src_desc, tgt_desc, cfg.descriptor_match_radius, cfg.max_matches,
        per_query=cfg.match_per_query)
    R, t = matching.hypothesis_poses(src_desc, tgt_desc, matches)
    hyp_valid = matches.valid
    # live valid rows of the 2-2 buffer (front-compacted by
    # match_descriptors)
    total_matches = jnp.minimum(matches.count, cfg.max_matches)

    if cfg.enable_degraded_families:
        # 22-21 / 22-12 degraded 6-D families (flag; see PladeConfig):
        # extra hypothesis sources for pairs whose plane correspondence
        # is broken in one cloud.  Their matches only ADD hypotheses —
        # the 2-2 path above is untouched.  The three match buffers are
        # stitched FRONT-COMPACTED (matching.stitch_hypotheses) so the
        # tier dispatch in cluster_poses sees every degraded hypothesis.
        from .descriptors.pairlines import degraded_descriptors
        segments = [(R, t, matches.count)]
        for fam in ("2221", "2212"):
            tgt_d6 = degraded_descriptors(
                tgt.lines, tgt.planes.coeffs[:, :3], scale,
                cfg.max_target_pairs, ordered=True, min_angle_cos=cos10,
                family=fam, pad_value=-1e6)
            src_d6 = degraded_descriptors(
                src.lines, src.planes.coeffs[:, :3], scale,
                cfg.max_query_pairs, ordered=False, min_angle_cos=cos10,
                family=fam, pad_value=1e6)
            m6 = matching.match_descriptors(
                src_d6, tgt_d6, cfg.descriptor_match_radius,
                cfg.max_degraded_matches, per_query=cfg.match_per_query)
            R6, t6 = matching.hypothesis_poses(src_d6, tgt_d6, m6)
            segments.append((R6, t6, m6.count))
        R, t, hyp_valid, total_matches = matching.stitch_hypotheses(
            segments)

    # cluster at half the length/angle thresholds (util.cpp:331).  The
    # hypothesis buffer is front-compacted, so clustering the static
    # prefix covers every live hypothesis up to the budget; overflow is
    # counted loudly (cluster_truncated)
    euler_tol = math.sqrt(cfg.angle_threshold / 2.0)
    HB = min(cfg.max_cluster_hypotheses, R.shape[0])
    cluster_truncated = jnp.maximum(total_matches - HB, 0)
    clusters = matching.cluster_poses(
        R[:HB], t[:HB], hyp_valid[:HB], length_threshold / 2.0, euler_tol,
        cfg.max_pose_clusters)
    cR = R[clusters.rep]
    ct = t[clusters.rep]

    counts, _ = matching.plane_consistency(
        cR, ct, clusters.valid,
        src.planes.coeffs, src.geom.centers, src.geom.radii, src.planes.mask,
        tgt.planes.coeffs, tgt.geom.centers, tgt.geom.radii, tgt.planes.mask,
        src.bounding_center, tgt.bounding_center,
        tgt.bounding_radius, length_threshold,
        math.cos(cfg.angle_threshold))

    C = counts.shape[0]
    sel, sel_valid = matching.select_candidates(
        counts, jnp.arange(C, dtype=jnp.int32), cfg.max_candidate_results)
    sR = cR[sel]
    st = ct[sel]
    sel_counts = counts[sel]

    pen_overflow = jnp.int32(0)
    if cfg.enable_penetration_filter:
        tests = penetration.build_tests(
            sR, st, sel_valid,
            src.planes.coeffs, src.geom.corners, src.geom.centers,
            src.planes.mask,
            tgt.planes.coeffs, tgt.geom.corners, tgt.geom.centers,
            tgt.planes.mask,
            length_threshold, cfg.angle_threshold,
            max_tests=cfg.max_penetration_tests)
        pen = penetration.run_tests(
            tests, sR, st,
            src.geom.ds_points, src.geom.ds_counts,
            tgt.geom.ds_points, tgt.geom.ds_counts,
            src.planes.coeffs, tgt.planes.coeffs,
            search_radius=length_threshold,
            min_points=cfg.penetration_min_points,
            min_distance=length_threshold / 2.0,
            n_samples=cfg.penetration_samples,
            max_ratio=cfg.penetration_ratio)
        rejected = penetration.rejected_candidates(
            tests, pen, cfg.max_candidate_results)
        sel_valid = sel_valid & ~rejected
        pen_overflow = tests.overflow

    plane_frac = sel_counts.astype(jnp.float32) / jnp.maximum(
        src.planes.count.astype(jnp.float32), 1.0)
    ov, ov_approx = overlap_mod.overlap_scores(
        sR, st, sel_valid, src.ds.points, src.ds.count,
        tgt.ds.points, tgt.ds.count, dsd,
        plane_frac=plane_frac, face_weight=cfg.face_matches_weight,
        exact_k=cfg.overlap_exact_k, grid=cfg.overlap_grid,
        src_normals=src.ds.normals, tgt_normals=tgt.ds.normals,
        normal_cos=cfg.overlap_normal_cos, return_approx=True)
    score = cfg.face_matches_weight * plane_frac \
        + (1.0 - cfg.face_matches_weight) * ov
    score = jnp.where(sel_valid, score, -jnp.inf)
    best = jnp.argmax(score)

    if cfg.rescore_top_k > 0:
        # TIGHT-RADIUS RESCORE of the top-K coarse candidates (framework
        # addition; the reference ships the raw dsd-radius overlap argmax,
        # plade.cpp:545-575).  Rationale: at inlier radius dsd (4x point
        # spacing) an aliasing pose over repetitive structure keeps its
        # false hits — structural mismatches of 0.1-0.6 world units all
        # pass a 0.16 test once the coarse pose is only hypothesis-
        # accurate.  After point-to-plane ICP, the TRUE pose aligns shared
        # surfaces to noise level while an alias cannot align what does
        # not correspond, so an exact oriented overlap at ~2x spacing
        # separates them decisively (measured on the synthetic RESSO
        # scenes: alias 0.83 vs true 0.74 at radius dsd, flipped well
        # apart at dsd/2 post-ICP).  The coarse score still ranks; only
        # the final argmax among the top-K changes.
        K = cfg.rescore_top_k
        # POSE-DIVERSE top-K: the plain score top-K is typically K near-
        # duplicate clusters of one pose family (measured: all four top
        # slots were variants of the same alias, the true pose ranked
        # just below), so pick greedily while skipping any candidate
        # within (length_threshold, 2x angle_threshold) of an already-
        # picked pose — K distinct pose modes enter the rescore.  The
        # selection ranks by the phase-1 BOUND score (plane frac +
        # dilated-bitmap overlap): the exact overlap entries are 0 for
        # every candidate the bound loop never had to evaluate, which
        # would rank real modes below noise
        rank_score = jnp.where(
            sel_valid,
            cfg.face_matches_weight * plane_frac
            + (1.0 - cfg.face_matches_weight) * ov_approx, -jnp.inf)
        C2 = score.shape[0]
        tr_all = st                                          # (C,3)
        cosag = jnp.einsum("aij,bij->ab", sR, sR)            # trace(RaRb^T)
        near_pose = (jnp.linalg.norm(
            tr_all[:, None, :] - tr_all[None, :, :], axis=-1)
            < length_threshold) \
            & (cosag > 1.0 + 2.0 * math.cos(2.0 * cfg.angle_threshold))

        def pick(k, state):
            banned, sel = state
            avail = (rank_score > -jnp.inf) & ~banned
            i = jnp.argmax(jnp.where(avail, rank_score, -jnp.inf))
            ok = avail[i]
            sel = sel.at[k].set(jnp.where(ok, i, C2))
            banned = banned | (near_pose[i] & ok)
            banned = banned.at[i].set(True)
            return banned, sel

        _, sel_k = jax.lax.fori_loop(
            0, K, pick, (jnp.zeros((C2,), bool),
                         jnp.full((K,), C2, jnp.int32)))
        kvalid = sel_k < C2
        top_idx = jnp.minimum(sel_k, C2 - 1)
        # re-center each selected family representative with a SHORT
        # point-to-plane ICP before the tight test.  Load-bearing: the
        # diversity pick chooses each pose family's rep by the dilated
        # bound, which cannot tell a dead-center member from one 0.2
        # off — and the tight radius punishes off-center reps harshly
        # (measured: scoring raw reps overturned an already-correct
        # coarse argmax with a 90-degree alias).  Three iterations
        # suffice — point-to-plane Gauss-Newton on planar scenes
        # converges from <= lt/2 error in 2-3 steps
        from .refine.icp import refine_icp
        icp_sub = max(1, cfg.rescore_icp_subsample)
        Rr, tr, _, _ = jax.vmap(
            lambda R0, t0: refine_icp(
                R0, t0, src.ds.points[::icp_sub], src.ds.mask[::icp_sub],
                tgt.ds.points, tgt.ds.normals, dsd,
                cfg.rescore_icp_iters))(sR[top_idx], st[top_idx])
        r_fine = cfg.rescore_radius_factor * dsd / cfg.downsample_factor
        smask = src.ds.mask
        tmask = tgt.ds.mask
        cnt_f = overlap_mod.exact_overlap_counts(
            Rr, tr, src.ds.points, smask, tgt.ds.points, r_fine * r_fine,
            src_normals=src.ds.normals, tgt_normals=tgt.ds.normals,
            normal_cos=cfg.overlap_normal_cos)
        # CO-VISIBLE normalization: divide aligned counts by the number
        # of source points that land inside the target's OBSERVED volume
        # (dilated occupancy at length_threshold), not by cloud size.
        # Under partial overlap the true pose leaves the unshared scan
        # region outside the target's coverage by construction — a
        # cloud-size denominator taxes it for points the target scanner
        # never saw, which is exactly how a replica-covering alias was
        # measured outscoring the true pose (0.657 vs 0.537 tight) while
        # aligning fewer of the points both scanners DID see (0.69 vs
        # 0.76 co-visible).  The floor keeps a sliver pose (tiny
        # co-visible patch, perfectly aligned) from gaming the ratio.
        bm_cv, org_cv, cell_cv = overlap_mod.build_occupancy(
            tgt.ds.points, tmask, length_threshold, cfg.overlap_grid)
        covis = overlap_mod.approx_overlap_counts(
            bm_cv, org_cv, cell_cv, Rr, tr, src.ds.points, smask,
            cfg.overlap_grid)
        denom = jnp.maximum(jnp.minimum(src.ds.count, tgt.ds.count),
                            1).astype(jnp.float32)
        denom_k = jnp.maximum(covis.astype(jnp.float32),
                              cfg.rescore_covis_floor * denom)
        ov_f = cnt_f.astype(jnp.float32) / denom_k
        score_f = cfg.face_matches_weight * plane_frac[top_idx] \
            + (1.0 - cfg.face_matches_weight) * ov_f
        score_f = jnp.where(kvalid, score_f, -jnp.inf)
        bestk = jnp.argmax(score_f)
        best = top_idx[bestk]
        # the winner was RANKED as its re-centered pose Rr/tr scored by
        # score_f — return exactly those, not the raw representative and
        # the stale coarse entries (which can be 0 for candidates the
        # bound loop never exactly evaluated): the reported pose and its
        # quality metrics must be the quantities that won the argmax
        best_R = Rr[bestk]
        best_t = tr[bestk]
        rep_score = score_f[bestk]
        rep_overlap = ov_f[bestk]
    else:
        best_R = sR[best]
        best_t = st[best]
        rep_score = score[best]
        rep_overlap = ov[best]

    success = jnp.any(sel_valid) & (total_matches > 0)
    Rb = jnp.where(success, best_R, jnp.eye(3))
    tb = jnp.where(success, best_t, jnp.zeros(3))

    if cfg.enable_icp:
        # point-to-plane refinement of the winning coarse pose
        # (addition vs reference — it ships the raw hypothesis,
        # plade.cpp:545-575)
        from .refine.icp import refine_icp
        max_corr = cfg.icp_max_corr_factor * dsd / cfg.downsample_factor
        Ri, ti, _, _ = refine_icp(
            Rb, tb, src.ds.points, src.ds.mask,
            tgt.ds.points, tgt.ds.normals, max_corr, cfg.icp_iters)
        Rb = jnp.where(success, Ri, Rb)
        tb = jnp.where(success, ti, tb)

    return RegistrationResult(
        transform=se3_matrix(Rb, tb),
        score=jnp.where(success, rep_score, 0.0),
        overlap=jnp.where(success, rep_overlap, 0.0),
        matched_planes=jnp.where(success, sel_counts[best], 0),
        success=success,
        match_saturated=matches.saturated,
        pen_overflow=pen_overflow,
        cluster_truncated=cluster_truncated,
    )


@functools.partial(jax.jit, static_argnames=("cfg",))
def register_pair(tgt: PreparedCloud, src: PreparedCloud, dparams,
                  cfg: PladeConfig) -> RegistrationResult:
    return _register_pair_impl(tgt, src, dparams, cfg)


# --------------------------------------------------------------------------
# device-only full step: extraction -> preparation -> registration with no
# host round-trips — the unit that dist/ batches and shards over meshes
# --------------------------------------------------------------------------

def build_register_device_fn(cfg: PladeConfig, num_points: int,
                             with_stats: bool = False):
    """Un-jitted full-pipeline step for fixed cloud size ``num_points``.

    Covers the core ``registration`` overload (plade.cpp:638-662: extract
    with auto-tuning, fail when < min_planes) plus the 550-line pipeline
    (plade.cpp:31-580), entirely on device.  The host-level file entry's
    target/source swap stays on the host (plade.cpp:690-704).

    ``with_stats=True`` makes the step return ``(result, stats)`` where
    ``stats`` is the per-cloud ExtractStats pair (leading axis 2:
    target, source) — bench/diagnostic surface for the extraction
    round accounting.
    """
    extract = ransac.build_extract_fn(cfg, num_points, max_extract=64)

    def step(tgt_cloud: Cloud, src_cloud: Cloud, key):
        k1, k2 = jax.random.split(key)
        floor = jnp.int32(cfg.ransac_min_allowed_support)
        # both clouds extract in one vmapped while_loop: their greedy
        # rounds run in lockstep on device, halving the sequential depth
        # of the pipeline's dominant stage
        both, stats = jax.vmap(lambda p, n, c, k: extract(p, n, c, k, floor))(
            jnp.stack([tgt_cloud.points, src_cloud.points]),
            jnp.stack([tgt_cloud.normals, src_cloud.normals]),
            jnp.stack([tgt_cloud.count, src_cloud.count]),
            jnp.stack([k1, k2]))
        tgt_planes = ransac.select_planes_device(
            jax.tree.map(lambda x: x[0], both), cfg)
        src_planes = ransac.select_planes_device(
            jax.tree.map(lambda x: x[1], both), cfg)
        enough = (tgt_planes.count >= cfg.min_planes) & \
            (src_planes.count >= cfg.min_planes)

        sp = average_spacing(src_cloud.points, src_cloud.mask,
                             cfg.spacing_k, cfg.spacing_samples)
        dsd = cfg.downsample_factor * sp
        lt = cfg.length_factor * sp
        scale = lt / math.cos(math.pi / 2 - cfg.angle_threshold)

        # both preparations vmapped in lockstep (downsample sorts + OBBs
        # are the stage's cost; see extraction note above)
        stacked = jax.tree.map(lambda a, b: jnp.stack([a, b]),
                               tgt_cloud, src_cloud)
        planes2 = jax.tree.map(lambda a, b: jnp.stack([a, b]),
                               tgt_planes, src_planes)
        preps = jax.vmap(lambda c, p: _prepare_cloud_impl(c, p, dsd, cfg))(
            stacked, planes2)
        tgt_prep = jax.tree.map(lambda x: x[0], preps)
        src_prep = jax.tree.map(lambda x: x[1], preps)
        res = _register_pair_impl(tgt_prep, src_prep, (scale, lt, dsd), cfg)
        success = res.success & enough
        out = RegistrationResult(
            transform=jnp.where(success, res.transform, jnp.eye(4)),
            score=jnp.where(success, res.score, 0.0),
            overlap=jnp.where(success, res.overlap, 0.0),
            matched_planes=jnp.where(success, res.matched_planes, 0),
            success=success,
            match_saturated=res.match_saturated,
            pen_overflow=res.pen_overflow,
            cluster_truncated=res.cluster_truncated,
        )
        return (out, stats) if with_stats else out

    return step


@functools.lru_cache(maxsize=8)
def register_pair_device(cfg: PladeConfig, num_points: int):
    """Jitted single-pair full-device step (cached per config/shape)."""
    return jax.jit(build_register_device_fn(cfg, num_points))


# --------------------------------------------------------------------------
# host-level orchestration (numpy in, numpy out)
# --------------------------------------------------------------------------

def _pad_size(n: int, minimum: int = 4096, maximum: int | None = None) -> int:
    size = minimum
    while size < n:
        size *= 2
    if maximum is not None:
        size = min(size, maximum)
    return size


def _cap_cloud(points, normals, max_points: int, seed: int = 0):
    """Uniform random subsample when a cloud exceeds the static-shape budget
    (``cfg.max_points``).  The reference has no such cap — it is the padded
    buffer ceiling the device programs are compiled for.

    Returns (points, normals, capped) — ``capped`` is True when the
    subsample fired (callers surface it through their info dicts)."""
    n = points.shape[0]
    if n <= max_points:
        return points, normals, False
    rng = np.random.default_rng(seed)
    idx = np.sort(rng.choice(n, size=max_points, replace=False))
    return points[idx], normals[idx], True


def register_clouds(tgt_points, tgt_normals, src_points, src_normals,
                    cfg: PladeConfig = PladeConfig(), seed: int = 0,
                    ransac_min_support=None):
    """Register source onto target from raw numpy clouds.

    Mirrors the file-level reference entry (plade.cpp:665-707): swaps
    target/source when the source is >= 1.2x larger (the result is inverted
    back), auto-tunes plane extraction, then runs the device pipeline.

    ``ransac_min_support`` mirrors the explicit-min-support overload
    (plade.cpp:583-599): an int or a (target, source) pair pins the RANSAC
    support threshold instead of auto-tuning.

    Returns (transform 4x4 np.ndarray, info dict).
    """
    swapped = False
    if src_points.shape[0] >= tgt_points.shape[0] * cfg.swap_size_ratio:
        tgt_points, src_points = src_points, tgt_points
        tgt_normals, src_normals = src_normals, tgt_normals
        swapped = True

    tgt_points, tgt_normals, tgt_capped = _cap_cloud(
        tgt_points, tgt_normals, cfg.max_points, seed)
    src_points, src_normals, src_capped = _cap_cloud(
        src_points, src_normals, cfg.max_points, seed + 1)
    pad = _pad_size(max(tgt_points.shape[0], src_points.shape[0]),
                    maximum=cfg.max_points)
    tgt_cloud = pad_cloud(tgt_points, tgt_normals, pad)
    src_cloud = pad_cloud(src_points, src_normals, pad)

    key = jax.random.PRNGKey(seed)
    k1, k2 = jax.random.split(key)
    if ransac_min_support is None:
        tgt_planes = ransac.auto_extract(tgt_cloud.points, tgt_cloud.normals,
                                         tgt_cloud.count, k1, cfg, pad)
        src_planes = ransac.auto_extract(src_cloud.points, src_cloud.normals,
                                         src_cloud.count, k2, cfg, pad)
    else:
        if isinstance(ransac_min_support, int):
            ms_t = ms_s = ransac_min_support
        else:
            ms_t, ms_s = ransac_min_support
        if swapped:
            ms_t, ms_s = ms_s, ms_t
        # pinned support: no auto-tune halving, no threshold re-selection
        # (the reference overload uses the given support directly,
        # plade.cpp:583-599)
        extractor = ransac._cached_extractor(cfg, pad)
        tgt_planes = ransac.select_planes_pinned(
            extractor(tgt_cloud.points, tgt_cloud.normals, tgt_cloud.count,
                      k1, jnp.int32(ms_t), init_support=ms_t)[0], cfg)
        src_planes = ransac.select_planes_pinned(
            extractor(src_cloud.points, src_cloud.normals, src_cloud.count,
                      k2, jnp.int32(ms_s), init_support=ms_s)[0], cfg)

    info = {"swapped": swapped,
            "tgt_planes": int(tgt_planes.count),
            "src_planes": int(src_planes.count)}
    if tgt_capped or src_capped:
        info["cloud_capped"] = {"target": tgt_capped, "source": src_capped,
                                "max_points": cfg.max_points}
    if int(tgt_planes.count) < cfg.min_planes or \
       int(src_planes.count) < cfg.min_planes:
        # too few planes (plade.cpp:646-657)
        info["failure"] = "too few planes"
        return np.eye(4, dtype=np.float32), info

    # parameters derived from the source cloud's spacing (plade.cpp:41-56)
    sp = float(average_spacing(src_cloud.points, src_cloud.mask,
                               cfg.spacing_k, cfg.spacing_samples))
    dp = cfg.derived(sp)
    info["average_spacing"] = sp

    tgt_prep = prepare_cloud(tgt_cloud, tgt_planes,
                             jnp.float32(dp.down_sample_distance), cfg)
    src_prep = prepare_cloud(src_cloud, src_planes,
                             jnp.float32(dp.down_sample_distance), cfg)
    dparams = (jnp.float32(dp.scale), jnp.float32(dp.length_threshold),
               jnp.float32(dp.down_sample_distance))
    result = register_pair(tgt_prep, src_prep, dparams, cfg)

    T = np.asarray(result.transform)
    info["score"] = float(result.score)
    info["overlap"] = float(result.overlap)
    info["matched_planes"] = int(result.matched_planes)
    info["success"] = bool(result.success)
    info["match_saturated"] = int(result.match_saturated)
    info["pen_overflow"] = int(result.pen_overflow)
    info["cluster_truncated"] = int(result.cluster_truncated)
    if swapped:
        T = np.linalg.inv(T)
    return T, info


def register_with_planes(tgt_points, tgt_normals, src_points, src_normals,
                         tgt_planes: PlaneSet, src_planes: PlaneSet,
                         cfg: PladeConfig = PladeConfig()):
    """Registration given already-extracted planes — the reference's core
    overload (plade.cpp:31-580), exposed for callers with their own plane
    segmentation.  No target/source swap is applied (matching the
    reference overload, which receives clouds as-is).

    ``*_planes`` are PlaneSets padded to ``cfg.max_planes`` whose
    ``point_plane`` indexes the respective cloud rows.

    Returns (transform 4x4 np.ndarray, info dict).
    """
    n_max = max(tgt_points.shape[0], src_points.shape[0])
    if n_max > cfg.max_points:
        raise ValueError(
            f"cloud size {n_max} exceeds cfg.max_points={cfg.max_points}; "
            "register_with_planes cannot subsample (plane point indices "
            "would dangle) — raise max_points or downsample the input")
    pad = _pad_size(n_max, maximum=cfg.max_points)
    tgt_cloud = pad_cloud(tgt_points, tgt_normals, pad)
    src_cloud = pad_cloud(src_points, src_normals, pad)

    def _pad_pp(planes: PlaneSet) -> PlaneSet:
        pp = np.asarray(planes.point_plane)
        if pp.shape[0] < pad:
            pp = np.concatenate(
                [pp, np.full(pad - pp.shape[0], -1, np.int32)])
        return planes._replace(point_plane=jnp.asarray(pp[:pad], jnp.int32))

    tgt_planes = _pad_pp(tgt_planes)
    src_planes = _pad_pp(src_planes)
    info = {"tgt_planes": int(tgt_planes.count),
            "src_planes": int(src_planes.count)}
    if int(tgt_planes.count) < cfg.min_planes or \
       int(src_planes.count) < cfg.min_planes:
        info["failure"] = "too few planes"
        return np.eye(4, dtype=np.float32), info

    sp = float(average_spacing(src_cloud.points, src_cloud.mask,
                               cfg.spacing_k, cfg.spacing_samples))
    dp = cfg.derived(sp)
    info["average_spacing"] = sp
    tgt_prep = prepare_cloud(tgt_cloud, tgt_planes,
                             jnp.float32(dp.down_sample_distance), cfg)
    src_prep = prepare_cloud(src_cloud, src_planes,
                             jnp.float32(dp.down_sample_distance), cfg)
    dparams = (jnp.float32(dp.scale), jnp.float32(dp.length_threshold),
               jnp.float32(dp.down_sample_distance))
    result = register_pair(tgt_prep, src_prep, dparams, cfg)
    info["score"] = float(result.score)
    info["overlap"] = float(result.overlap)
    info["matched_planes"] = int(result.matched_planes)
    info["success"] = bool(result.success)
    info["match_saturated"] = int(result.match_saturated)
    info["pen_overflow"] = int(result.pen_overflow)
    info["cluster_truncated"] = int(result.cluster_truncated)
    return np.asarray(result.transform), info


def register_files(target_file: str, source_file: str,
                   cfg: PladeConfig = PladeConfig(), seed: int = 0):
    """File-level entry (reference plade.cpp:665-707; PLY only)."""
    from .io.ply import read_ply
    tp, tn = read_ply(target_file)
    sp_, sn = read_ply(source_file)
    if tn is None or sn is None:
        raise ValueError("registration requires point normals in both clouds")
    return register_clouds(tp, tn, sp_, sn, cfg, seed)

"""Instrumented reproduction of tests/test_pipeline.py::test_register_small_overlap.

Dumps per-stage state: extracted planes vs ground truth, intersection
lines, descriptor matches, hypothesis quality, cluster survival, and
consistency counts — to localize where the true pose is lost.
"""
import os
import sys

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_default_device", jax.devices("cpu")[0])

import math

import jax.numpy as jnp
import numpy as np

from plade_tpu.core.config import PladeConfig
from plade_tpu.core.types import pad_cloud
from plade_tpu.extract import ransac
from plade_tpu.io.synthetic import make_room, random_rigid, transform_cloud
from plade_tpu.knn.bruteforce import average_spacing
from plade_tpu.match import matching
from plade_tpu.pipeline import _pad_size, prepare_cloud
from plade_tpu.descriptors.pairlines import pair_descriptors

SMALL_CFG = PladeConfig(
    ransac_candidates_per_round=64,
    ransac_init_min_support=2000,
    ransac_min_allowed_support=200,
    min_planes=6,
    max_planes=12,
    bitmap_grid=64,
    spacing_samples=2000,
    max_ds_points=4096,
    max_plane_points=1024,
    max_lines=128,
    max_query_pairs=2048,
    max_target_pairs=4096,
    max_matches=8192,
    max_pose_clusters=512,
    max_candidate_results=64,
    max_penetration_tests=1024,
)


def main():
    rng = np.random.default_rng(0)
    cfg = SMALL_CFG
    pts, nrm, gt_planes = make_room(rng, n_per_plane=2000, noise=0.002,
                                    extra_planes=6,
                                    faces=("floor", "wall_y-", "wall_x+"))
    lo, hi = np.quantile(pts[:, 0], [0.35, 0.65])
    tgt_sel = pts[:, 0] <= hi
    src_sel = pts[:, 0] >= lo
    tpts, tnrm = pts[tgt_sel], nrm[tgt_sel]
    spts0, snrm0 = pts[src_sel], nrm[src_sel]
    R_gt, t_gt = random_rigid(rng, max_angle=1.0, max_trans=0.5)
    spts, snrm = transform_cloud(spts0, snrm0, R_gt.T, -R_gt.T @ t_gt)

    print(f"tgt {tpts.shape[0]} pts, src {spts.shape[0]} pts")
    # simulate register_clouds setup (sizes similar -> no swap)
    assert not spts.shape[0] >= tpts.shape[0] * cfg.swap_size_ratio
    pad = _pad_size(max(tpts.shape[0], spts.shape[0]), maximum=cfg.max_points)
    tgt_cloud = pad_cloud(tpts, tnrm, pad)
    src_cloud = pad_cloud(spts, snrm, pad)
    key = jax.random.PRNGKey(0)
    k1, k2 = jax.random.split(key)
    tgt_planes = ransac.auto_extract(tgt_cloud.points, tgt_cloud.normals,
                                     tgt_cloud.count, k1, cfg, pad)
    src_planes = ransac.auto_extract(src_cloud.points, src_cloud.normals,
                                     src_cloud.count, k2, cfg, pad)
    print(f"tgt planes: {int(tgt_planes.count)}, "
          f"src planes: {int(src_planes.count)}")

    def dump_planes(tag, planes, true_R=None, true_t=None):
        n = int(planes.count)
        co = np.asarray(planes.coeffs)[:n]
        sz = np.asarray(planes.sizes)[:n]
        for i in range(n):
            nvec, d = co[i, :3], co[i, 3]
            # compare against GT planes (in target frame)
            if true_R is not None:
                # transform plane to target frame: n' = R n, d' = d - n'.t
                nvec2 = true_R @ nvec
                d2 = d - float(nvec2 @ true_t)
            else:
                nvec2, d2 = nvec, d
            best = min(
                (min(np.linalg.norm(nvec2 - np.asarray(gn)) +
                     abs(d2 - gd),
                     np.linalg.norm(nvec2 + np.asarray(gn)) +
                     abs(-d2 - gd))
                 for gn, gd in gt_planes))
            print(f"  {tag}[{i}] sz={sz[i]:5d} n=({nvec[0]:+.3f},"
                  f"{nvec[1]:+.3f},{nvec[2]:+.3f}) d={d:+.3f} "
                  f"gt_resid={best:.4f}")

    dump_planes("tgt", tgt_planes)
    dump_planes("src", src_planes, R_gt, t_gt)

    sp = float(average_spacing(src_cloud.points, src_cloud.mask,
                               cfg.spacing_k, cfg.spacing_samples))
    dp = cfg.derived(sp)
    print(f"avg spacing {sp:.4f} dsd {dp.down_sample_distance:.4f} "
          f"lt {dp.length_threshold:.4f} scale {dp.scale:.4f}")
    dsd = jnp.float32(dp.down_sample_distance)
    tgt_prep = prepare_cloud(tgt_cloud, tgt_planes, dsd, cfg)
    src_prep = prepare_cloud(src_cloud, src_planes, dsd, cfg)
    print(f"tgt lines: {int(tgt_prep.lines.count)}, "
          f"src lines: {int(src_prep.lines.count)}")

    # line-filter breakdown per plane pair
    from plade_tpu.geometry.lines import intersect_planes
    for tag, prep, planes in (("tgt", tgt_prep, tgt_planes),
                              ("src", src_prep, src_planes)):
        n = int(planes.count)
        co = planes.coeffs
        rej_par = rej_rad = ok_n = 0
        for i in range(n):
            for j in range(i + 1, n):
                dire, pt, val = intersect_planes(co[i], co[j],
                                                 cfg.plane_pair_max_cos)
                if not bool(val):
                    rej_par += 1
                    continue
                w = np.asarray(pt) - np.asarray(prep.bounding_center)
                along = float(np.dot(w, np.asarray(dire)))
                dist = math.sqrt(max(float(np.dot(w, w)) - along * along, 0))
                if dist > float(prep.bounding_radius):
                    rej_rad += 1
                    print(f"    {tag} pair ({i},{j}) REJ radius: "
                          f"dist={dist:.3f} > r={float(prep.bounding_radius):.3f}")
                else:
                    ok_n += 1
        print(f"  {tag}: {ok_n} lines kept, {rej_par} parallel-rejected, "
              f"{rej_rad} radius-rejected")

    cos10 = math.cos(cfg.line_pair_min_angle)
    scale = jnp.float32(dp.scale)
    tgt_desc = pair_descriptors(tgt_prep.lines, tgt_prep.planes.coeffs[:, :3],
                                scale, cfg.max_target_pairs, ordered=True,
                                min_angle_cos=cos10, pad_value=-1e6)
    src_desc = pair_descriptors(src_prep.lines, src_prep.planes.coeffs[:, :3],
                                scale, cfg.max_query_pairs, ordered=False,
                                min_angle_cos=cos10, pad_value=1e6)
    print(f"tgt descriptors: {int(tgt_desc.count)}, "
          f"src descriptors: {int(src_desc.count)}")

    # src->tgt plane correspondence via GT transform
    nsrc = int(src_planes.count)
    ntgt = int(tgt_planes.count)
    sco = np.asarray(src_planes.coeffs)[:nsrc]
    tco = np.asarray(tgt_planes.coeffs)[:ntgt]
    print("src->tgt plane correspondence (GT):")
    corr = {}
    for i in range(nsrc):
        nv = R_gt @ sco[i, :3]
        dv = sco[i, 3] - float(nv @ t_gt)
        best_j, best_r = -1, 1e9
        for j in range(ntgt):
            r = min(np.linalg.norm(nv - tco[j, :3]) + abs(dv - tco[j, 3]),
                    np.linalg.norm(nv + tco[j, :3]) + abs(dv + tco[j, 3]))
            if r < best_r:
                best_j, best_r = j, r
        corr[i] = best_j if best_r < 0.1 else -1
        print(f"  src{i} -> tgt{best_j} resid={best_r:.4f}"
              f"{' (NO MATCH)' if best_r >= 0.1 else ''}")

    # descriptor diagnostics: per src query, min distance to any tgt desc
    qd = np.asarray(src_desc.desc)
    td = np.asarray(tgt_desc.desc)
    nq = int(src_desc.count)
    nt = int(tgt_desc.count)
    d2 = np.linalg.norm(qd[:nq, None, :] - td[None, :nt, :], axis=-1)
    print("per-query min descriptor distance:")
    qli = np.asarray(src_desc.line_idx)[:nq]
    tli = np.asarray(tgt_desc.line_idx)[:nt]
    ssup = np.asarray(src_prep.lines.support)
    tsup = np.asarray(tgt_prep.lines.support)
    for i in range(nq):
        j = int(np.argmin(d2[i]))
        sl = qli[i]
        tl = tli[j]
        print(f"  q{i} lines{tuple(sl)} planes"
              f"[{tuple(ssup[sl[0]])},{tuple(ssup[sl[1]])}] "
          f"min_d={d2[i, j]:.4f} vs t{j} planes"
              f"[{tuple(tsup[tl[0]])},{tuple(tsup[tl[1]])}]"
              f"\n     qdesc={np.round(qd[i], 3)}"
              f"\n     tdesc={np.round(td[j], 3)}")

    matches = matching.match_descriptors(src_desc, tgt_desc,
                                         cfg.descriptor_match_radius,
                                         cfg.max_matches)
    print(f"matches: {int(matches.count)} (saturated {int(matches.saturated)})")
    R, t = matching.hypothesis_poses(src_desc, tgt_desc, matches)
    Rn = np.asarray(R)
    tn = np.asarray(t)
    mval = np.asarray(matches.valid)
    # hypothesis error vs GT
    cosang = (np.trace(np.einsum('ij,mjk->mik', R_gt.T, Rn),
                       axis1=1, axis2=2) - 1) / 2
    rot_err = np.degrees(np.arccos(np.clip(cosang, -1, 1)))
    t_err = np.linalg.norm(tn - t_gt, axis=1)
    good = mval & (rot_err < 3.0) & (t_err < 0.15)
    print(f"good hypotheses (rot<3deg, t<0.15): {int(good.sum())} "
          f"of {int(mval.sum())}")
    if good.sum() > 0:
        gi = np.where(good)[0]
        print(f"  first good hyp idx {gi[:10]}")

    euler_tol = math.sqrt(cfg.angle_threshold / 2.0)
    clusters = matching.cluster_poses(R, t, matches.valid,
                                      dp.length_threshold / 2.0, euler_tol,
                                      cfg.max_pose_clusters)
    crep = np.asarray(clusters.rep)
    csize = np.asarray(clusters.size)
    cvalid = np.asarray(clusters.valid)
    # which clusters have a good representative?
    rep_good = good[crep] & cvalid
    print(f"clusters: {int(cvalid.sum())}, good-rep clusters: "
          f"{int(rep_good.sum())}, sizes of good-rep: "
          f"{csize[rep_good][:10]}")

    cR = R[clusters.rep]
    ct = t[clusters.rep]
    counts, _ = matching.plane_consistency(
        cR, ct, clusters.valid,
        src_prep.planes.coeffs, src_prep.geom.centers, src_prep.geom.radii,
        src_prep.planes.mask,
        tgt_prep.planes.coeffs, tgt_prep.geom.centers, tgt_prep.geom.radii,
        tgt_prep.planes.mask,
        src_prep.bounding_center, tgt_prep.bounding_center,
        tgt_prep.bounding_radius, jnp.float32(dp.length_threshold),
        math.cos(cfg.angle_threshold))
    cn = np.asarray(counts)
    print(f"consistency counts: max={cn.max()}, "
          f"count>=2: {(cn >= 2).sum()}")
    if rep_good.sum() > 0:
        print(f"  counts of good-rep clusters: {cn[rep_good][:20]}")
    top = np.argsort(-cn)[:10]
    for i in top:
        print(f"  cluster[{i}] count={cn[i]} size={csize[i]} "
              f"rot_err={rot_err[crep[i]]:.2f} t_err={t_err[crep[i]]:.3f}")

    # ---- candidate tail: selection, penetration, overlap, final score ----
    from plade_tpu.verify import penetration, overlap as overlap_mod
    C = counts.shape[0]
    sel, sel_valid = matching.select_candidates(
        counts, jnp.arange(C, dtype=jnp.int32), cfg.max_candidate_results)
    sR = cR[sel]
    st = ct[sel]
    sel_counts = np.asarray(counts)[np.asarray(sel)]
    lt = jnp.float32(dp.length_threshold)
    tests = penetration.build_tests(
        sR, st, sel_valid,
        src_prep.planes.coeffs, src_prep.geom.corners, src_prep.geom.centers,
        src_prep.planes.mask,
        tgt_prep.planes.coeffs, tgt_prep.geom.corners, tgt_prep.geom.centers,
        tgt_prep.planes.mask,
        lt, cfg.angle_threshold, max_tests=cfg.max_penetration_tests)
    pen = penetration.run_tests(
        tests, sR, st,
        src_prep.geom.ds_points, src_prep.geom.ds_counts,
        tgt_prep.geom.ds_points, tgt_prep.geom.ds_counts,
        src_prep.planes.coeffs, tgt_prep.planes.coeffs,
        search_radius=lt, min_points=cfg.penetration_min_points,
        min_distance=lt / 2.0, n_samples=cfg.penetration_samples,
        max_ratio=cfg.penetration_ratio)
    rejected = penetration.rejected_candidates(
        tests, pen, cfg.max_candidate_results)
    print(f"penetration tests: {int(jnp.sum(tests.valid.astype(jnp.int32)))}"
          f", rejected candidates: {int(jnp.sum(rejected & sel_valid))}")
    sel_valid2 = sel_valid & ~rejected
    plane_frac = jnp.asarray(sel_counts, jnp.float32) / float(
        int(src_planes.count))
    ov = overlap_mod.overlap_scores(
        sR, st, sel_valid2, src_prep.ds.points, src_prep.ds.count,
        tgt_prep.ds.points, tgt_prep.ds.count, dsd,
        plane_frac=plane_frac, face_weight=cfg.face_matches_weight,
        exact_k=cfg.overlap_exact_k, grid=cfg.overlap_grid)
    score = cfg.face_matches_weight * plane_frac \
        + (1.0 - cfg.face_matches_weight) * ov
    score = np.asarray(jnp.where(sel_valid2, score, -jnp.inf))
    seln = np.asarray(sel)
    # rot/t err of each selected candidate
    sRn = np.asarray(sR)
    stn = np.asarray(st)
    cosang = (np.trace(np.einsum('ij,mjk->mik', R_gt.T, sRn),
                       axis1=1, axis2=2) - 1) / 2
    sel_rot = np.degrees(np.arccos(np.clip(cosang, -1, 1)))
    sel_terr = np.linalg.norm(stn - t_gt, axis=1)
    ovn = np.asarray(ov)
    rejn = np.asarray(rejected)
    svn = np.asarray(sel_valid)
    print("selected candidates (count desc):")
    for i in range(min(16, len(seln))):
        if not svn[i]:
            continue
        print(f"  cand{i} cluster={seln[i]} count={sel_counts[i]} "
              f"pen_rej={bool(rejn[i])} ovl={ovn[i]:.3f} "
              f"score={score[i]:.3f} rot={sel_rot[i]:.1f} "
              f"terr={sel_terr[i]:.3f}")
    best = int(np.argmax(score))
    print(f"WINNER cand{best}: rot={sel_rot[best]:.2f} "
          f"terr={sel_terr[best]:.3f} score={score[best]:.3f}")


if __name__ == "__main__":
    main()

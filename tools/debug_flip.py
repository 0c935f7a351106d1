"""Diagnose the room-aliasing (180-degree flip) eval failures.

Rebuilds a failing EVAL scene pair, runs the pipeline stage by stage with
the SAME keys as dist/mesh.register_array_pairs, and reports where the
true pose is lost: hypothesis pool, clustering, plane consistency,
penetration, or final overlap scoring.  Also force-scores the exact GT
pose through the same verification stack to compare its score against the
aliased winner's.

Usage: PYTHONPATH=. python tools/debug_flip.py \
          [scene_seed pair_idx]
"""
import math
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from plade_tpu.utils.cache import enable_compile_cache

enable_compile_cache()

import jax
import jax.numpy as jnp

from plade_tpu.core.config import PladeConfig
from plade_tpu.core.types import pad_cloud
from plade_tpu.descriptors.pairlines import pair_descriptors
from plade_tpu.extract import ransac
from plade_tpu.io.synthetic import make_scan_sequence
from plade_tpu.knn.bruteforce import average_spacing
from plade_tpu.match import matching
from plade_tpu.pipeline import _pad_size, _prepare_cloud_impl
from plade_tpu.verify import overlap as overlap_mod
from plade_tpu.verify import penetration

SIZE = 4.0
N_POINTS = 60000


def rot_err_deg(Ra, Rb):
    c = (np.trace(np.asarray(Ra).T @ np.asarray(Rb)) - 1.0) / 2.0
    return float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))


def main():
    scene_seed = int(sys.argv[1]) if len(sys.argv) > 1 else 1
    pair_idx = int(sys.argv[2]) if len(sys.argv) > 2 else 1
    cfg = PladeConfig()
    rng = np.random.default_rng(scene_seed)
    scans, poses = make_scan_sequence(
        rng, n_scans=6, n_points=N_POINTS, overlap_radius=3.4, step=2.0,
        n_rooms=3, n_per_plane=9000, noise=0.005 * SIZE, size=SIZE,
        extra_planes=3, normal_noise_deg=3.0, max_angle=1.0, max_trans=0.6)
    i, j = pair_idx, pair_idx + 1
    tp, tn = scans[i]
    sp_, sn = scans[j]
    G = np.linalg.inv(poses[i]) @ poses[j]
    R_gt = G[:3, :3].astype(np.float32)
    t_gt = G[:3, 3].astype(np.float32)
    print(f"pair ({i},{j}): tgt {tp.shape[0]} pts, src {sp_.shape[0]} pts")

    pad = _pad_size(max(tp.shape[0], sp_.shape[0]), maximum=cfg.max_points)
    tgt_cloud = pad_cloud(tp, tn, pad)
    src_cloud = pad_cloud(sp_, sn, pad)
    # same key as register_array_pairs (seed 0) gives pair ``pair_idx``
    key = jax.random.fold_in(jax.random.PRNGKey(0), pair_idx)
    k1, k2 = jax.random.split(key)

    extractor = ransac._cached_extractor(cfg, pad)
    floor = cfg.ransac_min_allowed_support
    tgt_planes = ransac.select_planes(
        extractor(tgt_cloud.points, tgt_cloud.normals, tgt_cloud.count, k1,
                  floor)[0], cfg)
    src_planes = ransac.select_planes(
        extractor(src_cloud.points, src_cloud.normals, src_cloud.count, k2,
                  floor)[0], cfg)
    print(f"tgt planes {int(tgt_planes.count)}, src planes "
          f"{int(src_planes.count)}")

    spacing = float(average_spacing(src_cloud.points, src_cloud.mask,
                                    cfg.spacing_k, cfg.spacing_samples))
    dp = cfg.derived(spacing)
    print(f"spacing {spacing:.4f} lt {dp.length_threshold:.4f}")

    @jax.jit
    def stages(tgt_cloud, src_cloud, tgt_planes, src_planes):
        dsd = jnp.float32(dp.down_sample_distance)
        tgt = _prepare_cloud_impl(tgt_cloud, tgt_planes, dsd, cfg)
        src = _prepare_cloud_impl(src_cloud, src_planes, dsd, cfg)
        scale = jnp.float32(dp.scale)
        length_threshold = jnp.float32(dp.length_threshold)
        cos10 = math.cos(cfg.line_pair_min_angle)
        tgt_desc = pair_descriptors(tgt.lines, tgt.planes.coeffs[:, :3],
                                    scale, cfg.max_target_pairs, ordered=True,
                                    min_angle_cos=cos10, pad_value=-1e6)
        src_desc = pair_descriptors(src.lines, src.planes.coeffs[:, :3],
                                    scale, cfg.max_query_pairs, ordered=False,
                                    min_angle_cos=cos10, pad_value=1e6)
        matches = matching.match_descriptors(
            src_desc, tgt_desc, cfg.descriptor_match_radius, cfg.max_matches)
        R, t = matching.hypothesis_poses(src_desc, tgt_desc, matches)
        euler_tol = math.sqrt(cfg.angle_threshold / 2.0)
        clusters = matching.cluster_poses(
            R, t, matches.valid, length_threshold / 2.0, euler_tol,
            cfg.max_pose_clusters)
        cR = R[clusters.rep]
        ct = t[clusters.rep]
        # append the GT pose as an extra "candidate" for scoring
        cR_g = jnp.concatenate([cR, jnp.asarray(R_gt)[None]], axis=0)
        ct_g = jnp.concatenate([ct, jnp.asarray(t_gt)[None]], axis=0)
        cvalid_g = jnp.concatenate([clusters.valid, jnp.ones((1,), bool)])
        counts, _ = matching.plane_consistency(
            cR_g, ct_g, cvalid_g,
            src.planes.coeffs, src.geom.centers, src.geom.radii,
            src.planes.mask,
            tgt.planes.coeffs, tgt.geom.centers, tgt.geom.radii,
            tgt.planes.mask,
            src.bounding_center, tgt.bounding_center,
            tgt.bounding_radius, length_threshold,
            math.cos(cfg.angle_threshold))
        C = counts.shape[0]
        sel, sel_valid = matching.select_candidates(
            counts, jnp.arange(C, dtype=jnp.int32), cfg.max_candidate_results)
        sR = cR_g[sel]
        st = ct_g[sel]
        sel_counts = counts[sel]
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
        plane_frac = sel_counts.astype(jnp.float32) / jnp.maximum(
            src.planes.count.astype(jnp.float32), 1.0)
        ov = overlap_mod.overlap_scores(
            sR, st, sel_valid & ~rejected, src.ds.points, src.ds.count,
            tgt.ds.points, tgt.ds.count, dsd,
            plane_frac=plane_frac, face_weight=cfg.face_matches_weight,
            exact_k=cfg.overlap_exact_k, grid=cfg.overlap_grid,
            src_normals=src.ds.normals, tgt_normals=tgt.ds.normals,
            normal_cos=cfg.overlap_normal_cos)
        # unfiltered overlap too (so a penetration-rejected GT still scores)
        ov_all = overlap_mod.overlap_scores(
            sR, st, sel_valid, src.ds.points, src.ds.count,
            tgt.ds.points, tgt.ds.count, dsd,
            plane_frac=plane_frac, face_weight=cfg.face_matches_weight,
            exact_k=cfg.overlap_exact_k, grid=cfg.overlap_grid,
            src_normals=src.ds.normals, tgt_normals=tgt.ds.normals,
            normal_cos=cfg.overlap_normal_cos)
        return dict(R=R, t=t, mvalid=matches.valid, mcount=matches.count,
                    crep=clusters.rep, csize=clusters.size,
                    cvalid=clusters.valid, counts=counts, sel=sel,
                    sel_valid=sel_valid, sel_counts=sel_counts,
                    rejected=rejected, plane_frac=plane_frac, ov=ov,
                    ov_all=ov_all, sR=sR, st=st,
                    src_count=src.planes.count)

    out = {k: np.asarray(v) for k, v in stages(
        tgt_cloud, src_cloud, tgt_planes, src_planes).items()}

    # --- hypothesis stage ---
    R, t, mvalid = out["R"], out["t"], out["mvalid"]
    errs = np.array([rot_err_deg(R_gt, R[k]) if mvalid[k] else 1e9
                     for k in range(R.shape[0])])
    terr = np.linalg.norm(t - t_gt[None], axis=1)
    good = (errs < 5.0) & (terr < 0.5) & mvalid
    print(f"hypotheses: {int(mvalid.sum())} valid "
          f"(count={int(out['mcount'])}), {int(good.sum())} within GT tol, "
          f"best rot {errs.min():.2f} deg")

    # --- cluster stage ---
    crep, cvalid = out["crep"], out["cvalid"]
    cerr = np.array([rot_err_deg(R_gt, R[crep[k]]) if cvalid[k] else 1e9
                     for k in range(crep.shape[0])])
    cterr = np.linalg.norm(t[crep] - t_gt[None], axis=1)
    cgood = (cerr < 5.0) & (cterr < 0.5) & cvalid
    print(f"clusters: {int(cvalid.sum())} valid, {int(cgood.sum())} near GT; "
          f"sizes of near-GT: {sorted(out['csize'][cgood])[-5:] if cgood.any() else []}")

    # --- consistency + selection (last row of counts is the forced GT) ---
    counts = out["counts"]
    print(f"forced-GT candidate plane count: {counts[-1]} "
          f"(needs >= 2); src planes {out['src_count']}")
    sel, sel_valid = out["sel"], out["sel_valid"]
    C = counts.shape[0]
    gt_in_sel = np.where(sel == C - 1)[0]
    sRl, stl = out["sR"], out["st"]
    serr = np.array([rot_err_deg(R_gt, sRl[k]) for k in range(sRl.shape[0])])
    sterr = np.linalg.norm(stl - t_gt[None], axis=1)
    sgood = (serr < 5.0) & (sterr < 0.5) & sel_valid
    print(f"selected: {int(sel_valid.sum())} valid, {int(sgood.sum())} near "
          f"GT (incl forced)")

    rej = out["rejected"]
    score = np.where(sel_valid & ~rej,
                     cfg.face_matches_weight * out["plane_frac"]
                     + (1 - cfg.face_matches_weight) * out["ov"], -np.inf)
    score_all = np.where(sel_valid,
                         cfg.face_matches_weight * out["plane_frac"]
                         + (1 - cfg.face_matches_weight) * out["ov_all"],
                         -np.inf)
    win = int(np.argmax(score))
    print(f"winner: rot_err {serr[win]:.2f} deg, trans_err {sterr[win]:.3f}, "
          f"score {score[win]:.4f} (planes {out['sel_counts'][win]}, "
          f"frac {out['plane_frac'][win]:.3f}, ov {out['ov'][win]:.4f}, "
          f"pen_rejected {bool(rej[win])})")
    if len(gt_in_sel):
        g = gt_in_sel[0]
        print(f"forced GT: sel rank {g}, valid {bool(sel_valid[g])}, "
              f"pen_rejected {bool(rej[g])}, score {score_all[g]:.4f} "
              f"(planes {out['sel_counts'][g]}, frac "
              f"{out['plane_frac'][g]:.3f}, ov {out['ov_all'][g]:.4f})")
    else:
        print("forced GT NOT in top-200 selection (count < 2 or crowded out)")
    # best near-GT candidate that survived everything
    alive = sgood & ~rej
    if alive.any():
        b = int(np.argmax(np.where(alive, score, -np.inf)))
        print(f"best surviving near-GT: rank {b}, score {score[b]:.4f} "
              f"(planes {out['sel_counts'][b]}, ov {out['ov'][b]:.4f}) "
              f"vs winner {score[win]:.4f}")
    else:
        print("NO near-GT candidate survives to scoring")


if __name__ == "__main__":
    sys.exit(main())

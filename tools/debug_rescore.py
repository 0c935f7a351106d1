"""Dump the tight-rescore internals on a failing aliased pair.

For the top-K coarse candidates: rot/trans error vs GT before and after
ICP, tight oriented overlap, and final rescore — to verify the vmapped
ICP works and see whether the alias genuinely outscores the true pose at
tight radius.

Usage: PYTHONPATH=. python tools/debug_rescore.py
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
from plade_tpu.pipeline import _pad_size, prepare_cloud
from plade_tpu.refine.icp import refine_icp
from plade_tpu.verify import overlap as overlap_mod
from plade_tpu.verify import penetration

SIZE = 4.0


def rot_err_deg(Ra, Rb):
    c = (np.trace(np.asarray(Ra).T @ np.asarray(Rb)) - 1.0) / 2.0
    return float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))


def main():
    scene_seed = int(sys.argv[1]) if len(sys.argv) > 1 else 1
    pair_idx = int(sys.argv[2]) if len(sys.argv) > 2 else 1
    cfg = PladeConfig()
    rng = np.random.default_rng(scene_seed)
    scans, poses = make_scan_sequence(
        rng, n_scans=6, n_points=60000, overlap_radius=3.4, step=2.0,
        n_rooms=3, n_per_plane=9000, noise=0.005 * SIZE, size=SIZE,
        extra_planes=3, normal_noise_deg=3.0, max_angle=1.0, max_trans=0.6)
    i, j = pair_idx, pair_idx + 1
    tp, tn = scans[i]
    sp_, sn = scans[j]
    G = np.linalg.inv(poses[i]) @ poses[j]
    R_gt = G[:3, :3].astype(np.float32)
    t_gt = G[:3, 3].astype(np.float32)

    pad = _pad_size(max(tp.shape[0], sp_.shape[0]), maximum=cfg.max_points)
    tgt_cloud = pad_cloud(tp, tn, pad)
    src_cloud = pad_cloud(sp_, sn, pad)
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
    spacing = float(average_spacing(src_cloud.points, src_cloud.mask,
                                    cfg.spacing_k, cfg.spacing_samples))
    dp = cfg.derived(spacing)
    dsd = jnp.float32(dp.down_sample_distance)
    tgt = prepare_cloud(tgt_cloud, tgt_planes, dsd, cfg)
    src = prepare_cloud(src_cloud, src_planes, dsd, cfg)
    lt = jnp.float32(dp.length_threshold)

    @jax.jit
    def coarse(tgt, src):
        scale = jnp.float32(dp.scale)
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
            R, t, matches.valid, lt / 2.0, euler_tol, cfg.max_pose_clusters)
        cR = R[clusters.rep]
        ct = t[clusters.rep]
        counts, _ = matching.plane_consistency(
            cR, ct, clusters.valid,
            src.planes.coeffs, src.geom.centers, src.geom.radii,
            src.planes.mask,
            tgt.planes.coeffs, tgt.geom.centers, tgt.geom.radii,
            tgt.planes.mask,
            src.bounding_center, tgt.bounding_center,
            tgt.bounding_radius, lt, math.cos(cfg.angle_threshold))
        C = counts.shape[0]
        sel, sel_valid = matching.select_candidates(
            counts, jnp.arange(C, dtype=jnp.int32), cfg.max_candidate_results)
        sR = cR[sel]
        st = ct[sel]
        plane_frac = counts[sel].astype(jnp.float32) / jnp.maximum(
            src.planes.count.astype(jnp.float32), 1.0)
        ov = overlap_mod.overlap_scores(
            sR, st, sel_valid, src.ds.points, src.ds.count,
            tgt.ds.points, tgt.ds.count, dsd,
            plane_frac=plane_frac, face_weight=cfg.face_matches_weight,
            exact_k=cfg.overlap_exact_k, grid=cfg.overlap_grid,
            src_normals=src.ds.normals, tgt_normals=tgt.ds.normals,
            normal_cos=cfg.overlap_normal_cos)
        score = cfg.face_matches_weight * plane_frac \
            + (1.0 - cfg.face_matches_weight) * ov
        score = jnp.where(sel_valid, score, -jnp.inf)
        return sR, st, plane_frac, ov, score

    sR, st, plane_frac, ov, score = coarse(tgt, src)
    K = int(sys.argv[3]) if len(sys.argv) > 3 else 16
    # pose-diverse selection (mirrors pipeline.py rescore)
    sc_np = np.asarray(score)
    sR_np = np.asarray(sR)
    st_np = np.asarray(st)
    lt_f = float(dp.length_threshold)
    banned = np.zeros(sc_np.shape[0], bool)
    top_idx = []
    for _ in range(K):
        avail = np.where((sc_np > -np.inf) & ~banned, sc_np, -np.inf)
        i = int(np.argmax(avail))
        if not np.isfinite(avail[i]):
            break
        top_idx.append(i)
        dtr = np.linalg.norm(st_np - st_np[i], axis=-1)
        tra = np.einsum("aij,ij->a", sR_np, sR_np[i])
        near = (dtr < lt_f) & (tra > 1 + 2 * np.cos(2 * cfg.angle_threshold))
        banned |= near
        banned[i] = True
    top_idx = np.asarray(top_idx)
    # where does the best GT-adjacent candidate rank among DISTINCT modes?
    G_errs = np.array([rot_err_deg(R_gt, sR_np[c]) for c in
                       range(sR_np.shape[0])])
    G_terr = np.linalg.norm(st_np - t_gt[None], axis=1)
    gmask = (G_errs < 5.0) & (G_terr < 0.5) & np.isfinite(sc_np)
    if gmask.any():
        print(f"best near-GT coarse score {sc_np[gmask].max():.4f} "
              f"(overall max {np.nanmax(sc_np[np.isfinite(sc_np)]):.4f}); "
              f"in diverse top-{K}: "
              f"{bool(gmask[top_idx].any())}")
    else:
        print("NO near-GT candidate among selected at all")

    @jax.jit
    def rescore(Rk, tk, tgt, src):
        Rr, tr = Rk, tk
        rmse = jnp.zeros(Rk.shape[0])
        ninl = jnp.zeros(Rk.shape[0], jnp.int32)
        denom = jnp.maximum(jnp.minimum(src.ds.count, tgt.ds.count),
                            1).astype(jnp.float32)
        bm, org, cell = overlap_mod.build_occupancy(
            tgt.ds.points, tgt.ds.mask, lt, cfg.overlap_grid)
        covis = overlap_mod.approx_overlap_counts(
            bm, org, cell, Rr, tr, src.ds.points, src.ds.mask,
            cfg.overlap_grid).astype(jnp.float32) / denom
        variants = {}
        for rf in (2.0, 1.5):
            for nc in (0.7071, 0.866):
                r_fine = rf * dsd / cfg.downsample_factor
                cnt = overlap_mod.exact_overlap_counts(
                    Rr, tr, src.ds.points, src.ds.mask, tgt.ds.points,
                    r_fine * r_fine,
                    src_normals=src.ds.normals, tgt_normals=tgt.ds.normals,
                    normal_cos=nc)
                variants[(rf, nc)] = cnt.astype(jnp.float32) / denom
        return Rr, tr, rmse, ninl, covis, variants

    Rk = jnp.asarray(sR_np[top_idx])
    tk = jnp.asarray(st_np[top_idx])
    Rr, tr, rmse, ninl, covis, variants = rescore(Rk, tk, tgt, src)
    Rr, tr, rmse, ninl, covis = (np.asarray(Rr), np.asarray(tr),
                                 np.asarray(rmse), np.asarray(ninl),
                                 np.asarray(covis))
    variants = {k2: np.asarray(v) for k2, v in variants.items()}
    Rk, tk = np.asarray(Rk), np.asarray(tk)
    pf = np.asarray(plane_frac)[top_idx]
    floor = cfg.rescore_covis_floor
    for k in range(len(top_idx)):
        e1 = rot_err_deg(R_gt, Rr[k])
        te1 = float(np.linalg.norm(tr[k] - t_gt))
        cells = []
        for (rf, nc), v in variants.items():
            ovk = v[k] / max(covis[k], floor)
            fin = 0.2 * pf[k] + 0.8 * ovk
            cells.append(f"rf{rf}/nc{nc:.2f}: {v[k]:.3f}->{ovk:.3f} "
                         f"fin {fin:.3f}")
        print(f"cand[{k}] rot {e1:7.2f} trans {te1:6.3f} frac {pf[k]:.3f} "
              f"covis {covis[k]:.3f} | " + " | ".join(cells))


if __name__ == "__main__":
    sys.exit(main())

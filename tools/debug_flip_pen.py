"""Why does the aliased winner survive the penetration filter?

Reruns the failing pair of debug_flip.py, then dumps every (src plane,
tgt plane) triple of the WINNER candidate: the build_tests need-mask
stages (skip / line / clip / overlap) and, for compacted tests, the
side-1 / side-2 point counts of run_tests — against the reference
semantics of AreTwoPlanesPenetrable (util.cpp:1279-1458).

Usage: PYTHONPATH=. python tools/debug_flip_pen.py
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
from plade_tpu.extract import ransac
from plade_tpu.io.synthetic import make_scan_sequence
from plade_tpu.knn.bruteforce import average_spacing
from plade_tpu.pipeline import _pad_size, _prepare_cloud_impl, prepare_cloud
from plade_tpu.verify import penetration
from plade_tpu.geometry.lines import intersect_planes
from plade_tpu.geometry.transforms import normalize

SIZE = 4.0


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
    lt = float(dp.length_threshold)

    # winner pose from the earlier diagnosis: recompute the full pipeline
    # winner by running register_pair
    from plade_tpu.pipeline import register_pair
    res = register_pair(tgt, src, (jnp.float32(dp.scale), jnp.float32(lt),
                                   dsd), cfg)
    T = np.asarray(res.transform)
    Rw = T[:3, :3].astype(np.float32)
    tw = T[:3, 3].astype(np.float32)
    c = (np.trace(G[:3, :3].T @ Rw) - 1.0) / 2.0
    print(f"winner rot_err {np.degrees(np.arccos(np.clip(c, -1, 1))):.2f} "
          f"deg trans_err {np.linalg.norm(tw - G[:3, 3]):.3f} "
          f"pen_overflow={int(res.pen_overflow)}")

    Ps = int(src_planes.count)
    Pt = int(tgt_planes.count)
    R1 = jnp.asarray(Rw)[None]
    t1 = jnp.asarray(tw)[None]

    # --- replicate build_tests stages with full masks dumped ---
    ns = src.planes.coeffs[:, :3]
    ds = src.planes.coeffs[:, 3]
    rn = jnp.einsum("cij,pj->cpi", R1, ns)
    rd = ds[None, :] - jnp.einsum("cpi,ci->cp", rn, t1)
    sc = jnp.einsum("cij,pj->cpi", R1, src.geom.centers) + t1[:, None, :]
    rcorners = jnp.einsum("cij,pkj->cpki", R1, src.geom.corners) \
        + t1[:, None, None, :]
    nt = tgt.planes.coeffs[:, :3]
    dt = tgt.planes.coeffs[:, 3]
    d_a = jnp.abs(jnp.einsum("qi,cpi->cpq", nt, sc) + dt[None, None, :])
    d_b = jnp.abs(jnp.einsum("cpi,qi->cpq", rn, tgt.geom.centers)
                  + rd[..., None])
    c2pd = 0.5 * (d_a + d_b)
    dotn = jnp.einsum("cpi,qi->cpq", rn, nt)
    skip = (c2pd < lt) & (dotn > cfg.angle_threshold)
    p1 = jnp.concatenate([rn, rd[..., None]], axis=-1)
    C = 1
    P_s = ns.shape[0]
    P_t = nt.shape[0]
    p1b = jnp.broadcast_to(p1[:, :, None, :], (C, P_s, P_t, 4))
    p2b = jnp.broadcast_to(
        jnp.concatenate([nt, dt[:, None]], -1)[None, None, :, :],
        (C, P_s, P_t, 4))
    u, p0, line_ok = intersect_planes(p1b, p2b)
    q1 = jnp.broadcast_to(rcorners[:, :, None, :, :], (C, P_s, P_t, 4, 3))
    q2 = jnp.broadcast_to(tgt.geom.corners[None, None, :, :, :],
                          (C, P_s, P_t, 4, 3))
    pts1, n1 = penetration._clip_line_with_quad(u, p0, q1)
    pts2, n2 = penetration._clip_line_with_quad(u, p0, q2)
    clip_ok = (n1 == 2) & (n2 == 2)
    direc = normalize(pts1[..., 1, :] - pts1[..., 0, :])
    allpts = jnp.concatenate([pts1, pts2], axis=-2)
    proj = jnp.sum((allpts - pts1[..., 0:1, :]) * direc[..., None, :], -1)
    order = jnp.argsort(proj, axis=-1)
    tags = order // 2
    overlap_ok = tags[..., 0] != tags[..., 1]
    need = (~skip) & line_ok & clip_ok & overlap_ok

    need_np = np.asarray(need)[0]
    print(f"winner triples: skip={int(np.asarray(skip)[0][:Ps, :Pt].sum())} "
          f"line_ok={int(np.asarray(line_ok)[0][:Ps, :Pt].sum())} "
          f"clip_ok={int(np.asarray(clip_ok)[0][:Ps, :Pt].sum())} "
          f"overlap_ok={int(np.asarray(overlap_ok)[0][:Ps, :Pt].sum())} "
          f"need={int(need_np[:Ps, :Pt].sum())}")

    # run the point tests for the needed triples and dump counts
    tests = penetration.build_tests(
        R1, t1, jnp.ones((1,), bool),
        src.planes.coeffs, src.geom.corners, src.geom.centers,
        src.planes.mask,
        tgt.planes.coeffs, tgt.geom.corners, tgt.geom.centers,
        tgt.planes.mask, jnp.float32(lt), cfg.angle_threshold,
        max_tests=cfg.max_penetration_tests)
    pen = penetration.run_tests(
        tests, R1, t1, src.geom.ds_points, src.geom.ds_counts,
        tgt.geom.ds_points, tgt.geom.ds_counts,
        src.planes.coeffs, tgt.planes.coeffs,
        search_radius=jnp.float32(lt),
        min_points=cfg.penetration_min_points,
        min_distance=jnp.float32(lt) / 2.0,
        n_samples=cfg.penetration_samples,
        max_ratio=cfg.penetration_ratio)
    tv = np.asarray(tests.valid)
    print(f"compacted tests: {int(tv.sum())}, penetrable: "
          f"{int(np.asarray(pen)[tv].sum())}")

    # per-test side counts (re-run one chunk manually for the valid tests)
    ns_np = np.asarray(src.planes.coeffs)[:, :3]
    ds_np = np.asarray(src.planes.coeffs)[:, 3]
    ntg_np = np.asarray(tgt.planes.coeffs)
    sdp = np.asarray(src.geom.ds_points)
    sdc = np.asarray(src.geom.ds_counts)
    tdp = np.asarray(tgt.geom.ds_points)
    tdc = np.asarray(tgt.geom.ds_counts)
    tc_, ts_, tt_ = (np.asarray(tests.cand), np.asarray(tests.src),
                     np.asarray(tests.tgt))
    st_, di_, le_ = (np.asarray(tests.start), np.asarray(tests.direc),
                     np.asarray(tests.length))
    min_distance = lt / 2.0
    for k in range(len(tv)):
        if not tv[k]:
            continue
        spl, tpl = int(ts_[k]), int(tt_[k])
        cloud1 = sdp[spl][:sdc[spl]] @ Rw.T + tw
        cloud2 = tdp[tpl][:tdc[tpl]]
        rn1 = Rw @ ns_np[spl]
        rd1 = ds_np[spl] - rn1 @ tw
        samples = st_[k][None] + (np.arange(cfg.penetration_samples)[:, None]
                                  * lt) * di_[k][None]
        s_ok = (np.arange(cfg.penetration_samples) * lt) < le_[k]

        def side(points, other, pn, pd):
            d2o = ((other[:, None, :] - samples[None, :, :]) ** 2).sum(-1)
            occ = (d2o <= (lt / 2) ** 2).sum(0) >= 2
            live = s_ok & occ
            d2p = ((points[:, None, :] - samples[None, :, :]) ** 2).sum(-1)
            near = ((d2p <= lt * lt) & live[None, :]).any(1)
            signed = points @ pn + pd
            pos = int((near & (signed > min_distance)).sum())
            neg = int((near & (signed < -min_distance)).sum())
            return pos, neg

        pos1, neg1 = side(cloud1, cloud2, ntg_np[tpl, :3], ntg_np[tpl, 3])
        pos2, neg2 = side(cloud2, cloud1, rn1, rd1)
        print(f"  test[{k}] src={spl} tgt={tpl} len={le_[k]:.2f} "
              f"side1=({pos1},{neg1}) side2=({pos2},{neg2}) "
              f"pen={bool(np.asarray(pen)[k])}")


if __name__ == "__main__":
    sys.exit(main())

"""Golden test vs the reference's bundled sample pair + ground truth.

The polyhedron pair is the reference's de-facto acceptance artifact
(sample_data/polyhedron_source_groundtruth.txt; SURVEY section 4).  These
run the full default-size pipeline, so they run on the card only
(``python -m pytest -m gpu tests/``) and skip elsewhere.
"""
import os

import numpy as np
import pytest

SAMPLE_DIR = "/root/reference/sample_data"
GT = np.array([
    [-0.50608, 0.86067, 0.05595, -0.25258],
    [0.82135, 0.50072, -0.27326, 0.86333],
    [-0.26320, -0.09234, -0.96031, 0.15475],
    [0.0, 0.0, 0.0, 1.0]])

pytestmark = pytest.mark.gpu


def test_polyhedron_pair_matches_groundtruth(gpu):
    if not os.path.isdir(SAMPLE_DIR):
        pytest.skip("the polyhedron sample pair is not present")
    from plade_tpu.core.config import PladeConfig
    from plade_tpu.pipeline import register_files

    T, info = register_files(
        os.path.join(SAMPLE_DIR, "polyhedron_target.ply"),
        os.path.join(SAMPLE_DIR, "polyhedron_source.ply"),
        PladeConfig(), seed=0)
    assert info["success"], info
    c = (np.trace(GT[:3, :3].T @ T[:3, :3]) - 1.0) / 2.0
    rot_err = np.degrees(np.arccos(np.clip(c, -1.0, 1.0)))
    trans_err = np.linalg.norm(T[:3, 3] - GT[:3, 3])
    # coarse (no ICP) acceptance: the reference's own room-pair run differs
    # from GT at ~1e-2 (BASELINE.md); polyhedron is cleaner
    assert rot_err < 1.0, (T, rot_err)
    assert trans_err < 0.05, (T, trans_err)


def test_small_overlap_fullscale_scan_pair(gpu):
    """Full-scale partial-overlap golden (VERDICT r2 next #1): two ~90k-pt
    scans sharing <= 40% of their points, default config.  The step/radius
    choice is validated in-test by measuring the actual shared fraction in
    the world frame."""
    from plade_tpu.core.config import PladeConfig
    from plade_tpu.io.synthetic import make_scan_sequence
    from plade_tpu.pipeline import register_clouds

    # step/radius calibrated so the measured shared fraction below is
    # ~0.31 (the 3.4 step used before round 4 produced 0.52 — NOT a
    # small-overlap scene)
    rng = np.random.default_rng(21)
    radius, step = 3.2, 4.0
    scans, poses = make_scan_sequence(
        rng, n_scans=2, n_points=94000, overlap_radius=radius, step=step,
        n_rooms=4, n_per_plane=22000, noise=0.015, size=4.0, extra_planes=4,
        normal_noise_deg=4.0, max_angle=1.2, max_trans=0.8)
    (tp, tn), (sp, sn) = scans
    assert min(tp.shape[0], sp.shape[0]) >= 90000
    G = np.linalg.inv(poses[0]) @ poses[1]

    # measured shared fraction: target-scan points (world frame) that the
    # source scan also sees (within its overlap sphere)
    tw = (poses[0][:3, :3] @ tp.T).T + poses[0][:3, 3]
    c1 = np.array([step, 0.0, 0.0])
    shared = np.mean(np.linalg.norm(tw - c1, axis=1) <= radius)
    assert shared <= 0.40, f"scene not small-overlap: {shared:.2f}"

    T, info = register_clouds(tp, tn, sp, sn, PladeConfig(), seed=0)
    assert info["success"], info
    c = (np.trace(G[:3, :3].T @ T[:3, :3]) - 1.0) / 2.0
    rot_err = np.degrees(np.arccos(np.clip(c, -1.0, 1.0)))
    trans_err = np.linalg.norm(T[:3, 3] - G[:3, 3])
    assert rot_err < 2.0, (T, rot_err)
    assert trans_err < 0.15, (T, trans_err)


def test_noisy_fullscale_scan_pair(gpu):
    """Full-scale noisy golden standing in for the missing room pair
    (VERDICT missing #4): ~94k-point synthetic building scans with
    realistic scan noise (0.5% of extent), ~6 deg per-point normal error,
    and partial occlusion (the two scans see overlapping but different
    world regions), run at the DEFAULT config.  Thresholds mirror the
    room-pair tolerances (reference run differs from room GT at ~1e-2,
    sample_data/room_source_groundtruth.txt vs file_pairs_results.txt).
    """
    from plade_tpu.core.config import PladeConfig
    from plade_tpu.io.synthetic import make_scan_sequence
    from plade_tpu.pipeline import register_clouds

    rng = np.random.default_rng(12)
    scans, poses = make_scan_sequence(
        rng, n_scans=2, n_points=94000, overlap_radius=3.6, step=2.2,
        n_rooms=3, n_per_plane=22000, noise=0.02, size=4.0, extra_planes=3,
        normal_noise_deg=6.0, max_angle=1.2, max_trans=0.8)
    (tp, tn), (sp, sn) = scans
    assert min(tp.shape[0], sp.shape[0]) >= 90000  # full-scale like room
    G = np.linalg.inv(poses[0]) @ poses[1]  # source scan -> target scan

    T, info = register_clouds(tp, tn, sp, sn, PladeConfig(), seed=0)
    assert info["success"], info
    c = (np.trace(G[:3, :3].T @ T[:3, :3]) - 1.0) / 2.0
    rot_err = np.degrees(np.arccos(np.clip(c, -1.0, 1.0)))
    trans_err = np.linalg.norm(T[:3, 3] - G[:3, 3])
    assert rot_err < 2.0, (T, rot_err)
    assert trans_err < 0.15, (T, trans_err)


def test_rescore_overturns_coarse_alias_and_reports_its_ranking(gpu):
    """VERDICT r4 next-#5 'Done' criterion: on a scene where the tight
    co-visible rescore OVERTURNS the coarse argmax (a 180-degree lattice
    alias wins the reference-style coarse score), the returned transform
    must be the rescored winner and info['score']/info['overlap'] must
    equal the tight co-visible quantities that ranked it — recomputed
    here independently from the returned pose.

    Scene: synthetic scan sequence seed 1, pair 1->2 (60k points), where
    rescore_top_k=0 measurably locks rot ~180 deg / trans ~6.7 while the
    default config recovers rot 0.06 deg."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from plade_tpu.core.config import PladeConfig
    from plade_tpu.core.types import pad_cloud
    from plade_tpu.extract import ransac
    from plade_tpu.io.synthetic import make_scan_sequence
    from plade_tpu.knn.bruteforce import average_spacing
    from plade_tpu.pipeline import _pad_size, prepare_cloud, register_clouds
    from plade_tpu.verify import overlap as om

    cfg = PladeConfig()
    assert cfg.rescore_top_k > 0 and not cfg.enable_icp
    rng = np.random.default_rng(1)
    scans, poses = make_scan_sequence(
        rng, n_scans=3, n_points=60000, overlap_radius=3.4, step=2.0,
        n_rooms=3, n_per_plane=9000, noise=0.02, size=4.0, extra_planes=3,
        normal_noise_deg=3.0, max_angle=1.0, max_trans=0.6)
    i, j = 1, 2
    tp, tn = scans[i]
    sp, sn = scans[j]
    G = np.linalg.inv(poses[i]) @ poses[j]

    def rot_err(T):
        c = (np.trace(G[:3, :3].T @ T[:3, :3]) - 1.0) / 2.0
        return float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))

    # 1) coarse-only (reference-style final ranking) picks the alias
    coarse_cfg = dataclasses.replace(cfg, rescore_top_k=0)
    Tc, infoc = register_clouds(tp, tn, sp, sn, coarse_cfg, seed=0)
    assert rot_err(Tc) > 5.0, (rot_err(Tc), "scene no longer aliases")

    # 2) default config overturns to the true pose
    T, info = register_clouds(tp, tn, sp, sn, cfg, seed=0)
    assert info["success"], info
    assert rot_err(T) < 2.0, (rot_err(T), info)
    assert np.linalg.norm(T[:3, 3] - G[:3, 3]) < 0.15

    # 3) the reported score/overlap are the tight co-visible quantities
    # of the RETURNED pose (independent recompute; register_clouds
    # derives its planes from PRNGKey(seed) split exactly like this)
    pad = _pad_size(max(tp.shape[0], sp.shape[0]), maximum=cfg.max_points)
    tc = pad_cloud(tp, tn, pad)
    sc = pad_cloud(sp, sn, pad)
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    tpl = ransac.auto_extract(tc.points, tc.normals, tc.count, k1, cfg, pad)
    spl = ransac.auto_extract(sc.points, sc.normals, sc.count, k2, cfg, pad)
    spc = float(average_spacing(sc.points, sc.mask, cfg.spacing_k,
                                cfg.spacing_samples))
    dp = cfg.derived(spc)
    dsd = jnp.float32(dp.down_sample_distance)
    tprep = prepare_cloud(tc, tpl, dsd, cfg)
    sprep = prepare_cloud(sc, spl, dsd, cfg)
    Rb = jnp.asarray(T[:3, :3].astype(np.float32))
    tb = jnp.asarray(T[:3, 3].astype(np.float32))
    r_fine = cfg.rescore_radius_factor * dsd / cfg.downsample_factor
    cnt = om.exact_overlap_counts(
        Rb[None], tb[None], sprep.ds.points, sprep.ds.mask,
        tprep.ds.points, r_fine * r_fine,
        src_normals=sprep.ds.normals, tgt_normals=tprep.ds.normals,
        normal_cos=cfg.overlap_normal_cos)
    bm, org, cell = om.build_occupancy(
        tprep.ds.points, tprep.ds.mask,
        jnp.float32(dp.length_threshold), cfg.overlap_grid)
    covis = om.approx_overlap_counts(
        bm, org, cell, Rb[None], tb[None], sprep.ds.points, sprep.ds.mask,
        cfg.overlap_grid)
    denom = float(max(min(int(sprep.ds.count), int(tprep.ds.count)), 1))
    denom_k = max(float(covis[0]), cfg.rescore_covis_floor * denom)
    ov_f = float(cnt[0]) / denom_k
    pf = info["matched_planes"] / max(int(spl.count), 1)
    score_f = cfg.face_matches_weight * pf \
        + (1.0 - cfg.face_matches_weight) * ov_f
    assert np.isclose(info["overlap"], ov_f, rtol=1e-3, atol=1e-4), \
        (info["overlap"], ov_f)
    assert np.isclose(info["score"], score_f, rtol=1e-3, atol=1e-4), \
        (info["score"], score_f)

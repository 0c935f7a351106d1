"""Plane extraction tests on synthetic scenes with known planes."""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from plade_tpu.core.config import PladeConfig
from plade_tpu.core.types import pad_cloud
from plade_tpu.extract import ransac
from plade_tpu.io.synthetic import make_room

TEST_CFG = PladeConfig(
    ransac_candidates_per_round=64,
    bitmap_grid=64,
)


def _extract(points, normals, cfg, min_support, max_extract=16, seed=0,
             stats=False):
    n = points.shape[0]
    pad = 1 << (n - 1).bit_length()
    cloud = pad_cloud(points, normals, pad)
    fn = ransac.make_extractor(cfg, pad, max_extract=max_extract)
    planes, st = fn(cloud.points, cloud.normals, cloud.count,
                    jax.random.PRNGKey(seed), min_support)
    return (planes, st) if stats else planes


def test_extract_single_plane(rng):
    from plade_tpu.io.synthetic import make_plane_points
    pts, nrm = make_plane_points(rng, (0, 0, 1.0), (1, 0, 0), (0, 1, 0),
                                 2.0, 2.0, 4000, noise=0.002)
    planes = _extract(pts, nrm, TEST_CFG, min_support=500)
    assert int(planes.count) == 1
    n, d = np.asarray(planes.coeffs[0, :3]), float(planes.coeffs[0, 3])
    # normal oriented along the point normals (+z here)
    np.testing.assert_allclose(n, [0, 0, 1], atol=0.02)
    assert abs(d + 1.0) < 0.02
    assert int(planes.sizes[0]) > 3500


def test_extract_room_planes(rng):
    pts, nrm, gt_planes = make_room(rng, n_per_plane=1500, noise=0.002,
                                    extra_planes=2)
    planes = _extract(pts, nrm, TEST_CFG, min_support=400)
    count = int(planes.count)
    assert count >= len(gt_planes) - 1  # at least nearly all planes found
    got = np.asarray(planes.coeffs[:count])
    matched = 0
    for n_gt, d_gt in gt_planes:
        dots = got[:, :3] @ n_gt
        dd = np.abs(got[:, 3] - d_gt)
        if np.any((dots > 0.99) & (dd < 0.05)):
            matched += 1
    assert matched >= len(gt_planes) - 1
    # support points assigned
    pp = np.asarray(planes.point_plane)
    assert (pp >= 0).sum() > 0.8 * pts.shape[0]


def test_connected_component_split(rng):
    # two coplanar patches far apart: CC trim must keep only one
    from plade_tpu.io.synthetic import make_plane_points
    p1, n1 = make_plane_points(rng, (0, 0, 0), (1, 0, 0), (0, 1, 0),
                               1.0, 1.0, 2000, noise=0.001)
    p2, n2 = make_plane_points(rng, (8, 0, 0), (1, 0, 0), (0, 1, 0),
                               1.0, 1.0, 1000, noise=0.001)
    pts = np.concatenate([p1, p2])
    nrm = np.concatenate([n1, n2])
    planes = _extract(pts, nrm, TEST_CFG, min_support=300, max_extract=4)
    # both patches should come out as separate planes, not one merged plane
    assert int(planes.count) == 2
    sizes = sorted(int(s) for s in np.asarray(planes.sizes[:2]))
    assert 800 < sizes[0] < 1300
    assert 1700 < sizes[1] < 2300


def test_extract_noisy_scan_recall(rng):
    """Plane recall on a realistically noisy scan: point noise 0.01x the
    scene extent (2x the RANSAC eps band of 0.005x) and ~8 deg per-point
    normal-estimation error.  This is the regime the 3-point stratified
    draws + Gaussian-gated refits must cover — seed-normal proposals alone
    degrade when individual normals are unreliable (VERDICT missing #3;
    reference engine RansacShapeDetector.cpp:89-191, ScoreComputer.h:10-43).
    """
    size = 4.0
    pts, nrm, gt_planes = make_room(rng, n_per_plane=1500, noise=0.01 * size,
                                    size=size, extra_planes=2,
                                    normal_noise_deg=8.0)
    planes = _extract(pts, nrm, TEST_CFG, min_support=400)
    count = int(planes.count)
    got = np.asarray(planes.coeffs[:count])
    matched = 0
    for n_gt, d_gt in gt_planes:
        dots = got[:, :3] @ n_gt
        dd = np.abs(got[:, 3] - d_gt)
        if np.any((dots > 0.98) & (dd < 0.1)):
            matched += 1
    # >= 90% plane recall at this noise level
    assert matched >= int(np.ceil(0.9 * len(gt_planes))), \
        f"recall {matched}/{len(gt_planes)}"


def test_overlook_termination_uses_config(rng):
    """ransac_overlook_prob drives both the acceptance gate and termination
    (CandidateFailureProbability, RansacShapeDetector.h:62-68): a stricter
    allowed overlook probability must spend strictly more candidate draws
    before committing/terminating, and both runs still find the planes."""
    pts, nrm, gt_planes = make_room(rng, n_per_plane=1200, noise=0.002,
                                    extra_planes=0)
    base = dataclasses.replace(TEST_CFG, ransac_candidates_per_round=16,
                               min_planes=2)
    lax_cfg = dataclasses.replace(base, ransac_overlook_prob=0.05)
    strict_cfg = dataclasses.replace(base, ransac_overlook_prob=1e-6)
    p_lax, st_lax = _extract(pts, nrm, lax_cfg, min_support=400, stats=True)
    p_strict, st_strict = _extract(pts, nrm, strict_cfg, min_support=400,
                                   stats=True)
    assert int(p_strict.count) == len(gt_planes)
    assert int(p_lax.count) >= 2
    # the strict bound demands more evidence: more greedy rounds
    assert int(st_strict.rounds) > int(st_lax.rounds)


def test_max_trials_caps_support_halving(rng):
    """ransac_max_trials caps the auto-tune halvings (reference extract(),
    plade.cpp:623-628): with zero allowed halvings the support threshold
    stays at the (unattainable) init value and nothing is extracted."""
    pts, nrm, gt_planes = make_room(rng, n_per_plane=1200, noise=0.002,
                                    extra_planes=0)
    # the staged halving cascade is the ransac_flat_support=False path
    # (the default flat mode starts at the floor and never halves)
    staged = dataclasses.replace(TEST_CFG, ransac_flat_support=False)
    no_halve = dataclasses.replace(staged, ransac_max_trials=0,
                                   min_planes=2)
    planes, st = _extract(pts, nrm, no_halve, min_support=400, stats=True)
    assert int(planes.count) == 0
    assert int(st.trials) == 0
    assert int(st.min_support) == 10000   # never halved
    ok = dataclasses.replace(staged, ransac_max_trials=10, min_planes=2)
    planes2, st2 = _extract(pts, nrm, ok, min_support=400, stats=True)
    assert int(planes2.count) == len(gt_planes)
    assert 1 <= int(st2.trials) <= 10


def test_flat_support_matches_staged(rng):
    """Flat-support mode (start at the floor; PladeConfig.
    ransac_flat_support) recovers the same planes as the staged halving
    cascade in no more greedy rounds — the acceptance bound itself stages
    big-to-small, and the support threshold is re-selected a posteriori."""
    pts, nrm, gt_planes = make_room(rng, n_per_plane=1500, noise=0.002,
                                    extra_planes=2)
    staged_cfg = dataclasses.replace(TEST_CFG, ransac_flat_support=False,
                                     ransac_init_min_support=2000)
    p_flat, st_flat = _extract(pts, nrm, TEST_CFG, min_support=400,
                               stats=True)
    p_staged, st_staged = _extract(pts, nrm, staged_cfg, min_support=400,
                                   stats=True)

    def recall(planes):
        count = int(planes.count)
        got = np.asarray(planes.coeffs[:count])
        matched = 0
        for n_gt, d_gt in gt_planes:
            dots = got[:, :3] @ n_gt
            dd = np.abs(got[:, 3] - d_gt)
            if np.any((dots > 0.99) & (dd < 0.05)):
                matched += 1
        return matched

    assert recall(p_flat) >= len(gt_planes) - 1
    assert recall(p_flat) >= recall(p_staged)
    assert int(st_flat.trials) == 0            # never halves
    assert int(st_flat.rounds) <= int(st_staged.rounds)


def test_select_planes_auto_tune(rng):
    pts, nrm, _ = make_room(rng, n_per_plane=900, noise=0.002, extra_planes=2)
    cfg = dataclasses.replace(TEST_CFG, min_planes=4, max_planes=6,
                              ransac_min_allowed_support=200,
                              ransac_init_min_support=10000)
    planes = _extract(pts, nrm, cfg, min_support=200, max_extract=16)
    sel = ransac.select_planes(planes, cfg)
    assert int(sel.count) <= 6
    assert int(sel.count) >= 4
    # remapped point ids stay consistent
    pp = np.asarray(sel.point_plane)
    assert pp.max() < int(sel.count)


def _closed_flood_fill(occ):
    """numpy reference for extract.ransac._cc_labels: morphological close
    with the cross (dilate, erode, union the original), then 8-connected
    components labelled by their smallest flat index; empty cells G*G."""
    from collections import deque

    G = occ.shape[0]

    def cross(b, op, pad_val):
        p = np.pad(b, 1, constant_values=pad_val)
        return op.reduce([b, p[:-2, 1:-1], p[2:, 1:-1],
                          p[1:-1, :-2], p[1:-1, 2:]])

    closed = cross(cross(occ > 0, np.logical_or, False),
                   np.logical_and, True) | (occ > 0)
    expect = np.full((G, G), G * G, np.int32)
    seen = np.zeros((G, G), bool)
    for r in range(G):
        for c in range(G):
            if not closed[r, c] or seen[r, c]:
                continue
            comp = []
            dq = deque([(r, c)])
            seen[r, c] = True
            while dq:
                y, x = dq.popleft()
                comp.append((y, x))
                for dy in (-1, 0, 1):
                    for dx in (-1, 0, 1):
                        yy, xx = y + dy, x + dx
                        if 0 <= yy < G and 0 <= xx < G \
                                and closed[yy, xx] and not seen[yy, xx]:
                            seen[yy, xx] = True
                            dq.append((yy, xx))
            m = min(y * G + x for y, x in comp)
            for y, x in comp:
                expect[y, x] = m
    return expect


def _serpentine(G):
    """One component that winds through the whole grid: full rows every
    fourth line, joined at alternating ends — a path of ~G^2/4 cells, far
    beyond what a fixed handful of label-propagation steps can cross."""
    occ = np.zeros((G, G), np.int32)
    for k, r in enumerate(range(0, G, 4)):
        occ[r, :] = 1
        if r + 4 < G:
            occ[r:r + 5, G - 1 if k % 2 == 0 else 0] = 1
    return occ


@pytest.mark.parametrize("grid_kind", ["random25", "random45", "serpentine"])
def test_cc_labels_match_flood_fill(grid_kind, rng):
    """The exact CC (stencil + pointer jumps to a fixpoint) equals a numpy
    flood fill on 64x64 occupancy grids, the bitmap_grid default."""
    G = 64
    if grid_kind == "serpentine":
        occ = _serpentine(G)
    else:
        occ = (rng.random((G, G)) < int(grid_kind[-2:]) / 100).astype(
            np.int32)
    expect = _closed_flood_fill(occ)
    got = np.asarray(jax.jit(ransac._cc_labels, static_argnums=1)(
        jnp.asarray(occ.reshape(-1)), G)).reshape(G, G)
    np.testing.assert_array_equal(got, expect)
    if grid_kind == "serpentine":
        assert len(np.unique(expect[expect < G * G])) == 1


def test_cc_labels_lanes_independent(rng):
    """Under vmap (one lane per accept slot) each lane labels on its own:
    occupied columns at every lane edge would merge across a leak."""
    G, L = 32, 3
    occ = (rng.random((L, G, G)) < 0.3).astype(np.int32)
    occ[:, :, 0] = 1
    occ[:, :, G - 1] = 1
    occ[1] = _serpentine(G)
    got = np.asarray(jax.vmap(lambda o: ransac._cc_labels(o, G))(
        jnp.asarray(occ.reshape(L, -1)))).reshape(L, G, G)
    for lane in range(L):
        np.testing.assert_array_equal(got[lane], _closed_flood_fill(occ[lane]))


def test_hist_scatter_matches_histogram2d(rng):
    """The trim's occupancy histogram against np.histogram2d, with
    weights masking out non-inliers."""
    G = 16
    ij = rng.integers(0, G, size=(500, 2)).astype(np.int32)
    w = rng.random(500) < 0.6
    got = np.asarray(ransac._hist_scatter(jnp.asarray(ij), jnp.asarray(w),
                                          G)).reshape(G, G)
    want, _, _ = np.histogram2d(ij[:, 0], ij[:, 1], bins=G,
                                range=[[0, G], [0, G]], weights=w)
    np.testing.assert_array_equal(got, want.astype(np.int32))

"""Medium-shape sharded execution: 16k-point pairs on the 8-device mesh.

The TINY dryrun (2,048-pt clouds) proves the sharding compiles; this proves
the sharded path at a realistic shape (VERDICT r2 weak #5).  Gated behind
PLADE_RUN_MEDIUM=1 because the 8-virtual-CPU compile+run takes minutes.
"""
import os

import jax
import numpy as np
import pytest

pytestmark = pytest.mark.skipif(
    os.environ.get("PLADE_RUN_MEDIUM") != "1",
    reason="set PLADE_RUN_MEDIUM=1 to run the medium-shape mesh test")

MEDIUM = dict(
    ransac_candidates_per_round=128,
    ransac_init_min_support=4000,
    ransac_min_allowed_support=200,
    min_planes=6,
    max_planes=16,
    bitmap_grid=64,
    spacing_samples=4000,
    max_ds_points=8192,
    max_plane_points=1024,
    max_lines=128,
    max_query_pairs=4096,
    max_target_pairs=8192,
    max_matches=16384,
    max_pose_clusters=1024,
    max_candidate_results=128,
    max_penetration_tests=4096,
)
N_POINTS = 16384


def _pair(seed: int):
    from plade_tpu.core.types import pad_cloud
    from plade_tpu.io.synthetic import (make_room, random_rigid,
                                        transform_cloud)
    rng = np.random.default_rng(seed)
    pts, nrm, _ = make_room(rng, n_per_plane=1800, noise=0.003,
                            extra_planes=4)
    pts, nrm = pts[:N_POINTS], nrm[:N_POINTS]
    R, t = random_rigid(rng, max_angle=1.0, max_trans=0.5)
    spts, snrm = transform_cloud(pts, nrm, R.T, -R.T @ t)
    return pad_cloud(pts, nrm, N_POINTS), pad_cloud(spts, snrm, N_POINTS), R, t


def test_medium_shape_mesh_batch():
    from plade_tpu.core.config import PladeConfig
    from plade_tpu.dist import mesh as dist_mesh

    cpu = jax.devices("cpu")
    if len(cpu) < 8:
        pytest.skip("needs 8 forced host devices")
    cfg = PladeConfig(**MEDIUM)
    mesh = dist_mesh.make_mesh(8, intra=2, devices=cpu)
    B = mesh.shape[dist_mesh.PAIRS]
    pairs = [_pair(i) for i in range(B)]
    tgt_b = dist_mesh.stack_clouds([p[0] for p in pairs])
    src_b = dist_mesh.stack_clouds([p[1] for p in pairs])
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    res = dist_mesh.register_batch(tgt_b, src_b, keys, cfg, mesh)
    success = np.asarray(res.success)
    assert success.all(), success.tolist()
    T = np.asarray(res.transform)
    for i, (_, _, R, t) in enumerate(pairs):
        c = (np.trace(R.T @ T[i, :3, :3]) - 1) / 2
        rot_err = np.degrees(np.arccos(np.clip(c, -1, 1)))
        terr = np.linalg.norm(T[i, :3, 3] - t)
        assert rot_err < 3.0 and terr < 0.2, (i, rot_err, terr)

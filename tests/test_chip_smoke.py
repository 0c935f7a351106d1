"""chip_smoke.py's phase functions on the CPU at the tiny driver config:
the device check refuses a CPU, and the single-pair and batch phases run
end to end on a small synthetic scan pair."""
import os
import sys

import jax
import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import __graft_entry__ as graft  # noqa: E402
import chip_smoke  # noqa: E402
from plade_tpu.core.config import PladeConfig  # noqa: E402

TINY_CFG = PladeConfig(**graft.TINY)


@pytest.fixture(scope="module")
def tiny_pair():
    return chip_smoke.make_pair(1001, n_points=3000, n_rooms=1,
                                n_per_plane=600)


@pytest.mark.parametrize("devices", [[], None], ids=["none", "cpu"])
def test_device_check_refuses_non_gpu(devices):
    with pytest.raises(SystemExit, match="needs GPU devices"):
        chip_smoke.check_devices(jax.devices("cpu") if devices is None
                                 else devices)


def test_pose_errors_and_bounds(tiny_pair):
    T_gt = tiny_pair[4]
    rot, trans = chip_smoke.pose_errors(T_gt, T_gt)
    assert rot < 0.05 and trans == 0.0   # arccos near 1: ~0.01 deg floor
    off = T_gt.copy()
    off[:3, 3] += [chip_smoke.TRANS_BOUND, 0.0, 0.0]
    with pytest.raises(AssertionError, match="out of bounds"):
        chip_smoke.check_pose("shifted", off, T_gt, True, {})
    with pytest.raises(AssertionError, match="truncation"):
        chip_smoke.check_pose("capped", T_gt, T_gt, True,
                              {"cloud_capped": True})


def test_single_pair_and_batch_phases(tiny_pair, tmp_path, monkeypatch):
    import plade_tpu.core.config as cfgmod
    from plade_tpu.dist.mesh import make_mesh

    # the CLI builds its own PladeConfig(): hand it the tiny one
    monkeypatch.setattr(cfgmod, "PladeConfig", lambda **kw: TINY_CFG)
    chip_smoke.phase_single_pair(TINY_CFG, tiny_pair, str(tmp_path))
    out = chip_smoke.register_pairs(
        "batch", TINY_CFG, [tiny_pair],
        make_mesh(1, devices=jax.devices("cpu")))
    assert len(out) == 1 and out[0].success
    np.testing.assert_allclose(out[0].transform[3], [0, 0, 0, 1])


def test_four_card_phase_on_virtual_devices():
    """Phase 5 on four virtual CPU devices: the pairs mesh and one device
    agree pair by pair (the same PRNG key per pair on both meshes)."""
    pairs = [chip_smoke.make_pair(s, n_points=3000, n_rooms=1,
                                  n_per_plane=600) for s in (1001, 1002)]
    chip_smoke.phase_four_cards(TINY_CFG, pairs * 2)

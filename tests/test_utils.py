"""Observability + IO utility tests."""
import os
import time

import numpy as np

from plade_tpu.io.vg import save_vg
from plade_tpu.utils.timing import StopWatch, stage, stage_report


def test_stopwatch_formatting():
    w = StopWatch()
    time.sleep(0.01)
    assert w.elapsed_seconds() >= 0.01
    assert any(u in w.time_string() for u in ("ms", "s"))


def test_stage_records(capfd):
    with stage("unit/st", verbose=True):
        time.sleep(0.005)
    rep = stage_report(reset=True)
    assert "unit/st" in rep and rep["unit/st"]["count"] == 1
    assert "[plade] unit/st" in capfd.readouterr().out


def test_save_vg_roundtrip(tmp_path):
    pts = np.arange(30, dtype=np.float32).reshape(10, 3)
    nrm = np.tile(np.array([[0, 0, 1]], np.float32), (10, 1))
    pp = np.array([0, 0, 0, 1, 1, 1, -1, -1, 0, 1], np.int32)
    f = str(tmp_path / "planes.vg")
    save_vg(f, pts, nrm, pp, num_planes=2)
    text = open(f).read()
    assert "num_points: 10" in text
    assert "num_groups: 2" in text
    assert text.count("group_type: 0") == 2
    assert text.count("group_num_point: 4") == 2  # planes {0,1,2,8}, {3,4,5,9}


def test_compile_cache_directory(monkeypatch, tmp_path):
    """JAX_COMPILATION_CACHE_DIR, when set, is used as is and nothing else
    is set in code; otherwise the cache goes to the checkout's fixed
    .jax_cache/."""
    import jax

    from plade_tpu.utils import cache

    names = ("jax_compilation_cache_dir",
             "jax_persistent_cache_min_compile_time_secs",
             "jax_persistent_cache_min_entry_size_bytes")
    before = {n: getattr(jax.config, n) for n in names}
    try:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert cache.enable_compile_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == \
            before["jax_compilation_cache_dir"]
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
        assert cache.enable_compile_cache() == cache.DEFAULT_DIR
        assert jax.config.jax_compilation_cache_dir == cache.DEFAULT_DIR
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        assert cache.DEFAULT_DIR == os.path.join(root, ".jax_cache")
    finally:
        for n, v in before.items():
            jax.config.update(n, v)

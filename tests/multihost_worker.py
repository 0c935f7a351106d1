"""Worker process for the real 2-process jax.distributed test.

Launched by tests/test_multihost.py::test_two_process_distributed with
    python multihost_worker.py <process_id> <num_processes> <coordinator>
Each process owns 2 virtual CPU devices; the global (pairs, intra) mesh
spans all 4.  The worker initializes the process group over localhost,
assembles its local shard of a 4-pair batch with local_batch_to_global,
runs the sharded registration step, and asserts its addressable results
succeeded.
"""
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402
import numpy as np  # noqa: E402


def main():
    pid, nproc, coord = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    # the process group must form before anything initializes the XLA
    # backend (importing package modules can, e.g. via module-level jnp
    # constants), so initialize first with the bare helper
    from plade_tpu.dist import multihost
    assert multihost.initialize(coordinator_address=coord,
                                num_processes=nproc, process_id=pid)
    from plade_tpu.core.config import PladeConfig
    from plade_tpu.dist import mesh as mesh_mod

    from __graft_entry__ import TINY, _tiny_pair
    assert jax.process_count() == nproc, jax.process_count()
    assert len(jax.devices()) == 2 * nproc, len(jax.devices())

    mesh = multihost.global_mesh(intra=1)          # (pairs=4, intra=1)
    cfg = PladeConfig(**TINY)
    B_local = len(jax.local_devices())
    # each host builds only ITS pairs: global pair index = pid*B_local + i
    pairs = [_tiny_pair(pid * B_local + i) for i in range(B_local)]
    local_tgt = mesh_mod.stack_clouds([p[0] for p in pairs])
    local_src = mesh_mod.stack_clouds([p[1] for p in pairs])
    local_keys = np.asarray(
        jax.random.split(jax.random.PRNGKey(0), nproc * B_local)
    )[pid * B_local:(pid + 1) * B_local]

    gt, gs, gk = multihost.local_batch_to_global(
        mesh, local_tgt, local_src, local_keys)
    res = mesh_mod.register_batch(gt, gs, gk, cfg, mesh)
    jax.block_until_ready(res)

    # each process asserts its own (addressable) pair results
    local_success = np.concatenate(
        [np.atleast_1d(np.asarray(s.data))
         for s in res.success.addressable_shards])
    assert local_success.all(), local_success

    # WARM steady state: >= 3 further sharded steps with fresh keys (the
    # first step above paid the compile).  Per-step wall on either
    # process equals the global step time (the step is collective), so
    # s/pair = dt / global pair count (a first step alone, which pays
    # the compile, says nothing about steady state)
    import time
    steps = 3
    t0 = time.perf_counter()
    for it in range(steps):
        lk = np.asarray(jax.vmap(jax.random.fold_in)(
            jax.numpy.asarray(local_keys),
            jax.numpy.full((B_local,), it + 1, dtype=jax.numpy.uint32)))
        gt2, gs2, gk2 = multihost.local_batch_to_global(
            mesh, local_tgt, local_src, lk)
        res = mesh_mod.register_batch(gt2, gs2, gk2, cfg, mesh)
        jax.block_until_ready(res)
    warm = (time.perf_counter() - t0) / (steps * nproc * B_local)
    print(f"WORKER_TIMING pid={pid} warm_s_per_pair={warm:.4f} "
          f"global_pairs={nproc * B_local} steps={steps}", flush=True)
    print(f"WORKER_OK pid={pid} local_success={local_success.tolist()}",
          flush=True)


if __name__ == "__main__":
    main()

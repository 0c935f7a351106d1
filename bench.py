"""Benchmark: registered pairs/s on one NVIDIA GPU.

Prints ONE JSON line: {"metric", "value", "unit", "device", "extra"}, where
``device`` names the JAX device and the card's name and power limit.
Exits non-zero when JAX finds no GPU.

The pairs are the synthetic scan pairs of ``chip_smoke.py``, made from
seeds: pair 0 is timed alone, pairs 0-7 as one vmapped batch and one at a
time.  Every timed call is fenced by ``block_until_ready``.
"""
import json
import sys
import time

import numpy as np

from chip_smoke import SEEDS, card_lines, check_devices, make_pair, pose_errors


def main():
    card = card_lines()[0]
    import jax
    import jax.numpy as jnp

    from plade_tpu.utils.cache import enable_compile_cache
    enable_compile_cache()
    check_devices(jax.devices())
    from plade_tpu.core.config import PladeConfig
    from plade_tpu.core.types import pad_cloud
    from plade_tpu.pipeline import _pad_size, build_register_device_fn

    cfg = PladeConfig()
    pairs = [make_pair(s) for s in SEEDS]
    pad = _pad_size(max(max(p[0].shape[0], p[2].shape[0]) for p in pairs),
                    maximum=cfg.max_points)
    clouds = [(pad_cloud(p[0], p[1], pad), pad_cloud(p[2], p[3], pad))
              for p in pairs]
    tgt, src = clouds[0]
    T_gt = pairs[0][4]
    B = len(pairs)

    def fenced(fn, *args):
        return jax.block_until_ready(fn(*args))

    # single pair, with the extraction stats
    fn_s = jax.jit(build_register_device_fn(cfg, pad, with_stats=True))
    res, stats = fenced(fn_s, tgt, src, jax.random.PRNGKey(0))
    runs = 5
    t0 = time.perf_counter()
    for i in range(runs):
        fenced(fn_s, tgt, src, jax.random.PRNGKey(i + 1))
    dt = (time.perf_counter() - t0) / runs
    rot_err_deg, trans_err = pose_errors(res.transform, T_gt)

    # batched throughput: vmap B distinct pairs through one card — the
    # production batch shape (register_array_pairs)
    vfn = jax.jit(jax.vmap(build_register_device_fn(cfg, pad)))
    tgt_b = jax.tree.map(lambda *xs: jnp.stack(xs), *[c[0] for c in clouds])
    src_b = jax.tree.map(lambda *xs: jnp.stack(xs), *[c[1] for c in clouds])
    rb = fenced(vfn, tgt_b, src_b, jax.random.split(jax.random.PRNGKey(1), B))
    bruns = 3
    t0 = time.perf_counter()
    for i in range(bruns):
        rb = fenced(vfn, tgt_b, src_b,
                    jax.random.split(jax.random.PRNGKey(100 + i), B))
    batch_dt = (time.perf_counter() - t0) / (bruns * B)
    batch_ok = bool(np.asarray(rb.success).all())

    # like-for-like sequential baseline: the SAME B pairs one at a time
    # through the non-vmapped program
    fn1 = jax.jit(build_register_device_fn(cfg, pad))
    fenced(fn1, tgt, src, jax.random.PRNGKey(0))
    sruns = 2
    t0 = time.perf_counter()
    for i in range(sruns):
        for j, (tg, sr) in enumerate(clouds):
            fenced(fn1, tg, sr, jax.random.PRNGKey(200 + i * B + j))
    seq_dt = (time.perf_counter() - t0) / (sruns * B)

    dev = jax.devices()[0]
    out = {
        "metric": "synthetic_pair_registration_throughput",
        "value": round(1.0 / batch_dt, 4),
        "unit": "pairs/s",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices()), "card": card},
        "extra": {
            "batched_s_per_pair": round(batch_dt, 4),
            "batch_size": B,
            "single_s_per_pair": round(dt, 4),
            "sequential_mean_s_per_pair": round(seq_dt, 4),
            "rot_err_deg": round(rot_err_deg, 3),
            "trans_err": round(trans_err, 4),
            "success": bool(res.success),
            "batched_all_success": batch_ok,
            "extract_rounds": [int(x) for x in np.asarray(stats.rounds)],
            "extract_drawn": [round(float(x), 1)
                              for x in np.asarray(stats.drawn)],
            "extract_trials": [int(x) for x in np.asarray(stats.trials)],
            "match_saturated": int(res.match_saturated),
            "pen_overflow": int(res.pen_overflow),
            "cluster_truncated": int(res.cluster_truncated),
        },
    }
    print(json.dumps(out))


if __name__ == "__main__":
    sys.exit(main())

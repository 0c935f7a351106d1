"""Smoke run of the registration path on NVIDIA GPUs.

    python chip_smoke.py               # phases 1-4 on one card
    python chip_smoke.py --four-cards  # phase 5 alone, on four cards

1. device: every JAX device is a GPU; the card's name and power limit
   (nvidia-smi, queried before JAX opens the card).
2. nearest neighbours: the dense NN searches (the repo has no
   hand-written kernel) compiled at the pipeline's real widths and
   compared with float64 numpy; ``memory_analysis()`` of the full
   single-pair step.
3. single pair: a synthetic 100k-point scan pair written to PLY and
   registered through ``pipeline.register_files`` and through the CLI;
   rotation and translation error against the generator's ground truth,
   success and the four truncation counters; compile seconds, steady
   seconds and peak device memory of the full single-pair step.
4. batch: four distinct pairs through ``dist.mesh.register_array_pairs``
   on a one-card mesh (the ``--device-batch`` path).
5. four cards: eight pairs through ``register_array_pairs`` on a
   four-card pairs mesh and on card 0 alone, in one process; per-pair
   success must be identical and the transforms must agree.

Everything runs in this one process, the only one that opens the cards.
Any failed check raises, so the process exits non-zero; the last line of
standard output is a JSON verdict, printed only when every phase passed.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

# the recall criterion of EVAL.md / io/resso.py
ROT_BOUND_DEG = 5.0
TRANS_BOUND = 0.5
# four-card and one-card registrations of a pair run the same program
# under the same PRNG key; the bound leaves room for a reordered float sum
# flipping a near-tie, which moves a correct coarse pose by ~0.05 deg
AGREE_ROT_DEG = 0.5
AGREE_TRANS = 0.05
# float32 diff-form distances against float64 numpy (tests/test_nn.py)
NN_RTOL = 1e-5
NN_ATOL = 1e-6
N_POINTS = 100000
# the scan pairs of bench.py: 3 rooms, 2 cm noise, 3 degree normal error
SCAN_KW = dict(n_scans=2, overlap_radius=3.4, step=2.0, n_rooms=3,
               n_per_plane=9000, noise=0.02, size=4.0, extra_planes=3,
               normal_noise_deg=3.0, max_angle=1.0, max_trans=0.6)
# screened on an H100: each registers within the bounds under four PRNG
# keys; seed 1003 is left out — under one key of four its extraction leads
# to the 180-degree alias of the repeated rooms (EVAL.md recall < 1)
SEEDS = (1001, 1002, 1004, 1005, 1006, 1007, 1008, 1009)
COUNTERS = ("match_saturated", "pen_overflow", "cluster_truncated",
            "cloud_capped")


def log(msg: str) -> None:
    print(msg, flush=True)


def card_lines() -> list[str]:
    """``name, power.limit`` of each card, from nvidia-smi; raises when it
    is missing or fails.  Call before JAX opens a card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    lines = [l.strip() for l in out.stdout.splitlines() if l.strip()]
    if not lines:
        raise RuntimeError("nvidia-smi listed no card")
    return lines


def check_devices(devices) -> None:
    """Phase 1: refuse anything but a non-empty list of GPU devices."""
    platforms = [d.platform for d in devices]
    if not platforms or any(p != "gpu" for p in platforms):
        raise SystemExit(f"chip_smoke: needs GPU devices, JAX has "
                         f"{platforms or 'none'}")


def make_pair(seed: int, n_points: int = N_POINTS, **scan_kw):
    """(tgt_pts, tgt_nrm, src_pts, src_nrm, T_gt): scans 0 and 1 of a
    synthetic scan sequence; T_gt maps the source onto the target."""
    from plade_tpu.io.synthetic import make_scan_sequence
    scans, poses = make_scan_sequence(np.random.default_rng(seed),
                                      n_points=n_points,
                                      **{**SCAN_KW, **scan_kw})
    (tp, tn), (sp, sn) = scans
    return tp, tn, sp, sn, np.linalg.inv(poses[0]) @ poses[1]


def pose_errors(T, T_gt) -> tuple[float, float]:
    """(rotation error in degrees, translation error) of T against T_gt."""
    from plade_tpu.io.resso import rotation_error_deg
    T = np.asarray(T, np.float64)
    return (rotation_error_deg(T[:3, :3], T_gt[:3, :3]),
            float(np.linalg.norm(T[:3, 3] - T_gt[:3, 3])))


def check_pose(label: str, T, T_gt, success: bool, counters: dict) -> None:
    rot, trans = pose_errors(T, T_gt)
    log(f"{label}: success={success} rot_err_deg={rot:.4f} "
        f"(bound {ROT_BOUND_DEG}) trans_err={trans:.5f} (bound "
        f"{TRANS_BOUND}) " + " ".join(f"{k}={int(v)}"
                                      for k, v in counters.items()))
    if not success:
        raise AssertionError(f"{label}: registration failed")
    if rot >= ROT_BOUND_DEG or trans >= TRANS_BOUND:
        raise AssertionError(f"{label}: pose error out of bounds")
    if any(int(v) for v in counters.values()):
        raise AssertionError(f"{label}: truncation counter set {counters}")


def _timed(fn, *args, reps: int = 3):
    """(result, mean seconds) of ``fn(*args)`` after one warm-up call,
    each call fenced by block_until_ready."""
    import jax
    out = jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = jax.block_until_ready(fn(*args))
    return out, (time.perf_counter() - t0) / reps


def check_nn(label, got_d, q, r, got_i=None, qn=None, rn=None,
             normal_cos=0.0, rows: int = 512, seed: int = 0) -> None:
    """Distances (and argmins) of a nearest-neighbour search against
    float64 numpy on ``rows`` sampled query rows."""
    got_d = np.asarray(got_d)
    sel = np.random.default_rng(seed).choice(q.shape[0], rows, replace=False)
    q64 = np.asarray(q, np.float64)[sel]
    r64 = np.asarray(r, np.float64)
    d64 = ((q64[:, None, :] - r64[None, :, :]) ** 2).sum(-1)
    if qn is not None:
        gate = (np.asarray(qn, np.float64)[sel]
                @ np.asarray(rn, np.float64).T) >= normal_cos
        d64 = np.where(gate, d64, np.inf)
    best = d64.min(1)
    fin = np.isfinite(best)
    if not np.array_equal(fin, np.isfinite(got_d[sel])):
        raise AssertionError(f"{label}: gated rows differ")
    np.testing.assert_allclose(got_d[sel][fin], best[fin], rtol=NN_RTOL,
                               atol=NN_ATOL, err_msg=label)
    if got_i is not None:
        # argmin: equal, or a tie within the distance tolerance
        picked = d64[np.arange(rows), np.asarray(got_i)[sel]]
        if not np.all(picked <= best * (1 + NN_RTOL) + NN_ATOL):
            raise AssertionError(f"{label}: argmin off a tie")
    log(f"{label}: matches float64 on {rows} sampled rows (rtol {NN_RTOL}, "
        f"atol {NN_ATOL}; float32 diff form, no TF32)")


def phase_nn(cfg, pair, card: str) -> None:
    """Phase 2: the nearest-neighbour searches as compiled for the card,
    at the widths the pipeline calls them, against float64 numpy."""
    import jax
    import jax.numpy as jnp

    from plade_tpu.knn import bruteforce
    from plade_tpu.verify import overlap

    tp, tn, _, _, _ = pair
    rng = np.random.default_rng(0)
    T = cfg.max_ds_points
    pick = rng.choice(tp.shape[0], T, replace=False)
    r = jnp.asarray(tp[pick])
    rn = jnp.asarray(tn[pick])
    cos = float(cfg.overlap_normal_cos)

    def queries(n):
        src = rng.integers(0, T, n)
        q = tp[pick][src] + rng.normal(scale=0.02, size=(n, 3))
        return (jnp.asarray(q.astype(np.float32)),
                jnp.asarray(tn[pick][src]))

    # exact overlap and the rescore's tight overlap: oriented, K poses of
    # the downsampled source stacked into one query array
    for name, k in (("exact_overlap", cfg.overlap_exact_k),
                    ("rescore", cfg.rescore_top_k)):
        q, qn = queries(k * T)
        got, sec = _timed(jax.jit(
            lambda a, b: overlap.oriented_min_dist_sq(a, b, r, rn, cos)),
            q, qn)
        check_nn(f"phase2 {name} {k}x{T} queries vs {T} refs", got, q, r,
                 qn=qn, rn=rn, normal_cos=cos)
        log(f"phase2 {name}: {sec * 1e3:.3f} ms [{card}]")

    # rescore ICP: nearest neighbour + argmin, vmapped over the modes
    K = cfg.rescore_top_k
    S = T // max(1, cfg.rescore_icp_subsample)
    q, _ = queries(K * S)
    (d, i), sec = _timed(jax.jit(jax.vmap(
        lambda a: bruteforce.nearest_neighbor(a, r))), q.reshape(K, S, 3))
    check_nn(f"phase2 icp {K}x{S} queries vs {T} refs", d.reshape(-1), q, r,
             got_i=i.reshape(-1))
    log(f"phase2 icp: {sec * 1e3:.3f} ms [{card}]")


def compile_step(cfg, pair, card: str):
    """Lower and compile the full single-pair step; prints its
    memory_analysis.  Returns (compiled, args, compile seconds)."""
    import jax

    from plade_tpu.core.types import pad_cloud
    from plade_tpu.pipeline import _pad_size, build_register_device_fn

    tp, tn, sp, sn, _ = pair
    pad = _pad_size(max(tp.shape[0], sp.shape[0]), maximum=cfg.max_points)
    args = (pad_cloud(tp, tn, pad), pad_cloud(sp, sn, pad),
            jax.random.PRNGKey(0))
    t0 = time.perf_counter()
    compiled = jax.jit(build_register_device_fn(cfg, pad)).lower(
        *args).compile()
    compile_s = time.perf_counter() - t0
    log(f"phase2 single-pair step ({pad} points) memory_analysis: "
        f"{compiled.memory_analysis()}")
    log(f"phase2 single-pair step compile_s={compile_s:.3f} [{card}]")
    return compiled, args, compile_s


def read_result(path: str) -> np.ndarray:
    """The 4x4 transform of a single-pair CLI result file."""
    with open(path) as f:
        lines = f.read().splitlines()
    at = lines.index("transformation:") + 1
    return np.asarray([l.split() for l in lines[at:at + 4]], np.float64)


def phase_single_pair(cfg, pair, workdir: str, seed: int = 0) -> None:
    """Phase 3: PLY in, 4x4 out, through register_files and the CLI."""
    from plade_tpu.cli.main import main as cli_main
    from plade_tpu.io.ply import write_ply
    from plade_tpu.pipeline import register_files

    tp, tn, sp, sn, T_gt = pair
    tgt = os.path.join(workdir, "target.ply")
    src = os.path.join(workdir, "source.ply")
    write_ply(tgt, tp, tn)
    write_ply(src, sp, sn)

    t0 = time.perf_counter()
    T, info = register_files(tgt, src, cfg, seed)
    log(f"phase3 register_files wall_s={time.perf_counter() - t0:.3f} "
        "(first call, compiles included)")
    # info carries cloud_capped as a dict, and only when a cloud was capped
    check_pose("phase3 register_files", T, T_gt, bool(info.get("success")),
               {k: bool(info.get(k, 0)) if k == "cloud_capped"
                else info.get(k, 0) for k in COUNTERS})

    out = os.path.join(workdir, "result.txt")
    t0 = time.perf_counter()
    rc = cli_main([tgt, src, out, "--seed", str(seed)])
    log(f"phase3 cli rc={rc} wall_s={time.perf_counter() - t0:.3f}")
    if rc != 0:
        raise AssertionError(f"phase3 cli: exit code {rc}")
    check_pose("phase3 cli", read_result(out), T_gt, True, {})


def register_pairs(label: str, cfg, pairs, mesh, seed: int = 0):
    """register_array_pairs over ``pairs`` on ``mesh``; checks every pair
    and returns the outcomes."""
    from plade_tpu.dist.mesh import register_array_pairs

    t0 = time.perf_counter()
    outcomes = register_array_pairs([p[:4] for p in pairs], cfg, seed,
                                    mesh=mesh)
    log(f"{label}: {len(pairs)} pairs on mesh {dict(mesh.shape)} "
        f"wall_s={time.perf_counter() - t0:.3f} (compiles included)")
    for i, (o, p) in enumerate(zip(outcomes, pairs)):
        check_pose(f"{label} pair {i}", o.transform, p[4], o.success,
                   {k: getattr(o, k) for k in COUNTERS})
    return outcomes


def phase_four_cards(cfg, pairs, seed: int = 0) -> None:
    """Phase 5: the pairs mesh over four cards against card 0 alone."""
    import jax

    from plade_tpu.dist.mesh import make_mesh

    if len(jax.devices()) < 4:
        raise SystemExit(f"chip_smoke: --four-cards needs 4 GPUs, JAX has "
                         f"{len(jax.devices())}")
    four = register_pairs("phase5 four cards", cfg, pairs,
                          make_mesh(4, intra=1), seed)
    one = register_pairs("phase5 card 0", cfg, pairs, make_mesh(1), seed)
    for i, (a, b) in enumerate(zip(four, one)):
        rot, trans = pose_errors(a.transform, np.asarray(b.transform))
        log(f"phase5 pair {i}: success {a.success}/{b.success} "
            f"four-vs-one rot_deg={rot:.4f} (bound {AGREE_ROT_DEG}) "
            f"trans={trans:.5f} (bound {AGREE_TRANS})")
        if a.success != b.success or rot >= AGREE_ROT_DEG \
                or trans >= AGREE_TRANS:
            raise AssertionError(f"phase5 pair {i}: four cards disagree "
                                 "with one")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--four-cards", action="store_true",
                        help="run only phase 5 on a four-card pairs mesh")
    args = parser.parse_args(argv)

    cards = card_lines()
    for line in cards:
        log(f"card: {line}")
    card = cards[0]

    import jax

    from plade_tpu.utils.cache import enable_compile_cache
    log(f"compile cache: {enable_compile_cache()}")
    devices = jax.devices()
    check_devices(devices)
    log(f"phase1 devices: {devices[0].device_kind} x{len(devices)}")

    from plade_tpu.core.config import PladeConfig
    from plade_tpu.dist.mesh import make_mesh

    cfg = PladeConfig()
    if args.four_cards:
        phase_four_cards(cfg, [make_pair(s) for s in SEEDS])
    else:
        pair = make_pair(SEEDS[0])
        phase_nn(cfg, pair, card)
        compiled, step_args, compile_s = compile_step(cfg, pair, card)
        res = jax.block_until_ready(compiled(*step_args))
        _, steady_s = _timed(compiled, *step_args, reps=1)
        check_pose("phase3 single-pair step", res.transform, pair[4],
                   bool(res.success),
                   {k: getattr(res, k) for k in COUNTERS[:3]})
        peak = devices[0].memory_stats()["peak_bytes_in_use"]
        log(f"phase3 single-pair step compile_s={compile_s:.3f} "
            f"steady_s={steady_s:.4f} peak_bytes_in_use={peak} [{card}]")
        with tempfile.TemporaryDirectory() as workdir:
            phase_single_pair(cfg, pair, workdir)
        register_pairs("phase4 batch", cfg,
                       [pair] + [make_pair(s) for s in SEEDS[1:4]],
                       make_mesh(1))
    log(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

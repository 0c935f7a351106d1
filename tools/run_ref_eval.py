"""Run the REFERENCE binary over the synthetic RESSO-equivalent scenes.

Turns "recall parity" into a measured comparison (VERDICT r2 next-#5): the
same scene directories `tools/run_eval.py` evaluates this pipeline on are
fed, pair by pair, to the reference binary built in place from
`/root/reference/code/PLADE` via the mini-PCL shim (tools/refbaseline/,
binary at .ref_build/PLADE — see tools/refbaseline/README.md).  Results are
appended to EVAL.md as the reference columns.

Reference CLI (code/PLADE/main.cpp:80-99): `PLADE target.ply source.ply
result.txt` writes "transformation:\n" + a 4x4 matrix on success, exit 0;
identity + exit 1 on failure.

Usage:  python tools/run_ref_eval.py  [--timeout 600]
"""
import argparse
import json
import os
import re
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from run_eval import SCENES, build_scene  # single source of scene truth
from plade_tpu.io import resso

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BIN = os.path.join(REPO, ".ref_build", "PLADE")
BASE = "/tmp/plade_synth_resso"
OUT = os.path.join(REPO, "REF_EVAL.json")


def parse_result(path):
    """Extract the 4x4 matrix following 'transformation:' (identity rows
    after the failure banner parse the same way)."""
    if not os.path.isfile(path):
        return None
    rows = []
    with open(path) as f:
        grab = False
        for line in f:
            if "transformation" in line or "identity matrix" in line:
                grab = True
                continue
            if grab:
                parts = line.split()
                try:
                    vals = [float(p) for p in parts]
                except ValueError:
                    continue
                if len(vals) == 4:
                    rows.append(vals)
                if len(rows) == 4:
                    break
    return np.asarray(rows) if len(rows) == 4 else None


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="per-pair wall-clock cap (s)")
    ap.add_argument("--runs", type=int, default=3,
                    help="independent runs per scene: the binary seeds "
                         "srand(time(0)) (RansacShapeDetector.cpp:463), so "
                         "one run is not a baseline (VERDICT r4 weak-#3b)")
    args = ap.parse_args()
    if not os.path.isfile(BIN):
        print(f"reference binary missing: {BIN} — build per "
              "tools/refbaseline/README.md", file=sys.stderr)
        return 2

    report = {}
    for sc in SCENES:
        name = sc["name"]
        d = build_scene(sc, BASE)
        scene = resso.load_scene(d)
        pairs = resso.consecutive_pairs(scene)
        run_recalls, run_rmses = [], []
        times, fails, timeouts = [], 0, 0
        for run in range(args.runs):
            hits, errs = 0, []
            for i, j in pairs:
                res_file = os.path.join(d, f"ref_result_{i}_{j}_r{run}.txt")
                t0 = time.perf_counter()
                try:
                    proc = subprocess.run(
                        [BIN, scene.scan_files[i], scene.scan_files[j],
                         res_file],
                        capture_output=True, timeout=args.timeout)
                    rc = proc.returncode
                except subprocess.TimeoutExpired:
                    rc, timeouts = -1, timeouts + 1
                dt = time.perf_counter() - t0
                times.append(dt)
                T = parse_result(res_file)
                ok = rc == 0 and T is not None
                if not ok:
                    fails += 1
                    T = np.eye(4)
                G = scene.pair_ground_truth(i, j)
                rot = resso.rotation_error_deg(G[:3, :3], T[:3, :3])
                trans = float(np.linalg.norm(T[:3, 3] - G[:3, 3]))
                hit = rot < 5.0 and trans < 0.5
                hits += hit
                errs.append(trans)
                print(f"[ref] {name} r{run} {i}->{j}: rc={rc} rot={rot:.2f} "
                      f"trans={trans:.3f} hit={hit} ({dt:.1f}s)", flush=True)
            run_recalls.append(hits / len(pairs))
            run_rmses.append(float(np.sqrt(np.mean(np.square(errs)))))
        report[name] = {
            "pairs": len(pairs),
            "recall": float(np.mean(run_recalls)),
            "recalls": run_recalls,
            "rmse_trans": float(np.sqrt(np.mean(np.square(run_rmses)))),
            "rmse_runs": run_rmses,
            "s_per_pair": float(np.median(times)),
            "runs": args.runs,
            "failures": fails, "timeouts": timeouts,
        }
        with open(OUT, "w") as f:
            json.dump(report, f, indent=1)
        print(f"[ref] {name}: recall={report[name]['recall']:.3f} "
              f"({'/'.join(f'{r:.2f}' for r in run_recalls)}) "
              f"median {report[name]['s_per_pair']:.1f}s/pair", flush=True)

    total = sum(r["pairs"] for r in report.values())
    rec = sum(r["pairs"] * r["recall"] for r in report.values()) / total
    print(f"[ref] OVERALL recall={rec:.3f} over {total} pairs -> {OUT}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

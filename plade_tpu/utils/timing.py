"""Stage timing + profiling hooks.

Device-aware counterpart of the reference's ``StopWatch`` wall timers
(code/PLADE/util.cpp:1682-1765, used around every pipeline stage at
plade.cpp:72,542,577) and console progress bar (util.cpp:1651-1669).
Device work is asynchronous, so a useful stage timer must
``block_until_ready`` on the stage's outputs; ``jax.profiler`` traces are
exposed for kernel-level work.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Any

import jax

_records: dict[str, list[float]] = defaultdict(list)


class StopWatch:
    """Wall timer with the reference's human-readable formatting
    (util.cpp:1736-1765)."""

    def __init__(self):
        self.start()

    def start(self):
        self._t0 = time.perf_counter()

    def elapsed_seconds(self) -> float:
        return time.perf_counter() - self._t0

    def time_string(self) -> str:
        s = self.elapsed_seconds()
        if s < 1e-3:
            return f"{s * 1e6:.0f} us"
        if s < 1.0:
            return f"{s * 1e3:.1f} ms"
        if s < 60.0:
            return f"{s:.2f} s"
        m, sec = divmod(s, 60.0)
        if m < 60:
            return f"{int(m)} m {sec:.1f} s"
        h, m = divmod(m, 60.0)
        return f"{int(h)} h {int(m)} m {sec:.0f} s"


@contextlib.contextmanager
def stage(name: str, *, sync: Any = None, verbose: bool = False):
    """Time a pipeline stage; ``sync`` (a pytree of arrays) is blocked on
    before stopping the clock so device work is included."""
    w = StopWatch()
    out: dict[str, Any] = {}
    try:
        yield out
    finally:
        target = out.get("sync", sync)
        if target is not None:
            jax.block_until_ready(target)
        dt = w.elapsed_seconds()
        _records[name].append(dt)
        if verbose:
            print(f"[plade] {name}: {w.time_string()}", flush=True)


def stage_report(reset: bool = False) -> dict[str, dict[str, float]]:
    """Summary of recorded stage timings: {name: {count,total,mean,last}}."""
    rep = {}
    for name, xs in _records.items():
        rep[name] = {"count": len(xs), "total": sum(xs),
                     "mean": sum(xs) / len(xs), "last": xs[-1]}
    if reset:
        _records.clear()
    return rep


def print_progress(fraction: float, width: int = 50):
    """Console progress bar (reference print_progress, util.cpp:1651-1669)."""
    fraction = min(max(fraction, 0.0), 1.0)
    n = int(fraction * width)
    bar = "#" * n + "-" * (width - n)
    print(f"\r[{bar}] {fraction * 100.0:5.1f}%", end="", flush=True)
    if fraction >= 1.0:
        print(flush=True)


@contextlib.contextmanager
def profiler_trace(logdir: str):
    """jax.profiler trace around a block (view with TensorBoard/XProf)."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()

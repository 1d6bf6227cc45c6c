"""Wall-clock measurement helpers (port of ``stochquant_tpu.timing``): one
copy of the paired-timing harness, so tools that time the port compare like
with like.

A call on the card returns before its kernels end: a ``run`` that times the
device's work synchronises before it returns.
"""

from __future__ import annotations

import time

__all__ = ["timeit", "ab_timeit"]


def _timed(run) -> float:
    t0 = time.perf_counter()
    run()
    return time.perf_counter() - t0


def timeit(run, reps=5):
    """Median of ``reps`` timed calls (after one warm call), plus the
    (min, max) spread: the spread is reported, not hidden."""
    run()
    ts = sorted(_timed(run) for _ in range(reps))
    return ts[len(ts) // 2], ts[0], ts[-1]


def ab_timeit(runs, reps=5):
    """Paired A/B timing in one process: warm every variant once, then take
    the timed reps in turns so drift of the machine hits every variant alike.
    Returns {name: (median, min, max)}."""
    for r in runs.values():
        r()
    ts = {k: [] for k in runs}
    for _ in range(reps):
        for k, r in runs.items():
            ts[k].append(_timed(r))
    return {k: (sorted(v)[len(v) // 2], min(v), max(v)) for k, v in ts.items()}

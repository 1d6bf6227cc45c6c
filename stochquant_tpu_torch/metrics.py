"""Structured metrics streaming.

Replaces the reference's '|'-separated stdout protocol (``tauhost.c:485-501``
→ parsed by ``taumain.py:27-48``) with JSON-lines records carrying step, Δτ,
acceptance, throughput and observables.  A sink can be a file, stdout, or a
callback (the live-plot client in viz.py consumes the same records).
"""

from __future__ import annotations

import json
import sys
import time
from typing import Callable, IO, Optional

import numpy as np


class MetricsSink:
    """JSON-lines metrics writer with throughput accounting on the monotonic
    clock (``time.perf_counter``); ``wall_time`` is seconds since the sink
    was made."""

    def __init__(self, stream: Optional[IO] = None, callback: Optional[Callable] = None):
        self.stream = stream
        self.callback = callback
        self._t0 = time.perf_counter()
        self._last_t = self._t0
        self._updates = 0
        self._first = None  # (time, updates) at the first frame record

    def emit(self, record: dict) -> None:
        record = dict(record)
        record.setdefault("wall_time", round(time.perf_counter() - self._t0, 3))
        if self.stream is not None:
            self.stream.write(json.dumps(record, default=_np_default) + "\n")
            self.stream.flush()
        if self.callback is not None:
            self.callback(record)

    def frame(
        self,
        frame_idx: int,
        n_frames: int,
        site_updates: int,
        dtau,
        stable_frac: float,
        observables: Optional[dict] = None,
    ) -> None:
        now = time.perf_counter()
        dt_wall = max(now - self._last_t, 1e-9)
        self._last_t = now
        self._updates += site_updates
        if self._first is None:
            self._first = (now, self._updates)
        rec = {
            "type": "frame",
            "frame": frame_idx,
            "percent": round(100.0 * (frame_idx + 1) / n_frames, 2),
            "dtau": float(np.mean(dtau)),
            "stable_frac": float(stable_frac),
            "mlups": round(site_updates / dt_wall / 1e6, 1),
        }
        if observables:
            rec.update(observables)
        self.emit(rec)

    def summary(self) -> dict:
        """Totals since the sink was made; ``avg_mlups`` is the rate after
        the first frame record (the updates recorded since, over the time
        since), which leaves out set-up and the burn-in: None before a
        second record."""
        now = time.perf_counter()
        avg = None
        if self._first is not None and self._updates > self._first[1]:
            t, u = self._first
            avg = round((self._updates - u) / (now - t) / 1e6, 1)
        return {
            "type": "summary",
            "total_site_updates": self._updates,
            "elapsed_s": round(now - self._t0, 3),
            "avg_mlups": avg,
        }


def _np_default(o):
    if isinstance(o, (np.floating, np.integer)):
        return o.item()
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(f"not JSON serializable: {type(o)}")


def stdout_sink() -> MetricsSink:
    return MetricsSink(stream=sys.stdout)

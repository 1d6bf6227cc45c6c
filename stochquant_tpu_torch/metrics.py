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
    """JSON-lines metrics writer with wall-clock throughput accounting."""

    def __init__(self, stream: Optional[IO] = None, callback: Optional[Callable] = None):
        self.stream = stream
        self.callback = callback
        self._t0 = time.time()
        self._last_t = self._t0
        self._updates = 0

    def emit(self, record: dict) -> None:
        record = dict(record)
        record.setdefault("wall_time", round(time.time() - self._t0, 3))
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
        now = time.time()
        dt_wall = max(now - self._last_t, 1e-9)
        self._last_t = now
        self._updates += site_updates
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
        elapsed = time.time() - self._t0
        return {
            "type": "summary",
            "total_site_updates": self._updates,
            "elapsed_s": round(elapsed, 3),
            "avg_mlups": round(self._updates / elapsed / 1e6, 1) if elapsed else 0.0,
        }


def _np_default(o):
    if isinstance(o, (np.floating, np.integer)):
        return o.item()
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(f"not JSON serializable: {type(o)}")


def stdout_sink() -> MetricsSink:
    return MetricsSink(stream=sys.stdout)

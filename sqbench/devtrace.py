"""Reading a ``torch.profiler`` trace of the window: the device's operations
and the host's, between two markers the harness records at streamed records
(where the device has just finished: a record reads its correlator back).

Busy time is the union of the device operations' intervals (kernels, copies
and sets), as ``chip_smoke.device_profile`` sums them, so that
1 − busy / window is the device's idle share of the same window.  An idle gap
is an interval between device operations; it is named by the innermost host
operation running at its midpoint, or by the Python between operations.
"""

from __future__ import annotations

import collections

OPEN, CLOSE = "sqbench.window_open", "sqbench.trace_close"
NO_OP = "(Python between ops)"


def _ns(ev, which: str) -> int:
    fn = getattr(ev, f"{which}_ns", None)
    if fn is not None:
        return int(fn())
    return int(getattr(ev, f"{which}_us")() * 1000)


def mark(torch, name: str) -> None:
    """A zero-length host marker in the trace."""
    with torch.profiler.record_function(name):
        pass


class Trace:
    """The device and host operations of the traced window."""

    def __init__(self, torch, prof):
        cuda = torch.autograd.DeviceType.CUDA
        events = prof.profiler.kineto_results.events()
        host, device, marks = [], [], {}
        for ev in events:
            name = ev.name()
            start = _ns(ev, "start")
            end = start + int(ev.duration_ns()) if hasattr(ev, "duration_ns") else _ns(ev, "end")
            if ev.device_type() == cuda:
                if not name.startswith("sqbench."):
                    device.append((start, end, name))
            elif name in (OPEN, CLOSE):
                marks.setdefault(name, start)
            else:
                host.append((start, end, name, ev.start_thread_id()))
        self.t0, self.t1 = marks[OPEN], marks[CLOSE]
        self.window_s = (self.t1 - self.t0) * 1e-9
        self.device = sorted(e for e in device if self.t0 <= e[0] < self.t1)
        threads = collections.Counter(e[3] for e in host)
        main = threads.most_common(1)[0][0] if threads else None
        self.host = sorted(((s, e, n) for s, e, n, t in host
                            if t == main and e > self.t0 and s < self.t1),
                           key=lambda h: (h[0], -h[1]))  # outer before inner
        self.busy_s, self.gaps = self._busy_and_gaps()

    def _busy_and_gaps(self):
        busy, gaps, cursor = 0, [], self.t0
        for start, end, _ in self.device:
            end = min(end, self.t1)
            if start > cursor:
                gaps.append((cursor, start))
            if end > cursor:
                busy += end - max(start, cursor)
                cursor = end
        if cursor < self.t1:
            gaps.append((cursor, self.t1))
        return busy * 1e-9, gaps

    def launches(self, match: str) -> list:
        """Seconds of each device operation whose name contains ``match``."""
        return [(e - s) * 1e-9 for s, e, n in self.device if match in n]

    def device_seconds(self, exclude=()) -> float:
        """Device time of every operation whose name contains none of ``exclude``."""
        return sum((e - s) * 1e-9 for s, e, n in self.device
                   if not any(m in n for m in exclude))

    def top_device_ops(self, k: int = 10) -> list:
        by = collections.Counter()
        for s, e, n in self.device:
            by[n] += (e - s) * 1e-9
        return [[n, t] for n, t in by.most_common(k)]

    def top_idle_gaps(self, k: int = 10) -> list:
        """Idle seconds summed by the host operation running at each gap's
        midpoint (a sweep over the main thread's nested operations)."""
        by = collections.Counter()
        stack, i = [], 0
        for a, b in sorted(self.gaps, key=lambda g: (g[0] + g[1]) / 2):
            t = (a + b) / 2
            while i < len(self.host) and self.host[i][0] <= t:
                while stack and stack[-1][1] <= self.host[i][0]:
                    stack.pop()
                stack.append(self.host[i])
                i += 1
            while stack and stack[-1][1] < t:
                stack.pop()
            by[stack[-1][2] if stack else NO_OP] += (b - a) * 1e-9
        return [[n, t] for n, t in by.most_common(k)]

"""The device's idle time split among the program's spans.

The program marks a span of its host loop by two zero-length host markers on
the main thread, ``<span>`` on entry and ``<span>/end`` on exit, with
``<span>`` starting ``sq.`` (``stochquant_tpu_torch/tracing.py``).  Each idle
interval of the traced window is cut at the markers, and each piece is
credited to the innermost span open at that moment, or to ``loop`` where
none is.  A span that the window's ends cut counts for its part inside the
window: an exit whose entry came before the window opened was open from its
start, an entry without its exit is open to its end.  Every piece of every
idle interval goes to one name, so the names' sums add up to the window's
idle time.

The profiler stamps the device's operations on the device's clock mapped to
the host's, and on the card that mapping can be off by milliseconds and drift
within a window: a kernel then starts before the call that launched it.  So
each idle interval is first put on the host's clock.  Where a chain kernel
(kernels 1 and 2) ends an idle interval, the device was idle when it was
launched, and the offset is the kernel's start less the start of its launch
call: the first ``cudaLaunchKernel`` inside an ``sq.launch`` span, the one
nearest the kernel's start less the previous offset (so a drifting offset is
followed, from 0 at the window's first).  Between such points the offset is
interpolated, beyond them held, and each interval moves whole by the offset
at its end.  The launch's own latency (the kernel starts some µs after its
call does) moves with it, from the launch span to the span before the
interval.  Where the offset at the window's start exceeds half a record, the
kernels pair with calls a record away and the intervals land there, at the
same place in their record.
"""

from __future__ import annotations

import bisect

PREFIX, END = "sq.", "/end"
LAUNCH = "sq.launch"
#: the host's launch call, as the profiler names it
CALL = "cudaLaunchKernel"
LOOP = "loop"
#: the kernels whose launches align the device's clock to the host's
KERNELS = ("chain_frame", "chain_frames_multi")


def markers(host) -> list:
    """(time ns, span name, entering) of each span marker among host events
    (start, end, name), in time order.  A span runs from its entry marker's
    start to its exit marker's end."""
    out = []
    for s, e, n in host:
        if n.startswith(PREFIX):
            if n.endswith(END):
                out.append((e, n[:-len(END)], False))
            else:
                out.append((s, n, True))
    return sorted(out, key=lambda m: m[0])


def _close(stack: list, name: str) -> bool:
    """Pop the innermost open ``name`` and what opened inside it; False where
    ``name`` is not open."""
    if name not in stack:
        return False
    del stack[len(stack) - 1 - stack[::-1].index(name):]
    return True


def _open_at_start(marks) -> list:
    """Spans open when the window opened, outermost first: those whose exit
    comes with no entry before it."""
    stack, unmatched = [], []
    for _, name, entering in marks:
        if entering:
            stack.append(name)
        elif not _close(stack, name):
            unmatched.append(name)
    return unmatched[::-1]


def segments(marks) -> list:
    """(start, end, name) covering all time: the innermost span open, or
    LOOP; before the first marker the spans open at the window's start, after
    the last those still open."""
    stack = _open_at_start(marks)
    out, cursor = [], float("-inf")
    for t, name, entering in marks:
        if t > cursor:
            out.append((cursor, t, stack[-1] if stack else LOOP))
            cursor = t
        if entering:
            stack.append(name)
        else:
            _close(stack, name)
    out.append((cursor, float("inf"), stack[-1] if stack else LOOP))
    return out


def launch_calls(host) -> list:
    """Start ns of the first launch call inside each ``sq.launch`` span, in
    time order (host events (start, end, name), outer before inner)."""
    out, depth, taken = [], 0, False
    for s, _, n in host:
        if n == LAUNCH:
            depth, taken = depth + 1, False
        elif n == LAUNCH + END:
            depth = max(depth - 1, 0)
        elif n == CALL and depth and not taken:
            out.append(s)
            taken = True
    return out


def offsets(gaps, kernel_starts, calls) -> list:
    """(device ns, offset ns) at each idle interval (in time order) that a
    kernel of ``kernel_starts`` ends: its start less the one of ``calls``
    nearest to it less the previous offset."""
    points, last = [], 0
    for _, b in gaps:
        if b in kernel_starts and calls:
            want = b - last
            i = bisect.bisect_left(calls, want)
            last = b - min(calls[max(i - 1, 0):i + 1], key=lambda c: abs(c - want))
            points.append((b, last))
    return points


def offset_at(points, t) -> float:
    """The offset at device time ``t``: linear between points, held beyond
    (rounded by the caller: a float holds ns since the epoch to 256 ns)."""
    if not points:
        return 0
    i = bisect.bisect_left(points, (t,))
    if i == 0:
        return points[0][1]
    if i == len(points):
        return points[-1][1]
    (ta, oa), (tb, ob) = points[i - 1], points[i]
    return oa + (ob - oa) * (t - ta) / (tb - ta)


def idle_by_span(marks, gaps, points=()) -> dict:
    """Idle ns of the device's idle intervals ``gaps``, each moved by the
    offset at its end (``points``, from :func:`offsets`), by span name."""
    moved = sorted((a - o, b - o) for a, b in gaps for o in (round(offset_at(points, b)),))
    by, i = {}, 0
    segs = segments(marks)
    for a, b in moved:
        while segs[i][1] <= a:
            i += 1
        j = i
        while j < len(segs) and segs[j][0] < b:
            s, e, name = segs[j]
            by[name] = by.get(name, 0) + min(b, e) - max(a, s)
            j += 1
    return by


def idle_ms_per_record(ctx, name: str):
    """Device idle ms a record while the host was in span ``name`` (LOOP:
    outside every span); None where the trace holds no device operation or
    no span marker (a program without spans)."""
    tr = ctx.trace
    if not tr.device or not ctx.frames:
        return None
    marks = markers(tr.host)
    if not marks:
        return None
    matches = [ctx.kernel(k)["match"] for k in KERNELS]
    starts = {s for s, _, n in tr.device if any(m in n for m in matches)}
    points = offsets(tr.gaps, starts, launch_calls(tr.host))
    records = ctx.frames / ctx.cell.fps
    return 1e-6 * idle_by_span(marks, tr.gaps, points).get(name, 0) / records

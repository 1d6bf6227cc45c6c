"""The device's idle time of a field cell split among the program's spans:
``_spans.py``'s markers, segments and idle split, with the device's clock put
on the host's at the 2-D field kernels' launches (kernels 3 and 4).

The profiler's device clock can be off the host's by hundreds of
milliseconds, and drift within a window by a millisecond a second
(``_spans.py``; the field cells' traces show both).  A field kernel that ends
an idle interval of the device, and whose launch call the host made inside
that interval, started a launch latency after its call: there the offset is
the kernel's start less the call's start.  A kernel that the device ran from
its queue also ends an idle interval when the device idled behind other work,
but its call came before the interval: there the offset says nothing, and no
alignment is made.

So the offsets are tracked from interval to interval.  At each interval a
field kernel ends, the kernel's call is taken to be the last field launch
call before the kernel's start on the host's clock (by the last offset, with
``JITTER`` of room for the offset's move since); where that call lies inside
the interval (within ``SLACK`` of its start), the offset becomes the kernel's
start less the call's start, else the interval aligns nothing.  The field
launch calls are the launch calls the host makes at the top level of an
``sq.launch`` span, outside every other host operation: the wrapper's own
launch through ``kernels/_build.launch``; a PyTorch operation inside the
wrapper (``torch.stack``, ``!= 0``) launches its kernel inside its own host
operation.

The first offset is chosen among the first kernel-ended intervals'
kernels' starts less the calls' starts within ``REACH`` of each other: the
one from which the tracking aligns the most of the first ``FIRST``
intervals, and of those the one whose offsets move least from interval to
interval (then the nearest to 0).  Paired with its own call, a kernel's
offset moves by the clocks' drift and the launch's jitter; paired with a
call records away, it moves by how much those records differ in length too.
Where the records do not differ, a record later or earlier is the same
place in its record, and the split a record is the same.
"""

from __future__ import annotations

import bisect

from sqbench.layer_metrics import _spans

#: the kernels whose launches align the device's clock to the host's
KERNELS = ("field_frame", "field_frames_multi")
#: room, in ns, for the offset's move between two aligned intervals
JITTER = 200_000
#: room, in ns, before an interval's start for a call inside it
SLACK = 50_000
#: how far apart, in ns, the first offset's search pairs kernels and calls
REACH = 1_000_000_000
#: the kernel-ended intervals the first offset is chosen on
FIRST = 16


def launch_calls(host) -> list:
    """Start ns of each launch call at the top level of an ``sq.launch`` span
    (host events (start, end, name), outer before inner), in time order."""
    out, depth, stack = [], 0, []
    for s, e, n in host:
        if n == _spans.LAUNCH:
            depth += 1
            continue
        if n == _spans.LAUNCH + _spans.END:
            depth = max(depth - 1, 0)
            continue
        if n.startswith(_spans.PREFIX):
            continue
        while stack and stack[-1] <= s:
            stack.pop()
        if "LaunchKernel" in n and depth and not stack:
            out.append(s)
        stack.append(e)
    return sorted(out)


def _track(ended, calls, o) -> list:
    """(device ns, offset ns) at each of the kernel-ended intervals ``ended``
    whose kernel's call lies inside it, tracking the offset from ``o``."""
    points = []
    for a, b in ended:
        i = bisect.bisect_right(calls, b - o + JITTER) - 1
        if i < 0 or calls[i] < a - o - SLACK:
            continue
        o = b - calls[i]
        points.append((b, o))
    return points


def first_offset(ended, calls):
    """The offset (ns) from which :func:`_track` aligns the most of
    ``ended``, of those the one whose offsets move least from interval to
    interval, the nearest to 0 among equals; None where none aligns."""
    best = None
    for _, b in ended[:3]:
        lo, hi = bisect.bisect_left(calls, b - REACH), bisect.bisect_right(calls, b + REACH)
        for c in calls[lo:hi]:
            o = b - c
            offs = [p for _, p in _track(ended, calls, o)]
            if not offs:
                continue
            moved = sum(abs(y - x) for x, y in zip(offs, offs[1:]))
            score = (len(offs), -moved, -abs(o))
            if best is None or score > best[0]:
                best = (score, o)
    return None if best is None else best[1]


def offsets(gaps, kernel_starts, calls) -> list:
    """(device ns, offset ns) at each idle interval (in time order) that a
    kernel of ``kernel_starts`` ends and whose kernel's launch call (of
    ``calls``, in time order) lies inside it: the kernel's start less the
    call's start."""
    ended = [g for g in gaps if g[1] in kernel_starts]
    o = first_offset(ended[:FIRST], calls)
    return [] if o is None else _track(ended, calls, o)


def idle_ms_per_record(ctx, name: str):
    """Device idle ms a record while the host was in span ``name`` (LOOP:
    outside every span); None where the trace holds no device operation, no
    span marker or no interval that aligns the clocks."""
    tr = ctx.trace
    if not tr.device or not ctx.frames:
        return None
    marks = _spans.markers(tr.host)
    if not marks:
        return None
    matches = [ctx.kernel(k)["match"] for k in KERNELS]
    starts = {s for s, _, n in tr.device if any(m in n for m in matches)}
    points = offsets(tr.gaps, starts, launch_calls(tr.host))
    if not points:
        return None
    records = ctx.frames / ctx.cell.fps
    return 1e-6 * _spans.idle_by_span(marks, tr.gaps, points).get(name, 0) / records

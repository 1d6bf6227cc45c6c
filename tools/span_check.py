#!/usr/bin/env python3
"""The port's spans (``stochquant_tpu_torch/tracing.py``) on the card: the
shared clock, the device's operations left as they were, the idle split, and
what a span costs.

    python3 tools/span_check.py clock [--cells A,B] [--seconds 6] [--seed N]
    python3 tools/span_check.py cost [--n 200000]
    python3 tools/span_check.py records [--cells A,B] [--seconds 36] [--seed N]

``clock`` serves each benchmark cell (the ``Cell`` of its kind: a chain cell
through ``runtime.run_chain``, ``sqbench/kinds/chain.py``; a field cell through
``runtime.run_field``, ``sqbench/kinds/field.py``) under ``torch.profiler``
for ``--seconds`` after the first record, between the harness's window
markers, and reports for each:

* every kernel launch of the cell's kind in the window (chains: kernels 1 and
  2; fields: kernels 3 and 4; by the roofline files' names): whether the
  launch call that the profiler records on the
  host for it (joined by correlation id) lies between the enter and exit
  markers of one ``sq.launch`` span, and whether the kernel starts on the
  device after that span's enter marker, on the profiler's raw clocks;
  the kernel's start less its call's start by tenth of the window
  (``lag_us_by_tenth``: launch latency plus the device clock's error) and
  the call's median length;
* the device events that carry a span's name or are user annotations (none
  should);
* the idle split as the benchmark's readers give it (chains:
  ``launch_idle_ms``, ``record_idle_ms``, ``loop_idle_ms``, the device's
  clock put on the host's at each launch by ``layer_metrics/_spans.py``;
  fields: ``field_launch_idle_ms``, ``field_record_idle_ms`` and the loop's
  share, aligned by ``layer_metrics/_field_spans.py`` only where the launch
  call lies inside the idle interval; ``offset_us`` by decile), the same
  split without that (``split_unaligned``), and the window's idle ms a
  record (1 − busy / window, times the window, over the records) that they
  add up to.

``cost`` times ``tracing.span`` with no profiler (the shared no-op) and
under a CPU profiler (two markers), in ns a span.

``records`` serves each cell untraced, under the harness's window and stop
(``sqbench/run.py``'s ``Window``), and reports how the host loop read its
records: for a chain cell ``run_chain.records_ahead`` and
``records_drained``, for a field cell ``run_field.records``,
``run_field.readbacks`` (seven a record), ``run_field.records_ahead`` (records
read with the next group already enqueued) and ``run_field.records_drained``
(records read with nothing enqueued behind them), with the launches of kernels
3 and 4 (``field_frame.launches``, ``field_frames_multi.launches``); null where the
checkout has no such counter; the records streamed and those in the
window; on the card also the caching allocator's peaks
(``torch.cuda.memory_stats``), over the cell's set-up and window.

Each mode prints JSON lines on stdout, the card's name and power limit
first; ``--device cpu`` rehearses ``clock`` on the plain path (no kernel).
"""

from __future__ import annotations

import argparse
import importlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

CELLS = ("anh1024.c256.fpl1", "dw200.c65536.threefry", "anh1024.c256.fpl16",
         "dw200.c65536.threefry13", "phi4_256.c16.fpl10", "phi4_256.c16.fpl1")
#: by a cell's kind: the module that aligns the clocks and splits the idle
#: time, and the benchmark's readers of that split
SPLIT = {"chain": ("_spans", ("launch_idle_ms", "record_idle_ms", "loop_idle_ms")),
         "field": ("_field_spans", ("field_launch_idle_ms", "field_record_idle_ms"))}
#: by a cell's kind: the counters ``records`` reads, (module, function, attribute)
COUNTERS = {
    "chain": (("stochquant_tpu_torch.runtime", "run_chain", "records_ahead"),
              ("stochquant_tpu_torch.runtime", "run_chain", "records_drained")),
    "field": (("stochquant_tpu_torch.runtime", "run_field", "records"),
              ("stochquant_tpu_torch.runtime", "run_field", "readbacks"),
              ("stochquant_tpu_torch.runtime", "run_field", "records_ahead"),
              ("stochquant_tpu_torch.runtime", "run_field", "records_drained"),
              ("stochquant_tpu_torch.kernels.field_kernel", "field_frame", "launches"),
              ("stochquant_tpu_torch.kernels.field_kernel", "field_frames_multi", "launches")),
}


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip() or "no card"
    except (OSError, subprocess.SubprocessError):
        return "no card"


def _launch_spans(host) -> list:
    """(enter, exit) ns of each ``sq.launch`` span among one thread's host
    events (start, end, name), in time order."""
    from sqbench.layer_metrics import _spans
    from stochquant_tpu_torch import tracing

    spans, open_at = [], []
    for t, name, entering in _spans.markers(host):
        if name != tracing.LAUNCH:
            continue
        if entering:
            open_at.append(t)
        elif open_at:
            spans.append((open_at.pop(), t))
    return sorted(spans)


def _lags_by_tenth(lags, width: int) -> list:
    """[min, median, max] µs of (kernel start − launch call start) in each
    tenth of the window, by the call's time: the device's clock against the
    host's, plus the launch latency."""
    out = []
    for k in range(10):
        xs = sorted(lag for t, lag in lags if k * width <= 10 * t < (k + 1) * width)
        out.append([round(xs[0] / 1e3, 1), round(xs[len(xs) // 2] / 1e3, 1),
                    round(xs[-1] / 1e3, 1)] if xs else None)
    return out


def check_clock(events, t0: int, t1: int, matches) -> dict:
    """Every kernel launch named by ``matches`` in [t0, t1) against the
    ``sq.launch`` spans of the thread that launched it."""
    import bisect

    import torch

    from sqbench import devtrace

    cuda = torch.autograd.DeviceType.CUDA
    kernels, runtime_calls, marks = [], {}, {}
    on_device_named, annotations = [], set()
    for ev in events:
        name = ev.name()
        start = devtrace._ns(ev, "start")
        end = start + int(ev.duration_ns())
        if ev.device_type() == cuda:
            if name.startswith("sq."):
                on_device_named.append(name)
            if ev.is_user_annotation():
                annotations.add(name)
            if t0 <= start < t1 and any(m in name for m in matches):
                kernels.append((start, end, name, ev.correlation_id(), ev.linked_correlation_id()))
        elif name.startswith("sq."):
            marks.setdefault(ev.start_thread_id(), []).append((start, end, name))
        elif "Launch" in name:
            runtime_calls[ev.correlation_id()] = (start, end, name, ev.start_thread_id())
    spans = {t: _launch_spans(m) for t, m in marks.items()}
    ok, bad, calls, lags, durations = 0, [], set(), [], []
    for start, end, name, corr, linked in kernels:
        call = runtime_calls.get(corr) or runtime_calls.get(linked)
        if call is None:
            bad.append({"kernel": name[:60], "why": "no launch call with its correlation id"})
            continue
        calls.add(call[2])
        lags.append((call[0] - t0, start - call[0]))
        durations.append(call[1] - call[0])
        ts = spans.get(call[3], [])
        i = bisect.bisect_right(ts, (call[0], float("inf"))) - 1
        inside = i >= 0 and ts[i][0] <= call[0] and call[1] <= ts[i][1]
        if inside and start > ts[i][0]:
            ok += 1
        else:
            bad.append({"kernel": name[:60], "call": [call[0], call[1]],
                        "span": list(ts[i]) if i >= 0 else None, "kernel_start": start})
    return {"launches": len(kernels), "inside_and_after": ok, "bad": bad[:5],
            "n_bad": len(bad), "launch_calls": sorted(calls),
            "lag_us_by_tenth": _lags_by_tenth(lags, t1 - t0),
            "call_us_median": sorted(durations)[len(durations) // 2] / 1e3 if durations else None,
            "device_events_named_sq": sorted(set(on_device_named)),
            "device_user_annotations": sorted(annotations)}


def _cell(cell_name: str, seed: int, device: str):
    """(the benchmark's cell, its configuration)."""
    from sqbench import run as bench

    entry, _, _ = bench.workload(cell_name)
    config = bench.load("configs", f"{entry['config']}.json")
    kind = importlib.import_module(f"sqbench.kinds.{config['kind']}")
    return kind.Cell(config, bench.load("traffic", f"{entry['traffic']}.json"),
                     bench.load("cells", f"{cell_name}.json"), seed, device), config


def clock(cell_name: str, seed: int, seconds: float, device: str) -> dict:
    import torch

    from sqbench import devtrace, work
    from sqbench import run as bench

    cell, config = _cell(cell_name, seed, device)
    align, readers = SPLIT[config["kind"]]
    align = importlib.import_module(f"sqbench.layer_metrics.{align}")
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cell.device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    win = {"t_open": None, "records": 0, "closed": False}

    def on_record(_rec):
        if win["closed"]:
            return
        now = time.perf_counter()
        if win["t_open"] is None:
            win["t_open"] = now
            devtrace.mark(torch, devtrace.OPEN)
            return
        win["records"] += 1
        if now - win["t_open"] >= seconds:
            devtrace.mark(torch, devtrace.CLOSE)
            prof.stop()
            win["closed"] = True

    prof.start()
    cell.serve(on_record, lambda: win["closed"])
    tr = devtrace.Trace(torch, prof)
    ctx = bench.Context(tr, cell, config, win["records"] * cell.fps)
    split = {r: importlib.import_module(f"sqbench.layer_metrics.{r}").read(ctx) for r in readers}
    from sqbench.layer_metrics import _spans

    if config["kind"] == "field":
        split["loop"] = align.idle_ms_per_record(ctx, _spans.LOOP)
    matches = [work.kernel(k)["match"] for k in align.KERNELS]
    starts = {s for s, _, n in tr.device if any(m in n for m in matches)}
    points = align.offsets(tr.gaps, starts, align.launch_calls(tr.host))
    raw = _spans.idle_by_span(_spans.markers(tr.host), tr.gaps)
    idle_ms = (tr.window_s - tr.busy_s) * 1e3 / win["records"]
    out = {"cell": cell_name, "seed": seed, "records": win["records"], "window_s": tr.window_s,
           "alignment_points": len(points),
           "busy_s": tr.busy_s, "device_idle_pct": 100.0 * (1.0 - tr.busy_s / tr.window_s),
           "idle_ms_a_record": idle_ms, "split": split,
           "split_unaligned": {n: 1e-6 * v / win["records"] for n, v in raw.items()},
           "offset_us": [round(o / 1e3, 1) for o in sorted(o for _, o in points)[::max(len(points) // 10, 1)]],
           "device_ops": [n for n, _ in tr.top_device_ops()]}
    if all(v is not None for v in split.values()):
        out["split_sum_over_idle"] = sum(split.values()) / idle_ms
    out.update(check_clock(prof.profiler.kineto_results.events(), tr.t0, tr.t1, matches))
    return out


def records(cell_name: str, seed: int, seconds: float, device: str) -> dict:
    import torch

    from sqbench import run as bench

    cell, config = _cell(cell_name, seed, device)
    counters = {}
    for module, fn, attr in COUNTERS[config["kind"]]:
        owner = getattr(importlib.import_module(module), fn)
        if hasattr(owner, attr):
            setattr(owner, attr, 0)
        counters[f"{fn}.{attr}"] = (owner, attr)
    win = bench.Window(seconds, time.perf_counter())
    streamed = [0]

    def on_record(_rec):
        now = time.perf_counter()
        streamed[0] += 1
        if win.t_open is None:
            win.t_open = now
        else:
            win.intervals.append(now - win.t_last)
        win.t_last = now

    cell.serve(on_record, win.closed)
    out = {"mode": "records", "cell": cell_name, "seed": seed, "streamed": streamed[0],
           "window_records": win.records}
    out.update({name: getattr(owner, attr, None) for name, (owner, attr) in counters.items()})
    if cell.device.type == "cuda":
        stats = torch.cuda.memory_stats(cell.device)
        out["memory"] = {k: stats[k] for k in (
            "allocated_bytes.all.peak", "reserved_bytes.all.peak", "segment.all.peak",
            "segment.large_pool.peak", "segment.small_pool.peak", "allocation.all.peak")}
    return out


def cost(n: int) -> dict:
    import torch

    from stochquant_tpu_torch import tracing

    def per_span() -> float:
        t = time.perf_counter()
        for _ in range(n):
            with tracing.span(tracing.LAUNCH):
                pass
        return (time.perf_counter() - t) / n * 1e9

    def bare() -> float:
        t = time.perf_counter()
        for _ in range(n):
            pass
        return (time.perf_counter() - t) / n * 1e9

    loop = min(bare() for _ in range(3))
    off = min(per_span() for _ in range(3)) - loop
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        on = min(per_span() for _ in range(3)) - loop
    return {"mode": "cost", "n": n, "ns_a_span_off": off, "ns_a_span_on": on}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="mode", required=True)
    c = sub.add_parser("clock")
    c.add_argument("--cells", default=",".join(CELLS))
    c.add_argument("--seconds", type=float, default=6.0)
    c.add_argument("--seed", type=int, default=3_141_592_653)
    c.add_argument("--device", default="cuda")
    k = sub.add_parser("cost")
    k.add_argument("--n", type=int, default=200_000)
    r = sub.add_parser("records")
    r.add_argument("--cells", default=",".join(CELLS))
    r.add_argument("--seconds", type=float, default=36.0)
    r.add_argument("--seed", type=int, default=3_141_592_653)
    r.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    print(json.dumps({"card": card_line()}), flush=True)
    if args.mode == "cost":
        print(json.dumps(cost(args.n)), flush=True)
        return 0
    serve = clock if args.mode == "clock" else records
    for name in args.cells.split(","):
        print(json.dumps(serve(name, args.seed, args.seconds, args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

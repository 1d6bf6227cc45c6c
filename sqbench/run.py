"""Run one cell of the benchmark of ``stochquant_tpu_torch`` once.

    python3 sqbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``.  The cell names a
configuration (``sqbench/configs/<config>.json``) and a traffic mix
(``sqbench/traffic/<traffic>.json``); ``sqbench/cells/<cell>.json`` holds the
size of its check and the limits of the numbers compared.  The configuration's
``kind`` picks the driver (``sqbench/kinds/<kind>.py``), which serves the
cell through the port's own entry; per-layer metrics are read by
``sqbench/layer_metrics/<metric>.py``.  Nothing here names a cell.

Set-up runs from the start of this script to the first streamed record after
the burn-in, which opens the window; the window closes at the first record
``--seconds`` later.  ``--trace 0`` reports the cell's end-to-end metrics,
``--trace 1`` its per-layer metrics from a ``torch.profiler`` trace of the
window's first ``TRACE_SECONDS``.  After the window the plain reference
judges what the timed path produced; each number compared is printed beside
its limit as the last lines on standard error and under ``checks``, the last
key of the result, which is the last line on standard output.

A run without a CUDA card, or with fewer cards than the cell asks for, exits
with code 2 and prints no result; one that finds JAX or the JAX package
loaded once the window has closed exits with code 3 and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if sys.path and Path(sys.path[0] or ".").resolve() == HERE:
    sys.path.pop(0)  # run as a script: import this folder only as the package sqbench
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from sqbench import card, work  # noqa: E402
from sqbench import devtrace  # noqa: E402

#: top-level module names that may not be loaded in a run (compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "stochquant_tpu")
#: seconds of the window a traced run profiles (its first)
TRACE_SECONDS = 6.0


def load(*parts) -> dict:
    return json.loads(HERE.joinpath(*parts).read_text())


def workload(name: str):
    """(workload entry, its end-to-end metrics, its per-layer metrics)."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; known: {sorted(cells)}")

    def applies(m):
        return "workloads" not in m or name in m["workloads"]

    return (cells[name], [m for m in bench["end_to_end"] if applies(m)],
            [m for m in bench["per_layer"] if applies(m)])


def base_name(metric: dict) -> str:
    """The quantity a metric measures: its name up to the first dot.  A
    quantity whose cells differ in kind (``mlups`` of the cells the card
    paces, ``mlups.host_paced`` of those the host loop paces) is split into
    metrics with bounds of their own, read by one reader."""
    return metric["name"].split(".")[0]


def percentile(values, q: float) -> float:
    """The q-th percentile, linear between the closest ranks."""
    xs = sorted(values)
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def forbidden_modules() -> list:
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


class Window:
    """Timing of the streamed records: set-up until the first, then the
    intervals between consecutive records until ``seconds`` have passed."""

    def __init__(self, seconds: float, t_start: float):
        self.seconds, self.t_start = seconds, t_start
        self.t_open = self.t_last = None
        self.setup_s = None
        self.intervals, self.failed = [], 0
        self.traced_records = None

    @property
    def records(self) -> int:
        return len(self.intervals)

    def closed(self) -> bool:
        return self.t_open is not None and self.t_last - self.t_open >= self.seconds


class Context:
    """What a per-layer reader reads: the trace, the cell and its frames."""

    def __init__(self, trace, cell, config, frames):
        self.trace, self.cell, self.config, self.frames = trace, cell, config, frames

    def kernel(self, name: str) -> dict:
        return work.kernel(name)

    def roofline_pct(self, name: str):
        """Least seconds of a launch over the mean device seconds of the
        kernel's launches in the trace, in per cent; None without a launch."""
        times = self.trace.launches(self.kernel(name)["match"])
        if not times:
            return None
        least, _ = work.least_seconds(name, self.cell.cfg, self.config["work"])
        return 100.0 * least / (sum(times) / len(times))


def run_cell(name: str, seed: int, seconds: float, trace: bool = False, *, device="cuda",
             overrides=None, control=False, t_start=T_START) -> dict:
    """Serve one cell once and judge it.  ``overrides`` ({"chain": ...,
    "action_params": ..., "check": ...}) changes the configuration and the
    check's size (tests); ``control`` also reads the control: the reference
    in the precision below the configuration's in the program's place."""
    import torch

    entry, e2e, per_layer = workload(name)
    config = load("configs", f"{entry['config']}.json")
    traffic = load("traffic", f"{entry['traffic']}.json")
    cell_spec = load("cells", f"{name}.json")
    overrides = overrides or {}
    config = dict(config, chain=dict(config["chain"], **overrides.get("chain", {})))
    if "action_params" in overrides:
        config["action_params"] = overrides["action_params"]
    cell_spec = dict(cell_spec, check=dict(cell_spec["check"], **overrides.get("check", {})))
    kind = importlib.import_module(f"sqbench.kinds.{config['kind']}")
    cell = kind.Cell(config, traffic, cell_spec, seed, device)
    cuda = cell.device.type == "cuda"
    win = Window(seconds, t_start)
    trace_s = min(seconds, TRACE_SECONDS)
    prof = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)

    def on_record(rec):
        now = time.perf_counter()
        if win.t_open is None:
            win.t_open, win.setup_s = now, now - win.t_start
            if prof is not None:
                devtrace.mark(torch, devtrace.OPEN)
        else:
            win.intervals.append(now - win.t_last)
            win.failed += cell.failed(rec)
            if prof is not None and win.traced_records is None and now - win.t_open >= trace_s:
                devtrace.mark(torch, devtrace.CLOSE)
                prof.stop()
                win.traced_records = win.records
        win.t_last = now

    sampler = card.CardSampler() if cuda else None
    try:
        if prof is not None:
            prof.start()
        cell.serve(on_record, win.closed)
        if prof is not None and win.traced_records is None:
            devtrace.mark(torch, devtrace.CLOSE)
            prof.stop()
            win.traced_records = win.records
    finally:
        clocks = sampler.stop() if sampler is not None else "no card"
    memory_peak = torch.cuda.max_memory_allocated(cell.device) if cuda else 0
    if win.records == 0:
        raise RuntimeError("the window closed without a record after its first")
    window_s = win.t_last - win.t_open

    values = {
        "mlups": win.records * cell.updates_per_record / window_s / 1e6,
        "record_ms_p95": 1e3 * percentile(win.intervals, 95),
        "setup_s": win.setup_s,
    }
    out = {"attempted": win.records * cell.chain_frames_per_record, "failed": win.failed,
           "records": win.records, "window_s": window_s, "setup_s": win.setup_s,
           "clocks": clocks, "memory_peak_bytes": memory_peak,
           "record_ms_median": 1e3 * percentile(win.intervals, 50)}
    metrics = {}
    if prof is None:
        for m in e2e:
            metrics[m["name"]] = {"value": values[base_name(m)], "unit": m["unit"]}
    else:
        tr = devtrace.Trace(torch, prof)
        ctx = Context(tr, cell, config, win.traced_records * cell.fps)
        for m in per_layer:
            v = importlib.import_module(f"sqbench.layer_metrics.{base_name(m)}").read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        out["trace"] = {"busy_s": tr.busy_s, "window_s": tr.window_s,
                        "breakdown": {"device_ops": tr.top_device_ops(),
                                      "idle_gaps": tr.top_idle_gaps()}}
        del tr, ctx, prof
    out["metrics"] = metrics

    cell.prepare_check()
    if cuda:
        torch.cuda.empty_cache()
    readings = {}
    out["check_s"] = card.timed(torch, lambda: readings.update(cell.check()))
    limits = cell_spec["limits"]
    out["checks"] = {k: {"value": readings[k], "limit": limits[k]} for k in limits}
    out["correct"] = all(readings[k] <= limits[k] for k in limits)
    if control:
        out["control"] = cell.check(dtype=torch.bfloat16)
    return out


def device_info(torch, chips: int, out: dict) -> dict:
    """The result's ``device``: the card, the cards used, the peak memory, and
    from a traced run the device's busy seconds and the traced window."""
    name_limit = card.card_line().split(", ")
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": out["memory_peak_bytes"],
            "power_limit": name_limit[-1] if len(name_limit) > 1 else "unknown"}
    if "trace" in out:
        info["busy_s"] = out["trace"]["busy_s"]
        info["window_s"] = out["trace"]["window_s"]
    return info


def result_line(out: dict, device: dict) -> dict:
    """The last line: the keys the benchmark reads, ``checks`` last."""
    line = {"correct": out["correct"], "attempted": out["attempted"], "failed": out["failed"],
            "metrics": out["metrics"], "device": device}
    if "trace" in out:
        line["breakdown"] = out["trace"]["breakdown"]
    line["checks"] = out["checks"]
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    entry, _, _ = workload(args.workload)
    chips = int(entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"sqbench: {args.workload} needs {chips} CUDA card(s), found {found}; "
              "no result", file=sys.stderr)
        return 2
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    result = result_line(out, device_info(torch, chips, out))
    print(f"sqbench: {args.workload} seed {args.seed}: {out['records']} records in "
          f"{out['window_s']:.3f} s (median {out['record_ms_median']:.3f} ms), set-up "
          f"{out['setup_s']:.3f} s, check {out['check_s']:.3f} s; card: {out['clocks']}",
          flush=True)
    found = forbidden_modules()
    if found:
        print(f"sqbench: loaded after the window: {', '.join(found)}; no result",
              file=sys.stderr)
        return 3
    for k, c in out["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

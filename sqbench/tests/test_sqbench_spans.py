"""The readers that split the device's idle time among the program's spans
(``layer_metrics/_spans.py``: ``launch_idle_ms``, ``record_idle_ms``,
``loop_idle_ms``), on hand-made traces (also with the device's clock off the
host's), and on a real CPU trace of the program's markers with made-up device
intervals."""

import importlib
import sys
import types
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from sqbench import devtrace, work  # noqa: E402
from sqbench.layer_metrics import _spans  # noqa: E402

READERS = {name: importlib.import_module(f"sqbench.layer_metrics.{name}").read
           for name in ("launch_idle_ms", "record_idle_ms", "loop_idle_ms")}
MS = 1_000_000  # ns


def enter(t, name):
    return (t, t + 1, name)


def leave(t, name):
    return (t - 1, t, name + _spans.END)


def ctx(host, gaps, t0=0, t1=100 * MS, frames=4, fps=1, device=((0, 1, "k"),)):
    trace = types.SimpleNamespace(host=sorted(host, key=lambda h: (h[0], -h[1])),
                                  gaps=list(gaps), t0=t0, t1=t1, device=list(device))
    return types.SimpleNamespace(trace=trace, frames=frames, cell=types.SimpleNamespace(fps=fps),
                                 kernel=work.kernel)


def read_all(c) -> dict:
    return {name: read(c) for name, read in READERS.items()}


def test_a_known_idle_total_splits_among_launch_record_and_loop():
    host = [enter(10 * MS, "sq.launch"), (12 * MS, 13 * MS, "cudaLaunchKernel"),
            leave(20 * MS, "sq.launch"),
            enter(50 * MS, "sq.record"), leave(70 * MS, "sq.record")]
    # idle: 5 ms in the loop, 4 in the launch, 6 in the record, 3 across its end (2 in, 1 out)
    gaps = [(2 * MS, 7 * MS), (15 * MS, 19 * MS), (55 * MS, 61 * MS), (68 * MS, 71 * MS)]
    got = read_all(ctx(host, gaps, frames=4))
    assert got == pytest.approx({"launch_idle_ms": 4 / 4, "record_idle_ms": (6 + 2) / 4,
                                 "loop_idle_ms": (5 + 1) / 4})
    assert sum(got.values()) * 4 == pytest.approx(sum(b - a for a, b in gaps) / MS)


def test_records_are_frames_over_frames_a_record():
    host = [enter(10 * MS, "sq.record"), leave(20 * MS, "sq.record")]
    got = read_all(ctx(host, [(12 * MS, 14 * MS)], frames=32, fps=16))
    assert got == pytest.approx({"launch_idle_ms": 0.0, "record_idle_ms": 1.0,
                                 "loop_idle_ms": 0.0})


def test_spans_cut_by_the_window_count_for_their_part_inside_it():
    # the window opens inside a record and closes inside a launch nested in a record
    host = [leave(10 * MS, "sq.record"), enter(80 * MS, "sq.record"),
            enter(90 * MS, "sq.launch")]
    gaps = [(0, 15 * MS), (85 * MS, 100 * MS)]
    got = read_all(ctx(host, gaps, frames=1))
    assert got == pytest.approx({"launch_idle_ms": 10.0, "record_idle_ms": 10.0 + 5.0,
                                 "loop_idle_ms": 5.0})


def test_spans_open_at_the_window_start_nest_in_the_order_they_close():
    # a launch inside a record were both open when the window opened
    host = [leave(10 * MS, "sq.launch"), leave(30 * MS, "sq.record")]
    got = read_all(ctx(host, [(0, 40 * MS)], frames=1))
    assert got == pytest.approx({"launch_idle_ms": 10.0, "record_idle_ms": 20.0,
                                 "loop_idle_ms": 10.0})


def test_nested_markers_credit_the_innermost_span():
    host = [enter(10 * MS, "sq.record"), enter(20 * MS, "sq.launch"),
            leave(30 * MS, "sq.launch"), leave(40 * MS, "sq.record")]
    got = read_all(ctx(host, [(5 * MS, 45 * MS)], frames=1))
    assert got == pytest.approx({"launch_idle_ms": 10.0, "record_idle_ms": 20.0,
                                 "loop_idle_ms": 10.0})


def test_a_gap_with_no_span_open_goes_to_the_loop():
    host = [enter(10 * MS, "sq.launch"), leave(20 * MS, "sq.launch"),
            (30 * MS, 40 * MS, "aten::mean")]
    got = read_all(ctx(host, [(25 * MS, 45 * MS)], frames=2))
    assert got == pytest.approx({"launch_idle_ms": 0.0, "record_idle_ms": 0.0,
                                 "loop_idle_ms": 10.0})


KERNEL1 = "void chain_frame_kernel<3, ThreefryNoise<20> >(ChainParams, float const*)"


def skewed(offset, n=3):
    """``n`` records 10 ms apart: the record span [0, 4] ms, the launch span
    [6, 8] with its launch call at 7, the kernel from 7 to 13 on the host's
    clock; the device idles from 1 to 1.5 and from 3 to 7 (1.5 ms in the
    record, 2 in the loop, 1 in the launch).  The device's clock reads
    ``offset(t)`` ms late."""
    host, gaps, device = [], [], []
    for k in range(n):
        b = 10 * k
        host += [enter(b * MS, "sq.record"), leave((b + 4) * MS, "sq.record"),
                 enter((b + 6) * MS, "sq.launch"), ((b + 7) * MS, (b + 7) * MS + 9000, "cudaLaunchKernel"),
                 ((b + 7) * MS + 9500, (b + 7) * MS + 12000, "cudaLaunchKernel"),
                 leave((b + 8) * MS, "sq.launch")]
        gaps.append((round((b + 1 + offset(b + 1)) * MS), round((b + 1.5 + offset(b + 1.5)) * MS)))
        gaps.append((round((b + 3 + offset(b + 3)) * MS), round((b + 7 + offset(b + 7)) * MS)))
        device.append((gaps[-1][1], round((b + 13 + offset(b + 13)) * MS), KERNEL1))
    return ctx(host, gaps, t0=0, t1=10 * n * MS, frames=n, device=device)


@pytest.mark.parametrize("offset", [lambda t: 0.0, lambda t: 0.3, lambda t: -0.45,
                                    lambda t: -0.4 + 1.5e-4 * t],  # 150 ppm
                         ids=["none", "late", "early", "drifting"])
def test_the_device_clock_is_put_on_the_hosts_at_each_launch(offset):
    got = read_all(skewed(offset))
    assert got == pytest.approx({"launch_idle_ms": 1.0, "record_idle_ms": 1.5,
                                 "loop_idle_ms": 2.0}, abs=2e-3)


@pytest.mark.parametrize("offset", [lambda t: 4.5 + 0.004 * t, lambda t: 12.0],
                         ids=["drifting past half a record", "a record and more late"])
def test_an_offset_past_half_a_record_keeps_each_interval_in_place_in_its_record(offset):
    """A drift (4,000 ppm) carrying the offset past half a record (5 ms) is
    followed from kernel to kernel; an offset of more than a record pairs
    each kernel with a call a record away, which moves no interval within its
    record (but those of the last record, whose calls a record on are not in
    the window: one of 30)."""
    got = read_all(skewed(offset, n=30))
    assert got == pytest.approx({"launch_idle_ms": 1.0, "record_idle_ms": 1.5,
                                 "loop_idle_ms": 2.0}, abs=0.05)


def test_without_the_alignment_a_late_device_clock_moves_the_split():
    c = skewed(lambda t: 0.3)
    raw = _spans.idle_by_span(_spans.markers(c.trace.host), c.trace.gaps)
    assert {k: v / 3 / MS for k, v in raw.items()} == pytest.approx(
        {"sq.launch": 1.3, "sq.record": 1.2, "loop": 2.0})


@pytest.mark.parametrize("case", ["no device operation", "no span marker", "no frame"])
def test_the_readers_read_nothing_where_the_trace_holds_nothing(case):
    host = [enter(10 * MS, "sq.launch"), leave(20 * MS, "sq.launch")]
    kw = {"no device operation": {"device": ()},
          "no span marker": {"host": [(10 * MS, 20 * MS, "aten::mean")]},
          "no frame": {"frames": 0}}[case]
    args = {"host": host, "gaps": [(0, 100 * MS)], **kw}
    assert read_all(ctx(**args)) == dict.fromkeys(READERS)


def test_the_programs_markers_reach_the_readers_through_the_harness_trace():
    """A CPU trace of ``run_chain`` between the harness's window markers, read
    by ``devtrace.Trace``: the readers find the program's marker pairs, read
    nothing without a device operation, and with made-up device intervals
    split the idle time with nothing left over."""
    import dataclasses

    from stochquant_tpu_torch import metrics, runtime
    from stochquant_tpu_torch.config import PRESETS

    cfg = dataclasses.replace(PRESETS["double_well"], n_chains=4, n_sites=32, loops=10,
                              frames=4, fps=1, dtau=1e-4)
    seen = []

    def on_record(rec):
        if rec.get("type") == "frame":
            seen.append(rec)
            if len(seen) == 1:
                devtrace.mark(torch, devtrace.OPEN)
            elif len(seen) == 4:
                devtrace.mark(torch, devtrace.CLOSE)

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        runtime.run_chain(cfg, device="cpu", backend="torch", burn_frames=1,
                          sink=metrics.MetricsSink(callback=on_record))
    tr = devtrace.Trace(torch, prof)
    c = types.SimpleNamespace(trace=tr, frames=3, cell=types.SimpleNamespace(fps=1),
                              kernel=work.kernel)
    assert tr.device == [] and read_all(c) == dict.fromkeys(READERS)
    names = [n for _, n, _ in _spans.markers(tr.host)]
    # the opening record's exit, two pairs, the closing record's entry
    assert names == ["sq.record"] * 6
    # a device operation every third of the window: idle everywhere else
    third = (tr.t1 - tr.t0) // 3
    tr.device = [(tr.t0 + k * third, tr.t0 + k * third + third // 2, "kernel") for k in range(3)]
    tr.busy_s, tr.gaps = tr._busy_and_gaps()
    got = read_all(c)
    idle_ms = (tr.window_s - tr.busy_s) * 1e3
    assert got["launch_idle_ms"] == 0.0 and got["record_idle_ms"] > 0.0
    assert sum(got.values()) * 3 == pytest.approx(idle_ms, rel=1e-9)

"""The port's spans (``tracing.span``) on the CPU: a no-op without a
profiler, one marker pair a record of ``runtime.run_chain`` and a launch of
the chain kernels' wrappers under one, markers in ``cli run --profile``'s
trace; and ``metrics.MetricsSink``'s clock and average."""

import dataclasses
import json
import types

import pytest
import torch

from stochquant_tpu_torch import actions, cli, metrics, runtime, tracing
from stochquant_tpu_torch.config import PRESETS
from stochquant_tpu_torch.integrators import langevin
from stochquant_tpu_torch.kernels import chain_kernel

torch.set_num_threads(1)

CFG = dataclasses.replace(PRESETS["double_well"], n_chains=4, n_sites=32, loops=10,
                          frames=3, fps=1, dtau=1e-4)


def _profile():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def _span_markers(prof) -> list:
    """Names of the span markers on the profiled thread, in time order."""
    events = [ev for ev in prof.profiler.kineto_results.events()
              if ev.name().startswith("sq.")]
    assert len({ev.start_thread_id() for ev in events}) <= 1
    return [ev.name() for ev in sorted(events, key=lambda ev: ev.start_ns())]


def _pairs(name, n) -> list:
    return [name, name + tracing.END] * n


def test_span_is_a_shared_no_op_without_a_profiler():
    off = tracing.span(tracing.RECORD)
    assert off is tracing.span(tracing.LAUNCH)
    with _profile() as prof:
        with off:
            pass
    assert _span_markers(prof) == []


def test_span_writes_a_marker_pair_under_a_profiler_also_on_an_exception():
    with _profile() as prof:
        with tracing.span(tracing.RECORD):
            with tracing.span(tracing.LAUNCH):
                pass
        with pytest.raises(ValueError):
            with tracing.span(tracing.LAUNCH):
                raise ValueError("inside")
    assert _span_markers(prof) == [tracing.RECORD, *_pairs(tracing.LAUNCH, 1),
                                   tracing.RECORD + tracing.END, *_pairs(tracing.LAUNCH, 1)]


def test_run_chain_leaves_one_record_span_a_record():
    recs = []
    with _profile() as prof:
        runtime.run_chain(CFG, device="cpu", backend="torch", burn_frames=1,
                          sink=metrics.MetricsSink(callback=recs.append))
    assert [r["type"] for r in recs] == ["frame"] * 3 + ["summary"]
    assert _span_markers(prof) == _pairs(tracing.RECORD, 3)


@pytest.mark.parametrize("n_frames, fpl, launches", [(3, 1, 3), (3, 2, 2), (5, 2, 3)])
def test_chain_kernel_wrappers_leave_one_launch_span_a_launch(n_frames, fpl, launches):
    """On CPU tensors the wrappers run their plain versions inside the span:
    kernel 1 a frame at K = 1; kernel 2 a group of K and kernel 1 the rest."""
    act = actions.get(CFG.action)
    s0 = langevin.init_chain_state(CFG, act, device="cpu")
    with _profile() as prof:
        _, m = chain_kernel.run_frames_kernel(s0, act, CFG, n_frames, frames_per_launch=fpl)
    assert m["stable"].shape[0] == n_frames
    assert _span_markers(prof) == _pairs(tracing.LAUNCH, launches)


def test_cli_profile_trace_holds_the_markers(tmp_path):
    cli.main(["run", "--preset", "harmosc", "--frames", "2", "--loops", "5", "--chains", "2",
              "--dtau", "1e-3", "--device", "cpu", "--metrics", str(tmp_path / "m.jsonl"),
              "--profile", str(tmp_path / "prof")])
    events = json.loads((tmp_path / "prof" / "trace.json").read_text())["traceEvents"]
    names = [e["name"] for e in sorted(events, key=lambda e: float(e.get("ts", 0)))
             if e.get("name", "").startswith("sq.")]
    assert names == _pairs(tracing.RECORD, 2)


class _Clock:
    def __init__(self):
        self.t = 100.0

    def perf_counter(self):
        return self.t


def test_metrics_sink_times_on_the_monotonic_clock_and_averages_after_the_first_record(
        monkeypatch):
    clock = _Clock()
    # no time.time: the sink may read only the monotonic clock
    monkeypatch.setattr(metrics, "time", types.SimpleNamespace(perf_counter=clock.perf_counter))
    recs = []
    sink = metrics.MetricsSink(callback=recs.append)
    clock.t += 10.0   # set-up and the burn-in
    sink.frame(0, 3, 1_000_000, [1e-3], 1.0)
    assert sink.summary()["avg_mlups"] is None
    clock.t += 2.0
    sink.frame(1, 3, 1_000_000, [1e-3], 1.0)
    clock.t += 2.0
    sink.frame(2, 3, 1_000_000, [1e-3], 1.0)
    summary = sink.summary()
    assert [r["mlups"] for r in recs] == [0.1, 0.5, 0.5]
    assert [r["wall_time"] for r in recs] == [10.0, 12.0, 14.0]
    assert summary == {"type": "summary", "total_site_updates": 3_000_000,
                       "elapsed_s": 14.0, "avg_mlups": 0.5}

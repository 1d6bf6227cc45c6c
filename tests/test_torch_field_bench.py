"""The benchmark's field cells on the CPU (``sqbench/kinds/field.py``,
``sqbench/reference/field.py``): the plain reference against the port's
plain field integrator, the cells served through ``sqbench.run.run_cell`` on
the plain path (the program passes, the control and each planted fault
fail), ``runtime.run_field``'s spans and counters, the field kernels' work
counts and the readers that split the device's idle time at the field
kernels' launches, and the new benchmark entries loaded by name."""

import dataclasses
import importlib
import json
import sys
import types
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from sqbench import run, work, work_field  # noqa: E402
from sqbench.kinds import field as field_kind  # noqa: E402
from sqbench.layer_metrics import _field_spans, _spans  # noqa: E402
from sqbench.reference import field as ref  # noqa: E402
from stochquant_tpu_torch import actions, metrics, runtime, tracing  # noqa: E402
from stochquant_tpu_torch.config import FieldConfig  # noqa: E402
from stochquant_tpu_torch.integrators import field as field_mod  # noqa: E402
from stochquant_tpu_torch.kernels import field_kernel  # noqa: E402

torch.set_num_threads(1)

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELL = "phi4_256.c16.fpl10"
#: the one-frame-a-launch cell: kernel 3, the PyTorch epilogue, a record every frame
CELL_FPL1 = "phi4_256.c16.fpl1"
#: the field cell's traffic and the one-frame-a-launch mix (kernel 3 and the PyTorch epilogue
#: on the card) that the field kind serves as well
TRAFFICS = ["threefry.fpl10", "threefry.fpl1"]
TINY = {"chain": {"n_chains": 3, "shape": [16, 16], "loops": 4}, "check": {"chains": 3}}
MS = 1_000_000  # ns


def _ref_cfg(shape, loops, seed, n_chains=3, **kw) -> dict:
    spec = run.load("configs", "phi4_2d_256.json")
    cfg = dict(spec["chain"], shape=list(shape), loops=loops, n_chains=n_chains, seed=seed,
               rng_impl="threefry", frames_per_launch=1, fps=1,
               action_params=spec["action_params"], **kw)
    return cfg


def _program_cfg(cfg: dict) -> FieldConfig:
    return FieldConfig(action="phi4", shape=tuple(cfg["shape"]), dtau=cfg["dtau"],
                       n_chains=cfg["n_chains"], loops=cfg["loops"], seed=cfg["seed"],
                       grow_after=cfg["grow_after"], rng_impl=cfg["rng_impl"])


def _as_ref(state) -> ref.State:
    return ref.State(**{k: getattr(state, k) for k in ref.FLOAT_LEAVES + ref.EXACT_LEAVES},
                     step=int(state.step))


def _assert_states_match(got: ref.State, want: ref.State):
    for k in ref.FLOAT_LEAVES:
        g, w = getattr(got, k), getattr(want, k)
        scale = max(float(w.abs().max()), 1e-30)
        assert float((g - w).abs().max()) / scale <= 1e-6, k
    for k in ref.EXACT_LEAVES:
        assert torch.equal(getattr(got, k), getattr(want, k)), k
    assert got.step == want.step


@pytest.mark.parametrize("shape,loops,frames,grow_after", [
    ((16, 16), 4, 1, 10**9), ((16, 16), 5, 3, 1), ((24, 24), 6, 1, 10**9),
    ((24, 24), 4, 2, 10**9)])
def test_reference_follows_the_plain_integrator(shape, loops, frames, grow_after):
    """From the cold start through ``frames`` frames (an odd ``loops`` ends on
    a half-used noise pair; ``grow_after`` 1 grows Δτ every other frame):
    the states to float32 rounding, the decisions exact, for every chain and
    for a subset of rows followed on its own."""
    cfg = _ref_cfg(shape, loops, seed=4_000_000_007, grow_after=grow_after)
    pcfg = _program_cfg(cfg)
    act = actions.get_field("phi4")
    s0 = field_mod.init_field_state(pcfg, device="cpu")
    ids = torch.arange(3)
    _assert_states_match(_as_ref(s0), ref.init_state(cfg, ids))
    got, got_m = field_mod.run_field_frames(s0, act, pcfg, frames)
    want, want_m = ref.frames(ref.init_state(cfg, ids), cfg, ids, frames)
    _assert_states_match(_as_ref(got), want)
    for k in ("stable", "dtau", "max_phi"):
        assert torch.equal(got_m[k], want_m[k]), k
    rows = torch.tensor([0, 2])
    sub, _ = ref.frames(ref.init_state(cfg, rows), cfg, rows, frames)
    _assert_states_match(sub, ref.State(**{k: getattr(want, k)[rows] for k in
                                           ref.FLOAT_LEAVES + ref.EXACT_LEAVES},
                                        step=want.step))


def test_reference_follows_the_kernels_plain_versions_through_a_group():
    """Kernel 4's plain version (a group of K frames) and kernel 3's with the
    PyTorch epilogue, from a state after a burn-in with its means reset."""
    cfg = _ref_cfg((16, 16), 6, seed=2_718_281_828)
    pcfg = dataclasses.replace(_program_cfg(cfg), frames_per_launch=3)
    act = actions.get_field("phi4")
    s0, _ = field_mod.run_field_frames(field_mod.init_field_state(pcfg, device="cpu"), act,
                                       pcfg, 2)
    s0 = field_mod.reset_field_means(s0)
    got, m = field_kernel.run_field_frames_kernel(s0, act, pcfg, 4, frames_per_launch=3)
    want, want_m = ref.frames(_as_ref(s0), cfg, torch.arange(3), 4)
    _assert_states_match(_as_ref(got), want)
    assert torch.equal(m["stable"], want_m["stable"]) and torch.equal(m["dtau"], want_m["dtau"])


def test_reference_observables_are_the_records():
    cfg = _ref_cfg((16, 16), 4, seed=5)
    pcfg = dataclasses.replace(_program_cfg(cfg), frames=2)
    recs = []
    res = runtime.run_field(pcfg, device="cpu", backend="torch",
                            sink=metrics.MetricsSink(callback=recs.append))
    means = {k: getattr(res.state, k) for k in ("mag_mean", "mag2_mean", "mag4_mean",
                                                "absmag_mean", "phi2_mean")}
    obs = ref.observables(means, 256)
    last = [r for r in recs if r["type"] == "frame"][-1]
    for k in ref.OBSERVABLES:
        assert last[k] == pytest.approx(float(obs[k].double().mean()), rel=1e-6, abs=1e-9), k


def serve(traffic, seed=4_000_000_007, records=4, control=False):
    """The field kind at TINY on the CPU under ``traffic``, as ``run.run_cell``
    serves a cell: the window, then the check; (readings, control readings,
    limits, records streamed after the first)."""
    spec = run.load("configs", "phi4_2d_256.json")
    config = dict(spec, chain=dict(spec["chain"], **TINY["chain"]))
    cell_spec = run.load("cells", f"{CELL}.json")
    cell_spec = dict(cell_spec, check=dict(cell_spec["check"], **TINY["check"]))
    cell = field_kind.Cell(config, run.load("traffic", f"{traffic}.json"), cell_spec, seed, "cpu")
    seen = []
    cell.serve(seen.append, lambda: len(seen) > records)
    cell.prepare_check()
    got = cell.check()
    return (got, cell.check(dtype=torch.bfloat16) if control else None, cell_spec["limits"],
            len(seen) - 1)


def _correct(got, limits) -> bool:
    return all(got[k] <= limits[k] for k in limits)


def test_the_field_cell_is_served_and_judged_through_the_harness():
    out = run.run_cell(CELL, 4_000_000_007, 0.4, device="cpu", overrides=TINY)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["records"] >= 1
    fps = run.load("traffic", "threefry.fpl10.json")["fps"]
    assert out["attempted"] == out["records"] * 3 * fps
    assert set(out["metrics"]) == {"mlups.host_paced", "record_ms_p95.host_paced", "setup_s"}


def test_the_one_frame_field_cell_is_served_and_judged_through_the_harness():
    """``phi4_256.c16.fpl1``: kernel 3's path (the plain frame and the
    PyTorch epilogue on the CPU), a record every frame."""
    out = run.run_cell(CELL_FPL1, 2_147_483_659, 0.4, device="cpu", overrides=TINY)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["records"] >= 1
    assert out["attempted"] == out["records"] * 3
    assert set(out["metrics"]) == {"mlups.host_paced", "record_ms_p95.host_paced", "setup_s"}


@pytest.mark.parametrize("traffic", TRAFFICS)
def test_field_cell_passes_and_the_control_fails_every_limit(traffic):
    got, control, limits, records = serve(traffic, control=True)
    assert _correct(got, limits), got
    assert records >= 4
    for k in ("state_gap", "decisions", "record_gap"):
        assert control[k] > limits[k], (k, control)
    assert control["missing"] == 0


def _fault_unchanged(monkeypatch):
    real = field_mod.run_field_frames

    def unchanged(state, *a, **kw):
        _, m = real(state, *a, **kw)
        return state, m
    monkeypatch.setattr(field_mod, "run_field_frames", unchanged)


def _fault_half_the_chains(monkeypatch):
    real = field_mod.susceptibility

    def half(state, volume):
        return real(state, volume)[: state.mag_mean.shape[0] // 2 + 1]
    monkeypatch.setattr(field_mod, "susceptibility", half)


def _fault_altered_observable(monkeypatch):
    real = field_mod.binder_cumulant
    monkeypatch.setattr(field_mod, "binder_cumulant", lambda state: real(state) * (1 + 1e-3))


def _fault_altered_state(monkeypatch):
    real = field_mod.run_field_frames

    def altered(state, *a, **kw):
        out, m = real(state, *a, **kw)
        phi = out.phi.clone()
        phi[1, 3, 5] += 1e-3
        return out._replace(phi=phi), m
    monkeypatch.setattr(field_mod, "run_field_frames", altered)


def _fault_nothing_observed(monkeypatch):
    monkeypatch.setattr(field_kind.Observer, "wrap", lambda self, fn: fn)


@pytest.mark.parametrize("fault", [_fault_unchanged, _fault_half_the_chains,
                                   _fault_altered_observable, _fault_altered_state,
                                   _fault_nothing_observed],
                         ids=["state_unchanged", "half_the_chains", "observable_altered",
                              "state_altered", "nothing_observed"])
@pytest.mark.parametrize("traffic", TRAFFICS)
def test_a_broken_field_path_is_not_correct(traffic, fault, monkeypatch):
    fault(monkeypatch)
    got, _, limits, _ = serve(traffic)
    assert not _correct(got, limits), got
    if fault is _fault_nothing_observed:
        assert got["missing"] == 3


def test_action_params_must_be_the_programs():
    with pytest.raises(ValueError, match="action_params"):
        run.run_cell(CELL, 1, 0.3, device="cpu",
                     overrides=dict(TINY, action_params={"m2": 2.0, "lam": 1.0}))


def test_a_chain_cells_size_key_sizes_a_square_lattice():
    cell = field_kind.Cell(run.load("configs", "phi4_2d_256.json") | {
        "chain": dict(run.load("configs", "phi4_2d_256.json")["chain"], n_sites=12)},
        run.load("traffic", "threefry.fpl10.json"), run.load("cells", f"{CELL}.json"),
        7, "cpu")
    assert cell.program_config().shape == (12, 12)
    assert cell.updates_per_record == 16 * 144 * 100 * 10


# ---------------------------------------------------------------------------
# run_field's spans and counters
# ---------------------------------------------------------------------------


def _profile():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def _span_markers(prof) -> list:
    events = [ev for ev in prof.profiler.kineto_results.events() if ev.name().startswith("sq.")]
    return [ev.name() for ev in sorted(events, key=lambda ev: ev.start_ns())]


def _pairs(name, n) -> list:
    return [name, name + tracing.END] * n


FCFG = FieldConfig(action="phi4", shape=(16, 16), n_chains=2, loops=4, frames=6, fps=2,
                   seed=3)


@pytest.mark.parametrize("profiled", [False, True])
def test_run_field_leaves_one_record_span_a_record_and_counts_its_readbacks(profiled,
                                                                            monkeypatch):
    monkeypatch.setattr(runtime.run_field, "records", 0)
    monkeypatch.setattr(runtime.run_field, "readbacks", 0)
    recs = []
    prof = _profile() if profiled else None
    if prof is not None:
        prof.start()
    runtime.run_field(FCFG, device="cpu", backend="torch", burn_frames=1,
                      sink=metrics.MetricsSink(callback=recs.append))
    if prof is not None:
        prof.stop()
        assert _span_markers(prof) == _pairs(tracing.RECORD, 3)
    assert [r["type"] for r in recs] == ["frame"] * 3 + ["summary"]
    assert (runtime.run_field.records, runtime.run_field.readbacks) == (3, 21)


def test_run_field_spans_are_a_no_op_without_a_profiler():
    assert not torch.autograd._profiler_enabled()
    assert tracing.span(tracing.RECORD) is tracing.span(tracing.LAUNCH)
    with _profile() as prof:
        pass
    assert _span_markers(prof) == []


@pytest.mark.parametrize("n_frames, fpl, launches", [(3, 1, 3), (4, 3, 2), (6, 3, 2)])
def test_field_kernel_wrappers_leave_one_launch_span_a_launch(n_frames, fpl, launches):
    """On CPU tensors the wrappers run their plain versions inside the span:
    kernel 3 a frame at K = 1; kernel 4 a group of K and kernel 3 the rest."""
    act = actions.get_field("phi4")
    s0 = field_mod.init_field_state(FCFG, device="cpu")
    with _profile() as prof:
        _, m = field_kernel.run_field_frames_kernel(s0, act, FCFG, n_frames,
                                                    frames_per_launch=fpl)
    assert m["stable"].shape[0] == n_frames
    assert _span_markers(prof) == _pairs(tracing.LAUNCH, launches)


# ---------------------------------------------------------------------------
# work counts and the idle split at the field kernels' launches
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kernel,fpl", [("field_frame", 1), ("field_frames_multi", 10)])
def test_field_roofline_counts(kernel, fpl):
    """At 256^2 x 16, loops 100: the issue rate binds, and the least time is
    the algorithm's operations a launch over 128 a clock on each of 132 SMs
    at 1980 MHz."""
    spec = run.load("configs", "phi4_2d_256.json")
    cfg = dict(spec["chain"], rng_impl="threefry", frames_per_launch=fpl)
    seconds, by = work_field.least_seconds(kernel, cfg, spec["work"])
    # a site-update: 18 fp32 + 6 alu, the force's 3 fp32, half of Threefry-20's 85
    step = 65536 * (18 + 6 + 3 + 85 / 2) + 256 * 3 + 12
    frame = 100 * step
    if kernel == "field_frames_multi":
        frame += 256 * 2 + 22
    assert by == "issue"
    assert seconds == pytest.approx(fpl * 16 * frame / (128 * 132 * 1.98e9), rel=1e-12)
    ops, n_bytes = work_field.launch_work(kernel, cfg, spec["work"])
    assert set(ops) == set(work.CLASSES) and n_bytes / 3.35e12 < seconds


def _enter(t, name):
    return (t, t + 1, name)


def _leave(t, name):
    return (t - 1, t, name + _spans.END)


def _record(t0, period, call_at, offset, queued=False):
    """Host events and device events of one record of a field cell that
    starts at ``t0``: the wrapper (with a PyTorch op's launch inside an
    ``aten`` op before the wrapper's own launch call at ``call_at``), then
    the record span; the kernel starts 5 us after its call, or ``queued``
    behind another device operation that runs from before the call to 0.6 ms
    after it, on a device clock ``offset`` ahead of the host's."""
    host = [_enter(t0, "sq.launch"), (t0 + 10_000, t0 + 30_000, "aten::stack"),
            (t0 + 12_000, t0 + 20_000, "cudaLaunchKernel"),
            (t0 + call_at, t0 + call_at + 8_000, "cudaLaunchKernelExC"),
            _leave(t0 + call_at + 20_000, "sq.launch"),
            _enter(t0 + call_at + 30_000, "sq.record"), _leave(t0 + period - 100_000, "sq.record")]
    k0 = t0 + call_at + 5_000 + offset
    device = []
    if queued:
        device.append((k0 - 15_000, k0 + 600_000, "void at::native::elementwise_kernel<>"))
        k0 += 602_000
    device.append((k0, k0 + period // 2, "void field_frame_cl_kernel<ThreefryNoise<20> >"))
    return host, device


def _trace(records, period=2 * MS, offset=0, call_at=50_000, queued=(), drift=0.0,
           jitter=0):
    """``records`` records; the device's clock ``offset`` ahead of the
    host's at the first and ``drift`` ns a ns more after; record i lasts
    ``period`` plus up to ``jitter`` ns, (i² · 7919) % 101 hundred-and-firsts of it."""
    host, device, t = [], [], 0
    for i in range(records):
        p = period + jitter * ((i * i * 7919) % 101) // 101
        h, d = _record(t, p, call_at, offset + round(drift * t), i in queued)
        t += p
        host += h
        device += d
    device.sort()
    t0, t1 = device[0][0] - 1, device[-1][1] + 1
    gaps, cursor = [], t0
    for s, e, _ in device:
        if s > cursor:
            gaps.append((cursor, s))
        cursor = max(cursor, e)
    gaps.append((cursor, t1))
    tr = types.SimpleNamespace(host=sorted(host, key=lambda h: (h[0], -h[1])), device=device,
                               gaps=gaps, t0=t0, t1=t1)
    return types.SimpleNamespace(trace=tr, frames=records, cell=types.SimpleNamespace(fps=1),
                                 kernel=work.kernel)


def test_field_launch_calls_are_the_wrappers_own():
    ctx = _trace(3)
    assert _field_spans.launch_calls(ctx.trace.host) == [50_000, 2 * MS + 50_000,
                                                         4 * MS + 50_000]


@pytest.mark.parametrize("offset", [0, 300_000, -450_000, 37 * MS + 700_000, -38 * MS])
def test_the_idle_split_is_the_same_whatever_the_device_clocks_offset(offset):
    """Each kernel starts 5 us after its call and runs half a record: the
    device idles from the kernel's end through the record (0.85 ms), the
    loop (0.1 ms) and the wrapper up to its launch call (0.05 ms), whatever
    the offset of the device's clock; 7 of the 8 records' idle intervals lie
    whole in the window."""
    names = ("sq.launch", "sq.record", "loop")
    got = {k: _field_spans.idle_ms_per_record(_trace(8, offset=offset), k) for k in names}
    want = {"sq.launch": 0.05 * 7 / 8, "sq.record": 0.85 * 7 / 8, "loop": 0.1 * 7 / 8}
    assert got == pytest.approx(want, abs=1e-6)


@pytest.mark.parametrize("offset,drift", [(-6 * MS, 1.35e-3), (231 * MS, -1.35e-3),
                                          (700_000, 2e-4)])
def test_the_offset_is_tracked_where_the_device_clock_drifts(offset, drift):
    """A device clock hundreds of ms off that drifts by a millisecond a
    second, records that differ in length by up to 0.6 ms (as a card's
    traces show): every interval aligns, each at the kernel's own call, and
    the split is the one without an offset."""
    ctx = _trace(40, offset=offset, drift=drift, jitter=600_000)
    starts = sorted(s for s, _, _ in ctx.trace.device)
    calls = _field_spans.launch_calls(ctx.trace.host)
    points = _field_spans.offsets(ctx.trace.gaps, set(starts), calls)
    assert [o for _, o in points] == [k - c for k, c in zip(starts, calls)]
    names = ("sq.launch", "sq.record", "loop")
    got = {k: _field_spans.idle_ms_per_record(ctx, k) for k in names}
    want = {k: _field_spans.idle_ms_per_record(_trace(40, jitter=600_000), k) for k in names}
    # a drifting device clock stretches each ~1 ms idle interval by ~1.35 us on its own
    assert got == pytest.approx(want, abs=5e-3)


def test_a_queued_kernel_does_not_align_the_clocks():
    """A kernel whose call came before its idle interval (the device ran it
    from its queue behind another operation) leaves the offset where the
    kernels launched into an idle device put it."""
    ctx = _trace(8, offset=300_000, queued={4})
    starts = {s for s, _, n in ctx.trace.device if "field_frame_" in n}
    points = _field_spans.offsets(ctx.trace.gaps, starts,
                                  _field_spans.launch_calls(ctx.trace.host))
    assert len(points) == 7
    assert {o for _, o in points} == {305_000}


def test_the_idle_split_is_none_where_no_interval_aligns():
    """No idle interval ends at a field kernel (the trace's kernels are
    another program's): the clocks cannot be put together, and the readers
    report nothing rather than a split on unaligned clocks."""
    ctx = _trace(8, offset=300_000)
    ctx.trace.device = [(s, e, n.replace("field_frame_", "other_")) for s, e, n in
                        ctx.trace.device]
    for name in ("field_launch_idle_ms", "field_record_idle_ms"):
        assert importlib.import_module(f"sqbench.layer_metrics.{name}").read(ctx) is None


def test_readers_without_markers_or_device_give_none():
    ctx = _trace(3)
    bare = types.SimpleNamespace(trace=types.SimpleNamespace(
        host=[h for h in ctx.trace.host if not h[2].startswith("sq.")], device=ctx.trace.device,
        gaps=ctx.trace.gaps), frames=3, cell=ctx.cell, kernel=work.kernel)
    for name in ("field_launch_idle_ms", "field_record_idle_ms"):
        reader = importlib.import_module(f"sqbench.layer_metrics.{name}").read
        assert reader(bare) is None
        assert reader(types.SimpleNamespace(trace=types.SimpleNamespace(
            host=ctx.trace.host, device=[], gaps=[]), frames=3, cell=ctx.cell,
            kernel=work.kernel)) is None


# ---------------------------------------------------------------------------
# the benchmark's entries, by name
# ---------------------------------------------------------------------------


def test_the_field_configuration_loads_by_name():
    cfg = next(c for c in BENCH["configs"] if c["name"] == "phi4_2d_256")
    data = run.load("configs", "phi4_2d_256.json")
    assert cfg["file"] == "sqbench/configs/phi4_2d_256.json" and data["kind"] == "field"
    assert data["source"] == cfg["source"] and data["reduced"] == cfg["reduced"] == ["frames"]
    assert set(data["changes"]) == {"frames"}
    act = actions.get_field(data["chain"]["action"])
    assert {k: getattr(act, k) for k in data["action_params"]} == data["action_params"]
    assert data["chain"]["shape"] == [256, 256] and data["chain"]["n_chains"] == 16
    importlib.import_module(f"sqbench.reference.actions.{data['chain']['action']}")


def test_the_field_cell_loads_by_name():
    entry, e2e, per_layer = run.workload(CELL)
    assert entry["config"] == "phi4_2d_256" and entry["chips"] == 1
    traffic = run.load("traffic", f"{entry['traffic']}.json")
    assert traffic["rng_impl"] == "threefry" and traffic["frames_per_launch"] == 10
    spec = run.load("cells", f"{CELL}.json")
    assert spec["check"]["chains"] == 16
    assert set(spec["limits"]) == set(spec["why"]) == {"state_gap", "decisions", "record_gap",
                                                       "missing"}
    assert spec["limits"]["decisions"] == spec["limits"]["missing"] == 0
    names = {m["name"] for m in e2e}
    assert names == {"mlups.host_paced", "record_ms_p95.host_paced", "setup_s"}
    assert {run.base_name(m) for m in per_layer} == {
        "field_frames_multi_roofline", "field_epilogue_device_ms", "field_launch_idle_ms",
        "field_record_idle_ms"}
    for m in per_layer:
        assert m["moves"] in names
        assert callable(importlib.import_module(f"sqbench.layer_metrics.{run.base_name(m)}").read)


def test_the_one_frame_field_cell_loads_by_name():
    entry, e2e, per_layer = run.workload(CELL_FPL1)
    assert entry["config"] == "phi4_2d_256" and entry["chips"] == 1
    traffic = run.load("traffic", f"{entry['traffic']}.json")
    assert entry["traffic"] == "threefry.fpl1" and traffic["frames_per_launch"] == 1
    spec = run.load("cells", f"{CELL_FPL1}.json")
    assert spec["check"]["chains"] == 16
    assert set(spec["limits"]) == set(spec["why"]) == {"state_gap", "decisions", "record_gap",
                                                       "missing"}
    assert spec["limits"]["decisions"] == spec["limits"]["missing"] == 0
    names = {m["name"] for m in e2e}
    assert names == {"mlups.host_paced", "record_ms_p95.host_paced", "setup_s"}
    assert {run.base_name(m) for m in per_layer} == {
        "field_frame_roofline", "field_epilogue_device_ms", "field_launch_idle_ms",
        "field_record_idle_ms"}
    for m in per_layer:
        assert m["moves"] in names
        assert callable(importlib.import_module(f"sqbench.layer_metrics.{run.base_name(m)}").read)


@pytest.mark.parametrize("reader,kernel,fpl", [("field_frame_roofline", "field_frame", 1),
                                               ("field_frames_multi_roofline",
                                                "field_frames_multi", 10)])
def test_the_field_roofline_readers_read_their_own_kernels_launches(reader, kernel, fpl):
    """The least time a launch over the mean of the kernel's launches in the
    trace, the other kernel's launches left out; None without a launch."""
    spec = run.load("configs", "phi4_2d_256.json")
    cfg = dict(spec["chain"], rng_impl="threefry", frames_per_launch=fpl)
    least, _ = work_field.least_seconds(kernel, cfg, spec["work"])
    other = "field_frames_cl_kernel" if kernel == "field_frame" else "field_frame_cl_kernel"
    device = [(0, 4 * MS, f"void {kernel.replace('_multi', '')}_cl_kernel<ThreefryNoise<20> >"),
              (5 * MS, 11 * MS, f"void {kernel.replace('_multi', '')}_cl_kernel<ThreefryNoise<20> >"),
              (12 * MS, 40 * MS, f"void {other}<ThreefryNoise<20> >")]

    def ctx(dev):
        trace = types.SimpleNamespace(launches=lambda m: [(e - s) * 1e-9 for s, e, n in dev
                                                          if m in n])
        return types.SimpleNamespace(trace=trace, cell=types.SimpleNamespace(cfg=cfg),
                                     config=spec, kernel=work.kernel)
    read = importlib.import_module(f"sqbench.layer_metrics.{reader}").read
    assert read(ctx(device)) == pytest.approx(100.0 * least / 5e-3, rel=1e-12)
    assert read(ctx(device[2:] if kernel == "field_frame" else device[:0])) is None


@pytest.mark.parametrize("kernel,match", [("field_frame", "field_frame_"),
                                          ("field_frames_multi", "field_frames_")])
def test_the_field_kernels_match_their_own_launches(kernel, match):
    """Kernel 3's name matches kernel 3's launches (at B = 1 and on a
    cluster) and not kernel 4's, and the other way round."""
    k = work.kernel(kernel)
    assert k["match"] == match
    names = {"field_frame": ["void field_frame_cl_kernel<ThreefryNoise<20> >(FieldParams)",
                             "void field_frame_kernel<PhiloxNoise>(FieldParams)"],
             "field_frames_multi": ["void field_frames_cl_kernel<ThreefryNoise<20> >(FieldParams)",
                                    "void field_frames_kernel<PhiloxNoise>(FieldParams)"]}
    for name, launches in names.items():
        assert all((match in n) == (name == kernel) for n in launches)

"""``runtime.run_field`` reads each record one frame group late: its records,
checkpoints, stops and final state are those of a loop that reads each
record at once (written out here), and each group but the drained ones is
enqueued before the previous group's record is read.  The CPU cases run the
plain path, and a mesh of two CPU shards, which drains every record; the
``cuda`` cases run kernels 3 and 4 on the card and skip without one."""

import dataclasses
import math
import shutil

import numpy as np
import pytest
import torch

from stochquant_tpu_torch import actions, metrics, runtime
from stochquant_tpu_torch.config import FieldConfig
from stochquant_tpu_torch.integrators import field as field_mod
from stochquant_tpu_torch.io import checkpoint
from stochquant_tpu_torch.kernels import field_kernel
from stochquant_tpu_torch.parallel import make_mesh

torch.set_num_threads(1)

CFG = FieldConfig(action="phi4", shape=(16, 16), n_chains=2, loops=4, seed=3)
KEYS = ("frame", "dtau", "stable_frac", "mag", "abs_mag", "phi2", "susceptibility", "binder")


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _sequential(cfg, device="cpu", frames=None, burn_frames=1):
    """(record, state) of each frame group, the record read as soon as its
    group has run, with the host means of ``run_field``'s seven readbacks;
    ``frames(state, n)`` runs a group (default: the plain integrator)."""
    act = actions.get_field(cfg.action)
    frames = frames or (lambda s, n: field_mod.run_field_frames(s, act, cfg, n))
    volume = math.prod(cfg.shape)
    state = field_mod.init_field_state(cfg, device=device)
    state, _ = frames(state, burn_frames)
    state = field_mod.reset_field_means(state)
    out, done = [], 0
    while done < cfg.frames:
        n = min(cfg.fps, cfg.frames - done)
        state, m = frames(state, n)
        done += n
        out.append(({
            "frame": done - 1,
            "dtau": float(np.mean(_host(m["dtau"][-1]))),
            "stable_frac": float(_host(m["stable"][-n:].float().mean())),
            "mag": float(_host(state.mag_mean).mean()),
            "abs_mag": float(_host(state.absmag_mean).mean()),
            "phi2": float(_host(state.phi2_mean).mean()),
            "susceptibility": float(_host(field_mod.susceptibility(state, volume)).mean()),
            "binder": float(_host(field_mod.binder_cumulant(state)).mean()),
        }, state))
    return out


def _assert_records(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for k in KEYS:
            assert g[k] == w[k], (k, g["frame"])


def _assert_state(got, want):
    for name, a, b in zip(want._fields, got, want):
        assert torch.equal(a, b), name


def _reset_counters():
    for name in ("records", "readbacks", "records_ahead", "records_drained"):
        setattr(runtime.run_field, name, 0)


#: frames, frames a group, the poll of ``stop`` that fires, checkpoint_every
CASES = {
    "fps1": dict(frames=5, fps=1),
    "fps3": dict(frames=9, fps=3),
    "limit_not_a_multiple": dict(frames=7, fps=3),
    "stop_after_record_1": dict(frames=6, fps=1, stop_at=1),
    "stop_after_record_2": dict(frames=8, fps=2, stop_at=2),
    "stop_after_record_5": dict(frames=5, fps=1, stop_at=5),
    "checkpoint_every_2": dict(frames=6, fps=1, every=2),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_field_records_read_one_group_late_are_those_of_a_sequential_loop(case, tmp_path,
                                                                          monkeypatch):
    spec = CASES[case]
    cfg = dataclasses.replace(CFG, frames=spec["frames"], fps=spec["fps"])
    want = _sequential(cfg)
    stop_at, every = spec.get("stop_at"), spec.get("every", 0)
    n_records = stop_at or len(want)
    drained = {n_records} | {k for k in range(1, n_records + 1)
                             if every and (k * cfg.fps) % every == 0}

    events = []
    real = field_mod.run_field_frames

    def logged(state, *a, **kw):
        events.append("group")
        return real(state, *a, **kw)

    monkeypatch.setattr(field_mod, "run_field_frames", logged)
    ck, kept = tmp_path / "ck.npz", tmp_path / "kept.npz"
    recs, preempted, polls = [], [], []

    def on_record(rec):
        if rec["type"] == "frame":
            events.append("record")
            recs.append(rec)
            if every and len(recs) == every + 1:
                shutil.copy(ck, kept)  # the checkpoint written after record `every`
        elif rec["type"] == "preempted":
            preempted.append(rec)

    def stop():
        polls.append(len(recs))
        return len(polls) == stop_at

    _reset_counters()
    res = runtime.run_field(cfg, device="cpu", backend="torch", burn_frames=1,
                            sink=metrics.MetricsSink(callback=on_record),
                            checkpoint_out=str(ck), checkpoint_every=every, stop=stop)

    # the order: group k+1 is enqueued before record k is read, unless k is drained
    order = ["group"]  # the burn-in
    for k in range(1, n_records + 1):
        if k == 1 or k - 1 in drained:
            order.append("group")
        if k not in drained:
            order.append("group")
        order.append("record")
    assert events == order
    assert polls == list(range(n_records))  # once a group, before its record is read
    assert runtime.run_field.records_ahead == n_records - len(drained)
    assert runtime.run_field.records_drained == len(drained)
    assert runtime.run_field.records == len(recs) == n_records
    assert runtime.run_field.readbacks == 7 * n_records

    _assert_records(recs, [r for r, _ in want[:n_records]])
    _assert_state(res.state, want[n_records - 1][1])
    frames_done = min(n_records * cfg.fps, cfg.frames)
    assert checkpoint.read_meta(ck)["frames_done"] == frames_done
    assert [p["frames_done"] for p in preempted] == ([frames_done] if stop_at else [])

    resume_from = ck if stop_at else kept if every else None
    if resume_from is None:
        return
    # a resume continues the uninterrupted run from the state the last record described
    start = checkpoint.read_meta(resume_from)["frames_done"] // cfg.fps
    saved, _ = checkpoint.load(resume_from, "cpu")
    _assert_state(saved, want[start - 1][1])
    recs.clear()
    res = runtime.run_field(cfg, device="cpu", backend="torch",
                            sink=metrics.MetricsSink(callback=on_record),
                            checkpoint_in=str(resume_from), resume_progress=True)
    _assert_records(recs, [r for r, _ in want[start:]])
    _assert_state(res.state, want[-1][1])


@pytest.mark.parametrize("stop_at", [None, 2])
def test_a_field_mesh_run_drains_every_record(stop_at, tmp_path):
    """Two CPU shards through the halo runner: every record is copied at once
    and read with nothing enqueued behind it, and the records and state are
    those of the same mesh run stopped after each record and resumed."""
    cfg = dataclasses.replace(CFG, frames=4, fps=1, mesh_axes=("x", None))
    mesh = make_mesh([("x", 2)], devices="cpu")
    recs, polls = [], []

    def stop():
        polls.append(len(recs))
        return len(polls) == stop_at

    def frames_only(into):
        return metrics.MetricsSink(callback=lambda r: r["type"] == "frame" and into.append(r))

    _reset_counters()
    res = runtime.run_field(cfg, mesh=mesh, backend="torch", burn_frames=1, stop=stop,
                            sink=frames_only(recs))
    n_records = stop_at or cfg.frames
    assert len(recs) == n_records
    assert polls == list(range(n_records))
    assert runtime.run_field.records_ahead == 0
    assert runtime.run_field.records_drained == n_records
    assert runtime.run_field.readbacks == 7 * n_records

    ck = tmp_path / "ck.npz"
    drained, state = [], None
    for k in range(n_records):
        state = runtime.run_field(cfg, mesh=mesh, backend="torch", burn_frames=1,
                                  sink=frames_only(drained), checkpoint_out=str(ck),
                                  checkpoint_in=str(ck) if k else None,
                                  resume_progress=bool(k), stop=lambda: True).state
    _assert_records(recs, drained)
    _assert_state(res.state, state)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU interpret mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("fpl", [1, 10])
def test_field_kernel_runs_read_records_late_into_pinned_slots(cuda_device, fpl,
                                                               monkeypatch):
    """Kernel 3 (a group of one frame, the PyTorch epilogue) and kernel 4 (10
    frames a launch): the records and final state are bitwise those of a
    loop that reads each record at once; the host slots are page-locked;
    every record but the last is read with the next group enqueued, and
    nothing enqueued between a stop poll and the record read after it
    synchronises the stream."""
    cfg = dataclasses.replace(CFG, shape=(64, 64), n_chains=4, loops=20, fps=fpl,
                              frames_per_launch=fpl, frames=5 * fpl)
    act = actions.get_field(cfg.action)
    n_records = 5
    want = _sequential(cfg, cuda_device, lambda s, n: field_kernel.run_field_frames_kernel(
        s, act, cfg, n, frames_per_launch=min(cfg.frames_per_launch, n)))

    made = []

    class Kept(runtime._FieldRecords):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(runtime, "_FieldRecords", Kept)
    recs = []

    def on_record(rec):
        torch.cuda.set_sync_debug_mode(0)
        if rec["type"] == "frame":
            recs.append(rec)

    def stop():
        torch.cuda.set_sync_debug_mode("error")  # until the record after this poll is read
        return False

    _reset_counters()
    try:
        res = runtime.run_field(cfg, device=cuda_device, backend="cuda", burn_frames=1,
                                sink=metrics.MetricsSink(callback=on_record), stop=stop)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert runtime.run_field.records_ahead == n_records - 1
    assert runtime.run_field.records_drained == 1
    assert runtime.run_field.readbacks == 7 * n_records
    (records,) = made
    assert all(t.is_pinned() for slot in records.slots for t in slot["host"].values())
    assert all(slot["event"] is not None for slot in records.slots)
    _assert_records(recs, [r for r, _ in want])
    _assert_state(res.state, want[-1][1])

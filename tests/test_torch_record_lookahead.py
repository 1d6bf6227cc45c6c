"""``runtime.run_chain`` reads each record one frame group late: its records,
checkpoints, stops and final state are those of a loop that reads each
record at once (written out here), and each group but the drained ones is
enqueued before the previous group's record is read.  The CPU cases run the
plain path; the ``cuda`` cases run kernels 1 and 2 on the card, and a mesh
over two cards, and skip without them."""

import dataclasses
import shutil

import numpy as np
import pytest
import torch

from stochquant_tpu_torch import actions, metrics, runtime
from stochquant_tpu_torch.config import PRESETS
from stochquant_tpu_torch.integrators import langevin
from stochquant_tpu_torch.io import checkpoint
from stochquant_tpu_torch.parallel import make_mesh

torch.set_num_threads(1)

CFG = dataclasses.replace(PRESETS["double_well"], n_chains=4, n_sites=16, loops=5,
                          dtau=1e-4)
KEYS = ("frame", "dtau", "stable_frac", "log_abs_corr")


def _sequential(cfg, burn_frames=1):
    """(record, state) of each frame group, the record read as soon as its
    group has run."""
    act = actions.get(cfg.action)
    state = langevin.init_chain_state(cfg, act, device="cpu")
    state, _ = langevin.run_frames(state, act, cfg, burn_frames)
    state = langevin.reset_means(state)
    out, done = [], 0
    while done < cfg.frames:
        n = min(cfg.fps, cfg.frames - done)
        state, m = langevin.run_frames(state, act, cfg, n)
        done += n
        corr = langevin.connected_correlator(state).mean(dim=0).double().numpy()
        out.append(({"frame": done - 1, "dtau": float(np.mean(m["dtau"][-1].numpy())),
                     "stable_frac": float(m["stable"][-n:].float().mean()),
                     "log_abs_corr": np.log(np.abs(corr) + 1e-300)}, state))
    return out


def _assert_records(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for k in KEYS:
            assert np.array_equal(g[k], w[k]), (k, g["frame"])


def _assert_state(got, want):
    for name, a, b in zip(want._fields, got, want):
        assert torch.equal(a, b), name


def _reset_counters():
    runtime.run_chain.records_ahead = runtime.run_chain.records_drained = 0


#: frames, frames a group, the poll of ``stop`` that fires, checkpoint_every
CASES = {
    "fps1": dict(frames=5, fps=1),
    "fps4": dict(frames=8, fps=4),
    "limit_not_a_multiple": dict(frames=7, fps=3),
    "stop_after_record_1": dict(frames=6, fps=1, stop_at=1),
    "stop_after_record_2": dict(frames=8, fps=2, stop_at=2),
    "stop_after_record_5": dict(frames=7, fps=1, stop_at=5),
    "checkpoint_every_2": dict(frames=6, fps=1, every=2),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_records_read_one_group_late_are_those_of_a_sequential_loop(case, tmp_path,
                                                                    monkeypatch):
    spec = CASES[case]
    cfg = dataclasses.replace(CFG, frames=spec["frames"], fps=spec["fps"])
    want = _sequential(cfg)
    stop_at, every = spec.get("stop_at"), spec.get("every", 0)
    n_records = stop_at or len(want)
    drained = {n_records} | {k for k in range(1, n_records + 1)
                             if every and (k * cfg.fps) % every == 0}

    events = []
    real = langevin.run_frames

    def logged(state, *a, **kw):
        events.append("group")
        return real(state, *a, **kw)

    monkeypatch.setattr(langevin, "run_frames", logged)
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
    res = runtime.run_chain(cfg, device="cpu", backend="torch", burn_frames=1,
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
    assert runtime.run_chain.records_ahead == n_records - len(drained)
    assert runtime.run_chain.records_drained == len(drained)
    assert runtime.run_chain.records_ahead + runtime.run_chain.records_drained == len(recs)

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
    res = runtime.run_chain(cfg, device="cpu", backend="torch",
                            sink=metrics.MetricsSink(callback=on_record),
                            checkpoint_in=str(resume_from), resume_progress=True)
    _assert_records(recs, [r for r, _ in want[start:]])
    _assert_state(res.state, want[-1][1])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU interpret mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("fps", [1, 16])
def test_kernel_runs_read_records_late_without_a_sync_and_as_drained_runs(cuda_device,
                                                                          fps, tmp_path):
    """Kernel 1 (a group of one frame) and kernel 2 (16 frames a launch): the
    records and final state equal those of the same run stopped after every
    record and resumed, which drains each record; every record but the last
    is read with the next group enqueued; nothing enqueued between a stop
    poll and the record read after it synchronises the stream."""
    cfg = dataclasses.replace(PRESETS["double_well"], n_chains=256, n_sites=64, loops=100,
                              dtau=1e-4, fps=fps, frames_per_launch=fps, frames=5 * fps)
    n_records = 5

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
        res = runtime.run_chain(cfg, device=cuda_device, backend="cuda", burn_frames=1,
                                sink=metrics.MetricsSink(callback=on_record), stop=stop)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert len(recs) == n_records
    assert runtime.run_chain.records_ahead >= n_records - 1
    assert runtime.run_chain.records_ahead + runtime.run_chain.records_drained == n_records

    ck = tmp_path / "ck.npz"
    drained, state = [], None
    for k in range(n_records):
        state = runtime.run_chain(
            cfg, device=cuda_device, backend="cuda", burn_frames=1,
            sink=metrics.MetricsSink(callback=lambda r: r["type"] == "frame" and drained.append(r)),
            checkpoint_out=str(ck), checkpoint_in=str(ck) if k else None,
            resume_progress=bool(k), stop=lambda: True).state
    _assert_records(recs, drained)
    _assert_state(res.state, state)


@pytest.mark.cuda
def test_a_mesh_over_two_cards_assembling_on_the_second_reads_whole_records():
    """A chain mesh over cuda:0 and cuda:1 that assembles on cuda:1 gathers
    its Δτ row on cuda:0 and its correlator on cuda:1; each record is copied
    to the host at once, so records and state are the unsplit run's."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs: the mesh puts a shard on each of cuda:0 and cuda:1")
    cfg = dataclasses.replace(PRESETS["double_well"], n_chains=8192, n_sites=200, loops=50,
                              dtau=1e-4, fps=1, frames_per_launch=1, frames=6)
    want, got = [], []
    a = runtime.run_chain(cfg, device="cuda:0", backend="cuda", burn_frames=1,
                          sink=metrics.MetricsSink(callback=want.append))
    b = runtime.run_chain(dataclasses.replace(cfg, mesh_chain_axis="chain"),
                          mesh=make_mesh([("chain", 2)], devices=["cuda:0", "cuda:1"]),
                          device="cuda:1", backend="cuda", burn_frames=1,
                          sink=metrics.MetricsSink(callback=got.append))
    torch.cuda.synchronize("cuda:0")
    torch.cuda.synchronize("cuda:1")
    _assert_records([r for r in got if r["type"] == "frame"],
                    [r for r in want if r["type"] == "frame"])
    _assert_state([t.cpu() for t in b.state], a.state._replace(**{
        name: t.cpu() for name, t in zip(a.state._fields, a.state)}))

"""The port's runtime and CLI on the CPU: frame records, checkpoints, the
same final state as the JAX runtime, the field and gauge paths' routing,
and loud refusals of what is not ported."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from stochquant_tpu import metrics as jmetrics
from stochquant_tpu import runtime as jruntime
from stochquant_tpu.config import ChainConfig as JChainConfig
from stochquant_tpu.config import FieldConfig as JFieldConfig
from stochquant_tpu.integrators.gauge import GaugeConfig as JGaugeConfig
from stochquant_tpu_torch import cli, metrics, runtime
from stochquant_tpu_torch.config import PRESETS, ChainConfig, FieldConfig, Scheme, Sweep
from stochquant_tpu_torch.integrators.gauge import GaugeConfig
from stochquant_tpu_torch.io import checkpoint
from stochquant_tpu_torch.kernels import field_kernel_nd

torch.set_num_threads(1)

TINY = {
    "double_well": dataclasses.replace(PRESETS["double_well"], n_chains=4, n_sites=32,
                                       loops=10, frames=4, fps=2, dtau=1e-4),
    "harmosc": dataclasses.replace(PRESETS["harmosc"], n_chains=4, n_sites=16, loops=10,
                                   frames=3, dtau=1e-3),
}


def _records(path):
    return [json.loads(line) for line in open(path)]


def _check_records(recs, n_sites, n_frame_records):
    frames = [r for r in recs if r["type"] == "frame"]
    assert len(frames) == n_frame_records
    for r in frames:
        assert 0.0 <= r["stable_frac"] <= 1.0 and r["dtau"] > 0
        corr = np.asarray(r["log_abs_corr"])
        assert corr.shape == (n_sites,) and np.all(np.isfinite(corr))
    assert frames[-1]["percent"] == 100.0
    assert recs[-1]["type"] == "summary" and recs[-1]["total_site_updates"] > 0


@pytest.mark.parametrize("name", sorted(TINY))
def test_run_chain_on_cpu_matches_jax_runtime(name, tmp_path):
    cfg = TINY[name]
    mpath, ck = tmp_path / "m.jsonl", tmp_path / "ck.npz"
    with open(mpath, "w") as fh:
        res = runtime.run_chain(cfg, device="cpu", sink=metrics.MetricsSink(stream=fh),
                                checkpoint_out=str(ck), burn_frames=1)
    _check_records(_records(mpath), cfg.n_sites, -(-cfg.frames // cfg.fps))
    assert checkpoint.read_meta(ck)["frames_done"] == cfg.frames

    jres = jruntime.run_chain(JChainConfig.from_json(cfg.to_json()), backend="xla",
                              sink=jmetrics.MetricsSink(), burn_frames=1)
    for leaf, got, want in zip(res.state._fields, res.state, jres.state):
        want = np.asarray(want)
        if leaf in ("runs", "stab_cnt", "step"):
            np.testing.assert_array_equal(got.numpy().astype(want.dtype), want, err_msg=leaf)
        else:
            np.testing.assert_allclose(got.numpy(), want, rtol=2e-6, atol=2e-6, err_msg=leaf)


def test_cli_run_cpu_and_resume(tmp_path):
    m1, m2, ck = tmp_path / "a.jsonl", tmp_path / "b.jsonl", tmp_path / "ck.npz"
    base = ["run", "--preset", "harmosc", "--device", "cpu", "--loops", "5", "--chains", "2",
            "--dtau", "1e-3"]
    cli.main(base + ["--frames", "2", "--metrics", str(m1), "--out", str(ck)])
    _check_records(_records(m1), 100, 2)
    cli.main(base + ["--frames", "1", "--resume", str(ck), "--metrics", str(m2),
                     "--out", str(ck), "--backend", "torch", "--scheme", "heun",
                     "--rng", "threefry13"])
    _check_records(_records(m2), 100, 1)
    state, cfg = checkpoint.load(ck, "cpu")
    assert int(state.step) == 2 + 3 * 5 and cfg.scheme == Scheme.HEUN

    prof = tmp_path / "prof"
    cli.main(base + ["--frames", "1", "--metrics", str(m2), "--profile", str(prof)])
    assert json.loads((prof / "trace.json").read_text())["traceEvents"]


def test_auto_resume_and_preemption_are_bitwise(tmp_path):
    cfg = dataclasses.replace(TINY["harmosc"], frames=4, fps=1)
    full = runtime.run_chain(cfg, device="cpu", sink=metrics.MetricsSink()).state
    ck = tmp_path / "pre.npz"
    calls = {"n": 0}

    def stop():
        calls["n"] += 1
        return calls["n"] >= 2  # trip at the end of frame 2

    mpath = tmp_path / "m.jsonl"
    with open(mpath, "w") as fh:
        runtime.run_chain(cfg, device="cpu", sink=metrics.MetricsSink(stream=fh),
                          checkpoint_out=str(ck), stop=stop)
    assert any(r["type"] == "preempted" and r["frames_done"] == 2 for r in _records(mpath))
    res = runtime.run_chain(cfg, device="cpu", sink=metrics.MetricsSink(),
                            checkpoint_in=str(ck), resume_progress=True)
    for name, a, b in zip(full._fields, res.state, full):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)

    with pytest.raises(SystemExit):
        cli.main(["run", "--preset", "harmosc", "--device", "cpu", "--auto-resume"])


def test_unported_paths_raise():
    cfg = TINY["harmosc"]
    with pytest.raises(ValueError, match="CUDA device"):
        runtime.run_chain(cfg, device="cpu", backend="cuda")
    with pytest.raises(ValueError, match="backend"):
        runtime.run_chain(cfg, device="cpu", backend="pallas")
    for change, feature in ((dict(block_chains=0), "autotune"),
                            (dict(mesh_chain_axis="chains"), "mesh_chain_axis"),
                            (dict(scheme=Scheme.LM, loops=11), "even"),
                            # harmosc's double-well sibling keeps a zero mode: EXACT needs it frozen
                            (dict(scheme=Scheme.EXACT, action="double_well"), "EXACT")):
        with pytest.raises(ValueError, match=feature):
            runtime.run_chain(dataclasses.replace(cfg, **change), device="cpu")
    # what raised before this port had them: LM, EXACT, the power spectrum and
    # rng_impl='hardware' run (tests of their values: test_torch_schemes.py)
    for change in (dict(scheme=Scheme.LM), dict(scheme=Scheme.EXACT),
                   dict(accumulate_spectrum=True), dict(rng_impl="hardware")):
        res = runtime.run_chain(dataclasses.replace(cfg, frames=1, **change), device="cpu",
                                sink=metrics.MetricsSink())
        assert torch.isfinite(res.state.f).all() and int(res.state.step) == 2 + cfg.loops
    with pytest.raises(ValueError, match="EXACT"):
        cli.main(["run", "--preset", "phi4_2d", "--device", "cpu", "--scheme", "exact",
                  "--backend", "cuda"])
    with pytest.raises(SystemExit):
        cli.main(["run", "--preset", "no_such_preset", "--device", "cpu"])


def test_cuda_device_without_a_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU; the refusal is for hosts without one")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["run", "--preset", "harmosc", "--frames", "1", "--loops", "2"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        runtime.run_chain(TINY["harmosc"], device="cuda")


FIELD_OBS = ("mag", "abs_mag", "phi2", "susceptibility", "binder")
MEANS = ("mag_mean", "mag2_mean", "mag4_mean", "absmag_mean", "phi2_mean", "act_mean",
         "corr_mean")


def test_cli_run_phi4_2d_cpu_matches_jax_runtime(tmp_path):
    mpath, ck = tmp_path / "m.jsonl", tmp_path / "ck.npz"
    cli.main(["run", "--preset", "phi4_2d", "--device", "cpu", "--chains", "2", "--loops", "4",
              "--frames", "2", "--burn", "1", "--metrics", str(mpath), "--out", str(ck)])
    state, cfg = checkpoint.load(ck, "cpu")
    assert cfg.shape == (256, 256) and int(state.step) == 1 + 3 * 4
    recs = _records(mpath)
    frames = [r for r in recs if r["type"] == "frame"]
    assert len(frames) == 2 and recs[-1]["type"] == "summary"

    jrecs = []
    jres = jruntime.run_field(JFieldConfig.from_json(cfg.to_json()), backend="xla",
                              sink=jmetrics.MetricsSink(callback=jrecs.append), burn_frames=1)
    jframes = [r for r in jrecs if r["type"] == "frame"]
    for got, want in zip(frames, jframes):
        assert got["stable_frac"] == want["stable_frac"] == 1.0
        assert got["dtau"] == want["dtau"]
        for key in FIELD_OBS:
            np.testing.assert_allclose(got[key], want[key], rtol=1e-3, atol=1e-6, err_msg=key)
    for leaf, got, want in zip(state._fields, state, jres.state):
        want = np.asarray(want)
        if leaf in ("runs", "stab_cnt", "step"):
            np.testing.assert_array_equal(got.numpy().astype(want.dtype), want, err_msg=leaf)
        elif leaf in MEANS:
            np.testing.assert_allclose(got.numpy(), want, rtol=3e-5, atol=3e-6, err_msg=leaf)
        else:
            np.testing.assert_allclose(got.numpy(), want, rtol=2e-6, atol=2e-6, err_msg=leaf)


def test_field_resume_and_preemption_are_bitwise(tmp_path):
    cfg = FieldConfig(shape=(8, 16), dtau=0.01, n_chains=2, loops=4, frames=4, fps=1, seed=3,
                      sweep=Sweep.CHECKERBOARD)
    full = runtime.run_field(cfg, device="cpu", sink=metrics.MetricsSink(), burn_frames=1).state
    ck = tmp_path / "pre.npz"
    calls = {"n": 0}

    def stop():
        calls["n"] += 1
        return calls["n"] >= 3  # trip at the end of frame 3

    mpath = tmp_path / "m.jsonl"
    with open(mpath, "w") as fh:
        runtime.run_field(cfg, device="cpu", sink=metrics.MetricsSink(stream=fh), burn_frames=1,
                          checkpoint_out=str(ck), stop=stop)
    recs = _records(mpath)
    assert any(r["type"] == "preempted" and r["frames_done"] == 3 for r in recs)
    assert all(np.isfinite(r[k]) for r in recs if r["type"] == "frame" for k in FIELD_OBS)
    res = runtime.run_field(cfg, device="cpu", sink=metrics.MetricsSink(), burn_frames=1,
                            checkpoint_in=str(ck), resume_progress=True)
    for name, a, b in zip(full._fields, res.state, full):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)


CUDA = torch.device("cuda")
BASE = FieldConfig(shape=(256, 256), loops=100)


@pytest.mark.parametrize("change,backend,device,want", [
    # the JAX rule: whole-lattice kernels up to 1 MiB per chain, else tiled
    ({}, "auto", CUDA, "cuda"),
    ({}, "cuda", CUDA, "cuda"),
    (dict(shape=(512, 512)), "auto", CUDA, "cuda"),
    (dict(shape=(1024, 512)), "auto", CUDA, "cuda_tiled"),
    (dict(shape=(1024, 1024), sweep=Sweep.CHECKERBOARD), "cuda", CUDA, "cuda_tiled"),
    (dict(tile_rows=64), "auto", CUDA, "cuda_tiled"),
    (dict(loops=7), "auto", CUDA, "cuda"),
    ({}, "torch", CUDA, "torch"),
    (dict(shape=(32, 32, 32, 32)), "torch", CUDA, "torch"),
    ({}, "auto", torch.device("cpu"), "torch"),
    (dict(shape=(32, 32, 32, 32)), "auto", torch.device("cpu"), "torch"),
    # rng_impl='hardware': the Philox variants of kernels 3 and 4; ignored by 'torch'
    (dict(rng_impl="hardware"), "auto", CUDA, "cuda"),
    (dict(rng_impl="hardware", shape=(512, 512), loops=7), "cuda", CUDA, "cuda"),
    (dict(rng_impl="hardware", shape=(1024, 1024)), "torch", CUDA, "torch"),
    (dict(rng_impl="hardware", shape=(16, 16, 16)), "auto", torch.device("cpu"), "torch"),
    # Scheme.EXACT runs the plain integrator on every device ('auto' and 'torch')
    (dict(scheme=Scheme.EXACT, action="free_field"), "auto", CUDA, "torch"),
    (dict(scheme=Scheme.EXACT), "auto", CUDA, "torch"),
    (dict(scheme=Scheme.EXACT, shape=(8, 8, 8)), "torch", CUDA, "torch"),
    (dict(scheme=Scheme.EXACT), "auto", torch.device("cpu"), "torch"),
    # D >= 3 lattices run kernels 6 and 7 on a CUDA device
    (dict(shape=(32, 32, 32, 32)), "auto", CUDA, "cuda_nd"),
    (dict(shape=(16, 16, 16)), "cuda", CUDA, "cuda_nd"),
    (dict(shape=(32, 32, 32, 32), exchange_steps=4, tile_rows=8), "auto", CUDA, "cuda_nd"),
    (dict(shape=(8, 8, 4, 4, 2), sweep=Sweep.CHECKERBOARD, rng_impl="threefry13"), "cuda", CUDA,
     "cuda_nd"),
    # an odd loops on a path of pair launches ends each frame in one launch of
    # kernel 6's code at one micro-step: nothing gives way to the plain integrator
    (dict(shape=(32, 32, 32, 32), loops=7), "cuda", CUDA, "cuda_nd"),
    (dict(shape=(32, 32, 32, 32), loops=7), "auto", CUDA, "cuda_nd"),
    (dict(shape=(16, 16, 16), loops=1, exchange_steps=4), "auto", CUDA, "cuda_nd"),
    (dict(shape=(2048, 2048), loops=5), "auto", CUDA, "cuda_tiled"),
    (dict(tile_rows=64, loops=7), "auto", CUDA, "cuda_tiled"),
    (dict(tile_rows=64, loops=7), "cuda", CUDA, "cuda_tiled"),
    (dict(shape=(2048, 2048), loops=5), "cuda", CUDA, "cuda_tiled"),
])
def test_field_routing(change, backend, device, want):
    cfg = dataclasses.replace(BASE, **change)
    assert runtime.select_field_backend(cfg, backend, device) == want


@pytest.mark.parametrize("change,backend,device,match", [
    (dict(shape=(4, 4, 2, 2, 2, 2)), "auto", CUDA, "lattice dims"),
    (dict(shape=(16, 16, 16), tile_rows=0), "auto", CUDA, "autotune"),
    (dict(shape=(16, 16, 16), dtype="float64"), "auto", CUDA, "float32"),
    (dict(mesh_axes=("x", None)), "auto", CUDA, "mesh_axes"),
    (dict(mesh_axes=("x", None)), "torch", torch.device("cpu"), "mesh_axes"),
    (dict(mesh_chain_axis="chains"), "auto", CUDA, "mesh_chain_axis"),
    (dict(tile_rows=0), "auto", CUDA, "autotune"),
    # rng_impl='hardware' is kernels 3 and 4's: the tiled and D >= 3 kernels refuse it
    # on 'auto' as on 'cuda', and nothing gives way to the plain integrator unasked
    (dict(rng_impl="hardware", tile_rows=64), "auto", CUDA, "hardware"),
    (dict(rng_impl="hardware", shape=(1024, 1024)), "cuda", CUDA, "backend='torch'"),
    (dict(rng_impl="hardware", shape=(16, 16, 16)), "auto", CUDA, "hardware"),
    (dict(rng_impl="hardware", shape=(16, 16, 16)), "cuda", CUDA, "backend='torch'"),
    # Scheme.EXACT is a plain-path scheme: 'cuda' refuses it; no path takes m² <= 0,
    # a CHECKERBOARD sweep or a mesh under it
    (dict(scheme=Scheme.EXACT, action="free_field"), "cuda", CUDA, "EXACT"),
    (dict(scheme=Scheme.EXACT, sweep=Sweep.CHECKERBOARD), "torch", torch.device("cpu"), "SYNC"),
    (dict(scheme=Scheme.EXACT, sweep=Sweep.CHECKERBOARD), "auto", CUDA, "EXACT"),
    (dict(scheme=Scheme.EXACT, mesh_axes=("x", None)), "auto", CUDA, "single-program"),
    (dict(dtype="float64"), "cuda", CUDA, "float32"),
    ({}, "cuda", torch.device("cpu"), "CUDA device"),
    ({}, "pallas", CUDA, "backend"),
])
def test_field_routing_raises_for_what_is_not_ported(change, backend, device, match):
    cfg = dataclasses.replace(BASE, **change)
    with pytest.raises(ValueError, match=match):
        runtime.select_field_backend(cfg, backend, device)


def test_run_field_raises_for_an_odd_loops_on_the_nd_route(monkeypatch):
    # what 'auto' does on a CUDA device for an odd loops in 4-D, run here on the CPU
    # (the kernel wrappers run their plain versions): it no longer raises; each frame
    # is one pair and the one-step tail, and equals backend='torch' bit for bit
    real = runtime.select_field_backend
    monkeypatch.setattr(runtime, "select_field_backend",
                        lambda cfg, backend, device: real(cfg, backend, CUDA))
    tails = []
    real_tail = field_kernel_nd.field_step_nd
    monkeypatch.setattr(field_kernel_nd, "field_step_nd",
                        lambda *a: tails.append(a[4]) or real_tail(*a))
    cfg = dataclasses.replace(PRESETS["phi4_4d"], shape=(4, 4, 4, 4), n_chains=1, loops=3, frames=2)
    recs = []
    got = runtime.run_field(cfg, device="cpu", sink=metrics.MetricsSink(callback=recs.append))
    assert [r["type"] for r in recs] == ["frame", "frame", "summary"]
    assert tails == [1 + 2, 1 + 3 + 2]  # counter step0 + loops - 1 of each frame
    want = runtime.run_field(cfg, device="cpu", backend="torch", sink=metrics.MetricsSink())
    for name in ("phi", "dtau", "lrg_vl", "runs", "stab_cnt", "step"):
        assert torch.equal(getattr(got.state, name), getattr(want.state, name)), name


CUT_4D = dataclasses.replace(PRESETS["phi4_4d"], shape=(8, 8, 4, 4), n_chains=2, loops=4)


@pytest.mark.parametrize("extra,launches", [([], "pair"), (["--exchange-steps", "4"], "chunk")])
def test_cli_run_phi4_4d_cut_resumes_bitwise_and_matches_jax(extra, launches, monkeypatch,
                                                             tmp_path):
    """The slice as a whole: ``cli run --preset phi4_4d`` on the kernel route
    (its wrappers run their plain versions on CPU tensors), at a cut shape."""
    from stochquant_tpu_torch.kernels import field_kernel_nd as nd

    monkeypatch.setitem(cli.PRESETS, "phi4_4d", CUT_4D)
    real = runtime.select_field_backend
    monkeypatch.setattr(runtime, "select_field_backend",
                        lambda cfg, backend, device: real(cfg, backend, CUDA))
    calls = {"pair": 0, "chunk": 0}
    pair, chunk = nd.field_pair_nd, nd.field_chunk_nd
    monkeypatch.setattr(nd, "field_pair_nd",
                        lambda *a: calls.__setitem__("pair", calls["pair"] + 1) or pair(*a))
    monkeypatch.setattr(nd, "field_chunk_nd",
                        lambda *a: calls.__setitem__("chunk", calls["chunk"] + 1) or chunk(*a))
    base = ["run", "--preset", "phi4_4d", "--device", "cpu", *extra]
    paths = {k: (tmp_path / f"{k}.npz", tmp_path / f"{k}.jsonl") for k in "abc"}
    cli.main(base + ["--burn", "1", "--frames", "3", "--out", str(paths["a"][0]),
                     "--metrics", str(paths["a"][1])])
    cli.main(base + ["--frames", "1", "--resume", str(paths["a"][0]), "--out",
                     str(paths["b"][0]), "--metrics", str(paths["b"][1])])
    cli.main(base + ["--burn", "1", "--frames", "4", "--out", str(paths["c"][0]),
                     "--metrics", str(paths["c"][1])])
    other = "chunk" if launches == "pair" else "pair"
    assert calls[launches] == 10 * (2 if launches == "pair" else 1) and calls[other] == 0
    resumed, _ = checkpoint.load(paths["b"][0], "cpu")
    straight, cfg = checkpoint.load(paths["c"][0], "cpu")
    for name, x, y in zip(resumed._fields, resumed, straight):
        torch.testing.assert_close(x, y, rtol=0, atol=0, msg=name)
    assert cfg.shape == (8, 8, 4, 4) and int(straight.step) == 1 + 5 * 4
    assert cfg.exchange_steps == (4 if extra else None)
    frames = [r for r in _records(paths["a"][1]) if r["type"] == "frame"]
    assert [r["frame"] for r in frames] == [0, 1, 2]

    # the JAX runtime from the same checkpoint gives the same record and state
    jrecs = []
    jcfg = dataclasses.replace(JFieldConfig.from_json(cfg.to_json()), frames=1)
    jres = jruntime.run_field(jcfg, backend="xla", checkpoint_in=str(paths["a"][0]),
                              sink=jmetrics.MetricsSink(callback=jrecs.append))
    got = [r for r in _records(paths["b"][1]) if r["type"] == "frame"][0]
    want = [r for r in jrecs if r["type"] == "frame"][0]
    assert got["stable_frac"] == want["stable_frac"] == 1.0 and got["dtau"] == want["dtau"]
    for key in FIELD_OBS:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-3, atol=1e-6, err_msg=key)
    for leaf, g, w in zip(resumed._fields, resumed, jres.state):
        w = np.asarray(w)
        if leaf in ("runs", "stab_cnt", "step"):
            np.testing.assert_array_equal(g.numpy().astype(w.dtype), w, err_msg=leaf)
        elif leaf in MEANS:
            np.testing.assert_allclose(g.numpy(), w, rtol=3e-5, atol=3e-6, err_msg=leaf)
        else:
            np.testing.assert_allclose(g.numpy(), w, rtol=2e-6, atol=2e-6, err_msg=leaf)


GAUGE_BASE = GaugeConfig(group="u1", shape=(16, 16), n_chains=4, loops=10)


@pytest.mark.parametrize("change,backend,device,want", [
    ({}, "auto", CUDA, "cuda"),
    (dict(group="su2"), "cuda", CUDA, "cuda"),
    (dict(group="su3", shape=(64, 64)), "auto", CUDA, "cuda"),
    ({}, "torch", CUDA, "torch"),
    ({}, "auto", torch.device("cpu"), "torch"),
    (dict(group="su3", shape=(4, 4, 4, 4)), "auto", torch.device("cpu"), "torch"),
    (dict(exchange_steps=8), "auto", CUDA, "cuda"),  # unused without a mesh
])
def test_gauge_routing(change, backend, device, want):
    cfg = dataclasses.replace(GAUGE_BASE, **change)
    assert runtime.select_gauge_backend(cfg, backend, device) == (want, None)


@pytest.mark.parametrize("change", [dict(group="su3", shape=(4, 4, 4, 4)),
                                    dict(group="su2", shape=(8, 8, 8, 8)),
                                    dict(cooling_rate=0.05)])
def test_gauge_auto_on_cuda_falls_back_for_what_has_no_kernel(change):
    cfg = dataclasses.replace(GAUGE_BASE, **change)
    route, reason = runtime.select_gauge_backend(cfg, "auto", CUDA)
    assert route == "torch" and "2-D u1/su2/su3" in reason


@pytest.mark.parametrize("change,backend,device,match", [
    (dict(group="su3", shape=(4, 4, 4, 4)), "cuda", CUDA, "2-D"),
    (dict(cooling_rate=0.05), "cuda", CUDA, "cooling"),
    ({}, "cuda", torch.device("cpu"), "CUDA device"),
    (dict(mesh_axes=("x", None)), "auto", CUDA, "mesh_axes"),
    (dict(mesh_chain_axis="chains"), "torch", torch.device("cpu"), "mesh_chain_axis"),
    # the complexified groups have no kernel in either package: 'cuda' names the group
    (dict(group="cu1", beta_im=0.5), "cuda", CUDA, "group cu1"),
    (dict(group="csu3"), "cuda", CUDA, "group csu3"),
    ({}, "pallas", CUDA, "backend"),
])
def test_gauge_routing_raises_for_what_is_not_ported(change, backend, device, match):
    cfg = dataclasses.replace(GAUGE_BASE, **change)
    with pytest.raises(ValueError, match=match):
        runtime.select_gauge_backend(cfg, backend, device)


def test_run_gauge_records_the_backend_fallback(monkeypatch):
    # what 'auto' does on a CUDA device for su3_4d, run here on the CPU
    real = runtime.select_gauge_backend
    monkeypatch.setattr(runtime, "select_gauge_backend",
                        lambda cfg, backend, device: real(cfg, backend, CUDA))
    cfg = dataclasses.replace(cli.GAUGE_PRESETS["su3_4d"], n_chains=1, loops=2, frames=1)
    recs = []
    runtime.run_gauge(cfg, device="cpu", sink=metrics.MetricsSink(callback=recs.append))
    assert recs[0]["type"] == "backend_fallback" and recs[0]["backend"] == "torch"
    assert "su3" in recs[0]["reason"]
    frames = [r for r in recs if r["type"] == "frame"]
    assert len(frames) == 1 and frames[0]["plaquette_exact_2d"] is None


def test_cli_run_u1_2d_cpu_resumes_bitwise_and_matches_jax(tmp_path):
    base = ["run", "--preset", "u1_2d", "--device", "cpu", "--chains", "2", "--loops", "4",
            "--frames-per-launch", "2", "--measure-loops"]
    paths = {k: (tmp_path / f"{k}.npz", tmp_path / f"{k}.jsonl") for k in "abc"}
    cli.main(base + ["--burn", "1", "--frames", "3", "--out", str(paths["a"][0]),
                     "--metrics", str(paths["a"][1])])
    cli.main(base + ["--frames", "1", "--resume", str(paths["a"][0]), "--out",
                     str(paths["b"][0]), "--metrics", str(paths["b"][1])])
    cli.main(base + ["--burn", "1", "--frames", "4", "--out", str(paths["c"][0]),
                     "--metrics", str(paths["c"][1])])
    resumed, _ = checkpoint.load(paths["b"][0], "cpu")
    straight, cfg = checkpoint.load(paths["c"][0], "cpu")
    for name, x, y in zip(resumed._fields, resumed, straight):
        torch.testing.assert_close(x, y, rtol=0, atol=0, msg=name)
    assert cfg.measure_loops and cfg.frames_per_launch == 2 and int(straight.step) == 1 + 5 * 4

    recs = _records(paths["a"][1])
    frames = [r for r in recs if r["type"] == "frame"]
    assert [r["frame"] for r in frames] == [0, 1, 2]  # one record per frame, as in JAX
    for r in frames:
        assert r["stable_frac"] == 1.0 and 0.0 < r["plaquette"] <= 1.0
        assert r["plaquette_exact_2d"] == pytest.approx(0.44638996589653)
        assert np.isfinite([r["drift_max"], r["polyakov_re"], r["polyakov_im"]]).all()
    loops = [r for r in recs if r["type"] == "wilson_loops"]
    assert len(loops) == 1 and np.asarray(loops[0]["w"]).shape == (4, 4)
    assert recs[-1]["type"] == "summary" and recs[-1]["total_site_updates"] == 2 * 2 * 256 * 4 * 3

    jres = jruntime.run_gauge(JGaugeConfig.from_json(cfg.to_json()), backend="xla",
                              sink=jmetrics.MetricsSink(), burn_frames=1)
    for leaf, got, want in zip(straight._fields, straight, jres.state):
        want = np.asarray(want)
        if leaf in ("runs", "stab_cnt", "step"):
            np.testing.assert_array_equal(got.numpy().astype(want.dtype), want, err_msg=leaf)
        elif leaf == "plaq_mean":
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6, err_msg=leaf)
        else:
            np.testing.assert_allclose(got.numpy(), want, rtol=2e-6, atol=2e-6, err_msg=leaf)


def test_run_gauge_records_every_frame_and_batches_only_the_burn_in(monkeypatch, tmp_path):
    # the kernel route, run here through the kernels' plain versions (CPU tensors)
    from stochquant_tpu_torch.kernels import gauge_kernel as gk

    cfg = GaugeConfig(group="u1", beta=1.0, shape=(4, 8), n_chains=2, loops=3, frames=4, seed=5,
                      frames_per_launch=2)
    plain = runtime.run_gauge(cfg, device="cpu", sink=metrics.MetricsSink(), burn_frames=3).state
    calls, saved = [], []
    multi, single, save = gk.gauge_frames_multi, gk.gauge_frame, checkpoint.save
    monkeypatch.setattr(runtime, "select_gauge_backend", lambda *args: ("cuda", None))
    monkeypatch.setattr(gk, "gauge_frames_multi",
                        lambda s, a, c, K: calls.append(K) or multi(s, a, c, K))
    monkeypatch.setattr(gk, "gauge_frame", lambda s, a, c: calls.append(1) or single(s, a, c))
    monkeypatch.setattr(checkpoint, "save", lambda p, s, c, *, frames_done=None: saved.append(
        frames_done) or save(p, s, c, frames_done=frames_done))
    recs = []
    res = runtime.run_gauge(cfg, device="cpu", sink=metrics.MetricsSink(callback=recs.append),
                            burn_frames=3, checkpoint_out=str(tmp_path / "g.npz"),
                            checkpoint_every=3)
    assert calls == [2, 1, 1, 1, 1, 1]  # burn-in: one K=2 launch + the remainder
    assert [r["frame"] for r in recs if r["type"] == "frame"] == [0, 1, 2, 3]
    assert saved == [3, 4]
    for name, a, b in zip(plain._fields, res.state, plain):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)


def test_gauge_preemption_and_auto_resume_are_bitwise(tmp_path):
    cfg = GaugeConfig(group="su2", beta=2.0, shape=(4, 8), n_chains=2, loops=3, frames=4, seed=5)
    full = runtime.run_gauge(cfg, device="cpu", sink=metrics.MetricsSink(), burn_frames=1).state
    ck = tmp_path / "pre.npz"
    calls = {"n": 0}

    def stop():
        calls["n"] += 1
        return calls["n"] >= 2

    mpath = tmp_path / "m.jsonl"
    with open(mpath, "w") as fh:
        runtime.run_gauge(cfg, device="cpu", sink=metrics.MetricsSink(stream=fh), burn_frames=1,
                          checkpoint_out=str(ck), stop=stop)
    assert any(r["type"] == "preempted" and r["frames_done"] == 2 for r in _records(mpath))
    res = runtime.run_gauge(cfg, device="cpu", sink=metrics.MetricsSink(), burn_frames=1,
                            checkpoint_in=str(ck), resume_progress=True)
    for name, a, b in zip(full._fields, res.state, full):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)
    with pytest.raises(ValueError, match="incompatible"):
        runtime.run_gauge(dataclasses.replace(cfg, group="u1"), device="cpu",
                          sink=metrics.MetricsSink(), checkpoint_in=str(ck))


# ---------------------------------------------------------------------------
# a lattice split over a device mesh: run_field(mesh=), run_gauge(mesh=)
# ---------------------------------------------------------------------------

from stochquant_tpu_torch.actions import phi4  # noqa: E402
from stochquant_tpu_torch.parallel import DeviceMesh, halo, make_mesh  # noqa: E402


def _cuda_mesh(*axes):
    """A mesh of one CUDA device repeated, built without asking the machine
    for a GPU (``make_mesh`` would): the routing functions only read it."""
    names, sizes = tuple(n for n, _ in axes), tuple(s for _, s in axes)
    return DeviceMesh(names, sizes, (torch.device("cuda", 0),) * int(np.prod(sizes)))


def _cpu_mesh(*axes):
    return make_mesh(list(axes), devices="cpu")


X2 = dict(mesh_axes=("x", None))
CHAIN = dict(mesh_axes=(None, None), mesh_chain_axis="chain")


@pytest.mark.parametrize("change,mesh,backend,want", [
    (X2, _cpu_mesh(("x", 2)), "auto", "torch"),
    (X2, _cpu_mesh(("x", 2)), "torch", "torch"),
    (X2, _cuda_mesh(("x", 2)), "auto", "cuda"),
    (X2, _cuda_mesh(("x", 2)), "torch", "torch"),
    # the plain halo runner ignores rng_impl='hardware' (Threefry-20), as the JAX one does
    (dict(X2, rng_impl="hardware"), _cpu_mesh(("x", 2)), "torch", "torch"),
    (dict(X2, rng_impl="hardware"), _cuda_mesh(("x", 2)), "torch", "torch"),
    (X2, _cuda_mesh(("x", 2)), "cuda_step", "cuda_step"),
    (X2, _cuda_mesh(("x", 1)), "cuda_pair", "cuda_pair"),
    (dict(X2, loops=7), _cuda_mesh(("x", 2)), "auto", "cuda"),  # kernel 9, 128 KiB blocks
    (CHAIN, _cuda_mesh(("chain", 2)), "auto", "cuda"),
    # on a mesh of CUDA devices 'auto' is 'cuda' at any block size: kernel 3 per
    # shard, kernel 7 where the chunk geometry admits the split, else kernel 9
    (dict(CHAIN, shape=(1024, 512)), _cuda_mesh(("chain", 2)), "auto", "cuda"),
    (dict(X2, shape=(2048, 512)), _cuda_mesh(("x", 2)), "auto", "cuda"),
    (dict(X2, shape=(2048, 512), loops=7), _cuda_mesh(("x", 2)), "auto", "cuda"),
    (dict(X2, shape=(2048, 512), loops=7), _cuda_mesh(("x", 2)), "cuda", "cuda"),
    (dict(shape=(32, 32, 32, 32), mesh_axes=("x", None, None, None)), _cuda_mesh(("x", 2)),
     "auto", "cuda"),
    # kernel 8: asked for, or preferred on 'auto' where its rules admit the split
    (X2, _cuda_mesh(("x", 2)), "cuda_rdma", "cuda_rdma"),
    (dict(X2, prefer_rdma=True), _cuda_mesh(("x", 2)), "auto", "cuda_rdma"),
    (dict(X2, prefer_rdma=True), _cuda_mesh(("x", 1)), "auto", "cuda_rdma"),   # a ring of one
    (dict(X2, prefer_rdma=True, mesh_axes=("x", "y")), _cuda_mesh(("x", 2), ("y", 2)), "auto",
     "cuda"),
    (dict(X2, prefer_rdma=True), _cuda_mesh(("x", 2)), "cuda", "cuda"),
    (dict(X2, prefer_rdma=True), _cpu_mesh(("x", 2)), "auto", "torch"),
])
def test_field_routing_under_a_mesh(change, mesh, backend, want):
    cfg = dataclasses.replace(BASE, **change)
    assert runtime.select_field_backend(cfg, backend, None, mesh) == want


@pytest.mark.parametrize("change,want", [
    (X2, "cuda_nd"),                                   # kernel 7
    (dict(X2, loops=7), "cuda_step"),                  # kernel 9
    (dict(X2, shape=(2048, 512), loops=7), "cuda_step"),
    (CHAIN, "cuda_frame"),                             # kernel 3 per shard
    (dict(CHAIN, shape=(1024, 512)), "cuda_frame"),
])
def test_auto_on_a_cuda_mesh_resolves_to_a_kernel_at_any_block_size(change, want):
    cfg = dataclasses.replace(BASE, **change)
    mesh = _cuda_mesh(("x", 2)) if "x" in cfg.mesh_axes else _cuda_mesh(("chain", 2))
    assert runtime.select_field_backend(cfg, "auto", None, mesh) == "cuda"
    assert halo.resolve_backend(phi4.get_field(cfg.action), cfg, mesh, "cuda") == want


@pytest.mark.parametrize("change,mesh,backend,match", [
    (dict(X2, mesh_axes=("x", "y")), _cuda_mesh(("x", 2), ("y", 2)), "cuda_rdma", "dim-0-only"),
    (dict(X2, loops=7), _cuda_mesh(("x", 2)), "cuda_rdma", "even cfg.loops"),
    (X2, _cpu_mesh(("x", 2)), "cuda_rdma", "mesh of CUDA devices"),
    (dict(X2, exchange_steps=0), _cuda_mesh(("x", 2)), "auto", "autotune"),
    (dict(X2, exchange_steps=0), _cuda_mesh(("x", 2)), "cuda_pair", "autotune"),
    (dict(X2, dtype="float64"), _cuda_mesh(("x", 2)), "auto", "float32"),
    (X2, _cpu_mesh(("x", 2)), "cuda", "mesh of CUDA devices"),
    (X2, _cpu_mesh(("x", 2)), "cuda_step", "mesh of CUDA devices"),
    (X2, _cuda_mesh(("x", 2)), "cuda_tiled", "not available under the halo runner"),
    ({}, _cuda_mesh(("x", 2)), "auto", "needs cfg.mesh_axes"),
    (dict(mesh_chain_axis="chain"), _cuda_mesh(("chain", 2)), "auto", "needs cfg.mesh_axes"),
    (X2, DeviceMesh(("x",), (2,), (torch.device("cpu"), torch.device("cuda", 0))), "auto",
     "mixes device types"),
    # the split kernels draw Threefry only: rng_impl='hardware' is refused on 'auto' as on
    # 'cuda_step' and nothing gives way to 'torch' unasked
    (dict(X2, rng_impl="hardware"), _cuda_mesh(("x", 2)), "auto", "hardware"),
    (dict(X2, rng_impl="hardware"), _cuda_mesh(("x", 2)), "cuda_step", "hardware"),
    # no kernel covers these on the card, and nothing gives way to 'torch' unasked
    (dict(shape=(32, 32, 32, 32), mesh_axes=("x", None, None, None), loops=7),
     _cuda_mesh(("x", 2)), "auto", "use backend='torch'"),
])
def test_field_routing_under_a_mesh_raises_for_what_is_not_ported(change, mesh, backend, match):
    cfg = dataclasses.replace(BASE, **change)
    with pytest.raises(ValueError, match=match):
        runtime.select_field_backend(cfg, backend, None, mesh)


@pytest.mark.parametrize("mesh_axes,mesh_shape,chain_ax", [
    (("x", "y"), [("chain", 2), ("x", 2), ("y", 2)], "chain"),
    (("x", None), [("x", 4)], None),
])
def test_run_field_on_a_mesh_checkpoints_resumes_bitwise_and_equals_the_unsplit_run(
        tmp_path, mesh_axes, mesh_shape, chain_ax):
    base = FieldConfig(action="phi4", shape=(8, 8), dtau=0.01, n_chains=4, loops=5, frames=4,
                       seed=3)
    cfg = dataclasses.replace(base, mesh_axes=mesh_axes, mesh_chain_axis=chain_ax)
    mesh = make_mesh(mesh_shape, devices="cpu")
    recs = []
    full = runtime.run_field(cfg, mesh=mesh, sink=metrics.MetricsSink(callback=recs.append),
                             burn_frames=1)
    frames = [r for r in recs if r["type"] == "frame"]
    assert len(frames) == 4 and all(np.isfinite(r[k]) for r in frames for k in FIELD_OBS)
    assert frames[-1]["stable_frac"] == 1.0 and recs[-1]["type"] == "summary"
    want = runtime.run_field(base, device="cpu", sink=metrics.MetricsSink(), burn_frames=1).state
    assert full.state.phi.shape == (4, 8, 8) and full.state.corr_mean.shape == (4, 8)
    for name in ("phi", "dtau", "lrg_vl", "runs", "stab_cnt", "step"):
        assert torch.equal(getattr(full.state, name), getattr(want, name)), name
    for name in ("mag_mean", "mag2_mean", "phi2_mean", "act_mean", "corr_mean"):
        torch.testing.assert_close(getattr(full.state, name), getattr(want, name), rtol=1e-4,
                                   atol=1e-6, msg=name)

    # a whole-state checkpoint: 2 frames, then resumed on the mesh for the other 2
    ck = tmp_path / "split.npz"
    runtime.run_field(dataclasses.replace(cfg, frames=2), mesh=mesh, sink=metrics.MetricsSink(),
                      burn_frames=1, checkpoint_out=str(ck))
    state, loaded = checkpoint.load(ck, "cpu")
    assert state.phi.shape == (4, 8, 8) and loaded.mesh_axes == mesh_axes
    assert checkpoint.read_meta(ck)["frames_done"] == 2
    res = runtime.run_field(cfg, mesh=mesh, sink=metrics.MetricsSink(), checkpoint_in=str(ck),
                            resume_progress=True)
    for name, a, b in zip(full.state._fields, res.state, full.state):
        assert torch.equal(a, b), name
    # and the same checkpoint resumes unsplit, or on another mesh, to the same φ
    other = runtime.run_field(dataclasses.replace(base, frames=4), device="cpu",
                              sink=metrics.MetricsSink(), checkpoint_in=str(ck),
                              resume_progress=True)
    assert torch.equal(other.state.phi, full.state.phi)


def test_run_field_on_a_mesh_preempts_with_a_whole_state_checkpoint(tmp_path):
    cfg = FieldConfig(action="phi4", shape=(8, 8), dtau=0.01, n_chains=2, loops=4, frames=5,
                      seed=3, mesh_axes=("x", "y"))
    mesh = make_mesh([("x", 2), ("y", 2)], devices="cpu")
    full = runtime.run_field(cfg, mesh=mesh, sink=metrics.MetricsSink()).state
    calls = {"n": 0}

    def stop():
        calls["n"] += 1
        return calls["n"] >= 2

    recs, ck = [], tmp_path / "p.npz"
    runtime.run_field(cfg, mesh=mesh, sink=metrics.MetricsSink(callback=recs.append),
                      checkpoint_out=str(ck), stop=stop)
    assert any(r["type"] == "preempted" and r["frames_done"] == 2 for r in recs)
    assert checkpoint.load(ck, "cpu")[0].phi.shape == (2, 8, 8)
    res = runtime.run_field(cfg, mesh=mesh, sink=metrics.MetricsSink(), checkpoint_in=str(ck),
                            resume_progress=True)
    for name, a, b in zip(full._fields, res.state, full):
        assert torch.equal(a, b), name


def test_run_field_records_the_backend_fallback_under_a_mesh(monkeypatch):
    # there is none to record: what 'auto' does on a mesh of CUDA devices for a 2-D chain-only
    # mesh, run here on the CPU (kernel 3's wrapper runs its plain version on CPU tensors), is
    # the 'cuda' route, bitwise the plain runner, with no backend_fallback record
    monkeypatch.setattr(runtime, "_mesh_on_cuda", lambda mesh: True)
    cfg = FieldConfig(action="phi4", shape=(8, 8), n_chains=2, loops=3, frames=1,
                      mesh_axes=(None, None), mesh_chain_axis="chain")
    mesh = make_mesh([("chain", 2)], devices="cpu")
    recs = []
    auto = runtime.run_field(cfg, mesh=mesh, sink=metrics.MetricsSink(callback=recs.append))
    assert [r["type"] for r in recs] == ["frame", "summary"]
    plain = runtime.run_field(cfg, mesh=mesh, backend="torch", sink=metrics.MetricsSink())
    assert torch.equal(auto.state.phi, plain.state.phi)
    with pytest.raises(ValueError, match="use backend='torch'"):
        runtime.run_field(dataclasses.replace(cfg, shape=(4, 4, 4), mesh_axes=("chain", None, None),
                                              mesh_chain_axis=None), mesh=mesh)
    with pytest.raises(ValueError, match="device="):
        runtime.run_field(dataclasses.replace(cfg, mesh_axes=None, mesh_chain_axis=None))


GX2 = dict(mesh_axes=("x", None))


@pytest.mark.parametrize("change,mesh,backend,want,reasoned", [
    (GX2, _cpu_mesh(("x", 2)), "auto", "torch", False),
    (GX2, _cpu_mesh(("x", 2)), "torch", "torch", False),
    (GX2, _cuda_mesh(("x", 2)), "torch", "torch", False),
    (GX2, _cuda_mesh(("x", 2)), "cuda", "cuda", False),
    # auto keeps the per-step runner (exact rescale) and says that kernel 12 would apply
    (GX2, _cuda_mesh(("x", 2)), "auto", "torch", True),
    (dict(GX2, group="su3"), _cuda_mesh(("x", 2)), "auto", "torch", True),
    (dict(group="su3", shape=(4, 4, 4, 4), mesh_axes=("x", None, None, None)),
     _cuda_mesh(("x", 2)), "auto", "torch", False),
])
def test_gauge_routing_under_a_mesh(change, mesh, backend, want, reasoned):
    cfg = dataclasses.replace(GAUGE_BASE, **change)
    route, reason = runtime.select_gauge_backend(cfg, backend, None, mesh)
    assert route == want and bool(reason) == reasoned
    if reasoned:
        assert "kernel 12" in reason


@pytest.mark.parametrize("change,mesh,backend,match", [
    (GX2, _cpu_mesh(("x", 2)), "cuda", "mesh of CUDA devices"),
    ({}, _cpu_mesh(("x", 2)), "auto", "needs cfg.mesh_axes"),
    (GX2, _cpu_mesh(("x", 2)), "pallas", "backend"),
    # the chunk runner (kernel 12) refuses the complexified groups, naming the group
    (dict(GX2, group="cu1"), _cuda_mesh(("x", 2)), "cuda", "group cu1"),
])
def test_gauge_routing_under_a_mesh_raises(change, mesh, backend, match):
    cfg = dataclasses.replace(GAUGE_BASE, **change)
    with pytest.raises(ValueError, match=match):
        runtime.select_gauge_backend(cfg, backend, None, mesh)


@pytest.mark.parametrize("group,measure_loops", [("u1", True), ("su2", False)])
def test_run_gauge_on_a_mesh_checkpoints_resumes_bitwise_and_equals_the_unsplit_run(
        tmp_path, group, measure_loops):
    base = GaugeConfig(group=group, beta=2.0, shape=(8, 8), n_chains=2, dtau=2e-3, loops=4,
                       frames=3, seed=5, hot_start=True, measure_loops=measure_loops)
    cfg = dataclasses.replace(base, mesh_axes=("x", "y"))
    mesh = make_mesh([("x", 2), ("y", 2)], devices="cpu")
    recs = []
    full = runtime.run_gauge(cfg, mesh=mesh, sink=metrics.MetricsSink(callback=recs.append),
                             burn_frames=1)
    frames = [r for r in recs if r["type"] == "frame"]
    assert len(frames) == 3 and all(np.isfinite(r["plaquette"]) for r in frames)
    assert ("polyakov_re" in frames[0]) == measure_loops
    assert any(r["type"] == "wilson_loops" for r in recs) == measure_loops
    want = runtime.run_gauge(base, device="cpu", sink=metrics.MetricsSink(), burn_frames=1).state
    for name in ("links", "drift_max", "dtau", "runs", "stab_cnt", "step"):
        assert torch.equal(getattr(full.state, name), getattr(want, name)), name
    torch.testing.assert_close(full.state.plaq_mean, want.plaq_mean, rtol=1e-5, atol=1e-7)

    ck = tmp_path / "g.npz"
    runtime.run_gauge(dataclasses.replace(cfg, frames=1), mesh=mesh, sink=metrics.MetricsSink(),
                      burn_frames=1, checkpoint_out=str(ck))
    assert checkpoint.load(ck, "cpu")[0].links.shape == want.links.shape
    res = runtime.run_gauge(cfg, mesh=mesh, sink=metrics.MetricsSink(), checkpoint_in=str(ck),
                            resume_progress=True)
    for name, a, b in zip(full.state._fields, res.state, full.state):
        assert torch.equal(a, b), name


def test_run_gauge_chunk_backend_and_the_auto_record_under_a_mesh(monkeypatch):
    """What run_gauge does on a mesh of CUDA devices, run here on the CPU (the
    chunk kernel's wrapper runs its plain version on CPU tensors): 'cuda' is
    the chunk runner and gives the per-step runner's links; 'auto' runs the
    per-step runner and records why."""
    monkeypatch.setattr(runtime, "_mesh_on_cuda", lambda mesh: True)
    cfg = GaugeConfig(group="u1", beta=1.0, shape=(16, 16), n_chains=2, dtau=5e-3, loops=4,
                      frames=2, seed=5, mesh_axes=("x", None), grow_after=10**9)
    mesh = make_mesh([("x", 2)], devices="cpu")
    recs = []
    auto = runtime.run_gauge(cfg, mesh=mesh, sink=metrics.MetricsSink(callback=recs.append))
    assert recs[0]["type"] == "backend_fallback" and "kernel 12" in recs[0]["reason"]
    recs = []
    chunk = runtime.run_gauge(cfg, mesh=mesh, backend="cuda",
                              sink=metrics.MetricsSink(callback=recs.append))
    assert recs[0]["type"] == "frame" and chunk.summary["total_site_updates"] > 0
    assert torch.equal(chunk.state.links, auto.state.links)
    with pytest.raises(ValueError, match="even"):
        runtime.run_gauge(dataclasses.replace(cfg, loops=3), mesh=mesh, backend="cuda",
                          sink=metrics.MetricsSink())
    with pytest.raises(ValueError, match="device="):
        runtime.run_gauge(dataclasses.replace(cfg, mesh_axes=None))


# ---------------------------------------------------------------------------
# chain routing, the plain-path schemes through the runtime and the CLI
# ---------------------------------------------------------------------------

CHAIN_BASE = ChainConfig(action="harmonic", n_sites=16, n_chains=2, loops=4, frames=1)


@pytest.mark.parametrize("change,backend,device,want,reasoned", [
    ({}, "auto", CUDA, "cuda", False),
    ({}, "auto", torch.device("cpu"), "torch", False),
    # rng_impl='hardware': the kernels' Philox variants; the plain path ignores it
    (dict(rng_impl="hardware"), "auto", CUDA, "cuda", False),
    (dict(rng_impl="hardware"), "cuda", CUDA, "cuda", False),
    (dict(rng_impl="hardware"), "torch", CUDA, "torch", False),
    (dict(rng_impl="hardware"), "auto", torch.device("cpu"), "torch", False),
    # no kernel in either package: 'auto' on the card runs the plain path and says why
    (dict(scheme=Scheme.LM), "auto", CUDA, "torch", True),
    (dict(scheme=Scheme.EXACT), "auto", CUDA, "torch", True),
    (dict(accumulate_spectrum=True), "auto", CUDA, "torch", True),
    (dict(accumulate_spectrum=True, rng_impl="hardware"), "auto", CUDA, "torch", True),
    (dict(scheme=Scheme.LM), "torch", CUDA, "torch", False),
    (dict(scheme=Scheme.EXACT), "auto", torch.device("cpu"), "torch", False),
])
def test_chain_routing(change, backend, device, want, reasoned):
    cfg = dataclasses.replace(CHAIN_BASE, **change)
    route, reason = runtime.select_backend(backend, device, cfg)
    assert route == want and bool(reason) == reasoned
    if reasoned:
        assert "plain PyTorch integrator" in reason


@pytest.mark.parametrize("change,backend,device,match", [
    (dict(scheme=Scheme.LM), "cuda", CUDA, "LM"),
    (dict(scheme=Scheme.EXACT), "cuda", CUDA, "EXACT"),
    (dict(accumulate_spectrum=True), "cuda", CUDA, "spectrum"),
    ({}, "cuda", torch.device("cpu"), "CUDA device"),
    ({}, "xla", CUDA, "unknown chain backend"),
])
def test_chain_routing_raises(change, backend, device, match):
    with pytest.raises(ValueError, match=match):
        runtime.select_backend(backend, device, dataclasses.replace(CHAIN_BASE, **change))


@pytest.mark.parametrize("change", [dict(scheme=Scheme.LM), dict(scheme=Scheme.EXACT),
                                    dict(accumulate_spectrum=True)], ids=["lm", "exact", "spectrum"])
def test_run_chain_records_the_backend_fallback(change, monkeypatch):
    # what 'auto' does on a CUDA device, run here on the CPU
    real = runtime.select_backend
    monkeypatch.setattr(runtime, "select_backend",
                        lambda backend, device, cfg=None: real(backend, CUDA, cfg))
    recs = []
    cfg = dataclasses.replace(CHAIN_BASE, **change)
    res = runtime.run_chain(cfg, device="cpu", sink=metrics.MetricsSink(callback=recs.append))
    assert recs[0]["type"] == "backend_fallback" and recs[0]["backend"] == "torch"
    assert [r["type"] for r in recs[1:]] == ["frame", "summary"]
    assert torch.isfinite(res.state.f).all()


def test_field_fallback_reason_and_the_record():
    exact = FieldConfig(shape=(8, 8), n_chains=2, loops=2, frames=1, scheme=Scheme.EXACT)
    assert "EXACT" in runtime.field_fallback_reason(exact, "auto", CUDA)
    for cfg, backend, device in ((exact, "torch", CUDA), (exact, "auto", "cpu"),
                                 (dataclasses.replace(exact, scheme=Scheme.EM), "auto", CUDA)):
        assert runtime.field_fallback_reason(cfg, backend, device) is None
    # the record is the run's first when the reason stands, and absent on the CPU
    recs = []
    runtime.run_field(exact, device="cpu", sink=metrics.MetricsSink(callback=recs.append))
    assert [r["type"] for r in recs] == ["frame", "summary"]
    recs.clear()
    real = runtime.field_fallback_reason
    try:
        runtime.field_fallback_reason = lambda cfg, backend, device: real(cfg, backend, CUDA)
        runtime.run_field(exact, device="cpu", sink=metrics.MetricsSink(callback=recs.append))
    finally:
        runtime.field_fallback_reason = real
    assert recs[0]["type"] == "backend_fallback" and recs[0]["backend"] == "torch"


def test_cli_run_quartic_large_cut_matches_jax_runtime(tmp_path):
    """Preset quartic_large (config 2 with the power-spectrum channel) through
    `cli run` on the CPU, cut in chains and depth: the state, the spectrum
    among it, and the records against the JAX runner's."""
    mpath, ck = tmp_path / "m.jsonl", tmp_path / "ck.npz"
    cli.main(["run", "--preset", "quartic_large", "--device", "cpu", "--chains", "3", "--loops",
              "6", "--frames", "2", "--burn", "1", "--metrics", str(mpath), "--out", str(ck)])
    state, cfg = checkpoint.load(ck, "cpu")
    assert cfg.accumulate_spectrum and cfg.n_sites == 1024 and int(state.step) == 2 + 3 * 6
    assert tuple(state.spec_mean.shape) == (3, 513) and float(state.spec_mean.min()) >= 0
    recs = _records(mpath)
    _check_records(recs, 1024, 2)

    jrecs = []
    jres = jruntime.run_chain(JChainConfig.from_json(cfg.to_json()), backend="xla",
                              sink=jmetrics.MetricsSink(callback=jrecs.append), burn_frames=1)
    for got, want in zip([r for r in recs if r["type"] == "frame"],
                         [r for r in jrecs if r["type"] == "frame"]):
        assert got["stable_frac"] == want["stable_frac"] == 1.0 and got["dtau"] == want["dtau"]
        # |corr| itself: its logarithm is ill-conditioned where the correlator crosses zero
        np.testing.assert_allclose(np.exp(got["log_abs_corr"]), np.exp(want["log_abs_corr"]),
                                   rtol=0, atol=2e-6)
    for leaf, got, want in zip(state._fields, state, jres.state):
        want = np.asarray(want)
        if leaf in ("runs", "stab_cnt", "step"):
            np.testing.assert_array_equal(got.numpy().astype(want.dtype), want, err_msg=leaf)
        elif leaf == "spec_mean":  # pocketfft in both, the sums in another order
            np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                       atol=2e-5 * np.abs(want).max(), err_msg=leaf)
        else:
            np.testing.assert_allclose(got.numpy(), want, rtol=2e-6, atol=2e-6, err_msg=leaf)


@pytest.mark.parametrize("args", [
    ["--preset", "harmosc", "--scheme", "lm", "--dtau", "2e-3"],
    ["--preset", "harmosc", "--scheme", "exact"],
    ["--preset", "harmosc", "--rng", "hardware", "--dtau", "2e-3"],
    ["--preset", "phi4_2d", "--scheme", "exact"],
    ["--preset", "phi4_2d", "--rng", "hardware", "--frames-per-launch", "2"],
], ids=["lm", "exact", "hardware", "field_exact", "field_hardware"])
def test_cli_run_new_options_on_the_cpu_resume_bitwise(args, tmp_path):
    common = ["run", *args, "--device", "cpu", "--chains", "2", "--loops", "4"]
    a, b, c = (str(tmp_path / f"{n}.npz") for n in "abc")
    quiet = ["--metrics", str(tmp_path / "m.jsonl")]
    cli.main(common + ["--frames", "2", "--out", a] + quiet)
    cli.main(common + ["--frames", "1", "--resume", a, "--out", b] + quiet)
    cli.main(common + ["--frames", "3", "--out", c] + quiet)
    resumed, cfg = checkpoint.load(b, "cpu")
    straight, _ = checkpoint.load(c, "cpu")
    for name, x, y in zip(resumed._fields, resumed, straight):
        assert torch.equal(x, y), name
    frames = [r for r in _records(tmp_path / "m.jsonl") if r["type"] == "frame"]
    assert len(frames) == 3 and all(r["stable_frac"] == 1.0 for r in frames)
    if "hardware" in args:  # the plain path draws Threefry-20 under it
        t = str(tmp_path / "t.npz")
        cli.main(["run", *[x for x in args if x not in ("--rng", "hardware")], "--device", "cpu",
                  "--chains", "2", "--loops", "4", "--frames", "3", "--out", t] + quiet)
        threefry, _ = checkpoint.load(t, "cpu")
        assert all(torch.equal(x, y) for x, y in zip(straight, threefry))


# ---------------------------------------------------------------------------
# complex Langevin: run_complex, the complex presets, the complexified groups
# ---------------------------------------------------------------------------

CL_PRESETS = ("complex_gaussian", "complex_quartic", "complex_chain", "complex_field_2d",
              "cu1_2d_complex", "csu3_2d_complex")


@pytest.mark.parametrize("preset", CL_PRESETS)
def test_cli_run_complex_presets_match_the_jax_cli_records(preset, tmp_path):
    """`cli run` on each complex preset at a cut size on the CPU: the records
    carry the JAX CLI's keys, the final state is the JAX run's (decisions and
    counters exact, float leaves within rtol 1e-5, site sums within rtol
    3e-5), and a resume is bitwise the uninterrupted run."""
    from stochquant_tpu import cli as jcli
    from stochquant_tpu.io import checkpoint as jck

    small = ["--chains", "2", "--loops", "3"]
    if preset in ("complex_field_2d", "cu1_2d_complex", "csu3_2d_complex"):
        small = ["--chains", "2", "--loops", "2"]
    base = ["run", "--preset", preset, *small]
    paths = {k: (tmp_path / f"{k}.npz", tmp_path / f"{k}.jsonl") for k in "abcj"}
    cli.main(base + ["--device", "cpu", "--burn", "1", "--frames", "2", "--out",
                     str(paths["a"][0]), "--metrics", str(paths["a"][1])])
    cli.main(base + ["--device", "cpu", "--frames", "1", "--resume", str(paths["a"][0]),
                     "--out", str(paths["b"][0]), "--metrics", str(paths["b"][1])])
    cli.main(base + ["--device", "cpu", "--burn", "1", "--frames", "3", "--out",
                     str(paths["c"][0]), "--metrics", str(paths["c"][1])])
    jcli.main(base + ["--burn", "1", "--frames", "3", "--out", str(paths["j"][0]),
                      "--metrics", str(paths["j"][1])])
    resumed, _ = checkpoint.load(paths["b"][0], "cpu")
    straight, cfg = checkpoint.load(paths["c"][0], "cpu")
    for name, x, y in zip(resumed._fields, resumed, straight):
        assert torch.equal(x, y), name

    got, want = _records(paths["c"][1]), _records(paths["j"][1])
    assert [r["type"] for r in got] == [r["type"] for r in want]
    for g, w in zip(got, want):
        assert set(g) == set(w), (set(g) ^ set(w))
    frames = [r for r in got if r["type"] == "frame"]
    assert len(frames) == 3 and all(r["stable_frac"] == 1.0 for r in frames)
    jstate, jcfg = jck.load(paths["j"][0])
    assert jcfg.to_json() == cfg.to_json() and jck.read_meta(paths["c"][0])["frames_done"] == 3
    site_sums = ("plaq_mean",) + (("z2r_mean", "z2i_mean", "zim_mean")
                                  if preset == "complex_field_2d" else ())
    for name, g, w in zip(straight._fields, straight, jstate):
        w = np.asarray(w)
        if name in ("runs", "stab_cnt", "step"):
            np.testing.assert_array_equal(g.numpy().astype(w.dtype), w, err_msg=name)
        elif name in site_sums:
            np.testing.assert_allclose(g.numpy(), w, rtol=3e-5, atol=3e-6, err_msg=name)
        else:
            np.testing.assert_allclose(g.numpy(), w, rtol=2e-5, atol=2e-6, err_msg=name)
    for key in ("re_z2", "im_z2", "plaquette", "plaquette_im", "unitarity_norm"):
        if key in frames[-1]:
            assert frames[-1][key] == pytest.approx(
                [r for r in want if r["type"] == "frame"][-1][key], rel=1e-4, abs=1e-6), key


def test_run_complex_resumes_progress_and_refuses_other_runs(tmp_path):
    cfg = dataclasses.replace(cli.COMPLEX_PRESETS["complex_chain"], n_chains=2, n_sites=8,
                              loops=4, frames=4)
    full = runtime.run_complex(cfg, device="cpu", sink=metrics.MetricsSink(), burn_frames=1)
    ck, mpath = tmp_path / "c.npz", tmp_path / "m.jsonl"
    stop = iter([False, True]).__next__
    with open(mpath, "w") as fh:
        runtime.run_complex(cfg, device="cpu", sink=metrics.MetricsSink(stream=fh),
                            burn_frames=1, checkpoint_out=str(ck), stop=stop)
    assert any(r["type"] == "preempted" and r["frames_done"] == 2 for r in _records(mpath))
    res = runtime.run_complex(cfg, device="cpu", sink=metrics.MetricsSink(),
                              checkpoint_in=str(ck), resume_progress=True)
    for name, a, b in zip(full.state._fields, res.state, full.state):
        assert torch.equal(a, b), name
    with pytest.raises(ValueError, match="n_sites"):
        runtime.run_complex(dataclasses.replace(cfg, n_sites=16), device="cpu",
                            checkpoint_in=str(ck))
    with pytest.raises(ValueError, match="ComplexChainConfig"):
        runtime.run_complex(cli.COMPLEX_PRESETS["complex_gaussian"], device="cpu",
                            checkpoint_in=str(ck))
    with pytest.raises(TypeError, match="complex-Langevin config"):
        runtime.run_complex(TINY["harmosc"], device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            runtime.run_complex(cfg, device="cuda")


def test_run_gauge_cu1_2d_complex_on_a_mesh_equals_the_unsplit_run():
    """cu1_2d_complex under a 2-way mesh of CPU devices on the per-step halo
    runner (backend 'torch', cooling off: the halo runner refuses it): the
    unsplit run's links and decisions bit for bit, the unitarity norm its
    lattice mean (rtol 1e-5: the shards' means are summed in another order)."""
    from stochquant_tpu_torch import parallel

    base = dataclasses.replace(cli.GAUGE_PRESETS["cu1_2d_complex"], n_chains=2, loops=3,
                               frames=2, cooling_rate=0.0, hot_start=True)
    cfg = dataclasses.replace(base, mesh_axes=("x", None))
    mesh = parallel.make_mesh([("x", 2)], devices="cpu")
    recs, want_recs = [], []
    got = runtime.run_gauge(cfg, mesh=mesh, backend="torch", burn_frames=1,
                            sink=metrics.MetricsSink(callback=recs.append))
    want = runtime.run_gauge(base, device="cpu", burn_frames=1,
                             sink=metrics.MetricsSink(callback=want_recs.append))
    for name in ("links", "drift_max", "dtau", "runs", "stab_cnt", "step"):
        assert torch.equal(getattr(got.state, name), getattr(want.state, name)), name
    torch.testing.assert_close(got.state.plaq_mean, want.state.plaq_mean, rtol=1e-5, atol=1e-7)
    frames = [r for r in recs if r["type"] == "frame"]
    assert {"plaquette_im", "plaquette_exact_2d_im", "unitarity_norm"} <= set(frames[-1])
    want_frames = [r for r in want_recs if r["type"] == "frame"]
    assert len(frames) == len(want_frames)
    np.testing.assert_allclose([r["unitarity_norm"] for r in frames],
                               [r["unitarity_norm"] for r in want_frames], rtol=1e-5, atol=1e-9)
    with pytest.raises(ValueError, match="cooling"):
        runtime.run_gauge(dataclasses.replace(cfg, cooling_rate=0.05), mesh=mesh,
                          sink=metrics.MetricsSink())


@pytest.mark.parametrize("preset", ["cu1_2d_complex", "csu3_2d_complex"])
def test_complexified_gauge_presets_route_to_the_plain_path(preset, monkeypatch):
    """'auto' on a CUDA device runs the plain integrator and records why
    (here on the CPU with the route resolved for a CUDA device); 'cuda'
    raises, naming the group."""
    cfg = dataclasses.replace(cli.GAUGE_PRESETS[preset], n_chains=1, loops=2, frames=1)
    route, reason = runtime.select_gauge_backend(cfg, "auto", CUDA)
    assert route == "torch" and cfg.group in reason
    with pytest.raises(ValueError, match=f"group {cfg.group}"):
        runtime.select_gauge_backend(cfg, "cuda", CUDA)
    real = runtime.select_gauge_backend
    monkeypatch.setattr(runtime, "select_gauge_backend",
                        lambda cfg, backend, device: real(cfg, backend, CUDA))
    recs = []
    runtime.run_gauge(cfg, device="cpu", sink=metrics.MetricsSink(callback=recs.append))
    assert recs[0]["type"] == "backend_fallback" and recs[0]["backend"] == "torch"
    frame = [r for r in recs if r["type"] == "frame"][0]
    assert np.isfinite([frame[k] for k in ("plaquette", "plaquette_im", "unitarity_norm",
                                           "plaquette_exact_2d_im")]).all()


def test_measure_loops_on_a_complexified_group():
    cfg = dataclasses.replace(cli.GAUGE_PRESETS["csu3_2d_complex"], n_chains=1, loops=2,
                              frames=1, shape=(4, 4), measure_loops=True)
    recs = []
    runtime.run_gauge(cfg, device="cpu", sink=metrics.MetricsSink(callback=recs.append))
    frame = [r for r in recs if r["type"] == "frame"][0]
    assert np.isfinite([frame["polyakov_re"], frame["polyakov_im"]]).all()
    loops = [r for r in recs if r["type"] == "wilson_loops"]
    assert len(loops) == 1 and np.asarray(loops[0]["w"]).shape == (2, 2)

"""The port's autotuners (``kernels.autotune``) on the CPU: candidate lists
and the geometry-only skip, the JAX package's cache keys, the timing in
turns, and the ``autotune`` records the runtime writes for a 0.  The timing
itself runs on the card (the ``cuda`` test here and ``chip_smoke.py``
[28]).  Tolerances: none (integer choices and exact records)."""

import dataclasses

import pytest
import torch

from stochquant_tpu_torch import actions, metrics, runtime
from stochquant_tpu_torch.config import ChainConfig, FieldConfig
from stochquant_tpu_torch.kernels import autotune
from stochquant_tpu_torch.kernels import chain_kernel as ck
from stochquant_tpu_torch.kernels import field_kernel_nd as nd
from stochquant_tpu_torch.parallel import make_mesh

torch.set_num_threads(1)
ACT = actions.get_field("phi4")
ND = FieldConfig(action="phi4", shape=(8, 8, 8), n_chains=2, loops=4, frames=1, seed=5)
SPLIT = FieldConfig(action="phi4", shape=(16, 16), n_chains=2, loops=10, frames=1, seed=5,
                    mesh_axes=("x", None))


@pytest.fixture(autouse=True)
def fresh_cache():
    autotune.clear_cache()
    yield
    autotune.clear_cache()


def test_tile_rows_candidates_are_the_admitted_divisors():
    assert autotune.tile_rows_candidates(ND) == ([1, 2, 4, 8], {})
    admitted, skipped = autotune.tile_rows_candidates(ND, candidates=[2, 3, 4])
    assert admitted == [2, 4] and "divide" in skipped[3]
    # under the chunk path each height is held to the chunk geometry as well
    deep = dataclasses.replace(ND, shape=(4, 8, 8), exchange_steps=4)
    admitted, skipped = autotune.tile_rows_candidates(deep)
    assert admitted == [] and all("full global extent" in why for why in skipped.values())


def test_exchange_steps_candidates_skip_by_geometry_alone():
    mesh = make_mesh([("x", 2)], devices="cpu")
    launches = (nd.field_chunk_nd.launches, nd.field_pair_nd.launches)
    admitted, skipped = autotune.exchange_steps_candidates(ACT, SPLIT, mesh)
    assert admitted == [2, 4, 8]
    assert sorted(skipped) == [16, 32, 64] and "exceeds loops" in skipped[16]
    assert (nd.field_chunk_nd.launches, nd.field_pair_nd.launches) == launches
    # the D >= 3 default candidates; an odd loops admits none
    three = dataclasses.replace(SPLIT, shape=(16, 8, 8), mesh_axes=("x", None, None), loops=5)
    admitted, skipped = autotune.exchange_steps_candidates(ACT, three, mesh)
    assert admitted == [] and sorted(skipped) == [2, 4, 8, 16]
    assert "even cfg.loops" in skipped[2]
    assert autotune.exchange_steps_candidates(ACT, SPLIT, mesh, candidates=(3,))[1][3].startswith(
        "the chunk kernel advances an even number")


def test_cache_keys_are_the_jax_packages():
    autotune.best_tile_rows(ACT, ND, device="cpu")
    autotune.best_exchange_steps(ACT, SPLIT, make_mesh([("x", 2)], devices="cpu"))
    autotune.best_block_chains(actions.get("double_well"),
                               ChainConfig(action="double_well", n_sites=16, n_chains=4),
                               device="cpu")
    keys = sorted(autotune._CACHE, key=str)
    assert ("T0", "phi4", (8, 8, 8), 2, 4, "threefry", int(ND.sweep), None, True, None,
            "cpu") in keys
    assert ("W", "phi4", (16, 16), 2, 10, "threefry", int(SPLIT.sweep), ("x", None), None, (2,),
            True, (2, 4, 8, 16, 32, 64), "cpu") in keys
    assert ("double_well", 16, 4, 1000, "threefry", 0, 1, 1, True, None, "cpu") in keys
    # a cached pick is returned as it was
    first = autotune.best_tile_rows(ACT, ND, device="cpu")
    assert first["tile_rows"] == nd.default_tile_rows(ND)
    assert autotune.best_tile_rows(ACT, ND, device="cpu") is first


def test_cpu_resolves_to_the_defaults_untimed_and_says_why():
    rec = autotune.best_tile_rows(ACT, ND, device="cpu")
    assert rec["tile_rows"] == nd.default_tile_rows(ND) and "CPU" in rec["reason"]
    mesh = make_mesh([("x", 2)], devices="cpu")
    rec = autotune.best_exchange_steps(ACT, SPLIT, mesh)
    assert rec["exchange_steps"] == nd.default_exchange_steps(SPLIT) == 8 and "CPU" in rec["reason"]
    with pytest.raises(ValueError, match="D >= 3"):
        autotune.best_tile_rows(ACT, dataclasses.replace(ND, shape=(8, 8)), device="cpu")
    cfg = ChainConfig(action="double_well", n_sites=200, n_chains=65536)
    rec = autotune.best_block_chains(actions.get(cfg.action), cfg, device="cpu")
    assert rec["type"] == "autotune" and rec["block_chains"] == 1
    assert rec["launch_geometry"] == {"warps_per_chain": 4, "sites_per_lane": 2,
                                      "chains_per_block": 1}
    assert ck.launch_geometry(200, 65536) == (4, 2, 1)


def test_candidates_are_timed_in_turns_and_the_least_time_wins(monkeypatch):
    calls = []
    monkeypatch.setattr(autotune.torch.cuda, "synchronize", lambda device=None: None)
    clock = iter(range(1000))
    monkeypatch.setattr(autotune.time, "perf_counter", lambda: next(clock))
    times = autotune._timed_in_turns({4: lambda: calls.append(4), 2: lambda: calls.append(2)},
                                     torch.device("cpu"))
    assert calls == [4, 2] + [4, 2] * autotune._TUNE_REPS  # one warm call each, then turns
    assert times == {4: 1, 2: 1}
    rec = autotune._pick("tile_rows", "k", {4: 2e-3, 2: 1e-3}, {3: "no"}, 8, "height")
    assert rec["tile_rows"] == 2 and rec["candidates_ms"] == {"4": 2.0, "2": 1.0}
    assert rec["skipped"] == {"3": "no"} and autotune._CACHE["k"] is rec
    rec = autotune._pick("exchange_steps", "w", {}, {}, 8, "W")
    assert rec["exchange_steps"] == 8 and "default" in rec["reason"]


def test_the_timing_path_on_the_plain_versions(monkeypatch):
    """The tuners' loop as on the card, here over the kernels' plain versions
    (what their wrappers run on CPU tensors): every admitted candidate timed
    in turns, the least time picked, the pick cached under its key."""
    monkeypatch.setattr(autotune, "_kernels_run", lambda device: True)
    monkeypatch.setattr(autotune, "_device_kind", lambda device: "rehearsal")
    monkeypatch.setattr(autotune.torch.cuda, "synchronize", lambda device=None: None)
    small = dataclasses.replace(ND, shape=(4, 4, 4), loops=2)
    rec = autotune.best_tile_rows(ACT, small, device="cpu")
    assert sorted(map(int, rec["candidates_ms"])) == [1, 2, 4] and rec["skipped"] == {}
    assert str(rec["tile_rows"]) == min(rec["candidates_ms"], key=rec["candidates_ms"].get)
    mesh = make_mesh([("x", 2)], devices="cpu")
    split = dataclasses.replace(SPLIT, shape=(8, 8), loops=4)
    rec = autotune.best_exchange_steps(ACT, split, mesh)
    assert rec["exchange_steps"] in (2, 4) and sorted(map(int, rec["candidates_ms"])) == [2, 4]
    assert sorted(map(int, rec["skipped"])) == [8, 16, 32, 64]
    assert autotune.best_exchange_steps(ACT, split, mesh) is rec  # cached


def test_runtime_records_each_zero(monkeypatch):
    recs = []
    sink = metrics.MetricsSink(callback=recs.append)
    runtime.run_chain(ChainConfig(action="double_well", n_sites=16, n_chains=4, loops=4,
                                  frames=1, block_chains=0), device="cpu", sink=sink)
    runtime.run_field(dataclasses.replace(ND, tile_rows=0), device="cpu", sink=sink)
    mesh = make_mesh([("x", 2)], devices="cpu")
    runtime.run_field(dataclasses.replace(SPLIT, exchange_steps=0), mesh=mesh, sink=sink)
    tuned = [r for r in recs if r["type"] == "autotune"]
    assert [next(k for k in r if k in ("block_chains", "tile_rows", "exchange_steps"))
            for r in tuned] == ["block_chains", "tile_rows", "exchange_steps"]
    assert tuned[1]["tile_rows"] == nd.default_tile_rows(ND) and "plain" in tuned[1]["reason"]
    assert tuned[2]["exchange_steps"] == 8 and "plain" in tuned[2]["reason"]
    # the kernel route (here on CPU tensors: the wrappers' plain versions): D >= 3 is
    # tuned, 2-D takes the strip-tiled kernel's default height, as the JAX package
    real = runtime.select_field_backend
    monkeypatch.setattr(runtime, "select_field_backend",
                        lambda cfg, backend, device, mesh=None: real(cfg, backend, "cuda", mesh))
    recs.clear()
    runtime.run_field(dataclasses.replace(ND, tile_rows=0), device="cpu", sink=sink)
    runtime.run_field(FieldConfig(shape=(16, 16), n_chains=2, loops=4, frames=1, tile_rows=0),
                      device="cpu", sink=sink)
    tuned = [r for r in recs if r["type"] == "autotune"]
    assert "CPU" in tuned[0]["reason"] and tuned[1]["tile_rows"] == 16
    assert "strip-tiled" in tuned[1]["reason"]


def test_cli_takes_zero(tmp_path):
    from stochquant_tpu_torch import cli

    m = tmp_path / "m.jsonl"
    cli.main(["run", "--preset", "phi4_4d", "--device", "cpu", "--chains", "1", "--frames", "1",
              "--loops", "2", "--tile-rows", "0", "--metrics", str(m)])
    assert '"type": "autotune"' in m.read_text()


@pytest.mark.cuda
def test_the_tuners_time_kernels_6_and_7_for_every_admitted_candidate():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU interpret mode")
    cfg = dataclasses.replace(ND, shape=(16, 16, 16, 16), loops=4)
    before = nd.field_pair_nd.launches
    rec = autotune.best_tile_rows(ACT, cfg, device="cuda")
    admitted, _ = autotune.tile_rows_candidates(cfg)
    assert rec["tile_rows"] in admitted and set(rec["candidates_ms"]) == set(map(str, admitted))
    reps = (1 + autotune._TUNE_REPS) * autotune._TUNE_FRAMES * cfg.loops // 2
    assert nd.field_pair_nd.launches - before == reps * len(admitted)
    mesh = make_mesh([("x", 2)], devices="cuda:0")
    before = nd.field_chunk_nd.launches
    W = autotune.best_exchange_steps(ACT, SPLIT, mesh)["exchange_steps"]
    assert W in (2, 4, 8) and nd.field_chunk_nd.launches > before

"""BENCHMARK.json against the benchmark's contract, and every file it names
found by name: configurations, traffic mixes, cells, per-layer readers and
the work counts of the kernels they read."""

import importlib
import json
import re
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from sqbench import run, work  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
CONFIGS = [c["name"] for c in BENCH["configs"]]


def line_ok(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert (ROOT / p).is_dir()
    assert 1 <= len(BENCH["command"]) <= 32 and all(line_ok(w) for w in BENCH["command"])
    for w in BENCH["command"][1:]:
        if "/" in w:
            assert any(w.startswith(p + "/") for p in BENCH["paths"]), w
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_are_unique_and_well_formed():
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    for names in (CELLS, CONFIGS, metrics):
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=CONFIGS)
def test_config_loads_by_name(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert line_ok(cfg["source"]) and line_ok(cfg["why"])
    assert cfg["file"] == f"sqbench/configs/{cfg['name']}.json"
    data = run.load("configs", f"{cfg['name']}.json")
    assert data["source"] == cfg["source"]
    assert sorted(data["reduced"]) == sorted(cfg["reduced"]) and len(cfg["reduced"]) <= 16
    assert all(NAME.match(k) for k in cfg["reduced"])
    assert set(data["changes"]) == set(cfg["reduced"])
    assert cfg["name"] in {w["config"] for w in BENCH["workloads"]}
    importlib.import_module(f"sqbench.kinds.{data['kind']}")
    importlib.import_module(f"sqbench.reference.actions.{data['chain']['action']}")


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=CELLS)
def test_cell_loads_by_name(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] in (1, 4) and line_ok(cell["why"]) and NAME.match(cell["traffic"])
    assert cell["config"] in CONFIGS
    traffic = run.load("traffic", f"{cell['traffic']}.json")
    spec = run.load("cells", f"{cell['name']}.json")
    assert set(spec["limits"]) == {"state_gap", "decisions", "record_gap", "missing"}
    assert spec["limits"]["missing"] == 0
    assert (ROOT / "sqbench/roofline/noise" / f"{traffic['rng_impl']}.json").exists()
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert pairs.count((cell["config"], cell["traffic"])) == 1
    _, e2e, per_layer = run.workload(cell["name"])
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2 and per_layer


def test_end_to_end_metrics():
    names = [m["name"] for m in BENCH["end_to_end"]]
    assert "setup_s" in names and 1 <= len(names) <= 16
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=[m["name"] for m in BENCH["per_layer"]])
def test_per_layer_metric_has_a_reader(m):
    assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
    assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") and line_ok(m["layer"])
    assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    assert callable(importlib.import_module(f"sqbench.layer_metrics.{run.base_name(m)}").read)
    for cell in m.get("workloads", CELLS):
        assert cell in CELLS
        _, e2e, _ = run.workload(cell)
        assert m["moves"] in {e["name"] for e in e2e}


@pytest.mark.parametrize("kernel", ["chain_frame", "chain_frames_multi"])
def test_roofline_counts(kernel):
    """Both kernels at config 2's widths: the issue rate binds, and the least
    time is the algorithm's operations a launch over 128 a clock on each of
    132 SMs at 1980 MHz (kernel 2 with its epilogue)."""
    spec = run.load("configs", "anharmonic_n1024.json")
    cfg = dict(spec["chain"], rng_impl="threefry", frames_per_launch=16)
    seconds, by = work.least_seconds(kernel, cfg, spec["work"])
    frames = 16 if kernel == "chain_frames_multi" else 1
    # a site-update: 11 fp32 + 6 alu, the force's 3 fp32, half of Threefry-20's 85
    per_frame = 1000 * 1024 * (11 + 6 + 3 + 85 / 2)
    if frames == 16:
        per_frame += 1024 * 8 + 10   # the means folded a site, the chain's epilogue
    assert by == "issue"
    assert seconds == pytest.approx(frames * 256 * per_frame / (128 * 132 * 1.98e9), rel=1e-12)


@pytest.mark.parametrize("config,rng,binds", [
    ("double_well_n200", "threefry", "issue"), ("double_well_n200", "threefry13", "issue")])
def test_roofline_classes(config, rng, binds):
    """The headline's kernel 1: each class against its own pipe, the integer
    logic at half the float32 rate, and no class above the issue bound."""
    spec = run.load("configs", f"{config}.json")
    cfg = dict(spec["chain"], rng_impl=rng, frames_per_launch=1)
    ops, n_bytes = work.launch_work("chain_frame", cfg, spec["work"])
    assert set(ops) == set(work.CLASSES)
    rounds = 20 if rng == "threefry" else 13
    updates = 65536 * 200 * 1000
    alu_site = 6 + (2 * rounds + 4) / 2
    chain_alu = 1 + (2 * rounds + 4) / 2
    assert ops["alu"] == pytest.approx(updates * alu_site + 65536 * 1000 * chain_alu, rel=1e-12)
    assert ops["sfu"] == pytest.approx(updates * 3 + 65536 * 1000 * 2, rel=1e-12)
    seconds, by = work.least_seconds("chain_frame", cfg, spec["work"])
    assert by == binds and n_bytes / 3.35e12 < seconds

"""The harness end to end on the CPU at a tiny size, on the port's plain
path: the result line, no JAX, no result without a card, and the check: the
program passes, the control and each planted fault fail it.  One case needs
the card (``cuda``) and skips without one."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from sqbench import run  # noqa: E402

TINY = {"chain": {"n_chains": 8, "n_sites": 24, "dt": 0.1, "dtau": 1e-3, "loops": 10},
        "check": {"chains": 8}}
TINY_ANH = {"chain": {"n_chains": 8, "n_sites": 16, "loops": 10}, "check": {"chains": 8}}
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


def tiny(name):
    return TINY if name.startswith("dw") else TINY_ANH


def serve(name, seed=4000000007, seconds=0.5, **kw):
    return run.run_cell(name, seed, seconds, device="cpu", overrides=tiny(name), **kw)


@pytest.mark.parametrize("name", CELLS)
def test_program_passes_and_control_fails(name):
    """At the tiny size the program's plain path meets every limit, and the
    reference in bfloat16 in its place fails at least one."""
    out = serve(name, control=True)
    assert out["correct"], out["checks"]
    limits = {k: c["limit"] for k, c in out["checks"].items()}
    assert any(out["control"][k] > limits[k] for k in limits), out["control"]


@pytest.mark.parametrize("traced", [False, True])
def test_result_line_keys(traced):
    out = serve(CELLS[0], trace=traced)
    device = {"platform": "cpu", "kind": "cpu", "count": 1,
              "memory_peak_bytes": out["memory_peak_bytes"]}
    line = run.result_line(out, device)
    want = ["correct", "attempted", "failed", "metrics", "device"]
    want += ["breakdown", "checks"] if traced else ["checks"]
    assert list(line) == want
    assert json.loads(json.dumps(line)) == line
    names = set(line["metrics"])
    assert names <= ({"device_idle_pct", "epilogue_device_ms", "chain_frame_roofline"} if traced
                     else {"mlups", "record_ms_p95", "setup_s"})
    assert traced or names == {"mlups", "record_ms_p95", "setup_s"}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}


def _fault_unchanged(monkeypatch):
    from stochquant_tpu_torch.integrators import langevin
    real = langevin.run_frames

    def unchanged(state, *a, **kw):
        _, m = real(state, *a, **kw)
        return state, m
    monkeypatch.setattr(langevin, "run_frames", unchanged)


def _fault_half_batch(monkeypatch):
    from stochquant_tpu_torch.integrators import langevin
    real = langevin.connected_correlator

    def half(state):
        return real(state)[: state.x_mean.shape[0] // 2]
    monkeypatch.setattr(langevin, "connected_correlator", half)


def _fault_altered_answer(monkeypatch):
    from stochquant_tpu_torch.integrators import langevin
    real = langevin.run_frames

    def altered(state, *a, **kw):
        out, m = real(state, *a, **kw)
        f = out.f.clone()
        f[3, 5] += 1e-3
        return out._replace(f=f), m
    monkeypatch.setattr(langevin, "run_frames", altered)


@pytest.mark.parametrize("fault", [_fault_unchanged, _fault_half_batch, _fault_altered_answer],
                         ids=["state_unchanged", "half_the_batch", "answer_altered"])
@pytest.mark.parametrize("name", [CELLS[0], "anh1024.c256.fpl16"])
def test_a_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    fault(monkeypatch)
    out = serve(name)
    assert not out["correct"], out["checks"]


def test_nothing_observed_is_not_correct(monkeypatch):
    """A frame function the wrapper does not see (bound another way, or a new
    entry) leaves the check nothing to compare: that run is not correct."""
    from sqbench.kinds import chain
    monkeypatch.setattr(chain.Observer, "wrap", lambda self, fn: fn)
    out = serve(CELLS[0])
    assert out["checks"]["missing"]["value"] == 3
    assert not out["correct"], out["checks"]


def test_action_params_must_be_the_programs():
    """The program runs its action's own parameters; a configuration whose
    ``action_params`` differ from them is refused in set-up."""
    with pytest.raises(ValueError, match="action_params"):
        run.run_cell(CELLS[0], 1, 0.3, device="cpu",
                     overrides=dict(TINY, action_params={"v0": 3.0, "eta": 0.8, "mass": 1.0}))


def _clean_env():
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA"))}
    env["PYTHONPATH"] = str(ROOT)
    return env


def test_the_harness_loads_no_jax():
    """A whole run in a fresh process: no module named jax, jaxlib, flax or
    stochquant_tpu (compared whole: stochquant_tpu_torch is the program)."""
    code = ("import sys, json; from sqbench import run; "
            f"run.run_cell({CELLS[0]!r}, 3, 0.3, device='cpu', overrides={TINY!r}); "
            "print(json.dumps([run.forbidden_modules(), 'stochquant_tpu_torch.runtime' in sys.modules]))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_clean_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [[], True]


def test_a_run_without_a_card_fails():
    if torch.cuda.is_available():
        pytest.skip("a card is present: this case needs a host without one")
    out = subprocess.run([sys.executable, "sqbench/run.py", "--workload", CELLS[0], "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=ROOT, env=_clean_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 2
    assert out.stdout.strip() == ""
    assert "needs 1 CUDA card" in out.stderr


@pytest.mark.cuda
def test_graphs_replay_the_eager_reference():
    """On the card: the reference's CUDA graphs give the eager loop's bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from sqbench.reference import chain as ref
    cfg = dict(run.load("configs", "anharmonic_n1024.json")["chain"], rng_impl="threefry",
               seed=11, action_params={})
    ids = torch.arange(0, 256, 16, device="cuda")
    start = ref.init_state(cfg, ids)
    eager, _ = ref.frames(start, cfg, ids, 2)
    graphed, _ = ref.frames(start, cfg, ids, 2, ref.Graphs())
    for k in ref.FLOAT_LEAVES + ref.EXACT_LEAVES:
        assert torch.equal(getattr(eager, k), getattr(graphed, k)), k

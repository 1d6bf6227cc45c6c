"""The plain reference: Threefry against Random123's known answers, a frozen
tiny fixture, and the port's plain integrator on the CPU (bit for bit)."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from sqbench.reference import chain as ref  # noqa: E402
from sqbench.reference import threefry  # noqa: E402

DW = dict(action="double_well", action_params={"v0": 2.0, "eta": 0.8, "mass": 1.0},
          n_sites=24, dt=0.1, dtau=1e-3, n_chains=70001, noise_amp=1.0, bc="FIXED_BG",
          formulation="BACKGROUND", scheme="EM", parisi=True, ghost_override=None, loops=6,
          rng_impl="threefry", seed=4000000123, clamp=1000.0, shrink=0.95,
          grow_after=10**9, dtau_max=None)
ANH = dict(DW, action="anharmonic", action_params={"mu2": 1.0, "lam": 1.0, "mass": 1.0},
           n_sites=16, dt=0.25, dtau=0.01, n_chains=8, bc="PERIODIC", formulation="DIRECT",
           loops=7, rng_impl="threefry13", seed=17)


@pytest.mark.parametrize("rounds,key,ctr,want", [
    (20, (0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
    (13, (0, 0), (0, 0), (0x9D1C5EC6, 0x8BD50731)),
    (20, (0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF), (0x1CB996FC, 0xBB002BE7)),
    (20, (0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3), (0xC4923A9C, 0x483DF7A0)),
])
def test_threefry_known_answers(rounds, key, ctr, want):
    x0, x1 = threefry.threefry2x32(torch.tensor(key[0]), key[1], ctr[0], ctr[1], rounds)
    assert (int(x0), int(x1)) == want


def test_frozen_fixture():
    """Two frames of three chains (one beyond 65,535, a seed beyond 2**31)."""
    ids = torch.tensor([0, 5, 70000])
    state, m = ref.frames(ref.init_state(DW, ids), DW, ids, 2)
    assert state.step == 14 and bool(m["stable"].all())
    assert state.runs.tolist() == [[12, 0]] * 3
    want = {
        "f": [[-0.12627795338630676, 0.13914921879768372, 0.7622474431991577],
              [-0.06585777550935745, 0.015768246725201607, 0.18520191311836243],
              [-0.12248431146144867, -0.105775386095047, -0.475559800863266]],
        "omega": [0.899051308631897, 1.858986735343933, 1.6018210649490356],
        "x_mean": [[-0.593241810798645, -0.5516119003295898],
                   [-1.0707610845565796, -0.7606899738311768],
                   [-0.9025906324386597, -0.6628766059875488]],
        "xx0_mean": [[-0.2929910719394684, -0.27622461318969727],
                     [0.9803684949874878, 0.6857262849807739],
                     [0.6804264783859253, 0.5030385255813599]],
        "lrg_vl": [1.216381311416626, 1.454056739807129, 1.283121943473816],
    }
    got = {"f": state.f[:, :3], "omega": state.omega, "x_mean": state.x_mean[:, :2],
           "xx0_mean": state.xx0_mean[:, :2], "lrg_vl": state.lrg_vl}
    for k, v in want.items():  # float32 transcendentals may round apart across builds
        np.testing.assert_allclose(got[k].numpy(), np.array(v, dtype=np.float32),
                                   rtol=2e-6, atol=2e-7, err_msg=k)


def _port_run(cfg, frames):
    from stochquant_tpu_torch import actions
    from stochquant_tpu_torch.config import BoundaryCondition, ChainConfig, Formulation, Scheme
    from stochquant_tpu_torch.integrators import langevin
    c = {k: v for k, v in cfg.items() if k != "action_params"}
    c.update(bc=BoundaryCondition[c["bc"]], formulation=Formulation[c["formulation"]],
             scheme=Scheme[c["scheme"]])
    pcfg = ChainConfig(**c)
    act = actions.get(pcfg.action)
    state = langevin.init_chain_state(pcfg, act, device="cpu")
    return langevin.run_frames(state, act, pcfg, frames)


@pytest.mark.parametrize("cfg", [dict(DW, n_chains=6), ANH, dict(ANH, scheme="HEUN"),
                                 dict(DW, n_chains=4, bc="DIRICHLET", formulation="DIRECT")],
                         ids=["double_well", "anharmonic", "heun", "dirichlet"])
def test_reference_is_the_port_plain_path(cfg):
    """The reference over every chain against the port's plain integrator,
    run from the same seed: every leaf and decision bit for bit."""
    got, got_m = _port_run(cfg, 3)
    ids = torch.arange(cfg["n_chains"])
    want, want_m = ref.frames(ref.init_state(cfg, ids), cfg, ids, 3)
    for k in ref.FLOAT_LEAVES + ref.EXACT_LEAVES:
        assert torch.equal(getattr(got, k), getattr(want, k)), k
    assert int(got.step) == want.step
    for k in ("stable", "dtau"):
        assert torch.equal(got_m[k], want_m[k]), k


def test_a_sample_of_chains_follows_its_own_stream():
    """Rows taken from the whole ensemble give the sampled run's results."""
    cfg = dict(DW, n_chains=6)
    ids = torch.arange(6)
    whole, _ = ref.frames(ref.init_state(cfg, ids), cfg, ids, 2)
    rows = torch.tensor([1, 4])
    part, _ = ref.frames(ref.init_state(cfg, rows), cfg, rows, 2)
    for k in ref.FLOAT_LEAVES:
        assert torch.equal(getattr(whole, k)[rows], getattr(part, k)), k

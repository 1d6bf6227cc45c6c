"""The port's chain-kernel module: on the CPU its wrappers run the plain
versions, which must match the JAX package's Pallas kernels (interpret mode,
as tests/test_chain_kernel.py runs them).  The CUDA kernels themselves are
compared with the plain versions on the card (tests marked ``cuda``, and
``chip_smoke.py``)."""

import ctypes
import dataclasses

import numpy as np
import pytest
import torch

from stochquant_tpu import actions as jact
from stochquant_tpu.config import ChainConfig as JChainConfig
from stochquant_tpu.integrators import langevin as jl
from stochquant_tpu.kernels import chain_kernel as jck
from stochquant_tpu_torch import actions
from stochquant_tpu_torch.actions.base import QMAction
from stochquant_tpu_torch.config import BoundaryCondition, ChainConfig, Formulation, Scheme
from stochquant_tpu_torch.integrators import langevin
from stochquant_tpu_torch.io import checkpoint
from stochquant_tpu_torch.kernels import _build
from stochquant_tpu_torch.kernels import chain_kernel as ck

torch.set_num_threads(1)

CFG = ChainConfig(action="double_well", n_sites=128, dt=0.05, dtau=0.001, n_chains=8,
                  loops=10, seed=11)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU interpret mode")
    return torch.device("cuda")


def _jax_start(cfg):
    jcfg = JChainConfig.from_json(cfg.to_json())
    act = jact.get(cfg.action)
    s0 = jl.init_chain_state(jcfg, act)
    port = checkpoint.state_from_numpy(
        {name: np.asarray(leaf) for name, leaf in zip(s0._fields, s0)}, "cpu"
    )
    return jcfg, act, s0, port


def _assert_states_equal(a, b, label=""):
    for name, x, y in zip(a._fields, a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0, msg=f"{label}:{name}")


@pytest.mark.parametrize("fpl", [1, 2])
def test_plain_kernels_match_pallas_interpret(fpl):
    """frames_per_launch=1 (kernel 1 + epilogue) and K=2 with a remainder
    frame (kernel 2 once, then kernel 1) against run_frames_pallas."""
    jcfg, jact_, s0, port = _jax_start(CFG)
    want, wm = jck.run_frames_pallas(s0, jact_, jcfg, 3, block_chains=4, interpret=True,
                                     frames_per_launch=fpl)
    got, gm = ck.run_frames_kernel(port, actions.get(CFG.action), CFG, 3,
                                   frames_per_launch=fpl, block_chains=4)
    np.testing.assert_array_equal(gm["stable"].numpy(), np.asarray(wm["stable"]))
    for name, g, w in zip(got._fields, got, want):
        w = np.asarray(w)
        if name in ("runs", "stab_cnt", "step"):
            np.testing.assert_array_equal(g.numpy().astype(w.dtype), w, err_msg=name)
        else:
            np.testing.assert_allclose(g.numpy(), w, rtol=2e-6, atol=2e-6, err_msg=name)


def test_chain_blocking_does_not_change_results():
    """block_chains is accepted for checkpoint compatibility and ignored;
    only its autotune value 0 raises."""
    act = actions.get(CFG.action)
    s0 = langevin.init_chain_state(CFG, act, device="cpu")
    for fpl in (1, 2):
        ref, rm = ck.run_frames_kernel(s0, act, CFG, 3, frames_per_launch=fpl)
        for block in (2, 3, 4):
            got, gm = ck.run_frames_kernel(s0, act, CFG, 3, frames_per_launch=fpl,
                                           block_chains=block)
            _assert_states_equal(got, ref, f"fpl={fpl} block={block}")
            for key in rm:
                torch.testing.assert_close(gm[key], rm[key], rtol=0, atol=0)
    with pytest.raises(ValueError, match="autotune"):
        ck.run_frames_kernel(s0, act, CFG, 1, block_chains=0)


def test_cpu_tensors_run_the_plain_versions_without_launching():
    act = actions.get(CFG.action)
    s0 = langevin.init_chain_state(CFG, act, device="cpu")
    before = (ck.chain_frame.launches, ck.chain_frames_multi.launches)
    sums = ck.chain_frame(s0, act, CFG, chain_offset=8)
    ref = ck.chain_frame_ref(s0, act, CFG, chain_offset=8)
    for name, x, y in zip(sums._fields, sums, ref):
        torch.testing.assert_close(x, y, rtol=0, atol=0, msg=name)
    multi, mm = ck.chain_frames_multi(s0, act, CFG, 2)
    multi_ref, mr = ck.chain_frames_multi_ref(s0, act, CFG, 2)
    _assert_states_equal(multi, multi_ref, "multi")
    assert mm["stable"].shape == (2, CFG.n_chains)
    assert (ck.chain_frame.launches, ck.chain_frames_multi.launches) == before
    # K frames of kernel 2 == K launches of kernel 1 + the PyTorch epilogue
    single, _ = ck.run_frames_kernel(s0, act, CFG, 2, frames_per_launch=1)
    _assert_states_equal(multi, single, "multi vs single")


def test_launch_geometry():
    assert ck.launch_geometry(200) == (224, 1)
    assert ck.launch_geometry(1024) == (512, 2)
    assert ck.launch_geometry(2000) == (512, 4)
    assert ck.launch_geometry(4096) == (512, 8)
    with pytest.raises(ValueError, match="limit"):
        ck.launch_geometry(4097)


def test_kernel_parameters_mirror_the_cuda_struct():
    # 18 four-byte integer fields and 19 floats, in the order of csrc/chain_kernel.cu
    assert ctypes.sizeof(_build.ChainParams) == 37 * 4
    src = (_build._CSRC / "chain_kernel.cu").read_text()
    body = src[src.index("struct ChainParams {"):src.index("};", src.index("struct ChainParams {"))]
    names = []
    for line in body.splitlines()[1:]:
        decl = line.split("//")[0].strip().rstrip(";")
        if decl:
            names += [n.strip() for n in decl.split(None, 1)[1].split(",")]
    assert names == [f for f, _ in _build.ChainParams._fields_]

    act = actions.get("double_well")
    s0 = langevin.init_chain_state(CFG, act, device="cpu")
    p = ck._params(s0, act, CFG, chain_offset=2**32 + 3, n_frames=4)
    assert (p.n_chains, p.n_sites, p.threads, p.sites_per_thread) == (8, 128, 128, 1)
    assert (p.rounds, p.philox, p.loops, p.n_frames, p.step0, p.chain0) == (20, 0, 10, 4, 2, 3)
    hw = ck._params(s0, act, dataclasses.replace(CFG, rng_impl="hardware"), 0, 1)
    assert (hw.rounds, hw.philox) == (20, 1)
    assert (p.bc, p.background, p.has_zm, p.heun, p.action) == (1, 1, 1, 0, 1)
    assert p.dt == np.float32(0.05) and p.p1 == 24.0 and p.xcl_w == 2.5
    assert p.t_right == np.float32(128 * 0.05)


def test_unsupported_inputs_raise():
    act = actions.get(CFG.action)
    s0 = langevin.init_chain_state(CFG, act, device="cpu")

    @dataclasses.dataclass(frozen=True)
    class Custom(QMAction):
        def V(self, x):
            return x * x

    with pytest.raises(ValueError, match="Custom"):
        ck._action_constants(Custom())
    # the plain-path features stay refused by the kernels, as the Pallas ones refuse them
    for change, match in ((dict(scheme=Scheme.LM), "LM"), (dict(scheme=Scheme.EXACT), "EXACT"),
                          (dict(accumulate_spectrum=True), "spectrum")):
        bad = dataclasses.replace(CFG, **change)
        with pytest.raises(ValueError, match=match):
            ck.chain_frame(s0, act, bad)
        with pytest.raises(ValueError, match=match):
            ck.chain_frames_multi(s0, act, bad, 2)
        with pytest.raises(ValueError, match=match):
            ck.chain_frame_ref(s0, act, bad)
        with pytest.raises(ValueError, match=match):
            ck.run_frames_kernel(s0, act, bad, 1)
    # rng_impl='hardware' is the kernels' Philox variant: it runs, on another stream
    hw = dataclasses.replace(CFG, rng_impl="hardware")
    assert not torch.equal(ck.chain_frame(s0, act, hw).f, ck.chain_frame(s0, act, CFG).f)
    meta = langevin.ChainState(*(t if n == "step" else t.to("meta")
                                 for n, t in zip(s0._fields, s0)))
    with pytest.raises(ValueError, match="cuda"):
        ck.chain_frame(meta, act, CFG)


@pytest.mark.cuda
@pytest.mark.parametrize("name,cfg", [
    ("double_well_fixed_bg", dataclasses.replace(CFG, n_chains=32, loops=40)),
    ("anharmonic_periodic_tf13", ChainConfig(
        action="anharmonic", n_sites=1024, dt=0.25, dtau=0.01, n_chains=8, loops=20, seed=3,
        bc=BoundaryCondition.PERIODIC, formulation=Formulation.DIRECT,
        rng_impl="threefry13")),
    ("harmonic_dirichlet_heun", ChainConfig(
        action="harmonic", n_sites=96, dt=0.2, dtau=0.005, n_chains=8, loops=11, seed=4,
        bc=BoundaryCondition.DIRICHLET, formulation=Formulation.DIRECT, scheme=Scheme.HEUN)),
])
def test_cuda_kernels_match_plain_versions(cuda_device, name, cfg):
    act = actions.get(cfg.action)
    s0 = langevin.init_chain_state(cfg, act, device=cuda_device)
    plain, pm = langevin.run_frames(s0, act, cfg, 2)
    before = (ck.chain_frame.launches, ck.chain_frames_multi.launches)
    k1, m1 = ck.run_frames_kernel(s0, act, cfg, 2)
    k2, m2 = ck.chain_frames_multi(s0, act, cfg, 2)
    torch.cuda.synchronize()
    assert ck.chain_frame.launches == before[0] + 2
    assert ck.chain_frames_multi.launches == before[1] + 1
    for got, gm in ((k1, m1), (k2, m2)):
        leaves = [*zip(got._fields, got, plain), *((k, gm[k], pm[k]) for k in pm)]
        for leaf, x, y in leaves:
            if leaf in ("runs", "stab_cnt", "step", "stable"):
                assert torch.equal(x.cpu(), y.cpu()), leaf
            else:
                torch.testing.assert_close(x, y, rtol=0, atol=2e-6, msg=leaf)

"""The port's whole-lattice field kernels (kernels 3 and 4): on the CPU the
wrappers run their plain versions, which must match the JAX package's Pallas
kernels (interpret mode, as tests/test_field_kernel.py runs them) — φ, Δτ
and lrg_vl within 2e-6, the site means within rtol 3e-5 / atol 3e-6, the
accept/reject decisions, runs, stab_cnt and step exactly.  The CUDA kernels
themselves are compared with the plain versions on the card (tests marked
``cuda``, and ``chip_smoke.py``)."""

import ctypes
import dataclasses

import numpy as np
import pytest
import torch

from stochquant_tpu.actions import phi4 as jphi4
from stochquant_tpu.config import FieldConfig as JFieldConfig
from stochquant_tpu.integrators import field as jfield
from stochquant_tpu.kernels import field_kernel as jfk
from stochquant_tpu_torch import actions
from stochquant_tpu_torch.actions.phi4 import FieldAction
from stochquant_tpu_torch.config import FieldConfig, Scheme, Sweep
from stochquant_tpu_torch.integrators import field
from stochquant_tpu_torch.io import checkpoint
from stochquant_tpu_torch.kernels import _build
from stochquant_tpu_torch.kernels import field_kernel as fk

torch.set_num_threads(1)

EXACT = ("runs", "stab_cnt", "step")
MEANS = ("mag_mean", "mag2_mean", "mag4_mean", "absmag_mean", "phi2_mean", "act_mean",
         "corr_mean")
CFG = FieldConfig(shape=(8, 128), dtau=0.003, n_chains=3, loops=5, seed=7)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU interpret mode")
    return torch.device("cuda")


def _jax_start(cfg):
    jcfg = JFieldConfig.from_json(cfg.to_json())
    s0 = jfield.init_field_state(jcfg)
    port = checkpoint.state_from_numpy(
        {name: np.asarray(leaf) for name, leaf in zip(s0._fields, s0)}, "cpu"
    )
    return jcfg, jphi4.get_field(cfg.action), s0, port


def _assert_matches(got, gm, want, wm):
    np.testing.assert_array_equal(gm["stable"].numpy(), np.asarray(wm["stable"]))
    np.testing.assert_allclose(gm["dtau"].numpy(), np.asarray(wm["dtau"]), rtol=2e-6)
    for name, g, w in zip(got._fields, got, want):
        w = np.asarray(w)
        if name in EXACT:
            np.testing.assert_array_equal(g.numpy().astype(w.dtype), w, err_msg=name)
        else:
            tol = dict(rtol=3e-5, atol=3e-6) if name in MEANS else dict(rtol=2e-6, atol=2e-6)
            np.testing.assert_allclose(g.numpy(), w, err_msg=name, **tol)


def _assert_states_equal(a, b, label=""):
    for name, x, y in zip(a._fields, a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0, msg=f"{label}:{name}")


@pytest.mark.parametrize("cfg,n_frames,fpl", [
    # kernel 3 + epilogue, odd loops (the tail micro-step)
    (dataclasses.replace(CFG, shape=(16, 128), loops=9, seed=23), 2, 1),
    # kernel 4 twice (K=3), then kernel 3 for the seventh frame; checkerboard
    (dataclasses.replace(CFG, sweep=Sweep.CHECKERBOARD), 7, 3),
    # rejected frames roll back in-kernel: Δτ shrinks, means and runs freeze
    (dataclasses.replace(CFG, dtau=0.5, loops=4, seed=2, rng_impl="threefry13"), 4, 2),
])
def test_plain_kernels_match_pallas_interpret(cfg, n_frames, fpl):
    jcfg, jact, s0, port = _jax_start(cfg)
    want, wm = jfk.run_field_frames_pallas(s0, jact, jcfg, n_frames, interpret=True,
                                           frames_per_launch=fpl)
    got, gm = fk.run_field_frames_kernel(port, actions.get_field(cfg.action), cfg, n_frames,
                                         frames_per_launch=fpl)
    assert gm["stable"].shape == (n_frames, cfg.n_chains)
    _assert_matches(got, gm, want, wm)
    if cfg.dtau == 0.5:
        assert not gm["stable"].all(), "case must reject frames"


def test_cpu_tensors_run_the_plain_versions_without_launching():
    act = actions.get_field("phi4")
    s0 = field.init_field_state(CFG, device="cpu")
    before = (fk.field_frame.launches, fk.field_frames_multi.launches)
    sums = fk.field_frame(s0, act, CFG, chain_offset=5)
    ref = fk.field_frame_ref(s0, act, CFG, chain_offset=5)
    for name, x, y in zip(sums._fields, sums, ref):
        torch.testing.assert_close(x, y, rtol=0, atol=0, msg=name)
    multi, mm = fk.field_frames_multi(s0, act, CFG, 2)
    multi_ref, _ = fk.field_frames_multi_ref(s0, act, CFG, 2)
    _assert_states_equal(multi, multi_ref, "multi")
    assert mm["stable"].shape == (2, CFG.n_chains) and int(multi.step) == 1 + 2 * CFG.loops
    assert (fk.field_frame.launches, fk.field_frames_multi.launches) == before
    # K frames of kernel 4 == K launches of kernel 3 + the PyTorch epilogue
    single, _ = fk.run_field_frames_kernel(s0, act, CFG, 2, frames_per_launch=1)
    _assert_states_equal(multi, single, "multi vs single")
    # chain_offset keys the noise by global chain id
    shifted = fk.field_frame_ref(s0, act, CFG, chain_offset=1)
    assert not torch.equal(shifted.phi, ref.phi)


def test_kernel_parameters_mirror_the_cuda_struct():
    # 14 four-byte integer fields, 3 unsigned, 13 floats and kernels 3 and 4's
    # 4 cluster-geometry integers, in the order of csrc/field_common.cuh
    assert ctypes.sizeof(_build.FieldParams) == 34 * 4
    src = (_build._CSRC / "field_common.cuh").read_text()
    start = src.index("struct FieldParams {")
    body = src[start:src.index("};", start)]
    names = []
    for line in body.splitlines()[1:]:
        decl = line.split("//")[0].strip().rstrip(";")
        if decl:
            names += [n.strip() for n in decl.split(None, 1)[1].split(",")]
    assert names == [f for f, _ in _build.FieldParams._fields_]

    cfg = dataclasses.replace(CFG, sweep=Sweep.CHECKERBOARD, dtau_max=0.5, grow_after=3,
                              rng_impl="threefry13", spacing=0.5)
    p = fk.kernel_params((3, 8, 128), actions.get_field("phi4", m2=-0.5, lam=3.0), cfg,
                         step0=2**32 + 7, chain_offset=4, n_frames=2)
    assert (p.n_chains, p.L0, p.L1, p.rounds, p.loops, p.n_frames) == (3, 8, 128, 13, 5, 2)
    assert (p.checkerboard, p.action, p.grow_after, p.has_dtau_max) == (1, 0, 3, 1)
    assert (p.step0, p.chain0, p.seed, p.tile_rows, p.n_tiles) == (7, 4, 7, 0, 0)
    assert p.m2 == -0.5 and p.hm2 == -0.25 and p.l6 == 0.5 and p.l24 == np.float32(0.125)
    assert p.inv_a2 == 4.0 and p.measure == 0.25 and p.inv_l1 == np.float32(1 / 128)
    # one block per chain until a launch writes its cluster geometry
    assert (p.cl_B, p.cl_rows, p.cl_scratch, p.cl_empty) == (1, 8, 0, 0)
    free = fk.kernel_params((1, 4, 4), actions.get_field("free_field", m2=2.0), CFG, step0=1)
    assert (free.action, free.hm2, free.has_dtau_max) == (1, 1.0, 0)


def test_unsupported_inputs_raise():
    act = actions.get_field("phi4")
    s0 = field.init_field_state(CFG, device="cpu")

    @dataclasses.dataclass(frozen=True)
    class Custom(FieldAction):
        def V(self, phi):
            return phi * phi

    with pytest.raises(ValueError, match="Custom"):
        fk.kernel_params((3, 8, 128), Custom(), CFG, step0=1)
    # rng_impl='hardware' is the kernels' Philox variant: it runs, on another stream
    hw = dataclasses.replace(CFG, rng_impl="hardware")
    assert not torch.equal(fk.field_frame(s0, act, hw).phi, fk.field_frame(s0, act, CFG).phi)
    assert fk.kernel_params((3, 8, 128), act, hw, step0=1, philox=fk.philox(hw)).philox == 1
    assert (fk.noise_planes(CFG), fk.noise_planes(hw)) == (1, 3)
    for change, match in ((dict(scheme=Scheme.EXACT), "EXACT"),
                          (dict(shape=(4, 4, 4)), "2-D"),
                          (dict(dtype="float64"), "float32")):
        bad = dataclasses.replace(CFG, **change)
        with pytest.raises(ValueError, match=match):
            fk.field_frame(s0, act, bad)
        with pytest.raises(ValueError, match=match):
            fk.field_frames_multi(s0, act, bad, 2)
    with pytest.raises(ValueError, match="frames per launch"):
        fk.field_frames_multi(s0, act, CFG, 0)
    meta = field.FieldState(*(t if n == "step" else t.to("meta")
                              for n, t in zip(s0._fields, s0)))
    with pytest.raises(ValueError, match="cuda"):
        fk.field_frame(meta, act, CFG)


@pytest.mark.cuda
@pytest.mark.parametrize("name,cfg", [
    ("sync_odd_loops", dataclasses.replace(CFG, shape=(64, 96), loops=7)),
    ("checkerboard_tf13", dataclasses.replace(CFG, shape=(32, 128), sweep=Sweep.CHECKERBOARD,
                                              rng_impl="threefry13")),
    ("rejections", dataclasses.replace(CFG, dtau=0.5, loops=4, seed=2)),
    ("free_field", dataclasses.replace(CFG, action="free_field", dtau=0.02)),
])
def test_cuda_kernels_match_plain_versions(cuda_device, name, cfg):
    act = actions.get_field(cfg.action)
    s0 = field.init_field_state(cfg, device=cuda_device)
    plain, pm = field.run_field_frames(s0, act, cfg, 2)
    before = (fk.field_frame.launches, fk.field_frames_multi.launches)
    k3, m3 = fk.run_field_frames_kernel(s0, act, cfg, 2)
    k4, m4 = fk.field_frames_multi(s0, act, cfg, 2)
    torch.cuda.synchronize()
    assert fk.field_frame.launches == before[0] + 2
    assert fk.field_frames_multi.launches == before[1] + 1
    for got, gm in ((k3, m3), (k4, m4)):
        for leaf, x, y in [*zip(got._fields, got, plain), *((k, gm[k], pm[k]) for k in pm)]:
            if leaf in ("runs", "stab_cnt", "step", "stable"):
                assert torch.equal(x.cpu(), y.cpu()), leaf
            elif leaf in MEANS:
                torch.testing.assert_close(x, y, rtol=3e-5, atol=3e-6, msg=leaf)
            else:
                torch.testing.assert_close(x, y, rtol=0, atol=2e-6, msg=leaf)

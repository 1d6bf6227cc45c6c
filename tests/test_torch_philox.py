"""rng_impl='hardware' on the kernel routes: the Philox-4x32-10 stream of the
chain and whole-lattice field kernel wrappers, run here through their plain
versions (CPU tensors).

The JAX package's hardware-PRNG branch has no CPU lowering
(tests/test_chain_kernel.py: TPU-only), so no JAX trajectory exists to hold
these frames to.  Held instead: the statistics the JAX tests ask of that
branch (stationary ⟨x²⟩ against the exact Euler–Maruyama covariance,
free-field ⟨φ²⟩ against the lattice's exact value, at a reduced size), and the
stream's contract: a pure function of (seed, global chain, site, micro-step),
so the same at any frames per launch and chain blocking, resumable at a frame
boundary, fresh for a rejected frame's retry."""

import dataclasses

import numpy as np
import pytest
import torch

from stochquant_tpu.observables import exact
from stochquant_tpu_torch import actions, rng
from stochquant_tpu_torch.config import BoundaryCondition, ChainConfig, FieldConfig, Formulation, Scheme, Sweep
from stochquant_tpu_torch.integrators import field, langevin
from stochquant_tpu_torch.io import checkpoint
from stochquant_tpu_torch.kernels import chain_kernel as ck
from stochquant_tpu_torch.kernels import field_kernel as fk

torch.set_num_threads(1)

CHAIN = ChainConfig(action="double_well", n_sites=24, dt=0.05, dtau=0.001, n_chains=6, loops=10,
                    seed=11, rng_impl="hardware")
CHAIN_CASES = {
    "kink_with_omega": CHAIN,
    "odd_loops": dataclasses.replace(CHAIN, loops=7),
    "loops_below_a_group": dataclasses.replace(CHAIN, loops=3),
    "heun": dataclasses.replace(CHAIN, scheme=Scheme.HEUN, loops=6),
    "periodic_direct": ChainConfig(action="anharmonic", n_sites=20, dt=0.25, dtau=0.01, n_chains=4,
                                   loops=9, seed=13, bc=BoundaryCondition.PERIODIC,
                                   formulation=Formulation.DIRECT, rng_impl="hardware"),
    "rejections": ChainConfig(action="double_well", n_sites=16, dt=0.05, dtau=0.05, n_chains=6,
                              loops=6, seed=5, rng_impl="hardware"),
}
FIELD = FieldConfig(shape=(8, 12), dtau=0.01, n_chains=3, loops=10, seed=3, rng_impl="hardware")
FIELD_CASES = {
    "sync": FIELD,
    "odd_loops": dataclasses.replace(FIELD, loops=7),
    "checkerboard": dataclasses.replace(FIELD, sweep=Sweep.CHECKERBOARD, loops=6),
    "rejections": dataclasses.replace(FIELD, dtau=0.5, loops=4, seed=2),
}


def _same(a, b, label=""):
    for name, x, y in zip(a._fields, a, b):
        assert torch.equal(x, y), f"{label}:{name}"


def _chain_start(cfg):
    act = actions.get(cfg.action)
    return act, langevin.init_chain_state(cfg, act, device="cpu")


def _field_start(cfg):
    return actions.get_field(cfg.action), field.init_field_state(cfg, device="cpu")


# ---------------------------------------------------------------------------
# the stream's contract
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(CHAIN_CASES))
def test_chain_frames_do_not_depend_on_frames_per_launch_or_blocking(name):
    """K frames of kernel 2's plain version ≡ K × (kernel 1's + epilogue), a
    remainder frame included; two runs are equal; the chains of a block at
    chain_offset draw what they draw in the whole ensemble."""
    cfg = CHAIN_CASES[name]
    act, s0 = _chain_start(cfg)
    single, sm = ck.run_frames_kernel(s0, act, cfg, 3, frames_per_launch=1)
    again, _ = ck.run_frames_kernel(s0, act, cfg, 3, frames_per_launch=1)
    _same(single, again, "run to run")
    for fpl in (2, 3):
        multi, mm = ck.run_frames_kernel(s0, act, cfg, 3, frames_per_launch=fpl)
        _same(multi, single, f"fpl={fpl}")
        assert all(torch.equal(mm[k], sm[k]) for k in sm)
    state = s0
    for _ in range(3):
        state, _ = langevin.frame_epilogue(state, ck.chain_frame_ref(state, act, cfg), cfg)
    _same(state, ck.chain_frames_multi_ref(s0, act, cfg, 3)[0], "K x (frame + epilogue)")
    _same(state, single)
    lo = cfg.n_chains // 2
    block = langevin.ChainState(*(t if n == "step" else t[lo:] for n, t in zip(s0._fields, s0)))
    part = ck.chain_frame(block, act, cfg, chain_offset=lo)
    whole = ck.chain_frame(s0, act, cfg)
    for leaf, x, y in zip(part._fields, part, whole):
        if x is not None:
            assert torch.equal(x, y[lo:]), leaf
    if name == "rejections":
        assert not sm["stable"].all(), "case must reject a frame"


def test_chain_stream_is_its_own_and_a_rejected_frame_draws_fresh_noise():
    cfg = CHAIN_CASES["rejections"]
    act, s0 = _chain_start(cfg)
    s1, m1 = ck.run_frames_kernel(s0, act, cfg, 1)
    rejected = ~m1["stable"][0]
    assert rejected.any() and int(s1.step) == int(s0.step) + cfg.loops
    assert torch.equal(s1.f[rejected], s0.f[rejected])
    # the retry starts from the same field at an advanced counter: other noise
    retry = ck.chain_frame(s1._replace(dtau=s0.dtau), act, cfg)
    first = ck.chain_frame(s0, act, cfg)
    assert not torch.equal(retry.f[rejected], first.f[rejected])
    for impl in ("threefry", "threefry13"):
        other = ck.chain_frame(s0, act, dataclasses.replace(cfg, rng_impl=impl))
        assert not torch.equal(other.f, first.f)


def test_chain_noise_words_are_spent_once_and_omega_takes_site_n():
    """Steps s0 .. s0+3 of a frame take outputs 0 .. 3 of the evaluation at
    counter (site, s0); the next group the evaluation at s0 + 4; ω reads site N
    of the chain's own stream.  Checked by replaying a 6-step frame by hand
    through the one-step plain frame with the noise it must have drawn."""
    cfg = dataclasses.replace(CHAIN, loops=6, grow_after=10**9)
    act, s0 = _chain_start(cfg)
    C, N, step0 = cfg.n_chains, cfg.n_sites, int(s0.step)
    z = [rng.philox_normal_quad_for_shape(cfg.seed, rng.Stream.FIELD, step0 + 4 * g, (C, N + 1))
         for g in range(2)]
    want = ck.chain_frame_ref(s0, act, cfg)
    # the same six steps from frames of loops=1 whose first output is forced
    # to be the output the long frame spends on that step
    one = dataclasses.replace(cfg, loops=1)
    state, real = s0, rng.philox_normal_quad_for_shape
    try:
        for k in range(6):
            quad = z[k // 4]
            rng.philox_normal_quad_for_shape = (
                lambda *a, _q=quad, _k=k, **kw: (_q[_k % 4],) * 4)
            sums = ck.chain_frame_ref(state, act, one)
            assert not sums.unstable.any()
            state = state._replace(f=sums.f, omega=sums.omega, lrg_vl=sums.lrg_vl,
                                   step=langevin.host_step(int(state.step) + 1))
    finally:
        rng.philox_normal_quad_for_shape = real
    assert torch.equal(state.f, want.f) and torch.equal(state.omega, want.omega)
    assert not torch.equal(want.omega, s0.omega)
    # no two of the eight normals a site gets over two groups coincide
    flat = torch.stack([e for quad in z for e in quad]).reshape(8, -1)
    assert all(not torch.equal(flat[i], flat[j]) for i in range(8) for j in range(i))


@pytest.mark.parametrize("name", sorted(FIELD_CASES))
def test_field_frames_do_not_depend_on_frames_per_launch_or_blocking(name):
    cfg = FIELD_CASES[name]
    act, s0 = _field_start(cfg)
    single, sm = fk.run_field_frames_kernel(s0, act, cfg, 3, frames_per_launch=1)
    again, _ = fk.run_field_frames_kernel(s0, act, cfg, 3, frames_per_launch=1)
    _same(single, again, "run to run")
    for fpl in (2, 3):
        multi, mm = fk.run_field_frames_kernel(s0, act, cfg, 3, frames_per_launch=fpl)
        _same(multi, single, f"fpl={fpl}")
        assert all(torch.equal(mm[k], sm[k]) for k in sm)
    state = s0
    for _ in range(3):
        state, _ = field.field_frame_epilogue(state, fk.field_frame_ref(state, act, cfg), cfg)
    _same(state, fk.field_frames_multi_ref(s0, act, cfg, 3)[0], "K x (frame + epilogue)")
    _same(state, single)
    block = field.FieldState(*(t if n == "step" else t[1:] for n, t in zip(s0._fields, s0)))
    part, whole = fk.field_frame(block, act, cfg, chain_offset=1), fk.field_frame(s0, act, cfg)
    for leaf, x, y in zip(part._fields, part, whole):
        assert torch.equal(x, y[1:]), leaf
    threefry = fk.field_frame(s0, act, dataclasses.replace(cfg, rng_impl="threefry"))
    assert not torch.equal(threefry.phi, whole.phi)
    if name == "rejections":
        assert not sm["stable"].all(), "case must reject a frame"


@pytest.mark.parametrize("kind", ["chain", "field"])
def test_save_load_continue_is_bitwise(kind, tmp_path):
    if kind == "chain":
        cfg = CHAIN_CASES["odd_loops"]
        (act, s0), run = _chain_start(cfg), ck.run_frames_kernel
    else:
        cfg = FIELD_CASES["odd_loops"]
        (act, s0), run = _field_start(cfg), fk.run_field_frames_kernel
    full, _ = run(s0, act, cfg, 4, frames_per_launch=2)
    half, _ = run(s0, act, cfg, 1)
    checkpoint.save(tmp_path / "h.npz", half, cfg)
    loaded, lcfg = checkpoint.load(tmp_path / "h.npz", "cpu")
    assert lcfg == cfg and lcfg.rng_impl == "hardware"
    rest, _ = run(loaded, act, cfg, 3, frames_per_launch=3)
    _same(rest, full, kind)


def test_philox_serves_the_kernels_schemes_only():
    act, s0 = _chain_start(CHAIN)
    for change in (dict(scheme=Scheme.LM), dict(accumulate_spectrum=True)):
        with pytest.raises(ValueError, match="Philox"):
            langevin.frame_sums(s0, act, dataclasses.replace(CHAIN, **change), philox=True)
    exact_cfg = dataclasses.replace(CHAIN, action="harmonic", scheme=Scheme.EXACT)
    with pytest.raises(ValueError, match="Philox"):
        langevin.frame_sums(s0, actions.get("harmonic"), exact_cfg, philox=True)
    fact, f0 = _field_start(FIELD)
    with pytest.raises(ValueError, match="Philox"):
        field.field_frame_sums(f0, fact, dataclasses.replace(FIELD, scheme=Scheme.EXACT),
                               philox=True)


# ---------------------------------------------------------------------------
# the statistics the JAX tests ask of the TPU branch, at a reduced size
# ---------------------------------------------------------------------------

def test_chain_hardware_rng_stationary_x2_matches_the_exact_em_covariance():
    """tests/test_chain_kernel.py::test_hardware_rng_statistics at a quarter
    of its lattice (N = 32): ⟨x²⟩ within 6 standard errors + 2e-3."""
    cfg = ChainConfig(action="harmonic", n_sites=32, dt=0.25, dtau=0.02, n_chains=64, loops=100,
                      bc=BoundaryCondition.PERIODIC, formulation=Formulation.DIRECT, seed=3,
                      grow_after=10**9, rng_impl="hardware")
    act, s = _chain_start(cfg)
    s, _ = ck.run_frames_kernel(s, act, cfg, 15, frames_per_launch=5)
    s, m = ck.run_frames_kernel(langevin.reset_means(s), act, cfg, 40, frames_per_launch=4)
    assert m["stable"].all()
    B = exact.harmonic_drift_matrix(cfg.n_sites, cfg.dt, k=2.0, bc=cfg.bc)
    sigma = exact.em_stationary_cov(B, cfg.dt, cfg.dtau)
    x2 = s.x2_mean.double().numpy()
    err = x2.mean(axis=1).std() / np.sqrt(cfg.n_chains)
    assert abs(x2.mean() - np.diag(sigma).mean()) < 6 * err + 2e-3, (x2.mean(), np.diag(sigma).mean())


def test_field_hardware_rng_free_field_phi2_matches_the_lattice_value():
    """tests/test_field_kernel.py's TPU-only gate at 16² instead of 128²:
    ⟨φ²⟩ within 6 standard errors + 1e-3 of the exact EM value."""
    cfg = FieldConfig(action="free_field", shape=(16, 16), dtau=0.05, n_chains=8, loops=100,
                      seed=3, grow_after=10**9, rng_impl="hardware")
    act, s = _field_start(cfg)
    s, _ = fk.run_field_frames_kernel(s, act, cfg, 10, frames_per_launch=5)
    s, m = fk.run_field_frames_kernel(field.reset_field_means(s), act, cfg, 30,
                                      frames_per_launch=10)
    assert m["stable"].all()
    theory = exact.free_field_x2(cfg.shape, cfg.spacing, 1.0, dtau=cfg.dtau)
    est = s.phi2_mean.double().numpy()
    err = est.std() / np.sqrt(cfg.n_chains)
    assert abs(est.mean() - theory) < 6 * err + 1e-3, (est.mean(), theory)


# ---------------------------------------------------------------------------
# on the card: the Philox variants of kernels 1-4 against their plain versions
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU interpret mode")
    return torch.device("cuda")


def _held(got, gm, plain, pm, exact_leaves, sums=()):
    for leaf, x, y in [*zip(got._fields, got, plain), *((k, gm[k], pm[k]) for k in pm)]:
        if leaf in exact_leaves:
            assert torch.equal(x.cpu(), y.cpu()), leaf
        elif leaf in sums:
            torch.testing.assert_close(x, y, rtol=3e-5, atol=3e-6, msg=leaf)
        else:
            torch.testing.assert_close(x, y, rtol=0, atol=2e-6, msg=leaf)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CHAIN_CASES))
def test_cuda_philox_chain_kernels_match_plain_versions(cuda_device, name):
    cfg = CHAIN_CASES[name]
    act = actions.get(cfg.action)
    s0 = langevin.init_chain_state(cfg, act, device=cuda_device)
    plain, pm = ck.chain_frames_multi_ref(s0, act, cfg, 3)
    before = (ck.chain_frame.launches_hw, ck.chain_frames_multi.launches_hw)
    k1, m1 = ck.run_frames_kernel(s0, act, cfg, 3)
    k2, m2 = ck.chain_frames_multi(s0, act, cfg, 3)
    torch.cuda.synchronize()
    assert (ck.chain_frame.launches_hw, ck.chain_frames_multi.launches_hw) == (
        before[0] + 3, before[1] + 1)
    for got, gm in ((k1, m1), (k2, m2)):
        _held(got, gm, plain, pm, ("runs", "stab_cnt", "step", "stable"))
    _same(k1, k2, "kernel 1 + epilogue vs kernel 2")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(FIELD_CASES))
def test_cuda_philox_field_kernels_match_plain_versions(cuda_device, name):
    cfg = FIELD_CASES[name]
    act = actions.get_field(cfg.action)
    s0 = field.init_field_state(cfg, device=cuda_device)
    plain, pm = fk.field_frames_multi_ref(s0, act, cfg, 3)
    before = (fk.field_frame.launches_hw, fk.field_frames_multi.launches_hw)
    k3, m3 = fk.run_field_frames_kernel(s0, act, cfg, 3)
    k4, m4 = fk.field_frames_multi(s0, act, cfg, 3)
    torch.cuda.synchronize()
    assert (fk.field_frame.launches_hw, fk.field_frames_multi.launches_hw) == (
        before[0] + 3, before[1] + 1)
    sums = ("mag_mean", "mag2_mean", "mag4_mean", "absmag_mean", "phi2_mean", "act_mean",
            "corr_mean")
    for got, gm in ((k3, m3), (k4, m4)):
        _held(got, gm, plain, pm, ("runs", "stab_cnt", "step", "stable"), sums)
    _same(k3, k4, "kernel 3 + epilogue vs kernel 4")

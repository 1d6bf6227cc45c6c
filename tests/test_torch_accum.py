"""Two-level observable accumulation in the port: the cases of
tests/test_accum.py (fp64 shadow, no stall past 2²⁴, the (lo, hi) count past
2³²) plus agreement with the JAX package's helpers."""

import jax.numpy as jnp
import numpy as np
import torch

from stochquant_tpu.integrators import accum as jaccum
from stochquant_tpu_torch import actions
from stochquant_tpu_torch.config import ChainConfig
from stochquant_tpu_torch.integrators import accum, langevin
from stochquant_tpu_torch.kernels import chain_kernel

torch.set_num_threads(1)


def test_merge_tracks_fp64_shadow_over_2e7_samples():
    """20k frames × 1000 samples = 2×10⁷ samples, past the float32
    per-sample stall at 2²⁴, track the exact fp64 mean to 1e-5 relative."""
    rs = np.random.RandomState(7)
    loops, n_frames = 1000, 20_000
    frame_sums = ((1.0 + 0.1 * rs.standard_normal(n_frames)) * loops).astype(np.float32)
    sums = torch.from_numpy(frame_sums)
    mean = torch.zeros((), dtype=torch.float32)
    runs = 0
    for s in sums:
        n_new = torch.tensor(float(runs + loops), dtype=torch.float32)
        mean = accum.merge_frame_sum(mean, s, loops, n_new)
        runs += loops
    exact = frame_sums.astype(np.float64).sum() / (n_frames * loops)
    assert abs(float(mean) - exact) / abs(exact) < 1e-5


def test_merge_and_count_helpers_bit_equal_jax():
    rs = np.random.RandomState(1)
    runs = rs.randint(0, 2**32, size=(64, 2), dtype=np.uint64).astype(np.uint32)
    runs[:8, 0] = 2**32 - np.arange(1, 9)  # carries into the high word
    runs[8:16, 1] = 0
    accept = rs.rand(64) < 0.5
    mean = rs.standard_normal((64, 5)).astype(np.float32)
    fsum = (rs.standard_normal((64, 5)) * 20).astype(np.float32)
    loops = 20
    t_runs = torch.from_numpy(runs.astype(np.int64))
    np.testing.assert_array_equal(
        np.asarray(jaccum.runs_after(jnp.asarray(runs), loops)),
        accum.runs_after(t_runs, loops).numpy(),
    )
    np.testing.assert_array_equal(
        np.asarray(jaccum.bump_runs(jnp.asarray(runs), loops, jnp.asarray(accept))),
        accum.bump_runs(t_runs, loops, torch.from_numpy(accept)).numpy().astype(np.uint32),
    )
    n_new = jaccum.runs_after(jnp.asarray(runs), loops)[:, None]
    np.testing.assert_array_equal(
        np.asarray(jaccum.merge_frame_sum(jnp.asarray(mean), jnp.asarray(fsum), loops, n_new)),
        accum.merge_frame_sum(torch.from_numpy(mean), torch.from_numpy(fsum), loops,
                              torch.from_numpy(np.array(n_new))).numpy(),
    )
    np.testing.assert_array_equal(jaccum.runs_total(runs), accum.runs_total(t_runs))


def _cfg(**kw):
    base = dict(action="harmonic", n_sites=16, dt=0.2, dtau=1e-3, n_chains=2, loops=100,
                seed=11)
    return ChainConfig(**{**base, **kw})


def test_chain_mean_does_not_stall_past_2pow24():
    cfg = _cfg()
    act = actions.get(cfg.action)
    s0 = langevin.init_chain_state(cfg, act, device="cpu")
    BIG = 20_000_000  # > 2**24: a per-sample float32 mean freezes here
    fresh, _ = langevin.run_frames(s0, act, cfg, 1)
    runs = s0.runs.clone()
    runs[:, 0] = BIG
    big1, _ = langevin.run_frames(
        s0._replace(runs=runs, x_mean=torch.ones_like(s0.x_mean)), act, cfg, 1
    )
    frame_mean = fresh.x_mean.double().numpy()  # merge at runs=0 is S/loops
    want = (frame_mean - 1.0) * cfg.loops / (BIG + cfg.loops)
    delta = big1.x_mean.double().numpy() - 1.0
    assert np.all(np.abs(delta - want) < 0.05 * np.abs(want) + 2e-7)
    assert np.any(delta != 0.0), "mean stalled at large count"


def test_kernel_epilogues_merge_like_the_twin_at_large_count():
    """Kernel 1 + the PyTorch epilogue, and kernel 2's in-kernel epilogue
    (plain versions here), merge exactly like the twin at runs ≫ 2²⁴."""
    cfg = ChainConfig(action="double_well", n_sites=32, dt=0.05, dtau=1e-4, n_chains=4,
                      loops=20, seed=5)
    act = actions.get(cfg.action)
    s0 = langevin.init_chain_state(cfg, act, device="cpu")
    runs = s0.runs.clone()
    runs[:, 0] = 20_000_000
    s0 = s0._replace(runs=runs, x_mean=torch.ones_like(s0.x_mean),
                     x2_mean=torch.full_like(s0.x2_mean, 0.5))
    a, _ = langevin.run_frames(s0, act, cfg, 2)
    for fpl in (1, 2):
        b, _ = chain_kernel.run_frames_kernel(s0, act, cfg, 2, frames_per_launch=fpl)
        for name, x, y in zip(a._fields, a, b):
            torch.testing.assert_close(x, y, rtol=0, atol=0, msg=f"{name} fpl={fpl}")
    assert torch.any(a.x_mean != 1.0), "mean stalled at large count"


def test_runs_counter_survives_uint32_overflow():
    cfg = _cfg(loops=10)
    act = actions.get(cfg.action)
    s0 = langevin.init_chain_state(cfg, act, device="cpu")
    NEAR = 2**32 - 4  # + one frame of 10 accepted samples crosses 2**32
    runs = s0.runs.clone()
    runs[:, 0] = NEAR
    s0 = s0._replace(runs=runs, x2_mean=torch.ones_like(s0.x2_mean))
    for fpl in (1, 2):
        s1, m = chain_kernel.run_frames_kernel(s0, act, cfg, 2, frames_per_launch=fpl)
        assert bool(m["stable"].all()), "frames must be accepted for this gate"
        np.testing.assert_array_equal(accum.runs_total(s1.runs), np.uint64(NEAR + 2 * cfg.loops))
        assert torch.all(s1.runs[:, 1] == 1), "carry into the high word"
        assert torch.isfinite(s1.x2_mean).all()

    r = torch.tensor([[2**32 - 4, 0]], dtype=torch.int64)
    n = float(accum.runs_after(r, 10)[0])
    assert abs(n - (2**32 + 6)) <= 2**32 * 2**-23, n
    torch.testing.assert_close(accum.bump_runs(r, 10, torch.tensor([True])),
                               torch.tensor([[6, 1]]))
    torch.testing.assert_close(accum.bump_runs(r, 10, torch.tensor([False])), r)

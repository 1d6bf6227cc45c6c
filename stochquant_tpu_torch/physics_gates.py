"""Physics gates: the JAX package's statistical tests, run at full width
through the port's entry points and kernels, against exact answers.

    python3 -m stochquant_tpu_torch.physics_gates [--device cuda] [--gates abcdefgh]

Each gate runs ``runtime.run_chain`` / ``run_field`` / ``run_gauge`` with
``backend='auto'`` at the width of a cell of ``PERF.md`` §4, so on the card
the router picks the kernel named beside it; the launch counters are set to
0 before each run and must show that kernel afterwards.  The answers come
from ``observables.exact`` (float64 numpy), ``integrators.gauge``'s exact 2-D
plaquette and the reference oracle (``oracle.run_reference``):

(a) harmonic BACKGROUND chain (FIXED_BG) at the headline's N, Δt and 65,536
    chains, kernel 1 (Threefry) and 1h (Philox): per-site ⟨x²⟩ and ⟨x⁴⟩
    against the exact Euler–Maruyama covariance and 3σ⁴, the chains started
    from that Gaussian (``tests/test_background_moments.py:39``);
(b) the kink coordinate ω of the double well at the headline (kernel 1, a
    frame a run): per-frame increments, each over its chain's Δτ, against
    N(0, 2Δτ·loops·zm²) (``tests/test_background_moments.py:140``);
(c) the headline from a cold start against the reference algorithm over the
    same window, the oracle run 64 times from cold starts of its own: the edge
    profile |⟨x(t)⟩| (``tests/test_oracle.py:37``);
(d) a harmonic chain at config 2's width (kernels 2 and 2h): per-site ⟨x²⟩
    and the midpoint correlator against the exact EM covariance
    (``tests/test_integrator.py:26, 57``);
(e) config 2 (anharmonic, kernel 2) at Δτ = 0.01, 0.005 and 0.0025,
    extrapolated to Δτ → 0 by the quadratic through the three: per-chain
    ⟨x²⟩, ⟨x⁴⟩ and the gap of the midpoint correlator against the
    transfer matrix (``tests/test_physics_regression.py:88-160``);
(f) a free field at 256² × 16 (kernels 3, 4, 3h, 4h): ⟨φ²⟩ against the EM
    lattice propagator sum and the Binder cumulant against 0
    (``tests/test_field.py:14``, ``tests/test_physics_regression.py:196``);
(g) ⟨φ²⟩ of the free field on the tiled 1024² × 16 route (kernel 5) and at
    32⁴ on the pair (kernel 6, 4 chains) and chunk (kernel 7, 1 chain) paths;
(h) the 2-D plaquette of u1, su2 and su3 (kernel 10) against its exact value
    at the cells' Δτ (``tests/test_gauge.py:72-110, 208``) and extrapolated
    to Δτ → 0 from Δτ, Δτ/2 and Δτ/4.

Every gate keeps its source test's limit; where a gate departs from its
test (the start of (a), the per-chain Δτ of (b), the window and oracle runs
of (c), the three steps of (e) and (h), the error over frames of the 32⁴ cells) its
docstring says why.  Off the card the same code runs the plain path (the
counters stay at 0).
"""

from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import math
import os
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable, List, Optional

import numpy as np
import torch

from stochquant_tpu_torch import actions, metrics, oracle, runtime
from stochquant_tpu_torch.config import (
    BoundaryCondition, ChainConfig, FieldConfig, Formulation,
)
from stochquant_tpu_torch.integrators import accum, field, langevin
from stochquant_tpu_torch.integrators import gauge as gauge_mod
from stochquant_tpu_torch.io import checkpoint
from stochquant_tpu_torch.kernels import chain_kernel, field_kernel, field_kernel_nd
from stochquant_tpu_torch.kernels import field_kernel_tiled, gauge_kernel
from stochquant_tpu_torch.observables import analysis, exact

#: the launch counters of the kernels a gate may run (``*_hw``: the Philox variant)
COUNTED = {
    "chain_frame": chain_kernel.chain_frame,
    "chain_frames_multi": chain_kernel.chain_frames_multi,
    "field_frame": field_kernel.field_frame,
    "field_frames_multi": field_kernel.field_frames_multi,
    "field_pair": field_kernel_tiled.field_pair,
    "field_pair_nd": field_kernel_nd.field_pair_nd,
    "field_step_nd": field_kernel_nd.field_step_nd,
    "field_chunk_nd": field_kernel_nd.field_chunk_nd,
    "gauge_frame": gauge_kernel.gauge_frame,
    "gauge_frames_multi": gauge_kernel.gauge_frames_multi,
}
CONFIG2 = dict(action="anharmonic", n_sites=1024, dt=0.25, dtau=0.01, n_chains=256,
               loops=1000, seed=14, grow_after=10**9, bc=BoundaryCondition.PERIODIC,
               formulation=Formulation.DIRECT)


@dataclasses.dataclass
class Check:
    """One compared statistic: it passes when |value − exact| < limit
    (``<=`` with ``inclusive``); ``err`` is its standard error, ``where`` the
    site or part of the run it was taken at (the worst of several)."""

    gate: str
    what: str
    value: float
    exact: float
    err: float
    limit: float
    launches: dict
    where: str = ""
    inclusive: bool = False

    @property
    def diff(self) -> float:
        return abs(self.value - self.exact)

    @property
    def z(self) -> float:
        return self.diff / self.err if self.err > 0 else (0.0 if self.diff == 0 else math.inf)

    @property
    def passed(self) -> bool:
        return self.diff <= self.limit if self.inclusive else self.diff < self.limit

    def line(self) -> str:
        at = f" at {self.where}" if self.where else ""
        return (f"({self.gate}) {self.what}{at}: {self.value:.7g} vs {self.exact:.7g}, "
                f"err {self.err:.3g}, |Δ| {self.diff:.3g} {'<=' if self.inclusive else '<'} "
                f"limit {self.limit:.3g} (z {self.z:.2f}) {'ok' if self.passed else 'FAILED'}; "
                f"launches {self.launches or 'none'}")


def read_counters() -> dict:
    """Launches since the last :func:`reset_counters`, Philox ones as ``*_hw``."""
    out = {}
    for name, fn in COUNTED.items():
        hw = getattr(fn, "launches_hw", 0)
        if fn.launches - hw:
            out[name] = fn.launches - hw
        if hw:
            out[name + "_hw"] = hw
    return out


def reset_counters() -> None:
    for fn in COUNTED.values():
        fn.launches = 0
        if hasattr(fn, "launches_hw"):
            fn.launches_hw = 0


def counted(device, tally: Optional[dict], want: tuple, run: Callable):
    """``run()`` with the counters at 0 just before; on a CUDA device every
    kernel in ``want`` must have launched.  Returns (result, launches), the
    launches also added into ``tally`` (where it is not None)."""
    reset_counters()
    result = run()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    got = read_counters()
    for k, v in got.items():
        if tally is not None:
            tally[k] = tally.get(k, 0) + v
    if torch.device(device).type == "cuda":
        missing = [k for k in want if not got.get(k)]
        if missing:
            raise RuntimeError(f"kernels {missing} did not launch (launches {got})")
    return result, got


def _quiet():
    return metrics.MetricsSink(callback=lambda r: None)


def _host(t) -> np.ndarray:
    return t.detach().double().cpu().numpy()


def _per_site(gate, what, sim, theory, launches, n_sigma=6.0, slack=0.0) -> Check:
    """Per-site z-test over chains (``sim``: (C, N)); the worst site."""
    est = sim.mean(0)
    se = sim.std(0) / np.sqrt(sim.shape[0])
    theory = np.broadcast_to(theory, est.shape)
    i = int(np.argmax(np.abs(est - theory) / (n_sigma * se + slack)))
    return Check(gate, what, float(est[i]), float(theory[i]), float(se[i]),
                 float(n_sigma * se[i] + slack), launches, f"site {i} of {est.size}")


def _over_chains(gate, what, per_chain, theory, launches, n_sigma, slack=0.0) -> Check:
    v = np.asarray(per_chain, np.float64)
    err = float(v.std() / np.sqrt(v.size))
    return Check(gate, what, float(v.mean()), float(theory), err, n_sigma * err + slack,
                 launches, f"{v.size} chains")


def _stable_share(gate, state, frames, loops, launches) -> Check:
    """Every chain accepted every frame (the exact answers assume a fixed Δτ)."""
    share = float(np.mean(accum.runs_total(state.runs) == frames * loops))
    return Check(gate, "share of chains that accepted every frame", share, 1.0, 0.0, 0.0,
                 launches, inclusive=True)


# ---------------------------------------------------------------------------
# chains
# ---------------------------------------------------------------------------

def gate_a(device, tmp: Path, *, tally=None, rng_impl="threefry", n_sites=200, dt=0.02,
           dtau=1.5e-4, n_chains=65536, loops=1000, frames=20, seed=31) -> List[Check]:
    """(a) harmonic BACKGROUND chain at FIXED_BG: per-site ⟨x²⟩ and ⟨x⁴⟩
    against diag(em_stationary_cov) and 3σ⁴, z < 6 at every site.

    Δτ is held at 1.5e-4, under EM's bound 2/(4/Δt² + k) ≈ 2.0e-4 at the
    headline's Δt.  The chains start from that exact Gaussian (a checkpoint
    the run resumes from), as ``tests/test_background_moments.py:86-100``
    starts its chains: a cold start near 0 trips the detector (a white-noise
    field's drift step exceeds its size), which would move Δτ off the value
    the answer is exact at."""
    gate = "a"
    cfg = ChainConfig(action="harmonic", n_sites=n_sites, dt=dt, dtau=dtau, n_chains=n_chains,
                      loops=loops, frames=frames, seed=seed, grow_after=10**9,
                      formulation=Formulation.BACKGROUND, bc=BoundaryCondition.FIXED_BG,
                      rng_impl=rng_impl)
    act = actions.get(cfg.action)
    B = exact.harmonic_drift_matrix(n_sites, dt, bc=cfg.bc)
    cov = exact.em_stationary_cov(B, dt, dtau)
    chol = torch.linalg.cholesky(torch.as_tensor(cov, dtype=torch.float64, device=device))
    gen = torch.Generator(device=device).manual_seed(seed)
    z = torch.randn((n_chains, n_sites), generator=gen, dtype=torch.float64, device=device)
    f0 = (z @ chol.T).to(cfg.torch_dtype)
    del z
    start = langevin.init_chain_state(cfg, act, device=device)
    start = start._replace(f=f0, lrg_vl=f0.abs().amax(dim=-1))
    path = tmp / f"gate_a_{rng_impl}.npz"
    checkpoint.save(path, start, cfg)
    del start, f0
    want = ("chain_frame_hw",) if rng_impl == "hardware" else ("chain_frame",)
    res, launches = counted(device, tally, want, lambda: runtime.run_chain(
        cfg, device=device, checkpoint_in=str(path), sink=_quiet()))
    path.unlink()
    s = res.state
    sig2 = np.diag(cov)
    label = f"harmonic BACKGROUND {n_chains} x {n_sites}, {rng_impl}"
    return [
        _stable_share(gate, s, frames, loops, launches),
        _per_site(gate, f"{label}: <x^2> per site vs EM-exact", _host(s.x2_mean), sig2, launches),
        _per_site(gate, f"{label}: <x^4> per site vs 3 sigma^4", _host(s.x4_mean), 3.0 * sig2**2,
                  launches),
    ]


def gate_b(device, tmp: Path, *, tally=None, n_chains=65536, warm=10, frames=20,
           seed=13) -> List[Check]:
    """(b) ω's step law on the headline (double well, N = 200, Δt = 0.02,
    Δτ = 2e-4, loops 50, one frame a run and a launch): the accepted per-frame
    increments ζ = Δω / σ_c against N(0, 1), σ_c² = 2·Δτ_c·loops·(zm·c)².

    Each increment is scaled by its own chain's Δτ in that frame: at 2e-4 the
    cold start trips and the controller shrinks Δτ by 0.95 in the chains that
    tripped, which at 65,536 chains the test's single Δτ would read as a 5 %
    variance error (its bound is 0.6 % here).  The limits are the test's:
    mean 5/√n, variance 5·√(2/n), excess kurtosis 6·√(24/n), stable share >
    0.9 after the warm-up, ω inside [0, T]."""
    gate = "b"
    cfg = ChainConfig(action="double_well", n_sites=200, dt=0.02, dtau=2e-4, n_chains=n_chains,
                      loops=50, frames=warm, seed=seed, grow_after=10**9,
                      formulation=Formulation.BACKGROUND, bc=BoundaryCondition.FIXED_BG,
                      parisi=True)
    act = actions.get(cfg.action)
    zm_c = float(act.zero_mode_const()) * cfg.noise_amp
    upper = (cfg.n_sites - 1) * cfg.dt
    one = dataclasses.replace(cfg, frames=1)
    paths = [tmp / "gate_b_0.npz", tmp / "gate_b_1.npz"]

    def run():
        res = runtime.run_chain(cfg, device=device, checkpoint_out=str(paths[0]), sink=_quiet())
        s = res.state
        omegas, dtaus, accepted = [_host(s.omega)], [], []
        for k in range(frames):
            before = s
            res = runtime.run_chain(one, device=device, checkpoint_in=str(paths[k % 2]),
                                    checkpoint_out=str(paths[(k + 1) % 2]), sink=_quiet())
            s = res.state
            omegas.append(_host(s.omega))
            dtaus.append(_host(before.dtau))
            accepted.append(accum.runs_total(s.runs) - accum.runs_total(before.runs)
                            == cfg.loops)
        return np.stack(omegas), np.stack(dtaus), np.stack(accepted)

    (om, dtau, acc), launches = counted(device, tally, ("chain_frame",), run)
    for p in paths:
        p.unlink(missing_ok=True)
    inc = np.diff(om, axis=0)[acc]
    sigma = np.sqrt(2.0 * dtau[acc] * cfg.loops) * zm_c
    zeta = inc / sigma
    n = zeta.size
    label = f"omega step law, {n_chains} chains x {frames} frames"
    kurt = float(((zeta / zeta.std()) ** 4).mean() - 3.0)
    outside = max(0.0, -float(om.min()), float(om.max()) - upper)
    return [
        Check(gate, f"{label}: accepted share", float(acc.mean()), 1.0, 0.0, 0.1, launches),
        Check(gate, f"{label}: mean increment / sigma", float(zeta.mean()), 0.0,
              1.0 / math.sqrt(n), 5.0 / math.sqrt(n), launches, f"{n} increments"),
        Check(gate, f"{label}: variance / sigma^2", float(zeta.var()), 1.0,
              math.sqrt(2.0 / n), 5.0 * math.sqrt(2.0 / n), launches, f"{n} increments"),
        Check(gate, f"{label}: excess kurtosis", kurt, 0.0, math.sqrt(24.0 / n),
              6.0 * math.sqrt(24.0 / n), launches, f"{n} increments"),
        Check(gate, f"{label}: omega outside [0, T]", outside, 0.0, 0.0, 0.0, launches,
              inclusive=True),
    ]


def gate_c(device, tmp: Path, *, tally=None, n_sites=200, dt=0.02, dtau=2e-4, n_chains=65536,
           loops=1000, frames=20, seed=2026, oracle_runs=64, edge=8) -> List[Check]:
    """(c) the headline from a cold start against the reference algorithm:
    |⟨x(t)⟩| on the edge sites, |Δ| < 10σ + 0.08 (``tests/test_oracle.py:37``).

    Both sides average the same window, ``frames`` × ``loops`` micro-steps
    from a cold start with ω at the middle: the port over its chains, the
    oracle over ``oracle_runs`` single-chain runs (seeds 1, 2, …; threads).
    At the headline's T = 3.98 the kink's width is a tenth of T, so the edge
    sites feel where ω wanders: one oracle run's time average carries an
    error of a few 0.01 that the test's geometry (T = 12) did not have, and
    σ is the error of both means, not of the port's alone."""
    gate = "c"
    cfg = ChainConfig(action="double_well", n_sites=n_sites, dt=dt, dtau=dtau, n_chains=n_chains,
                      loops=loops, frames=frames, seed=seed, grow_after=10**9)
    workers = max(1, min(8, os.cpu_count() or 1))
    with concurrent.futures.ThreadPoolExecutor(workers) as pool:
        refs = [pool.submit(oracle.run_reference, n_sites, dt, dtau, frames, loops, 3,
                            cfg.noise_amp, s) for s in range(1, oracle_runs + 1)]
        res, launches = counted(device, tally, ("chain_frame",), lambda: runtime.run_chain(
            cfg, device=device, sink=_quiet()))
        refs = [r.result() for r in refs]
    ours = _host(res.state.x_mean)
    mean, se = ours.mean(0), ours.std(0) / np.sqrt(n_chains)
    ref = np.stack([r.x_mean for r in refs])
    rmean, rse = ref.mean(0), ref.std(0, ddof=1) / np.sqrt(len(refs))
    sigma = np.hypot(se, rse)[:edge]
    d = np.abs(np.abs(mean[:edge]) - np.abs(rmean[:edge]))
    i = int(np.argmax(d / (10 * sigma + 0.08)))
    label = f"headline {n_chains} chains vs {len(refs)} oracle runs, {frames} x {loops} steps"
    return [
        Check(gate, f"{label}: oracle runs with accepted frames",
              float(np.mean([r.runs > 0 for r in refs])), 1.0, 0.0, 0.0, launches, inclusive=True),
        Check(gate, f"{label}: |<x(t)>| on the edge", float(abs(mean[i])), float(abs(rmean[i])),
              float(sigma[i]), float(10 * sigma[i] + 0.08), launches, f"site {i} of 0..{edge - 1}"),
    ]


def symmetric_correlator(corr: np.ndarray) -> np.ndarray:
    """(C, N) midpoint correlator → (C, N/2) by separation, both sides averaged."""
    n = corr.shape[-1]
    mid = n // 2
    seps = np.arange(mid)
    return 0.5 * (corr[:, mid + seps] + corr[:, mid - seps])


def gate_d(device, tmp: Path, *, tally=None, rng_impl="threefry", n_sites=1024, dt=0.25,
           dtau=0.01, n_chains=256, loops=1000, K=16, frames=32, seed=14) -> List[Check]:
    """(d) harmonic chain at config 2's width (PERIODIC, DIRECT, K frames a
    launch): per-site ⟨x²⟩ against diag(em_stationary_cov), 6σ + 1e-3, its
    site average within 5σ, and the midpoint correlator against the
    covariance row, 6σ + 2e-3 (``tests/test_integrator.py:26-80``)."""
    gate = "d"
    cfg = ChainConfig(action="harmonic", n_sites=n_sites, dt=dt, dtau=dtau, n_chains=n_chains,
                      loops=loops, frames=frames, seed=seed, grow_after=10**9,
                      bc=BoundaryCondition.PERIODIC, formulation=Formulation.DIRECT,
                      rng_impl=rng_impl, frames_per_launch=K, fps=K)
    want = ("chain_frames_multi_hw",) if rng_impl == "hardware" else ("chain_frames_multi",)
    res, launches = counted(device, tally, want, lambda: runtime.run_chain(
        cfg, device=device, burn_frames=K, sink=_quiet()))
    s = res.state
    B = exact.harmonic_drift_matrix(n_sites, dt, k=2.0, bc=cfg.bc)
    sigma = exact.em_stationary_cov(B, dt, dtau)
    x2 = _host(s.x2_mean)
    glob = x2.mean(axis=1)
    corr = _host(langevin.connected_correlator(s))
    label = f"harmonic PERIODIC {n_chains} x {n_sites}, K={K}, {rng_impl}"
    return [
        _stable_share(gate, s, frames, loops, launches),
        _per_site(gate, f"{label}: <x^2> per site vs EM-exact", x2, np.diag(sigma), launches,
                  slack=1e-3),
        _over_chains(gate, f"{label}: <x^2> site average", glob, np.diag(sigma).mean(), launches,
                     5.0),
        _per_site(gate, f"{label}: midpoint correlator vs covariance row", corr,
                  sigma[:, n_sites // 2], launches, slack=2e-3),
    ]


DTAUS_E = (0.01, 0.005, 0.0025)
#: the separations gate (e) fits the gap over
GAP_RANGE = (1, 8)


def config2_run(device, dtau, *, tally=None, n_chains=256, n_sites=1024, loops=1000, K=16,
                frames=32, burn=16):
    """Config 2 (``bench.py:184-197``: anharmonic, EM, K frames a launch) at
    ``dtau`` through ``run_chain``, kernel 2 on the card: (state, config,
    launches)."""
    cfg = ChainConfig(**dict(CONFIG2, dtau=dtau, n_chains=n_chains, n_sites=n_sites,
                             loops=loops),
                      frames=frames, frames_per_launch=K, fps=K)
    res, launches = counted(device, tally, ("chain_frames_multi",), lambda: runtime.run_chain(
        cfg, device=device, burn_frames=burn, sink=_quiet()))
    return res.state, cfg, launches


def gap_fit(corr: np.ndarray, dt: float, fit_range):
    """The gap of the chains' mean connected correlator (``corr``: (C, N/2)
    by separation), weighted by its error over chains."""
    return analysis.energy_gap_from_correlator(
        corr.mean(0), dt, mid=0, fit_range=fit_range,
        corr_err=corr.std(0) / np.sqrt(corr.shape[0]))


def extrapolate(values, errors):
    """Value at Δτ → 0 of the quadratic through the points at Δτ = h, h/2,
    h/4 (``DTAUS_E``): (v(h) − 6·v(h/2) + 8·v(h/4)) / 3, and its error."""
    w = np.array([1.0, -6.0, 8.0]) / 3.0
    return float(w @ np.asarray(values)), float(np.sqrt(w**2 @ np.asarray(errors) ** 2))


def gate_e(device, tmp: Path, *, tally=None, grids=((4.5, 800), (5.0, 1200)),
           **width) -> List[Check]:
    """(e) config 2 (``bench.py:184-197``: anharmonic, N = 1024, 256 chains,
    EM, kernel 2 at K = 16; ``width`` cuts it, see :func:`config2_run`) at
    three Δτ, extrapolated to Δτ → 0: per-chain ⟨x²⟩ and ⟨x⁴⟩ against
    ``transfer_matrix_moments`` (with its grid check), |x̂ − exact| < 6σ +
    2e-3, and the gap of the midpoint correlator against the transfer
    matrix's, 5σ + 0.05 (``tests/test_physics_regression.py:88-160``).

    The test runs LM, whose bias is O(Δτ²); kernel 2 runs EM, whose O(Δτ)
    bias the extrapolation removes.  A line through Δτ = 0.01 and 0.005
    leaves the O(Δτ²) term: on the Gaussian chain with this ⟨x²⟩ (m² = 4)
    −2.8e-3 in ⟨x²⟩ and −5.2e-3 in ⟨x⁴⟩ (``em_stationary_cov``), beyond the
    test's 2e-3; the quadratic through 0.01, 0.005 and 0.0025 leaves
    2.0e-4 and 4.0e-4.  ``tools/gap_fit_error.py`` sets the gap fit's own
    error beside a jackknife over chains."""
    gate = "e"
    act = actions.get("anharmonic")
    V = lambda x: act.V(torch.as_tensor(x)).numpy()  # noqa: E731
    x2s, x4s, gaps = [], [], []
    launches, stable = {}, []
    for dtau in DTAUS_E:
        s, cfg, got = config2_run(device, dtau, tally=tally, **width)
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        stable.append(_stable_share(gate, s, cfg.frames, cfg.loops, got))
        for out, leaf in ((x2s, s.x2_mean), (x4s, s.x4_mean)):
            per_chain = _host(leaf).mean(axis=1)
            out.append((per_chain.mean(), per_chain.std() / np.sqrt(cfg.n_chains)))
        fit = gap_fit(symmetric_correlator(_host(langevin.connected_correlator(s))), cfg.dt,
                      GAP_RANGE)
        gaps.append((fit.gap, fit.gap_err))
    (x_max, n_grid), (x_fine, n_fine) = grids
    x2_exact, x4_exact, gap_exact = exact.transfer_matrix_moments(
        V, cfg.n_sites, cfg.dt, x_max=x_max, n_grid=n_grid)
    x2_fine, _, _ = exact.transfer_matrix_moments(V, cfg.n_sites, cfg.dt, x_max=x_fine,
                                                  n_grid=n_fine)
    checks = [Check(gate, f"transfer matrix: <x^2> at {n_grid} vs {n_fine} grid points",
                    x2_exact, x2_fine, 0.0, 1e-8, {})] + stable
    label = (f"config 2 anharmonic {cfg.n_chains} x {cfg.n_sites}, "
             f"dtau {'/'.join(map(str, DTAUS_E))} -> 0")
    for what, pts, want, n_sigma, slack in (("<x^2>", x2s, x2_exact, 6.0, 2e-3),
                                            ("<x^4>", x4s, x4_exact, 6.0, 2e-3),
                                            ("gap", gaps, gap_exact, 5.0, 0.05)):
        v, e = extrapolate(*zip(*pts))
        checks.append(Check(gate, f"{label}: {what} (at each dtau "
                            f"{', '.join(f'{p[0]:.6g}' for p in pts)})",
                            v, want, e, n_sigma * e + slack, launches))
    return checks


# ---------------------------------------------------------------------------
# fields
# ---------------------------------------------------------------------------

def _field_run(device, tally, cfg, burn, want):
    """``run_field`` with its records; returns (state, per-frame chain-mean
    ⟨φ²⟩ of each measured frame, launches).  The records carry the running
    means: frame k's own mean is k·c_k − (k − 1)·c_(k−1), every frame
    accepted (checked)."""
    recs = []
    sink = metrics.MetricsSink(callback=recs.append)
    res, launches = counted(device, tally, want, lambda: runtime.run_field(
        cfg, device=device, burn_frames=burn, sink=sink))
    frames = [r for r in recs if r["type"] == "frame"]
    if any(r["stable_frac"] != 1.0 for r in frames):
        raise RuntimeError(f"rejected frames in the gate run: {[r['stable_frac'] for r in frames]}")
    cum = np.array([r["phi2"] for r in frames], np.float64)
    k = np.arange(1, len(cum) + 1, dtype=np.float64)
    per_frame = k * cum - (k - 1) * np.concatenate([[0.0], cum[:-1]])
    return res.state, per_frame, launches


def _free_field(shape, n_chains, loops, seed, frames, **kw) -> FieldConfig:
    return FieldConfig(action="free_field", shape=shape, spacing=1.0, dtau=0.05,
                       n_chains=n_chains, loops=loops, seed=seed, frames=frames,
                       grow_after=10**9, **kw)


def gate_f(device, tmp: Path, *, tally=None, shape=(256, 256), n_chains=16, frames=40,
           burn=10, seed=13) -> List[Check]:
    """(f) free field (m² = 1, Δτ = 0.05, SYNC) at ``bench.py``'s 256² × 16:
    kernels 3 (a frame a launch), 4 (K = 10) and their Philox variants, each
    at the cluster size the rule picks.  ⟨φ²⟩ per chain against
    ``free_field_x2(shape, 1, 1, Δτ)`` (EM-exact), z < 6 over chains; the
    Binder cumulant U per chain against 0, 6σ + 0.02."""
    gate = "f"
    theory = exact.free_field_x2(shape, 1.0, 1.0, dtau=0.05)
    checks = []
    for K, rng_impl in ((1, "threefry"), (10, "threefry"), (1, "hardware"), (10, "hardware")):
        cfg = _free_field(shape, n_chains, 100, seed, frames, frames_per_launch=K, fps=K,
                          rng_impl=rng_impl)
        kname = "field_frame" if K == 1 else "field_frames_multi"
        want = (kname + ("_hw" if rng_impl == "hardware" else ""),)
        s, _, launches = _field_run(device, tally, cfg, burn, want)
        label = f"free_field {n_chains} x {'x'.join(map(str, shape))}, K={K}, {rng_impl}"
        checks.append(_over_chains(gate, f"{label}: <phi^2> vs EM-exact", _host(s.phi2_mean),
                                   theory, launches, 6.0))
        checks.append(_over_chains(gate, f"{label}: Binder U vs 0",
                                   _host(field.binder_cumulant(s)), 0.0, launches, 6.0, 0.02))
    return checks


def gate_g(device, tmp: Path, *, tally=None, tiled_shape=(1024, 1024), tiled_chains=16,
           nd_shape=(32,) * 4, frames=20, seed=9) -> List[Check]:
    """(g) ⟨φ²⟩ of the free field (m² = 1, Δτ = 0.05, SYNC) against
    ``free_field_x2``, z < 6: the tiled 2-D route (kernel 5, 1024² × 16,
    ``auto`` past the 1 MiB rule; over chains), and 32⁴ on the pair path
    (kernel 6, 4 chains) and the chunk path (kernel 7, W = 4, 1 chain).  With
    one and four chains the error comes from the measured frames (each its
    chains' mean, binned over the autocorrelation time,
    ``analysis.binned_jackknife``), not from a spread over chains."""
    gate = "g"
    checks = []
    cfg = _free_field(tiled_shape, tiled_chains, 100, 13, frames)
    s, _, launches = _field_run(device, tally, cfg, 2, ("field_pair",))
    checks.append(_over_chains(
        gate, f"free_field {tiled_chains} x {'x'.join(map(str, tiled_shape))} (tiled)"
        ": <phi^2> vs EM-exact", _host(s.phi2_mean),
        exact.free_field_x2(tiled_shape, 1.0, 1.0, dtau=0.05), launches, 6.0))
    theory = exact.free_field_x2(nd_shape, 1.0, 1.0, dtau=0.05)
    for n_chains, W, want in ((4, None, "field_pair_nd"), (1, 4, "field_chunk_nd")):
        cfg = _free_field(nd_shape, n_chains, 20, seed, 2 * frames, exchange_steps=W)
        s, per_frame, launches = _field_run(device, tally, cfg, 5, (want,))
        mean, err = analysis.binned_jackknife(per_frame)
        path = "pair" if W is None else f"chunk W={W}"
        checks.append(Check(gate, f"free_field {n_chains} x {'x'.join(map(str, nd_shape))} "
                            f"({path}): <phi^2> vs EM-exact", mean, theory, err, 6.0 * err,
                            launches, f"{per_frame.size} frames"))
    return checks


# ---------------------------------------------------------------------------
# gauge
# ---------------------------------------------------------------------------

#: (group, beta, shape, chains, dtau, loops, seed, burn, frames): bench.py's
#: cells (bench.py:297-385), su3 at beta 2 as in tests/test_gauge.py:208;
#: burn-in and measured frames about 6 and 16-20 units of Langevin time
GAUGE_CELLS = (
    ("u1", 1.0, (256, 256), 32, 5e-3, 100, 15, 12, 40),
    ("su2", 2.0, (128, 128), 16, 2e-3, 100, 19, 30, 80),
    ("su3", 2.0, (64, 64), 8, 1e-3, 50, 19, 120, 320),
)


def gate_h(device, tmp: Path, *, tally=None, cells=GAUGE_CELLS) -> List[Check]:
    """(h) the mean plaquette per chain (kernel 10, a frame a launch) against
    the exact 2-D value: at the cell's Δτ within its test's 6σ + 10·Δτ
    (``tests/test_gauge.py:72-110, 208``), and extrapolated to Δτ → 0 by
    :func:`extrapolate` from runs at Δτ, Δτ/2 and Δτ/4 within 6σ + 1e-4.

    At the cells' Δτ EM's step bias moves u1's plaquette by −4.0e-3 (67σ),
    and 10·Δτ = 0.05 would also pass a fault of the update over ten times
    that size.  The bias is a series in Δτ; the quadratic through the three steps
    leaves its O(Δτ³) term, which the 1e-4 covers (u1's second-order term
    is ~2e-4 at Δτ = 5e-3, its third order an order of Δτ·slope smaller).
    Each halved step doubles ``loops``, so burn-in and measurement cover the
    same Langevin time, and takes seed + 1, + 2, so the three runs are
    independent."""
    gate = "h"
    checks = []
    for group, beta, shape, n_chains, dtau, loops, seed, burn, frames in cells:
        plaq = gauge_mod.exact_plaquette_2d(group, beta)
        label = f"{group} beta {beta:g} {n_chains} x {'x'.join(map(str, shape))}: plaquette"
        pts, launches = [], {}
        for k, div in enumerate((1, 2, 4)):
            cfg = gauge_mod.GaugeConfig(group=group, beta=beta, shape=shape, n_chains=n_chains,
                                        dtau=dtau / div, loops=loops * div, seed=seed + k,
                                        frames=frames, grow_after=10**9)
            res, got = counted(device, tally, ("gauge_frame",), lambda: runtime.run_gauge(
                cfg, device=device, burn_frames=burn, sink=_quiet()))
            for name, v in got.items():
                launches[name] = launches.get(name, 0) + v
            checks.append(_stable_share(gate, res.state, frames, cfg.loops, got))
            per_chain = _host(res.state.plaq_mean)
            pts.append((per_chain.mean(), per_chain.std() / np.sqrt(per_chain.size)))
            if div == 1:
                checks.append(_over_chains(gate, f"{label} at dtau {dtau:g} vs exact 2-D",
                                           per_chain, plaq, got, 6.0, 10 * dtau))
        v, e = extrapolate(*zip(*pts))
        checks.append(Check(gate, f"{label} at dtau -> 0 (at each dtau "
                            f"{', '.join(f'{p[0]:.7g}' for p in pts)}) vs exact 2-D", v, plaq,
                            e, 6.0 * e + 1e-4, launches))
    return checks


def run_gates(device, tmp: Path, gates: str = "abcdefgh",
              log: Callable[[str], None] = print):
    """Every gate in ``gates``, each line logged as it comes; (a) and (d) run
    under both generators.  Returns (the checks, ``.passed`` each; the
    launches summed over every run)."""
    hw = dict(rng_impl="hardware")
    plan = {"a": [(gate_a, {}), (gate_a, hw)], "b": [(gate_b, {})], "c": [(gate_c, {})],
            "d": [(gate_d, {}), (gate_d, hw)], "e": [(gate_e, {})], "f": [(gate_f, {})],
            "g": [(gate_g, {})], "h": [(gate_h, {})]}
    tally, checks = {}, []
    for g in gates:
        for gate, kw in plan[g]:
            t0 = time.perf_counter()
            got = gate(device, tmp, tally=tally, **kw)
            for c in got:
                log("  " + c.line())
            log(f"  ({g}) {time.perf_counter() - t0:.1f} s")
            checks.extend(got)
    return checks, tally


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--gates", default="abcdefgh")
    args = ap.parse_args(argv)
    device = runtime.resolve_device(args.device)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        checks, launches = run_gates(device, Path(tmp), args.gates)
    failed = [c for c in checks if not c.passed]
    print(f"{len(checks) - len(failed)} of {len(checks)} checks passed in "
          f"{time.perf_counter() - t0:.1f} s; launches {launches}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())

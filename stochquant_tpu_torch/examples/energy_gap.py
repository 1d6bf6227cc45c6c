"""End-to-end physics demo: extract the energy gap E₁−E₀ of the harmonic
oscillator from the connected correlator and compare to ω₀ = √(k/m).

The whole chain — simulate → correlator → autocorrelation-aware errors →
weighted log-linear fit — on the port: the frames run through the chain
kernel's wrapper (``chain_kernel.run_frames_kernel``: kernel 1 on a CUDA
device, its plain version on the CPU).

Run:  python -m stochquant_tpu_torch.examples.energy_gap [--device cpu]
"""

import numpy as np

from stochquant_tpu_torch import actions
from stochquant_tpu_torch.config import BoundaryCondition, ChainConfig, Formulation
from stochquant_tpu_torch.examples import cli_device
from stochquant_tpu_torch.integrators import langevin
from stochquant_tpu_torch.kernels import chain_kernel
from stochquant_tpu_torch.observables import analysis
from stochquant_tpu_torch.runtime import resolve_device


def main(device="cuda", *, n_sites=64, n_chains=512, loops=200, burn_frames=30, frames=120,
         seed=1):
    device = resolve_device(device)
    cfg = ChainConfig(
        action="harmonic",
        n_sites=n_sites,
        dt=0.25,
        dtau=0.01,
        n_chains=n_chains,
        loops=loops,
        bc=BoundaryCondition.PERIODIC,
        formulation=Formulation.DIRECT,
        seed=seed,
        grow_after=10**9,
    )
    act = actions.get(cfg.action)
    state = langevin.init_chain_state(cfg, act, device=device)
    state, _ = chain_kernel.run_frames_kernel(state, act, cfg, burn_frames)   # thermalize
    state = langevin.reset_means(state)
    state, metrics = chain_kernel.run_frames_kernel(state, act, cfg, frames)
    assert metrics["stable"][-1].all()

    corr = langevin.connected_correlator(state).cpu().numpy().astype(np.float64)
    mean = corr.mean(axis=0)
    err = corr.std(axis=0) / np.sqrt(cfg.n_chains)
    fit = analysis.energy_gap_from_correlator(mean, cfg.dt, corr_err=err)

    omega0 = act.omega0
    print(f"fitted gap  E1-E0 = {fit.gap:.4f} ± {fit.gap_err:.4f}")
    print(f"continuum   omega0 = {omega0:.4f}")
    # finite-Δt lattice dispersion: sinh(Δt·E)/Δt = ω₀·sqrt(1+(Δt·ω₀/2)²)
    e_lat = 2.0 / cfg.dt * np.arcsinh(0.5 * cfg.dt * omega0)
    print(f"lattice     E(dt)  = {e_lat:.4f}   (leading finite-dt prediction)")
    dev = abs(fit.gap - e_lat)
    print(f"deviation: {dev:.4f}  ({dev / max(fit.gap_err, 1e-9):.1f} sigma)")
    return {"gap": float(fit.gap), "gap_err": float(fit.gap_err), "omega0": float(omega0),
            "e_lat": float(e_lat), "corr_mean": mean}


if __name__ == "__main__":
    main(cli_device(__doc__))

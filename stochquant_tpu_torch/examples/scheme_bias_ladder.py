"""Integration-bias ladder: EM vs Heun vs LM vs EXACT on the harmonic chain.

For quadratic actions every scheme's stationary covariance is known in
closed form (``observables.exact``), so the finite-Δτ bias of each
integrator can be read off directly instead of estimated by Monte Carlo:

- EM    : Var = [Δt·b·(1 − Δτ·b/2)]⁻¹ — O(Δτ) bias, stable for Δτ·b < 2
- Heun  : O(Δτ²) bias, same stability bound
- LM    : exact *covariance* at any stable Δτ (higher moments biased)
- EXACT : the exact OU transition — zero bias at ANY Δτ, no stability bound

The script prints the predicted site-averaged ⟨x²⟩ relative bias per scheme
across Δτ, then runs a short EXACT-scheme simulation at Δτ·b_max ≈ 80 — a
step size where every other scheme diverges instantly — and checks the
sampled ⟨x²⟩ against the Δτ→0 target within Monte-Carlo error.  Scheme.EXACT
has no kernel in either package: the plain path runs on the given device.

Run:  python -m stochquant_tpu_torch.examples.scheme_bias_ladder [--device cpu]
"""

import numpy as np

from stochquant_tpu_torch import actions
from stochquant_tpu_torch.config import BoundaryCondition, ChainConfig, Formulation, Scheme
from stochquant_tpu_torch.examples import cli_device
from stochquant_tpu_torch.integrators import langevin
from stochquant_tpu_torch.observables import exact
from stochquant_tpu_torch.runtime import resolve_device

FRACS = (0.05, 0.2, 0.5, 1.0, 1.9)


def main(device="cuda", *, n_sites=32, n_chains=256, loops=20, burn_frames=2, frames=30):
    device = resolve_device(device)
    N, dt = n_sites, 0.2
    B = exact.harmonic_drift_matrix(N, dt, bc=BoundaryCondition.PERIODIC)
    b_max = float(np.linalg.eigvalsh(B).max())
    target = float(np.diag(exact.target_cov(B, dt)).mean())
    print(f"harmonic chain N={N}, dt={dt}: b_max={b_max:.2f}, "
          f"target <x^2> = {target:.6f}\n")

    ladder = {}
    print(f"{'dtau*b_max':>10} | {'EM bias':>10} | {'Heun bias':>10} | "
          f"{'LM bias':>10} | {'EXACT bias':>10}")
    for frac in FRACS:
        dtau = frac / b_max
        row = [f"{frac:>10.2f}"]
        biases = []
        for cov_fn in (exact.em_stationary_cov, exact.heun_stationary_cov,
                       exact.lm_stationary_cov):
            v = float(np.diag(cov_fn(B, dt, dtau)).mean())
            biases.append(v / target - 1.0)
            row.append(f"{v / target - 1.0:>+10.2%}")
        row.append(f"{0.0:>+10.2%}")  # EXACT: zero by construction
        ladder[frac] = tuple(biases)
        print(" | ".join(row))

    dtau = 80.0 / b_max
    print(f"\nEXACT scheme at dtau = {dtau:.3f} (dtau*b_max = 80 — every "
          "other scheme explodes):")
    cfg = ChainConfig(
        action="harmonic", n_sites=N, dt=dt, dtau=dtau, n_chains=n_chains,
        loops=loops, seed=11, scheme=Scheme.EXACT,
        formulation=Formulation.BACKGROUND, bc=BoundaryCondition.PERIODIC,
    )
    act = actions.get("harmonic")
    s = langevin.init_chain_state(cfg, act, device=device)
    s, _ = langevin.run_frames(s, act, cfg, burn_frames)   # burn (mixes in ~1 step)
    s = langevin.reset_means(s)
    s, m = langevin.run_frames(s, act, cfg, frames)
    assert bool(m["stable"].all())
    x2 = s.x2_mean.cpu().numpy().astype(np.float64)
    est = x2.mean()
    se = x2.mean(1).std() / np.sqrt(cfg.n_chains)
    print(f"  sampled <x^2> = {est:.6f} +/- {se:.6f}")
    print(f"  target        = {target:.6f}  "
          f"(z = {(est - target) / se:+.2f})")
    return {"b_max": b_max, "target": target, "ladder": ladder, "est": float(est),
            "se": float(se)}


if __name__ == "__main__":
    main(cli_device(__doc__))

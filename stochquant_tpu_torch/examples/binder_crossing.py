"""Locate the 2-D φ⁴ critical coupling with the Binder cumulant.

U(L) = 1 − ⟨M⁴⟩/(3⟨M²⟩²) flows to 0 in the symmetric phase and to 2/3 in the
broken phase; curves for different lattice sizes L cross at the critical
m²(λ) almost independently of L — the standard finite-size-scaling locator.
The frames run through the whole-lattice field kernel's wrapper
(``field_kernel.run_field_frames_kernel``: kernel 3 on a CUDA device, its
plain version on the CPU).

Run:  python -m stochquant_tpu_torch.examples.binder_crossing [--device cpu]
"""

import numpy as np

from stochquant_tpu_torch.actions import phi4
from stochquant_tpu_torch.config import FieldConfig, Sweep
from stochquant_tpu_torch.examples import cli_device
from stochquant_tpu_torch.integrators import field
from stochquant_tpu_torch.kernels import field_kernel
from stochquant_tpu_torch.runtime import resolve_device

SIZES = (12, 24)
M2S = (0.5, 0.0, -0.5, -1.0, -1.5, -2.0)


def binder_of(L, m2, lam=6.0, seed=13, *, device, n_chains=16, loops=200, burn_frames=25,
              frames=50):
    cfg = FieldConfig(
        action="phi4",
        shape=(L, L),
        dtau=0.02,
        n_chains=n_chains,
        loops=loops,
        seed=seed,
        grow_after=10**9,
        sweep=Sweep.CHECKERBOARD,
    )
    act = phi4.get_field("phi4", m2=m2, lam=lam)
    state = field.init_field_state(cfg, device=device)
    state, _ = field_kernel.run_field_frames_kernel(state, act, cfg, burn_frames)
    state = field.reset_field_means(state)
    state, _ = field_kernel.run_field_frames_kernel(state, act, cfg, frames)
    u = field.binder_cumulant(state).cpu().numpy().astype(np.float64)
    return u.mean(), u.std() / np.sqrt(cfg.n_chains)


def main(device="cuda", *, sizes=SIZES, m2s=M2S, **sizes_kw):
    device = resolve_device(device)
    table = {}
    print(f"{'m^2':>7} | " + " | ".join(f"U(L={L}) ± err" for L in sizes))
    for m2 in m2s:
        row = []
        for L in sizes:
            u, e = binder_of(L, m2, device=device, **sizes_kw)
            table[m2, L] = (float(u), float(e))
            row.append(f"{u:>7.3f} ± {e:.3f}")
        print(f"{m2:>7.2f} | " + " | ".join(row))
    print("\nU → 0 (symmetric), → 2/3 (broken); the L-curves cross near the "
          "critical m²(λ=6)")
    return table


if __name__ == "__main__":
    main(cli_device(__doc__))

"""2-D φ⁴ phase structure: scan m² through the symmetry-breaking transition
and watch ⟨|M|⟩ and the susceptibility χ (config 3 observables).  The
frames run through ``field_kernel.run_field_frames_kernel`` (kernel 3 on a
CUDA device, its plain version on the CPU).

Run:  python -m stochquant_tpu_torch.examples.phi4_phase_scan [--device cpu]
"""

import numpy as np

from stochquant_tpu_torch.actions import phi4
from stochquant_tpu_torch.config import FieldConfig, Sweep
from stochquant_tpu_torch.examples import cli_device
from stochquant_tpu_torch.integrators import field
from stochquant_tpu_torch.kernels import field_kernel
from stochquant_tpu_torch.runtime import resolve_device

M2S = (1.0, 0.0, -0.5, -1.0, -1.5, -2.0, -3.0)


def main(device="cuda", *, L=24, n_chains=16, loops=200, burn_frames=25, frames=50, m2s=M2S):
    device = resolve_device(device)
    lam = 6.0
    cfg = FieldConfig(
        action="phi4",
        shape=(L, L),
        dtau=0.02,
        n_chains=n_chains,
        loops=loops,
        seed=11,
        grow_after=10**9,
        sweep=Sweep.CHECKERBOARD,
    )
    table = {}
    print(f"{'m^2':>7} | {'<|M|>':>8} | {'chi':>9} | {'<phi^2>':>8}")
    for m2 in m2s:
        act = phi4.get_field("phi4", m2=m2, lam=lam)
        state = field.init_field_state(cfg, device=device)
        state, _ = field_kernel.run_field_frames_kernel(state, act, cfg, burn_frames)
        state = field.reset_field_means(state)
        state, metrics = field_kernel.run_field_frames_kernel(state, act, cfg, frames)
        absmag = float(state.absmag_mean.cpu().numpy().astype(np.float64).mean())
        chi = float(field.susceptibility(state, L * L).cpu().numpy().astype(np.float64).mean())
        p2 = float(state.phi2_mean.cpu().numpy().astype(np.float64).mean())
        table[m2] = (absmag, chi, p2)
        print(f"{m2:>7.2f} | {absmag:>8.4f} | {chi:>9.3f} | {p2:>8.4f}")
    print("\nbroken phase (m^2 << 0): <|M|> -> sqrt(-6 m^2/lam); "
          "chi peaks near the transition")
    return table


if __name__ == "__main__":
    main(cli_device(__doc__))

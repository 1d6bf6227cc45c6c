#!/usr/bin/env python3
"""The error of the gap fit of ``chip_smoke.py`` [29](e), read two ways.

    python3 tools/gap_fit_error.py

Runs config 2 on the card at each Δτ of ``physics_gates.DTAUS_E``, as gate
(e) does, and prints one JSON line per Δτ: the gap of the chains' mean
connected midpoint correlator with the fit's own error
(``analysis.energy_gap_from_correlator``: polyfit's covariance) and the error
of the same fit by a delete-one jackknife over 16 groups of chains.  A last
line extrapolates both to Δτ → 0 (``physics_gates.extrapolate``) beside the
transfer matrix's gap and the gap the same fit reads on the transfer matrix's
own two-point function over the same window (no noise, no step bias).
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from stochquant_tpu_torch import actions, physics_gates as pg, runtime  # noqa: E402
from stochquant_tpu_torch.integrators import langevin  # noqa: E402
from stochquant_tpu_torch.observables import analysis, exact  # noqa: E402

GROUPS = 16
X_MAX, N_GRID = 4.5, 800


def window_gap(V, n_sites: int, dt: float) -> float:
    """The gap fit over ``pg.GAP_RANGE`` of the lattice's exact two-point
    function, from the transfer matrix on ``exact.transfer_matrix_moments``'
    grid: E₁ − E₀ up to the window's excited states."""
    x = np.linspace(-X_MAX, X_MAX, N_GRID, dtype=np.float64)
    v = V(x).astype(np.float64)
    T = np.exp(-(x[:, None] - x[None, :]) ** 2 / (2.0 * dt)
               - dt * 0.5 * (v[:, None] + v[None, :])) * (x[1] - x[0])
    lam, U = np.linalg.eigh(T)
    order = np.argsort(lam)[::-1]
    r = np.clip(lam[order] / lam[order][0], -1.0, 1.0)
    U = U[:, order]
    X2 = (U.T @ (x[:, None] * U)) ** 2  # |<k|x|l>|^2
    w = r**n_sites / np.sum(r**n_sites)
    live = w > 0
    corr = [float(np.sum(w[live, None] * (r[None, :] / r[live, None]) ** d * X2[live]))
            for d in range(pg.GAP_RANGE[1] + 1)]
    return analysis.energy_gap_from_correlator(np.array(corr), dt, mid=0,
                                               fit_range=pg.GAP_RANGE).gap


def main() -> int:
    device = runtime.resolve_device("cuda")
    gaps, fit_errs, jk_errs = [], [], []
    for dtau in pg.DTAUS_E:
        s, cfg, _ = pg.config2_run(device, dtau)
        corr = pg.symmetric_correlator(langevin.connected_correlator(s).double().cpu().numpy())
        fit = pg.gap_fit(corr, cfg.dt, pg.GAP_RANGE)
        jk = np.array([pg.gap_fit(np.delete(corr, g, axis=0), cfg.dt, pg.GAP_RANGE).gap
                       for g in np.array_split(np.arange(corr.shape[0]), GROUPS)])
        jk_err = float(np.sqrt((GROUPS - 1) / GROUPS * np.sum((jk - jk.mean()) ** 2)))
        gaps.append(fit.gap)
        fit_errs.append(fit.gap_err)
        jk_errs.append(jk_err)
        print(json.dumps({"dtau": dtau, "gap": fit.gap, "fit_err": fit.gap_err,
                          "jackknife_err": jk_err, "chains": cfg.n_chains}), flush=True)
    act = actions.get("anharmonic")
    V = lambda x: act.V(torch.as_tensor(x)).numpy()  # noqa: E731
    _, _, gap_exact = exact.transfer_matrix_moments(V, cfg.n_sites, cfg.dt, x_max=X_MAX,
                                                    n_grid=N_GRID)
    gap0, fit_err0 = pg.extrapolate(gaps, fit_errs)
    _, jk_err0 = pg.extrapolate(gaps, jk_errs)
    print(json.dumps({"dtau": 0.0, "gap": gap0, "fit_err": fit_err0, "jackknife_err": jk_err0,
                      "transfer_matrix_gap": gap_exact,
                      "window_gap": window_gap(V, cfg.n_sites, cfg.dt),
                      "z_fit": abs(gap0 - gap_exact) / fit_err0,
                      "z_jackknife": abs(gap0 - gap_exact) / jk_err0}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

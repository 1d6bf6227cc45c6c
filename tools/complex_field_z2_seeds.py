#!/usr/bin/env python3
"""⟨z²⟩ of ``complex_field_2d`` against the lattice propagator, over seeds.

    python3 tools/complex_field_z2_seeds.py [--device cuda|cpu] [--seeds 21 1 2 3]
        [--chains 64] [--burn 30] [--frames 20] [--drift-cap 10]

Runs ``runtime.run_complex`` on the preset (Δτ held: ``grow_after`` 10**9)
with a burn-in, once per seed, and prints one JSON line per seed: the
ensemble ⟨z²⟩, the exact value ``exact_gaussian_z2``, their difference, the
standard error over chains and the difference in standard errors, beside the
Euler–Maruyama step's first-order bias Δτ/2.  It tells a fluctuation of one
seed from a bias of the integrator (``chip_smoke.py`` [27] checks seed 21).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seeds", type=int, nargs="+", default=[21, 1, 2, 3])
    ap.add_argument("--chains", type=int, default=64)
    ap.add_argument("--burn", type=int, default=30)
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--drift-cap", type=float, default=10.0)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from stochquant_tpu_torch import metrics, runtime
    from stochquant_tpu_torch.actions import complex_actions
    from stochquant_tpu_torch.cli import COMPLEX_PRESETS
    from stochquant_tpu_torch.integrators import complex_field

    for seed in args.seeds:
        cfg = dataclasses.replace(COMPLEX_PRESETS["complex_field_2d"], n_chains=args.chains,
                                  grow_after=10**9, frames=args.frames, seed=seed,
                                  drift_cap=args.drift_cap)
        res = runtime.run_complex(cfg, device=args.device, burn_frames=args.burn,
                                  sink=metrics.MetricsSink(callback=lambda r: None))
        sigma = complex_actions.get_complex(cfg.action).sigma
        want = complex_field.exact_gaussian_z2(cfg.shape, cfg.spacing, sigma)
        re, im = res.state.z2r_mean.double().cpu(), res.state.z2i_mean.double().cpu()
        got = complex(float(re.mean()), float(im.mean()))
        err = math.hypot(float(re.std()), float(im.std())) / math.sqrt(cfg.n_chains)
        print(json.dumps({
            "device": str(res.state.zr.device), "seed": seed, "drift_cap": cfg.drift_cap,
            "z2": [got.real, got.imag], "exact": [want.real, want.imag],
            "diff": [got.real - want.real, got.imag - want.imag], "standard_error": err,
            "standard_errors": abs(got - want) / err, "em_bias": cfg.dtau / 2,
        }))
    return 0


if __name__ == "__main__":
    sys.exit(main())

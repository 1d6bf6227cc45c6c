"""Command-line runner for chain, field, complex-Langevin and gauge presets
(port of ``stochquant_tpu.cli run``).

Examples:
    python -m stochquant_tpu_torch.cli run --preset double_well --frames 100
    python -m stochquant_tpu_torch.cli run --preset harmosc --chains 256 --out ck.npz
    python -m stochquant_tpu_torch.cli run --preset harmosc --device cpu --frames 5 --loops 20
    python -m stochquant_tpu_torch.cli run --preset phi4_2d --chains 16 --frames 20
    python -m stochquant_tpu_torch.cli run --preset phi4_2d --chains 16 --tile-rows 64
    python -m stochquant_tpu_torch.cli run --preset phi4_4d --chains 4 --frames 20
    python -m stochquant_tpu_torch.cli run --preset phi4_4d --chains 4 --exchange-steps 4
    python -m stochquant_tpu_torch.cli run --preset su3_2d --frames 20 --measure-loops
    python -m stochquant_tpu_torch.cli run --preset u1_2d --device cpu --frames 3 --loops 10
    python -m stochquant_tpu_torch.cli run --preset complex_field_2d --frames 20 --burn 5
    python -m stochquant_tpu_torch.cli run --preset csu3_2d_complex --frames 20
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import sys

import torch

from stochquant_tpu_torch import metrics as metrics_mod
from stochquant_tpu_torch import runtime
from stochquant_tpu_torch.config import PRESETS, ChainConfig, FieldConfig, Scheme
from stochquant_tpu_torch.integrators.complex_field import ComplexFieldConfig
from stochquant_tpu_torch.integrators.complex_langevin import (
    ComplexChainConfig,
    ComplexLangevinConfig,
)
from stochquant_tpu_torch.integrators.gauge import GaugeConfig

#: The JAX package's complex-Langevin presets (``stochquant_tpu.cli``).
COMPLEX_PRESETS = {
    "complex_gaussian": ComplexLangevinConfig(action="complex_gaussian"),
    "complex_quartic": ComplexLangevinConfig(action="complex_quartic", dtau=5e-4, loops=200),
    "complex_chain": ComplexChainConfig(action="complex_gaussian"),
    "complex_field_2d": ComplexFieldConfig(action="complex_gaussian", shape=(32, 32),
                                           n_chains=64),
}

#: The JAX package's gauge presets (``stochquant_tpu.cli``), the last two
#: complex Langevin at complex β with gauge cooling.
GAUGE_PRESETS = {
    "u1_2d": GaugeConfig(group="u1", beta=1.0, shape=(16, 16), n_chains=64),
    "su2_2d": GaugeConfig(group="su2", beta=2.0, shape=(16, 16), n_chains=64),
    "su3_2d": GaugeConfig(group="su3", beta=2.0, shape=(8, 8), n_chains=64),
    "su3_4d": GaugeConfig(group="su3", beta=5.7, shape=(4, 4, 4, 4), n_chains=4, dtau=1e-3),
    "su2_4d": GaugeConfig(group="su2", beta=2.2, shape=(8, 8, 8, 8), n_chains=8, dtau=1e-3),
    "cu1_2d_complex": GaugeConfig(group="cu1", beta=1.0, beta_im=0.5, shape=(16, 16),
                                  n_chains=64, dtau=5e-3, cooling_rate=0.05),
    "csu3_2d_complex": GaugeConfig(group="csu3", beta=2.0, beta_im=0.5, shape=(8, 8),
                                   n_chains=32, dtau=2e-3, cooling_rate=0.05),
}


def _apply_overrides(cfg, args):
    """The options given, each applied only where the config has the field."""
    updates = {}
    for arg, field in (
        ("frames", "frames"), ("loops", "loops"), ("chains", "n_chains"),
        ("dtau", "dtau"), ("seed", "seed"), ("fps", "fps"),
        ("frames_per_launch", "frames_per_launch"), ("rng", "rng_impl"),
        ("tile_rows", "tile_rows"), ("exchange_steps", "exchange_steps"),
    ):
        value = getattr(args, arg)
        if value is not None and hasattr(cfg, field):
            updates[field] = value
    if args.scheme is not None and hasattr(cfg, "scheme"):
        updates["scheme"] = Scheme[args.scheme.upper()]
    if args.measure_loops and hasattr(cfg, "measure_loops"):
        updates["measure_loops"] = True
    return dataclasses.replace(cfg, **updates) if updates else cfg


def cmd_run(args):
    presets = {**PRESETS, **COMPLEX_PRESETS, **GAUGE_PRESETS}
    preset = presets.get(args.preset)
    if preset is None:
        sys.exit(f"unknown preset {args.preset!r}; known: {sorted(presets)}")
    cfg = _apply_overrides(preset, args)
    resume, resume_progress = args.resume, False
    if args.auto_resume:
        if not args.out:
            sys.exit("--auto-resume requires --out (the checkpoint to resume from)")
        if os.path.exists(args.out):
            resume, resume_progress = args.out, True
    with contextlib.ExitStack() as stack:
        stream = stack.enter_context(open(args.metrics, "w")) if args.metrics else sys.stdout
        if args.profile:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if args.device.startswith("cuda"):
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=activities)
            stack.callback(_export_trace, prof, args.profile)  # runs after the profiler stops
            stack.enter_context(prof)
        guard = stack.enter_context(runtime.PreemptionGuard())
        common = dict(
            device=args.device, burn_frames=args.burn,
            sink=metrics_mod.MetricsSink(stream=stream), checkpoint_out=args.out,
            checkpoint_in=resume, checkpoint_every=args.checkpoint_every,
            resume_progress=resume_progress, stop=guard,
        )
        if isinstance(cfg, (ComplexLangevinConfig, ComplexChainConfig, ComplexFieldConfig)):
            runtime.run_complex(cfg, **common)  # no kernel in either package: no backend
        else:
            run = (runtime.run_chain if isinstance(cfg, ChainConfig)
                   else runtime.run_field if isinstance(cfg, FieldConfig) else runtime.run_gauge)
            run(cfg, backend=args.backend, **common)


def _export_trace(prof, directory) -> None:
    os.makedirs(directory, exist_ok=True)
    prof.export_chrome_trace(os.path.join(directory, "trace.json"))


def main(argv=None):
    p = argparse.ArgumentParser(prog="stochquant_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("run", help="run a chain, field, complex-Langevin or gauge preset "
                       "simulation")
    r.add_argument("--preset", required=True)
    r.add_argument("--frames", type=int)
    r.add_argument("--loops", type=int)
    r.add_argument("--chains", type=int)
    r.add_argument("--dtau", type=float)
    r.add_argument("--seed", type=int)
    r.add_argument("--fps", type=int, help="frames per metrics record")
    r.add_argument("--burn", type=int, default=0, help="burn-in frames (means reset after)")
    r.add_argument(
        "--device", default="cuda",
        help="torch device: cuda (default; fails if no GPU is available) or cpu",
    )
    r.add_argument(
        "--backend", default="auto", choices=list(runtime.BACKENDS),
        help="execution path: the hand-written CUDA kernels vs the plain "
        "PyTorch integrator; auto = cuda on a CUDA device, torch on the CPU "
        "(auto runs what has no kernel in either package on the plain path and records "
        "a backend_fallback: su2_4d, su3_4d, cu1_2d_complex, csu3_2d_complex, --scheme lm / "
        "exact, quartic_large's power spectrum; the complex_* presets have no backend and "
        "ignore it)",
    )
    r.add_argument(
        "--tile-rows", type=int,
        help="field presets: dim-0 rows one block of the tiled CUDA kernels owns (any "
        "value routes a 2-D run to the strip-tiled kernel; default: whole-lattice kernels "
        "up to 1 MiB in 2-D, a rule that fills the card in D >= 3)",
    )
    r.add_argument(
        "--exchange-steps", type=int,
        help="field presets: micro-steps per launch of the chunk kernel (W, even): in "
        "D >= 3 a W above 2 runs frames as W-step chunk launches instead of pair launches; "
        "a lattice split over a mesh (2-D included) exchanges halos every W steps",
    )
    r.add_argument(
        "--frames-per-launch", type=int,
        help="CUDA backend, chain, whole-lattice field and gauge kernels: batch this "
        "many frames per kernel launch with the accept/reject + Δτ epilogue in-kernel "
        "(gauge runs write one metrics record per frame, so this batches only their "
        "burn-in)",
    )
    r.add_argument(
        "--measure-loops", action="store_true",
        help="gauge presets: per-record Polyakov loop + final Wilson-loop table",
    )
    r.add_argument(
        "--scheme", choices=["em", "heun", "lm", "exact"],
        help="integration scheme: em and heun run the chain kernels; lm and exact "
        "(chains: BACKGROUND formulation with ω frozen; fields: m² > 0, the exact "
        "propagator on free_field and its ETD1 variant on phi4) run the plain path; "
        "field presets integrate every scheme but exact with em",
    )
    r.add_argument(
        "--rng", choices=["threefry", "threefry13", "hardware"],
        help="noise generator: threefry (20 rounds, default), threefry13 "
        "(13 rounds, a different stream) or hardware (the fast-noise setting: the chain "
        "and whole-lattice field kernels draw Philox-4x32-10, another stream again; the "
        "plain path ignores it and draws threefry)",
    )
    r.add_argument("--out", help="checkpoint output path (.npz)")
    r.add_argument("--resume", help="checkpoint to resume from (.npz)")
    r.add_argument(
        "--checkpoint-every", type=int, default=0, metavar="N",
        help="also write the checkpoint every N frames (preemption safety)",
    )
    r.add_argument(
        "--auto-resume", action="store_true",
        help="if --out already exists, resume from it and count its frames "
        "toward --frames (restartable-after-preemption loop)",
    )
    r.add_argument("--metrics", help="write JSON-lines metrics here instead of stdout")
    r.add_argument("--profile", help="write a torch.profiler chrome trace into this directory")
    r.set_defaults(fn=cmd_run)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()

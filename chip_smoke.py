#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  Phases, in order; any failure exits
non-zero:

1. device: a CUDA device must be present (there is no CPU path); prints its
   name and ``nvidia-smi``'s name and power limit;
2. build: compiles the CUDA kernels from ``stochquant_tpu_torch/kernels/csrc``
   and prints the build time and nvcc's resource report;
3. kernel vs plain: each kernel's wrapper against its plain PyTorch version
   on the card, for both Threefry variants, every boundary condition, Heun,
   an odd ``loops`` and a case with rejected frames: max|Δ| of every float
   leaf (state and per-frame metrics) ≤ 2e-6, ``stable``, ``runs``,
   ``stab_cnt`` and ``step`` exact;
4. main path: the port's ``cli run`` on preset ``double_well`` at 65,536
   chains and dτ = 2e-4 (one burn-in frame, then 3 frames, then
   ``--resume`` for one more), with kernel launch counts taken over that
   phase; the resumed state must equal an uninterrupted run bitwise.  The
   burn-in frame absorbs the cold start's rejection: 2e-4 sits just above
   Euler–Maruyama's stability bound at Δt = 0.02, so the first frame trips
   the detector and the controller settles at 0.95·2e-4.  Then kernel 2 at
   the run's K=2 from its checkpoint, held against its plain version as in 3;
5. timings: MLUPS (chains·sites·loops·frames / s) of the kernel path and of
   the plain version at the headline and config-2 shapes; the timed kernel
   launches (kernel 1 at the headline, kernel 2 at config 2 with K=16) are
   held against their plain versions as in 3.

Prints a JSON line with the kernels' numbers, then the card's name and power
limit, and last ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
GATE = 2e-6  # max |Δ| of every float leaf, kernel vs plain (the JAX kernels' bar)
HEADLINE = dict(action="double_well", n_sites=200, dt=0.02, dtau=2e-4, n_chains=65536,
                loops=1000, seed=2026, grow_after=10**9)
CONFIG2 = dict(action="anharmonic", n_sites=1024, dt=0.25, dtau=0.01, n_chains=256,
               loops=1000, seed=14, grow_after=10**9)
KERNELS = {
    "chain_frame": "stochquant_tpu/kernels/chain_kernel.py:283",
    "chain_frames_multi": "stochquant_tpu/kernels/chain_kernel.py:624",
}
SOURCE = "stochquant_tpu_torch/kernels/csrc/chain_kernel.cu"


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def gate_cases(ChainConfig, BoundaryCondition, Formulation, Scheme):
    """(name, config, n_frames): small cases for every branch of the kernels."""
    dw = dict(action="double_well", n_sites=200, dt=0.02, dtau=2e-4, n_chains=256,
              loops=100, seed=11, grow_after=10**9)
    direct = dict(formulation=Formulation.DIRECT)
    return [
        ("gate_threefry", ChainConfig(**dw), 2),
        ("gate_threefry13", ChainConfig(**dw, rng_impl="threefry13"), 2),
        ("periodic_anharmonic_n1024", ChainConfig(
            action="anharmonic", n_sites=1024, dt=0.25, dtau=0.01, n_chains=16, loops=50,
            seed=13, bc=BoundaryCondition.PERIODIC, **direct), 2),
        ("periodic_anharmonic_n2000_tf13", ChainConfig(
            action="anharmonic", n_sites=2000, dt=0.3, dtau=0.005, n_chains=8, loops=20,
            seed=15, bc=BoundaryCondition.PERIODIC, rng_impl="threefry13", **direct), 2),
        ("dirichlet_harmonic", ChainConfig(
            action="harmonic", n_sites=96, dt=0.2, dtau=0.01, n_chains=16, loops=40,
            seed=14, bc=BoundaryCondition.DIRICHLET, **direct), 2),
        ("heun_double_well", ChainConfig(**{**dw, "n_chains": 64, "loops": 40},
                                         scheme=Scheme.HEUN), 2),
        ("odd_loops_harmosc", ChainConfig(
            action="harmonic", n_sites=100, dt=0.1, dtau=0.002, n_chains=32, loops=21,
            seed=3, rng_impl="threefry13"), 2),
        ("rejections_double_well", ChainConfig(
            action="double_well", n_sites=32, dt=0.05, dtau=0.05, n_chains=16, loops=6,
            seed=5), 4),
        ("grow_shrink_dtau_max", ChainConfig(
            action="double_well", n_sites=32, dt=0.05, dtau=1.2e-3, n_chains=64, loops=50,
            seed=6, grow_after=1, dtau_max=1.4e-3), 8),
    ]


EXACT = ("runs", "stab_cnt", "step", "unstable", "stable")


def compare(got, want) -> tuple[float, list]:
    """(max|Δ| over every float leaf, exact leaves that differ) between a
    kernel's result and its plain version's: FrameSums, or a (ChainState,
    metrics) pair."""
    import torch

    if hasattr(got, "_fields"):
        leaves = zip(got._fields, got, want)
    else:
        (gs, gm), (ws, wm) = got, want
        leaves = [*zip(gs._fields, gs, ws), *((k, gm[k], wm[k]) for k in wm)]
    worst, bad = 0.0, []
    for name, x, y in leaves:
        if name in EXACT:
            if not torch.equal(x.cpu(), y.cpu()):
                bad.append(name)
        elif x.numel():
            worst = max(worst, float((x.double() - y.double()).abs().max()))
    return worst, bad


def gate(label: str, got, want) -> float:
    """Hold a kernel's result against its plain version's: every float leaf
    within GATE, every exact leaf equal.  Returns max|Δ|."""
    import torch

    torch.cuda.synchronize()
    err, bad = compare(got, want)
    log(f"  {label:56s} max|Δ| {err:.3e}  exact mismatches {bad or 'none'}")
    if err > GATE or bad:
        raise SystemExit(f"kernel vs plain gate failed: {label}")
    return err


def phase_gate(ck, langevin, actions, cfgmod, device) -> None:
    """Kernel wrapper vs plain version on the card, on small cases that
    reach every branch of the kernels."""
    for name, cfg, n in gate_cases(cfgmod.ChainConfig, cfgmod.BoundaryCondition,
                                   cfgmod.Formulation, cfgmod.Scheme):
        act = actions.get(cfg.action)
        s0 = langevin.init_chain_state(cfg, act, device=device)
        if cfg.bc == cfgmod.BoundaryCondition.DIRICHLET:
            s0.f[:, 0] = 0.0
            s0.f[:, -1] = 0.0
        gate(f"{name} chain_frame ×{n} + epilogue",
             ck.run_frames_kernel(s0, act, cfg, n, frames_per_launch=1),
             langevin.run_frames(s0, act, cfg, n))
        gate(f"{name} chain_frames_multi K={n}",
             ck.chain_frames_multi(s0, act, cfg, n), ck.chain_frames_multi_ref(s0, act, cfg, n))


def phase_main_path(torch, ck, cli, checkpoint, actions, tmp: Path) -> tuple[dict, float]:
    """The port's CLI on the double_well preset at 65,536 chains; then kernel
    2 at the K=2 it ran with, from the run's checkpoint, against its plain
    version.  Returns the launch counts and that max|Δ|."""
    common = ["run", "--preset", "double_well", "--chains", "65536", "--dtau", "2e-4",
              "--device", "cuda", "--frames-per-launch", "2"]
    ck.chain_frame.launches = 0
    ck.chain_frames_multi.launches = 0
    t0 = time.time()
    cli.main(common + ["--burn", "1", "--frames", "3", "--fps", "3", "--out", str(tmp / "a.npz"),
                       "--metrics", str(tmp / "a.jsonl")])
    cli.main(common + ["--frames", "1", "--resume", str(tmp / "a.npz"),
                       "--out", str(tmp / "b.npz"), "--metrics", str(tmp / "b.jsonl")])
    cli.main(common + ["--burn", "1", "--frames", "4", "--fps", "4", "--out", str(tmp / "c.npz"),
                       "--metrics", str(tmp / "c.jsonl")])
    torch.cuda.synchronize()
    launches = {"chain_frame": ck.chain_frame.launches,
                "chain_frames_multi": ck.chain_frames_multi.launches}
    log(f"  main path: 3 + resume 1 + uninterrupted 4 frames in {time.time() - t0:.1f}s; "
        f"launch counts {launches}")
    if min(launches.values()) < 1:
        raise SystemExit(f"a kernel of the main path was never launched: {launches}")

    for part in ("a", "b", "c"):
        recs = [json.loads(line) for line in open(tmp / f"{part}.jsonl")]
        frames = [r for r in recs if r["type"] == "frame"]
        if not frames or recs[-1]["type"] != "summary":
            raise SystemExit(f"run {part}: missing frame or summary records")
        for r in frames:
            corr = r["log_abs_corr"]
            if len(corr) != 200 or not all(isinstance(v, float) and abs(v) < 1e6 for v in corr):
                raise SystemExit(f"run {part}: non-finite log_abs_corr")
            if r["stable_frac"] < 0.99:
                raise SystemExit(f"run {part}: stable_frac {r['stable_frac']} < 0.99")
        log(f"  run {part}: {len(frames)} frame record(s), last stable_frac "
            f"{frames[-1]['stable_frac']}, dtau {frames[-1]['dtau']:.3e}, "
            f"avg_mlups {recs[-1]['avg_mlups']}")

    resumed, _ = checkpoint.load(tmp / "b.npz", "cpu")
    straight, _ = checkpoint.load(tmp / "c.npz", "cpu")
    for name, x, y in zip(resumed._fields, resumed, straight):
        if not torch.equal(x, y):
            raise SystemExit(f"resumed run differs from the uninterrupted one in {name}")
    if tuple(resumed.f.shape) != (65536, 200) or int(resumed.step) != 2 + (1 + 4) * 1000:
        raise SystemExit(f"unexpected final state: f {tuple(resumed.f.shape)}, step {int(resumed.step)}")
    for name in ("f", "x_mean", "xx0_mean", "x2_mean", "x4_mean", "lrg_vl", "omega"):
        if not torch.isfinite(getattr(resumed, name)).all():
            raise SystemExit(f"non-finite {name} in the final state")
    log("  resumed 4th frame is bitwise equal to the uninterrupted run; final state finite")

    state, cfg = checkpoint.load(tmp / "a.npz", "cuda")
    act = actions.get(cfg.action)
    err = gate(f"main path C={cfg.n_chains} N={cfg.n_sites} loops={cfg.loops} "
               f"chain_frames_multi K=2",
               ck.chain_frames_multi(state, act, cfg, 2), ck.chain_frames_multi_ref(state, act, cfg, 2))
    return launches, err


def timed(torch, fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def phase_timings(torch, device, ck, langevin, actions, cfgmod, card: str) -> dict:
    """MLUPS of the kernel path (median of 3 reps after a warm-up that lets
    the Δτ controller settle), then each kernel alone and its plain version
    on the same warmed states: kernel 1 at the headline, kernel 2 (K=16) at
    config 2.  A cold start is not timed: its first frame trips the detector
    and the frozen chains leave the kernel early."""
    ChainConfig, bc, form = cfgmod.ChainConfig, cfgmod.BoundaryCondition, cfgmod.Formulation
    out, warm = {}, {}

    def mlups(cfg, frames, seconds):
        return cfg.n_chains * cfg.n_sites * cfg.loops * frames / seconds / 1e6

    config2 = ChainConfig(**CONFIG2, bc=bc.PERIODIC, formulation=form.DIRECT)
    cases = [
        ("headline_threefry", ChainConfig(**HEADLINE), 3, 1),
        ("headline_threefry13", ChainConfig(**HEADLINE, rng_impl="threefry13"), 3, 1),
        ("config2_fpl1", config2, 16, 1),
        ("config2_fpl16", config2, 16, 16),
    ]
    for name, cfg, frames, fpl in cases:
        act = actions.get(cfg.action)
        state = langevin.init_chain_state(cfg, act, device=device)
        run = lambda s: ck.run_frames_kernel(s, act, cfg, frames, frames_per_launch=fpl)
        state, _ = run(state)  # warm-up
        reps = []
        for _ in range(3):
            holder = {}
            reps.append(timed(torch, lambda: holder.update(r=run(state))))
            state, m = holder["r"]
        warm[name] = (cfg, act, state)
        t = sorted(reps)[1]
        stable = float(m["stable"].float().mean())
        out[name] = dict(mlups=mlups(cfg, frames, t), seconds=t, reps=reps, stable=stable)
        log(f"  {name:22s} kernel path: {out[name]['mlups']:.1f} MLUPS (median of 3 reps of "
            f"{frames} frames, {t:.4f}s; reps {[round(r, 4) for r in reps]}; "
            f"stable {stable:.4f}) [{card}]")

    for kname, case, K in (("chain_frame", "headline_threefry", 1),
                           ("chain_frames_multi", "config2_fpl16", 16)):
        cfg, act, state = warm[case]
        if K == 1:
            launch = lambda: ck.chain_frame(state, act, cfg)
            plain = lambda: ck.chain_frame_ref(state, act, cfg)
        else:
            launch = lambda: ck.chain_frames_multi(state, act, cfg, K)
            plain = lambda: ck.chain_frames_multi_ref(state, act, cfg, K)
        got = launch()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(3):
            launch()
        end.record()
        torch.cuda.synchronize()
        out[kname + "_ms"] = start.elapsed_time(end) / 3
        holder = {}
        out[kname + "_plain_ms"] = timed(torch, lambda: holder.update(r=plain())) * 1e3
        out[kname + "_err"] = gate(
            f"{case} C={cfg.n_chains} N={cfg.n_sites} loops={cfg.loops} {kname} K={K}",
            got, holder["r"])
        log(f"  {kname:19s} kernel {out[kname + '_ms']:.3f} ms/launch (CUDA events, mean of "
            f"3), plain version {out[kname + '_plain_ms']:.1f} ms (once), at C={cfg.n_chains} "
            f"N={cfg.n_sites} loops={cfg.loops} K={K} [{card}]")

    # the plain path's MLUPS: one full frame (frame sums + epilogue) at the headline
    for name in ("headline_threefry", "headline_threefry13"):
        cfg, act, state = warm[name]
        t = timed(torch, lambda: langevin.run_frames(state, act, cfg, 1))
        out[name + "_plain_mlups"] = mlups(cfg, 1, t)
        log(f"  {name + ' plain':26s} {out[name + '_plain_mlups']:.2f} MLUPS (1 frame, "
            f"{t:.3f}s) [{card}]")
    out["config2_plain_mlups"] = mlups(config2, 16, out["chain_frames_multi_plain_ms"] / 1e3)
    log(f"  {'config2 plain':26s} {out['config2_plain_mlups']:.2f} MLUPS (16 frames, "
        f"chain_frames_multi_ref) [{card}]")
    return out


def main() -> int:
    if not (ROOT / "stochquant_tpu_torch").is_dir():
        print("chip_smoke.py: run it from a checkout of the repository "
              "(stochquant_tpu_torch/ not found beside it)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import torch

    # 1. device
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device available; the port's smoke test "
              "needs a GPU and has no CPU path", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    card = card_line()
    log(f"[1] device: {name}; torch {torch.__version__} CUDA {torch.version.cuda}; "
        f"nvidia-smi: {card}")

    from stochquant_tpu_torch import actions, cli
    from stochquant_tpu_torch import config as cfgmod
    from stochquant_tpu_torch.integrators import langevin
    from stochquant_tpu_torch.io import checkpoint
    from stochquant_tpu_torch.kernels import _build
    from stochquant_tpu_torch.kernels import chain_kernel as ck

    # 2. build
    t0 = time.time()
    _build.library()
    log(f"[2] build: {time.time() - t0:.1f}s into {_build.build_dir()}")
    log((_build.build_dir() / "nvcc.log").read_text().strip())

    # 3. kernel vs plain on the card
    log("[3] kernel vs plain PyTorch version on the card (every float leaf within "
        f"{GATE:g}, exact leaves equal):")
    phase_gate(ck, langevin, actions, cfgmod, device)

    # 4. main path
    log("[4] main path: cli run --preset double_well --chains 65536 --dtau 2e-4:")
    with tempfile.TemporaryDirectory() as tmp:
        launches, main_k2_err = phase_main_path(torch, ck, cli, checkpoint, actions, Path(tmp))

    # 5. timings, with kernel vs plain at the main path's shapes
    log(f"[5] timings [{card}]:")
    t = phase_timings(torch, device, ck, langevin, actions, cfgmod, card)

    # max_abs_err: the comparisons at the main path's shapes (headline K=1;
    # main-path state K=2 and config 2 K=16)
    err = {"chain_frame": t["chain_frame_err"],
           "chain_frames_multi": max(main_k2_err, t["chain_frames_multi_err"])}
    kernels = [
        {"name": kname, "route": "cuda", "source": SOURCE, "replaces": KERNELS[kname],
         "launches": launches[kname], "max_abs_err": err[kname],
         "ms": t[kname + "_ms"], "plain_ms": t[kname + "_plain_ms"]}
        for kname in KERNELS
    ]
    print(json.dumps({"kernels": kernels, "mlups": {
        k: v["mlups"] for k, v in t.items() if isinstance(v, dict)}}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

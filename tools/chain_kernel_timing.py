#!/usr/bin/env python3
"""Chain kernels 1 and 2 on the card: times, layouts and SASS.

    python3 tools/chain_kernel_timing.py measure [--root DIR]
    python3 tools/chain_kernel_timing.py sweep
    python3 tools/chain_kernel_timing.py turns PARENT_DIR
    python3 tools/chain_kernel_timing.py sass [--root DIR]

``measure`` times kernel 1 (``chain_frame``) at the headline (double_well,
65,536 chains x 200 sites, loops 1000) and kernel 2 (``chain_frames_multi``,
K = 16) at config 2 (anharmonic, 256 x 1024, loops 1000), each with Threefry-20
and with Philox (``rng_impl='hardware'``): CUDA-event ms per launch, the mean
of 3 after a warm-up that lets the dtau controller settle, as chip_smoke.py
[5] and [23] time them, with the SM clock sampled while each case runs.
``--root`` takes the package from another checkout (e.g. the parent commit
unpacked with ``git archive``); the kernels build into that checkout.

``sweep`` times the candidate layouts (G warps a chain, S sites a lane,
chains a block) at both shapes and holds each one's outputs bitwise against
the default layout's.  ``turns`` runs ``measure`` in a fresh process for
PARENT_DIR, this checkout, this checkout, PARENT_DIR and prints each case's
four times.  ``sass`` disassembles the built library (``cuobjdump -sass``)
and counts each chain kernel's instructions: the whole function, and the body
of its outer step loop per site and micro-step (Threefry: one body serves 2
steps of S slots; Philox: 4).  That body holds the code of every runtime
branch (action, boundary condition, Heun), so it bounds what one step executes
from above.

Each mode prints its results as JSON lines on stdout; the card's name and
power limit come first.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
HEADLINE = dict(action="double_well", n_sites=200, dt=0.02, dtau=2e-4, n_chains=65536,
                loops=1000, seed=2026, grow_after=10**9)
CONFIG2 = dict(action="anharmonic", n_sites=1024, dt=0.25, dtau=0.01, n_chains=256,
               loops=1000, seed=14, grow_after=10**9)
# candidate layouts (G, S, chains per block); G = 1 takes several chains a block
SWEEP = {"headline": [(1, 7, 4), (1, 7, 2), (2, 4, 1), (3, 3, 1), (4, 2, 1), (7, 1, 1)],
         "config2": [(17, 2, 1), (11, 3, 1), (9, 4, 1), (7, 5, 1), (6, 6, 1), (5, 7, 1)]}


def emit(**kw) -> None:
    print(json.dumps(kw), flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


class Clock:
    """The SM clock (MHz) sampled every 100 ms while the block runs."""

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits", "-lms",
             "100"], stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        text, _ = self.proc.communicate(timeout=10)
        mhz = sorted(float(v) for v in text.split() if v.replace(".", "").isdigit())
        self.line = (f"{mhz[0]:.0f}-{mhz[-1]:.0f} MHz, median {mhz[len(mhz) // 2]:.0f}"
                     if mhz else "no samples")
        return False


def load(root: Path):
    sys.path.insert(0, str(root))
    import torch

    from stochquant_tpu_torch import actions
    from stochquant_tpu_torch.config import BoundaryCondition, ChainConfig, Formulation
    from stochquant_tpu_torch.integrators import langevin
    from stochquant_tpu_torch.kernels import _build
    from stochquant_tpu_torch.kernels import chain_kernel as ck

    if not torch.cuda.is_available():
        raise SystemExit("chain_kernel_timing.py needs a CUDA device")
    cfgs = {"headline": ChainConfig(**HEADLINE),
            "config2": ChainConfig(**CONFIG2, bc=BoundaryCondition.PERIODIC,
                                   formulation=Formulation.DIRECT)}
    return torch, actions, langevin, _build, ck, cfgs


def cuda_ms(torch, fn, reps: int = 3) -> float:
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def warm_states(torch, actions, langevin, ck, cfgs):
    """(cfg, action, state) per (shape, rng): the state after a warm-up."""
    import dataclasses

    out = {}
    for shape, cfg in cfgs.items():
        for rng in ("threefry", "hardware"):
            c = dataclasses.replace(cfg, rng_impl=rng)
            act = actions.get(c.action)
            s = langevin.init_chain_state(c, act, device="cuda")
            frames, fpl = (3, 1) if shape == "headline" else (16, 16)
            s, _ = ck.run_frames_kernel(s, act, c, frames, frames_per_launch=fpl)
            out[shape, rng] = (c, act, s)
    torch.cuda.synchronize()
    return out


def launcher(ck, shape, c, act, s):
    if shape == "headline":
        return lambda: ck.chain_frame(s, act, c)
    return lambda: ck.chain_frames_multi(s, act, c, 16)


CASES = (("k1", "headline", "threefry"), ("k1h", "headline", "hardware"),
         ("k2", "config2", "threefry"), ("k2h", "config2", "hardware"))


def measure(root: Path) -> None:
    torch, actions, langevin, _build, ck, cfgs = load(root)
    _build.library()
    warm = warm_states(torch, actions, langevin, ck, cfgs)
    for name, shape, rng in CASES:
        c, act, s = warm[shape, rng]
        with Clock() as clk:
            ms = cuda_ms(torch, launcher(ck, shape, c, act, s))
        try:
            geometry = ck.launch_geometry(c.n_sites, c.n_chains)
        except TypeError:  # the one-block-per-chain layout: (threads, sites per thread)
            geometry = ck.launch_geometry(c.n_sites)
        emit(case=name, shape=shape, rng=rng, ms=ms, clock=clk.line, root=str(root),
             geometry=list(geometry))


def sweep() -> None:
    torch, actions, langevin, _build, ck, cfgs = load(HERE)
    _build.library()
    warm = warm_states(torch, actions, langevin, ck, cfgs)
    default = ck.launch_geometry
    for shape, geoms in SWEEP.items():
        for rng in ("threefry", "hardware"):
            c, act, s = warm[shape, rng]
            ref = launcher(ck, shape, c, act, s)()
            for geom in geoms:
                ck.launch_geometry = lambda n, chains=1, g=geom: g
                try:
                    got = launcher(ck, shape, c, act, s)()
                    flat = lambda r: list(r) if hasattr(r, "_fields") else [*r[0], *r[1].values()]
                    same = all(not torch.is_tensor(x) or torch.equal(x, y)
                               for x, y in zip(flat(got), flat(ref)))
                    with Clock() as clk:
                        ms = cuda_ms(torch, launcher(ck, shape, c, act, s))
                finally:
                    ck.launch_geometry = default
                emit(sweep=shape, rng=rng, G=geom[0], S=geom[1], chains_per_block=geom[2],
                     ms=ms, bitwise_equal_to_default=same, clock=clk.line)


def turns(parent: Path) -> None:
    runs = {}
    for i, root in enumerate((parent, HERE, HERE, parent)):
        out = subprocess.run([sys.executable, str(Path(__file__).resolve()), "measure", "--root",
                              str(root)], capture_output=True, text=True, timeout=1800)
        if out.returncode:
            raise SystemExit(f"measure in {root} failed:\n{out.stderr[-4000:]}")
        for line in out.stdout.splitlines():
            rec = json.loads(line)
            rec["turn"] = i
            emit(**rec)
            runs.setdefault(rec["case"], []).append(rec)
    for case, recs in runs.items():
        p = [r["ms"] for r in recs if r["turn"] in (0, 3)]
        c = [r["ms"] for r in recs if r["turn"] in (1, 2)]
        emit(case=case, parent_ms=p, change_ms=c, change_over_parent=sum(c) / sum(p),
             clocks=[r["clock"] for r in recs])


def sass(root: Path) -> None:
    sys.path.insert(0, str(root))
    from stochquant_tpu_torch.kernels import _build

    _build.library()
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    text = subprocess.run([tool, "-sass", str(_build.build_dir() / "libsq_kernels.so")],
                          capture_output=True, text=True, check=True).stdout
    # split into functions; keep the chain kernels
    for block in re.split(r"\n\s*Function : ", text)[1:]:
        name = block.split("\n", 1)[0].strip()
        m = re.match(r"_Z\d+(chain_frames?_kernel)ILi(\d+)E\d+(ThreefryNoiseILi(\d+)EE|PhiloxNoise)",
                     name)
        if not m:
            continue
        kernel, s, gen, rounds = m.group(1), int(m.group(2)), m.group(3), m.group(4)
        ins = [(int(a, 16), body) for a, body in re.findall(
            r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", block)]
        # the step loop: the widest backward branch (kernel 1); in kernel 2 the
        # widest one inside the frame loop
        spans = []
        for addr, body in ins:
            tgt = re.search(r"BRA\b.*?0x([0-9a-f]+)", body)
            if tgt and int(tgt.group(1), 16) < addr:
                spans.append((int(tgt.group(1), 16), addr))
        spans.sort(key=lambda sp: sp[0] - sp[1])
        loop = spans[0] if spans else (0, -1)
        if kernel == "chain_frames_kernel":
            inner = [sp for sp in spans[1:] if loop[0] <= sp[0] and sp[1] <= loop[1]]
            loop = inner[0] if inner else loop
        body_ins = [b for a, b in ins if loop[0] <= a <= loop[1]]
        steps = 4 if "Philox" in gen else 2
        kinds = {}
        for b in body_ins:
            op = b.split()[0] if not b.startswith("@") else b.split()[1]
            op = op.split(".")[0]
            kinds[op] = kinds.get(op, 0) + 1
        emit(kernel=kernel, S=s, generator=("philox" if "Philox" in gen else f"threefry{rounds}"),
             instructions=len(ins), loop_body=len(body_ins),
             loop_body_per_site_step=len(body_ins) / (steps * s),
             top_ops=sorted(kinds.items(), key=lambda kv: -kv[1])[:12], root=str(root))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", choices=("measure", "sweep", "turns", "sass"))
    ap.add_argument("parent", nargs="?", help="turns: the parent commit's checkout")
    ap.add_argument("--root", type=Path, default=HERE)
    args = ap.parse_args()
    if args.mode != "measure":  # a measure child prints only its records
        emit(card=card_line())
    if args.mode == "measure":
        measure(args.root.resolve())
    elif args.mode == "sweep":
        sweep()
    elif args.mode == "turns":
        if not args.parent:
            ap.error("turns needs PARENT_DIR")
        turns(Path(args.parent).resolve())
    else:
        sass(args.root.resolve())
    return 0


if __name__ == "__main__":
    sys.exit(main())

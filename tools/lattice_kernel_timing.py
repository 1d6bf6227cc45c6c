#!/usr/bin/env python3
"""Field kernels 3-4 and gauge kernels 10-12 on the card: times, cluster sizes
and the empty micro-step.

    python3 tools/lattice_kernel_timing.py measure [--root DIR]
    python3 tools/lattice_kernel_timing.py sweep
    python3 tools/lattice_kernel_timing.py turns PARENT_DIR

``measure`` times, at the shapes chip_smoke.py [9] [12] [19] [23] time them:
kernel 3 (``field_frame``) and kernel 4 (``field_frames_multi``, K = 10) at
256^2 x 16, loops 100, with Threefry-20 (rows 3, 4) and Philox (3h, 4h);
kernel 10 (``gauge_frame_sums``) at u1 256^2 x 32 loops 100, su2 128^2 x 16
loops 100 and su3 64^2 x 8 loops 50; kernel 11 (``gauge_frames_multi``, K =
8) at 256 chains, loops 10 (u1 and su2 on 16 x 128, su3 on 8 x 128); kernel
12 (``gauge_chunk``, W = 8) on a shard of u1 256^2 x 32 and su3 64^2 x 8 cut
in two along dim 0.  CUDA-event ms per launch, the mean of 3 after a warm-up
launch, from a state one frame past its start, with the SM clock sampled
while each case runs and the cluster geometry the launch took (B blocks a
chain, where its state lives; absent in a checkout that has none).
``--root`` takes the package from another checkout (e.g. the parent commit
unpacked with ``git archive``); the kernels build into that checkout.

``sweep`` times kernels 3, 4, 4h and 10 (u1, su2, su3) at every cluster size
the rule can pick for the timed shape, holds each one's outputs against B = 1
(bit for bit but for the site sums, which take another order), and times the
empty micro-step at each B > 1: the same launch with the site work skipped,
its barriers, halo publication and reductions kept (``_cluster.forced(B,
empty=True)``), per micro-step.  ``turns`` runs ``measure`` in a fresh process
for PARENT_DIR, this checkout, this checkout, PARENT_DIR and prints each
case's four times.

Each mode prints its results as JSON lines on stdout; the card's name and
power limit come first.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

from chain_kernel_timing import Clock, card_line, cuda_ms, emit

HERE = Path(__file__).resolve().parents[1]
FIELD = dict(shape=(256, 256), n_chains=16, loops=100, seed=13, grow_after=10**9)
GAUGE = {
    "u1": dict(group="u1", beta=1.0, shape=(256, 256), n_chains=32, dtau=5e-3, loops=100,
               seed=15, grow_after=10**9),
    "su2": dict(group="su2", beta=2.0, shape=(128, 128), n_chains=16, dtau=2e-3, loops=100,
                seed=19, grow_after=10**9),
    "su3": dict(group="su3", beta=5.0, shape=(64, 64), n_chains=8, dtau=1e-3, loops=50,
                seed=19, grow_after=10**9),
}
MULTI = {
    "u1": dict(group="u1", beta=1.0, shape=(16, 128), dtau=5e-3),
    "su2": dict(group="su2", beta=2.0, shape=(16, 128), dtau=2e-3),
    "su3": dict(group="su3", beta=5.0, shape=(8, 128), dtau=1e-3),
}
CHUNK_W = 8


def load(root: Path):
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("lattice_kernel_timing.py needs a CUDA device")
    from stochquant_tpu_torch import actions
    from stochquant_tpu_torch.config import FieldConfig
    from stochquant_tpu_torch.integrators import field, gauge
    from stochquant_tpu_torch.kernels import _build
    from stochquant_tpu_torch.kernels import field_kernel as fk
    from stochquant_tpu_torch.kernels import gauge_kernel as gk

    _build.library()
    return dict(torch=torch, actions=actions, FieldConfig=FieldConfig, field=field, gauge=gauge,
                fk=fk, gk=gk)


def cases(m):
    """(name, launch, wrapper whose .geometry the launch sets, micro-steps a
    launch) per case, from states one frame in."""
    torch, fk, gk, field, gauge = m["torch"], m["fk"], m["gk"], m["field"], m["gauge"]
    dev = torch.device("cuda")
    out = []
    for rng in ("threefry", "hardware"):
        cfg = m["FieldConfig"](**FIELD, rng_impl=rng)
        act = m["actions"].get_field(cfg.action)
        s, _ = fk.run_field_frames_kernel(field.init_field_state(cfg, device=dev), act, cfg, 1)
        tag = "" if rng == "threefry" else "h"
        out.append((f"k3{tag}", lambda s=s, a=act, c=cfg: fk.field_frame(s, a, c), fk.field_frame,
                    cfg.loops))
        out.append((f"k4{tag}", lambda s=s, a=act, c=cfg: fk.field_frames_multi(s, a, c, 10),
                    fk.field_frames_multi, cfg.loops * 10))
    for group, kw in GAUGE.items():
        cfg = gauge.GaugeConfig(**kw)
        act = gauge.resolve_gauge_action(cfg)
        s, _ = gk.run_gauge_frames_kernel(gauge.init_gauge_state(cfg, act, device=dev), act, cfg, 1)
        out.append((f"k10_{group}", lambda s=s, a=act, c=cfg: gk.gauge_frame_sums(s, a, c),
                    gk.gauge_frame, cfg.loops))
        if group in ("u1", "su3"):  # kernel 12 on the shard at rows 0 .. L0/2 of a cut in two
            loc0 = cfg.shape[0] // 2
            planes = gk.links_to_planes(s.links, act)
            rows = (torch.arange(loc0 + 2 * CHUNK_W, device=dev) - CHUNK_W) % cfg.shape[0]
            ext = planes[:, :, rows].contiguous()
            out.append((f"k12_{group}", lambda e=ext, s=s, a=act, c=cfg, l=loc0: gk.gauge_chunk(
                e, s.dtau, a, c, l, CHUNK_W, int(s.step)), gk.gauge_chunk, CHUNK_W))
    for group, kw in MULTI.items():
        cfg = gauge.GaugeConfig(**kw, n_chains=256, loops=10, seed=29, grow_after=10**9)
        act = gauge.resolve_gauge_action(cfg)
        s, _ = gk.run_gauge_frames_kernel(gauge.init_gauge_state(cfg, act, device=dev), act, cfg, 1)
        out.append((f"k11_{group}", lambda s=s, a=act, c=cfg: gk.gauge_frames_multi(s, a, c, 8),
                    gk.gauge_frames_multi, cfg.loops * 8))
    torch.cuda.synchronize()
    return out


def geometry(wrapper):
    g = getattr(wrapper, "geometry", None)
    return None if g is None else dict(B=g.B, placement=g.placement, smem=g.smem)


def measure(root: Path) -> None:
    m = load(root)
    for name, launch, wrapper, steps in cases(m):
        with Clock() as clk:
            ms = cuda_ms(m["torch"], launch)
        emit(case=name, ms=ms, micro_steps=steps, clock=clk.line, geometry=geometry(wrapper),
             root=str(root))


def flat(torch, result) -> list:
    """(name, tensor) leaves of frame sums or a (state, metrics) pair."""
    if hasattr(result, "_fields"):
        return [(n, t) for n, t in zip(result._fields, result) if torch.is_tensor(t)]
    state, metrics = result
    return [*zip(state._fields, state), *metrics.items()]


SITE_SUMS = {"ms", "m2s", "m4s", "ams", "p2s", "acs", "cs", "ps", "mag_mean", "mag2_mean",
             "mag4_mean", "absmag_mean", "phi2_mean", "act_mean", "corr_mean", "plaq_mean"}


def same_as(torch, got, ref) -> bool:
    for (name, x), (_, y) in zip(flat(torch, got), flat(torch, ref)):
        x, y = x.cpu(), y.cpu()
        if x.is_complex():
            x, y = torch.view_as_real(x), torch.view_as_real(y)
        if name in SITE_SUMS:
            if not torch.allclose(x.double(), y.double(), rtol=3e-5, atol=3e-6, equal_nan=True):
                return False
        elif x.is_floating_point():
            nan = torch.isnan(x)
            if not (torch.equal(nan, torch.isnan(y)) and torch.equal(x[~nan], y[~nan])):
                return False
        elif not torch.equal(x, y):
            return False
    return True


def sweep() -> None:
    m = load(HERE)
    from stochquant_tpu_torch.kernels import _cluster

    torch, fk, gk = m["torch"], m["fk"], m["gk"]
    for name, launch, wrapper, steps in cases(m):
        if name.startswith(("k11", "k12")) or name == "k3h":
            continue
        launch()
        shape, C = (256, 256), 16
        if name.startswith("k10"):
            kw = GAUGE[name[4:]]
            shape, C = kw["shape"], kw["n_chains"]
            group = ("u1", "su2", "su3").index(kw["group"])
            sizes = [g.B for g in gk.cluster_candidates(shape, group)]
        else:
            sizes = [g.B for g in fk.cluster_candidates(shape, 3 if name.endswith("h") else 1)]
        with _cluster.forced(1):
            ref = launch()
        for B in sizes:
            with _cluster.forced(B):
                got = launch()
                same = same_as(torch, got, ref)
                with Clock() as clk:
                    ms = cuda_ms(torch, launch)
                g = geometry(wrapper)
            empty_us = None
            if B > 1:
                with _cluster.forced(B, empty=True):
                    empty_us = cuda_ms(torch, launch) / steps * 1e3
            emit(sweep=name, B=B, chains=C, ms=ms, geometry=g, same_as_B1=same,
                 empty_micro_step_us=empty_us, micro_steps=steps, clock=clk.line)
    # what the card answered the rule: chains resident at once per geometry
    for (entry, _, key, g, multi), n in sorted(_cluster._RESIDENT.items(), key=str):
        emit(resident=n, entry=entry, key=str(key), B=g.B, rows=g.rows, smem=g.smem,
             scratch_in_smem=g.scratch_in_smem, multi=multi)


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
             geometry=next((r["geometry"] for r in recs if r["turn"] == 1), None),
             clocks=[r["clock"] for r in recs])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", choices=("measure", "sweep", "turns"))
    ap.add_argument("parent", nargs="?", help="turns: the parent commit's checkout")
    ap.add_argument("--root", type=Path, default=HERE)
    args = ap.parse_args()
    if args.mode != "measure":  # a measure child prints only its records
        emit(card=card_line())
    if args.mode == "measure":
        measure(args.root.resolve())
    elif args.mode == "sweep":
        sweep()
    else:
        if not args.parent:
            ap.error("turns needs PARENT_DIR")
        turns(Path(args.parent).resolve())
    return 0


if __name__ == "__main__":
    sys.exit(main())

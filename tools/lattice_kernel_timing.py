#!/usr/bin/env python3
"""Field kernels 3-9 and gauge kernels 10-12 on the card: times, cluster sizes,
tiles and the empty micro-step.

    python3 tools/lattice_kernel_timing.py measure [--root DIR] [--only clusters|fields]
    python3 tools/lattice_kernel_timing.py sweep [--only clusters|fields]
    python3 tools/lattice_kernel_timing.py turns PARENT_DIR [--only clusters|fields]

``measure`` times, at the shapes chip_smoke.py [9] [12] [19] [23] time them:
kernel 3 (``field_frame``) and kernel 4 (``field_frames_multi``, K = 10) at
256^2 x 16, loops 100, with Threefry-20 (rows 3, 4) and Philox (3h, 4h), and
kernel 3 with its epilogue (``field_frame_step``, cases k3e and k3eh, where the
checkout has it) with kernel 3's own device time in both modes;
kernel 10 (``gauge_frame_sums``) at u1 256^2 x 32 loops 100, su2 128^2 x 16
loops 100 and su3 64^2 x 8 loops 50; kernel 11 (``gauge_frames_multi``, K =
8) at 256 chains, loops 10 (u1 and su2 on 16 x 128, su3 on 8 x 128); kernel
12 (``gauge_chunk``, W = 8) on a shard of u1 256^2 x 32 and su3 64^2 x 8 cut
in two along dim 0.  CUDA-event ms per launch, the mean of 3 after a warm-up
launch, from a state one frame past its start, with the SM clock sampled
while each case runs and the cluster geometry the launch took (B blocks a
chain, where its state lives; absent in a checkout that has none).
Then kernels 5-8 at every shape where the main paths launch them (chip_smoke.py
[7]-[9], [14], [15], [18], [19], [25], [26]): kernel 5 (``field_pair``) at 1024^2 x 16
(the default strip) and 256^2 x 16 with 64-row strips; kernel 6 (``field_pair_nd``)
at 32^4 x 1, x 4 and x 8, its one-step tail (``field_step_nd``) at 32^4 x 1;
kernel 7 (``field_chunk_nd``) at 32^4 x 1, x 4 and x 8 (W = 4, dim 0 extended
periodically), on the (16, 128, 256) shard of 256^2 x 16 cut in two (W = 8), on
the ring of one (16, 256, 256) (W = 8) and on the (8, 16, 32, 32, 32) shard of
32^4 x 8 cut in two (W = 2); kernel 8 (``field_chunk_rdma_nd``) on the same three
slabs; kernel 9 (``field_halo_step``) on the (16, 128, 256) shard, with its
halo rows where the checkout's kernel takes them.  Beside the CUDA-event ms
of the wrapper, ``device_us`` is the kernel's own device time per launch
(torch.profiler), which the host's pace does not reach (kernel 12 has it
too).  ``--root`` takes the package from another checkout (e.g. the parent
commit unpacked with ``git archive``); the kernels build into that checkout.
``--only`` keeps the cluster kernels (3, 4, 10-12) or the field kernels 5-8.

``sweep`` times kernels 3, 4, 4h and 10 (u1, su2, su3) at every cluster size
the rule can pick for the timed shape, holds each one's outputs against B = 1
(bit for bit but for the site sums, which take another order), and times the
empty micro-step at each B > 1: the same launch with the site work skipped,
its barriers, halo publication and reductions kept (``_cluster.forced(B,
empty=True)``), per micro-step.  Kernel 12 it times at every cluster size
and with either work item (a site, or a link direction: ``forced_split``),
ms and device time, each held against B = 1, beside the rule's choice.  For the field kernels it times kernel 5 at
1024^2 x 16 and 256^2 x 16 at every strip height T0 that fits (synchronous
and checkerboard) and kernels 6 and 7 at 32^4 x 1 and x 8 and on the split
shard under every ``TARGET_BLOCKS`` of the tile rule, each held against the
plain version.  ``turns`` runs ``measure`` in a fresh process for PARENT_DIR,
this checkout, this checkout, PARENT_DIR and prints each case's four times.

Each mode prints its results as JSON lines on stdout; the card's name and
power limit come first.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import inspect
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
TILED = dict(shape=(1024, 1024), n_chains=16, loops=100, seed=13, grow_after=10**9)
ND = dict(action="phi4", shape=(32, 32, 32, 32), loops=20, seed=9, grow_after=10**9)
SPLIT = dict(action="phi4", shape=(256, 256), n_chains=16, loops=50, dtau=0.01, seed=21)


def load(root: Path):
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("lattice_kernel_timing.py needs a CUDA device")
    from stochquant_tpu_torch import actions
    from stochquant_tpu_torch.config import FieldConfig, Sweep
    from stochquant_tpu_torch.integrators import field, gauge
    from stochquant_tpu_torch.kernels import _build
    from stochquant_tpu_torch.kernels import field_kernel as fk
    from stochquant_tpu_torch.kernels import field_kernel_nd as nd
    from stochquant_tpu_torch.kernels import field_kernel_tiled as ft
    from stochquant_tpu_torch.kernels import field_halo_kernel as fh
    from stochquant_tpu_torch.kernels import gauge_kernel as gk

    _build.library()
    return dict(torch=torch, actions=actions, FieldConfig=FieldConfig, Sweep=Sweep, field=field,
                gauge=gauge, fk=fk, gk=gk, nd=nd, ft=ft, fh=fh)


def wrap_block(torch, phi, H: int, off0: int, loc0: int):
    """Rows off0 - H ... off0 + loc0 + H (periodic) of a (C, L0, ...) field."""
    rows = (torch.arange(loc0 + 2 * H, device=phi.device) + off0 - H) % phi.shape[1]
    return phi[:, rows].contiguous()


def field_cases(m):
    """(name, launch, kernel-name fragment for the profiler, micro-steps a
    launch) of kernels 5-9 at the main paths' shapes, from fresh states."""
    torch, nd, ft, field = m["torch"], m["nd"], m["ft"], m["field"]
    FieldConfig = m["FieldConfig"]
    dev = torch.device("cuda")
    out = []
    for name, kw, t0 in (("k5_1024x16", TILED, None),
                         ("k5_256x16_t64", dict(TILED, shape=(256, 256)), 64)):
        cfg = FieldConfig(**kw)
        act = m["actions"].get_field(cfg.action)
        s = field.init_field_state(cfg, device=dev)
        out.append((name, lambda s=s, a=act, c=cfg, t=t0: ft.field_pair(
            s.phi, s.dtau, a, c, int(s.step), t), "field_pair_kernel", 2))
    for C in (1, 4, 8):
        cfg = FieldConfig(**ND, n_chains=C)
        act = m["actions"].get_field(cfg.action)
        s = field.init_field_state(cfg, device=dev)
        step = int(s.step)
        split = (True, False, False, False)
        out.append((f"k6_32^4x{C}", lambda s=s, a=act, c=cfg, t=step: nd.field_pair_nd(
            s.phi, s.dtau, a, c, t), "nd_kernel", 2))
        if C == 1:
            out.append(("tail_32^4x1", lambda s=s, a=act, c=cfg, t=step: nd.field_step_nd(
                s.phi, s.dtau, a, c, t), "nd_kernel", 1))
        ext = wrap_block(torch, s.phi, 4, 0, 32)
        out.append((f"k7_32^4x{C}_W4", lambda e=ext, s=s, a=act, c=cfg, t=step, sp=split:
                    nd.field_chunk_nd(e, s.dtau, a, c, 4, sp, t), "nd_kernel", 4))
    for name, kw, loc0, W in (("x2_256x16", SPLIT, 128, 8), ("ring_256x16", SPLIT, 256, 8),
                              ("x2_32^4x8", dict(ND, n_chains=8), 16, 2)):
        cfg = FieldConfig(**kw)
        act = m["actions"].get_field(cfg.action)
        s = field.init_field_state(cfg, device=dev)
        split = (True,) + (False,) * (cfg.ndim - 1)
        ext = wrap_block(torch, s.phi, W, 0, loc0)
        out.append((f"k7_{name}_W{W}", lambda e=ext, s=s, a=act, c=cfg, W=W, sp=split:
                    nd.field_chunk_nd(e, s.dtau, a, c, W, sp, 7), "nd_kernel", W))
        own = s.phi[:, :loc0].contiguous()
        left = s.phi[:, cfg.shape[0] - loc0:].contiguous()
        right = s.phi[:, loc0:2 * loc0].contiguous() if loc0 < cfg.shape[0] else own
        left = left if loc0 < cfg.shape[0] else own
        out.append((f"k8_{name}_W{W}", lambda o=own, lf=left, r=right, s=s, a=act, c=cfg, W=W:
                    nd.field_chunk_rdma_nd(o, lf, r, s.dtau, a, c, W, 7), "nd_kernel", W))
    # kernel 9 on shard 1 of the split 256^2 x 16 lattice, as the cuda_step
    # runner launches it: with its halo rows where the checkout's kernel takes
    # them (narrowed views of shard 0), else without (the edge fixup's mode)
    cfg = FieldConfig(**SPLIT)
    act = m["actions"].get_field(cfg.action)
    s = field.init_field_state(cfg, device=dev)
    loc0 = cfg.shape[0] // 2
    args = (s.phi[:, loc0:].contiguous(), s.dtau, act, cfg, 7, 0, 0, (0, loc0, 0), (True, False))
    if "halos" in inspect.signature(m["fh"].field_halo_step).parameters:
        args += ({0: (s.phi[:, loc0 - 1:loc0], s.phi[:, :1])},)
    out.append(("k9_x2_256x16", lambda a=args: m["fh"].field_halo_step(*a),
                "field_halo_step_kernel", 1))
    torch.cuda.synchronize()
    return out


def device_us(torch, launch, fragment: str, reps: int = 5) -> float:
    """Device time per launch of the kernels whose name holds ``fragment``,
    under torch.profiler."""
    launch()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            launch()
        torch.cuda.synchronize()
    total = 0.0
    for ev in prof.key_averages():
        if fragment in ev.key:
            us = getattr(ev, "self_device_time_total", None)
            total += us if us is not None else getattr(ev, "self_cuda_time_total", 0)
    return total / reps


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
        if hasattr(fk, "field_frame_step"):
            out.append((f"k3e{tag}", lambda s=s, a=act, c=cfg: fk.field_frame_step(s, a, c),
                        fk.field_frame, cfg.loops))
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


def measure(root: Path, only=None) -> None:
    m = load(root)
    if only != "fields":
        for name, launch, wrapper, steps in cases(m):
            with Clock() as clk:
                ms = cuda_ms(m["torch"], launch)
                # kernels 12 and 3: their own device time too (the parent's and the
                # change's kernels are both named gauge_chunk_kernel<...>, and kernel 3
                # field_frame_kernel<...> or field_frame_cl_kernel<...> in both modes)
                fragment = ("gauge_chunk_kernel" if name.startswith("k12") else
                            "field_frame_" if name.startswith("k3") else None)
                us = device_us(m["torch"], launch, fragment) if fragment else None
            extra = {} if us is None else dict(device_us=us)
            emit(case=name, ms=ms, micro_steps=steps, clock=clk.line,
                 geometry=geometry(wrapper), root=str(root), **extra)
    if only != "clusters":
        for name, launch, fragment, steps in field_cases(m):
            with Clock() as clk:
                ms = cuda_ms(m["torch"], launch, reps=20)
                us = device_us(m["torch"], launch, fragment)
            emit(case=name, ms=ms, device_us=us, micro_steps=steps, clock=clk.line,
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


def field_leaves(torch, out) -> list:
    """A field kernel's outputs with the site sums apart: (exact, sums), the
    per-block sums as means over a block's sites (a sum of many sites near
    zero carries the rounding of its terms, not of its value)."""
    phi, *rest = out
    stats = rest[-1]
    cols = range(stats.shape[-1])
    sites = phi[0].numel() // stats.shape[1]
    slices = rest[:-1]
    if len(slices) == 1:  # the chunk kernels' slice sums, as means over a slice
        slices = [slices[0] / (phi[0].numel() // phi.shape[1])]
    return ([phi, stats[..., [c for c in cols if c % 5 >= 3]]],
            [*slices, stats[..., [c for c in cols if c % 5 < 3]] / sites])


def agrees(torch, got, want) -> bool:
    """phi and the maxima bit for bit, the sums within rtol 3e-5 / atol 3e-6."""
    (ge, gs), (we, ws) = field_leaves(torch, got), field_leaves(torch, want)
    return (all(torch.equal(x, y) for x, y in zip(ge, we))
            and all(torch.allclose(x.double(), y.double(), rtol=3e-5, atol=3e-6)
                    for x, y in zip(gs, ws)))


def sweep_fields(m) -> None:
    """Kernel 5 at every strip height that fits; kernels 6 and 7 under every
    TARGET_BLOCKS of the tile rule."""
    torch, nd, ft, field = m["torch"], m["nd"], m["ft"], m["field"]
    dev = torch.device("cuda")
    for shape, heights in (((1024, 1024), (1, 2, 4, 8, 16, 32)), ((256, 256), (16, 32, 64, 128))):
        for sweep in ("sync", "checkerboard"):
            cfg = m["FieldConfig"](**dict(TILED, shape=shape),
                                   sweep=getattr(m["Sweep"], sweep.upper()))
            act = m["actions"].get_field(cfg.action)
            s = field.init_field_state(cfg, device=dev)
            step = int(s.step)
            label = f"{shape[0]}^2x16"
            for t0 in heights:
                launch = lambda: ft.field_pair(s.phi, s.dtau, act, cfg, step, t0)  # noqa: E731
                try:
                    ok = agrees(torch, launch(),
                                ft.field_pair_ref(s.phi, s.dtau, act, cfg, step, t0))
                except (RuntimeError, ValueError) as err:
                    emit(sweep="k5", shape=label, sweep_kind=sweep, tile_rows=t0,
                         refused=str(err)[:200])
                    continue
                with Clock() as clk:
                    ms = cuda_ms(torch, launch, reps=20)
                    us = device_us(torch, launch, "field_pair_kernel")
                emit(sweep="k5", shape=label, sweep_kind=sweep, tile_rows=t0, ms=ms,
                     device_us=us, agrees_with_plain=ok, clock=clk.line)
    default = nd.TARGET_BLOCKS
    shapes = []
    for C in (1, 8):
        cfg = m["FieldConfig"](**ND, n_chains=C)
        s = field.init_field_state(cfg, device=dev)
        shapes.append((f"32^4x{C}", cfg, s, 4, 32))
    cfg = m["FieldConfig"](**SPLIT)
    shapes.append(("x2_256x16", cfg, field.init_field_state(cfg, device=dev), 8, 128))
    for name, cfg, s, W, loc0 in shapes:
        act = m["actions"].get_field(cfg.action)
        split = (True,) + (False,) * (cfg.ndim - 1)
        ext = wrap_block(torch, s.phi, W, 0, loc0)
        runs = {"k7": (lambda: nd.field_chunk_nd(ext, s.dtau, act, cfg, W, split, 3),
                       lambda: nd.field_chunk_nd_ref(ext, s.dtau, act, cfg, W, split, 3))}
        if loc0 == cfg.shape[0]:
            runs["k6"] = (lambda: nd.field_pair_nd(s.phi, s.dtau, act, cfg, 3),
                          lambda: nd.field_pair_nd_ref(s.phi, s.dtau, act, cfg, 3))
        for target in (64, 128, 256, 512, 1024, 2048, 4096):
            nd.TARGET_BLOCKS = target
            tiles = nd.resolve_tiles(cfg, (loc0,) + tuple(cfg.shape[1:]), cfg.n_chains, None,
                                     nd.chunk_halos(cfg, W, split))
            for kname, (launch, plain) in runs.items():
                ok = agrees(torch, launch(), plain())
                with Clock() as clk:
                    ms = cuda_ms(torch, launch, reps=20)
                    us = device_us(torch, launch, "nd_kernel")
                emit(sweep=kname, shape=name, W=W if kname == "k7" else 2, target=target,
                     tiles=tiles, ms=ms, device_us=us, agrees_with_plain=ok, clock=clk.line)
        nd.TARGET_BLOCKS = default


def sweep_chunk(m, name: str, launch) -> None:
    """Kernel 12 at every cluster size its rule can pick for the timed shard
    and with either work item (a site, or a link direction of a site): ms and
    device time per launch, each held against B = 1 (links, drift max and
    flags bit for bit, the plaquette sum as a mean within rtol 3e-5 / atol
    3e-6)."""
    from stochquant_tpu_torch.kernels import _cluster

    torch, gk = m["torch"], m["gk"]
    group = name[4:]
    kw = GAUGE[group]
    E0, L1 = kw["shape"][0] // 2 + 2 * CHUNK_W, kw["shape"][1]
    code = ("u1", "su2", "su3").index(group)
    launch()
    rule = gk.gauge_chunk.geometry
    rule_split = gk.chunk_split(rule, L1, code)
    with _cluster.forced(1):
        ref = launch()
    sites = CHUNK_W * (E0 - 2 * CHUNK_W) * L1
    for g in gk.chunk_candidates(E0, L1, code, CHUNK_W):
        for split in (False, True):
            with _cluster.forced(g.B), gk.forced_split(split):
                got = launch()
                same = (all(torch.equal(x, y) for x, y in zip(got[2:], ref[2:]))
                        and torch.equal(got[0], ref[0])
                        and torch.allclose(got[1].double() / sites, ref[1].double() / sites,
                                           rtol=3e-5, atol=3e-6))
                with Clock() as clk:
                    ms = cuda_ms(torch, launch, reps=20)
                    us = device_us(torch, launch, "gauge_chunk_kernel")
            emit(sweep=name, B=g.B, split=split, ms=ms, device_us=us,
                 geometry=geometry(gk.gauge_chunk), same_as_B1=same,
                 rule=dict(B=rule.B, split=rule_split), clock=clk.line)


def sweep(only=None) -> None:
    m = load(HERE)
    if only != "clusters":
        sweep_fields(m)
    if only == "fields":
        return
    from stochquant_tpu_torch.kernels import _cluster

    torch, fk, gk = m["torch"], m["fk"], m["gk"]
    for name, launch, wrapper, steps in cases(m):
        if name.startswith("k12"):
            sweep_chunk(m, name, launch)
            continue
        if name.startswith("k11") or name == "k3h":
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


def turns(parent: Path, only=None) -> None:
    runs = {}
    for i, root in enumerate((parent, HERE, HERE, parent)):
        extra = ["--only", only] if only else []
        out = subprocess.run([sys.executable, str(Path(__file__).resolve()), "measure", "--root",
                              str(root), *extra], capture_output=True, text=True, timeout=1800)
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
        if not p:  # a case the parent does not have
            emit(case=case, change_ms=c, clocks=[r["clock"] for r in recs])
            continue
        dev = {}
        if "device_us" in recs[0]:
            pu = [r["device_us"] for r in recs if r["turn"] in (0, 3)]
            cu = [r["device_us"] for r in recs if r["turn"] in (1, 2)]
            dev = dict(parent_device_us=pu, change_device_us=cu,
                       device_change_over_parent=sum(cu) / sum(pu) if sum(pu) else None)
        emit(case=case, parent_ms=p, change_ms=c, change_over_parent=sum(c) / sum(p), **dev,
             geometry=next((r.get("geometry") for r in recs if r["turn"] == 1), None),
             clocks=[r["clock"] for r in recs])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", choices=("measure", "sweep", "turns"))
    ap.add_argument("parent", nargs="?", help="turns: the parent commit's checkout")
    ap.add_argument("--root", type=Path, default=HERE)
    ap.add_argument("--only", choices=("clusters", "fields"))
    args = ap.parse_args()
    if args.mode != "measure":  # a measure child prints only its records
        emit(card=card_line())
    if args.mode == "measure":
        measure(args.root.resolve(), args.only)
    elif args.mode == "sweep":
        sweep(args.only)
    else:
        if not args.parent:
            ap.error("turns needs PARENT_DIR")
        turns(Path(args.parent).resolve(), args.only)
    return 0


if __name__ == "__main__":
    sys.exit(main())

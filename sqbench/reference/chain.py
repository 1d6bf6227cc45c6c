"""The plain reference of a chain cell: Langevin chains of a 1-D Euclidean-time
path in plain PyTorch, written from the semantics the port states (its plain
integrator's expressions, frozen here) and importing nothing of the program.

A frame is ``loops`` Euler-Maruyama (or Heun) micro-steps of every chain,
with the detector that freezes a chain whose drift step outgrows its running
max |x|, followed by the epilogue: accept or reject the frame, fold its sums
into the running means, adapt Δτ.  Noise is Threefry-2x32 keyed by the
global chain id, so any subset of the chains can be followed on its own:
``chain_ids`` names the rows a state holds.

``dtype`` is the precision the whole computation runs in: float32 as the
configuration states, or a lower one for the control.
"""

from __future__ import annotations

import importlib
import math
from typing import NamedTuple

import numpy as np
import torch

from sqbench.reference import threefry

#: float leaves compared by their gap; the integer ones and ``dtau`` exactly
FLOAT_LEAVES = ("f", "omega", "x_mean", "xx0_mean", "x2_mean", "x4_mean", "lrg_vl")
EXACT_LEAVES = ("runs", "dtau", "stab_cnt")


class State(NamedTuple):
    f: torch.Tensor          # (C, N)
    omega: torch.Tensor      # (C,)
    x_mean: torch.Tensor     # (C, N)
    xx0_mean: torch.Tensor   # (C, N)
    x2_mean: torch.Tensor    # (C, N)
    x4_mean: torch.Tensor    # (C, N)
    runs: torch.Tensor       # (C, 2) int64 (lo, hi) uint32 words of the sample count
    dtau: torch.Tensor       # (C,)
    stab_cnt: torch.Tensor   # (C,) int32
    lrg_vl: torch.Tensor     # (C,)
    step: int                # micro-step counter (uint32)


def action(cfg: dict):
    """The action named by ``cfg["action"]``: ``reference/actions/<name>.py``."""
    mod = importlib.import_module(f"sqbench.reference.actions.{cfg['action']}")
    return mod.Action(**cfg.get("action_params", {}))


def _divider(dtype, device):
    """IEEE division by (or of) a Python float held as a 0-d tensor."""
    cache = {}

    def div(a, b):
        def full(v):
            if v not in cache:
                cache[v] = torch.full((), v, dtype=dtype, device=device)
            return cache[v]
        return (full(a) if not isinstance(a, torch.Tensor) else a) / (
            full(b) if not isinstance(b, torch.Tensor) else b)
    return div


def _reflect(om, upper):
    om = torch.where(om > upper, 2.0 * upper - om, om)
    return torch.where(om < 0, -om, om)


def _constants(cfg, act):
    f32 = np.float32
    n, dt = cfg["n_sites"], cfg["dt"]
    ghost = cfg.get("ghost_override")
    asym_l, asym_r = ghost if ghost is not None else (act.asymptote(-1), act.asymptote(+1))
    background = cfg["formulation"] == "BACKGROUND"
    return dict(
        dt=float(f32(dt)), inv_dt2=float(f32(act.mass / (dt * dt))),
        c_amp=float(f32(cfg["noise_amp"])),
        zm_c=float(f32(act.zero_mode_const()) * f32(cfg["noise_amp"])),
        clamp=float(f32(cfg["clamp"])), upper=float(f32((n - 1) * dt)),
        asym_l=float(f32(asym_l)), asym_r=float(f32(asym_r)),
        background=background,
        has_zm=background and act.has_zero_mode and cfg["parisi"],
        heun=cfg["scheme"] == "HEUN",
    )


def init_state(cfg: dict, chain_ids: torch.Tensor, dtype=torch.float32) -> State:
    """The cold start from the seed: the field N(0, √(2Δτ)) (step 0), ω at the
    midpoint plus √Δt noise (step 1), reflected; ``lrg_vl`` the initial max |x|."""
    act = action(cfg)
    dev = chain_ids.device
    n, dt = cfg["n_sites"], cfg["dt"]
    rounds = threefry.ROUNDS[cfg["rng_impl"]]
    seed = threefry.u32(int(cfg["seed"]))
    k1 = threefry.chain_key(threefry.INIT, chain_ids)
    sites = torch.arange(n, dtype=torch.int64, device=dev)
    z, _ = threefry.normal_pair(seed, k1[:, None], sites[None, :], 0, rounds)
    f = torch.sqrt(torch.tensor(2.0 * cfg["dtau"], dtype=dtype, device=dev)) * z.to(dtype)
    z_om, _ = threefry.normal_pair(seed, k1, torch.zeros_like(chain_ids), 1, rounds)
    omega = 0.5 * n * dt + math.sqrt(dt) * z_om.to(dtype)
    omega = _reflect(omega, (n - 1) * dt)
    c = chain_ids.shape[0]
    zeros = torch.zeros((c, n), dtype=dtype, device=dev)
    if cfg["formulation"] == "BACKGROUND":
        t_grid = torch.arange(n, dtype=dtype, device=dev) * dt
        x0 = f + act.x_cl(t_grid[None, :], omega[:, None]).to(dtype)
    else:
        x0 = f
    return State(f, omega, zeros, zeros.clone(), zeros.clone(), zeros.clone(),
                 torch.zeros((c, 2), dtype=torch.int64, device=dev),
                 torch.full((c,), cfg["dtau"], dtype=dtype, device=dev),
                 torch.zeros((c,), dtype=torch.int32, device=dev),
                 torch.amax(torch.abs(x0), dim=-1), 2)


class Graphs:
    """CUDA graphs of a frame's micro-steps, one per shape and precision: the
    same PyTorch operations as the eager loop, captured once and replayed, so
    that a frame costs the device's time and not the host's launches.  The
    frame's state and noise are the graph's inputs; what the loop closes over
    (the configuration's constants) is kept alive with it.  The caller creates
    one per configuration and passes it to :func:`frames`; on the CPU the loop
    runs eagerly."""

    def __init__(self):
        self._cache = {}

    def run(self, key, steps, inputs):
        if inputs[0].device.type != "cuda":
            return steps(*inputs)
        if key not in self._cache:
            static = [t.clone() for t in inputs]
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                steps(*static)  # warm-up outside the capture
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                outputs = steps(*static)
            self._cache[key] = (graph, static, outputs, steps)
        graph, static, outputs, _ = self._cache[key]
        for dst, src in zip(static, inputs):
            dst.copy_(src)
        graph.replay()
        return tuple(t.clone() for t in outputs)


def _noise(cfg: dict, chain_ids: torch.Tensor, step: int, dtype, has_zm: bool):
    """The frame's noise: both Box-Muller fields of each pair of micro-steps
    (pairs, C, N), and the collective coordinate's (pairs, C) where it moves."""
    dev = chain_ids.device
    rounds = threefry.ROUNDS[cfg["rng_impl"]]
    seed = threefry.u32(int(cfg["seed"]))
    pairs = -(-cfg["loops"] // 2)
    steps = threefry.u32(step + 2 * torch.arange(pairs, dtype=torch.int64, device=dev))
    k1 = threefry.chain_key(threefry.FIELD, chain_ids)[None, :, None]
    sites = torch.arange(cfg["n_sites"], dtype=torch.int64, device=dev)[None, None, :]
    e0, e1 = threefry.normal_pair(seed, k1, sites, steps[:, None, None], rounds)
    if not has_zm:
        return e0.to(dtype), e1.to(dtype)
    k1_om = threefry.chain_key(threefry.COLLECTIVE, chain_ids)[None, :]
    o0, o1 = threefry.normal_pair(seed, k1_om, torch.zeros_like(k1_om), steps[:, None], rounds)
    return e0.to(dtype), e1.to(dtype), o0.to(dtype), o1.to(dtype)


def _frame_sums(state: State, cfg: dict, act, chain_ids: torch.Tensor, graphs=None):
    """One frame of micro-steps: (f, ω, the four per-site sums stacked, the
    running max |x|, the trip flag)."""
    k = _constants(cfg, act)
    c, n = state.f.shape
    dev, dtype = state.f.device, state.f.dtype
    div = _divider(dtype, dev)
    mid = n // 2
    loops = cfg["loops"]
    background, has_zm, bc = k["background"], k["has_zm"], cfg["bc"]
    t_grid = torch.arange(n, dtype=dtype, device=dev) * k["dt"]
    inv_dt2, clamp, upper = k["inv_dt2"], k["clamp"], k["upper"]
    t_ghost = torch.tensor([-cfg["dt"], n * cfg["dt"]], dtype=dtype, device=dev)
    ghost_l = torch.full((c, 1), k["asym_l"], dtype=dtype, device=dev)
    ghost_r = torch.full((c, 1), k["asym_r"], dtype=dtype, device=dev)
    zero_col = torch.zeros((c, 1), dtype=dtype, device=dev)

    def ghosts(om):
        if bc != "FIXED_BG":
            return (zero_col, zero_col)
        if background:
            g = act.x_cl(t_ghost[None, :], om[:, None]).to(dtype)
            return k["asym_l"] - g[:, 0:1], k["asym_r"] - g[:, 1:2]
        return ghost_l, ghost_r

    def neighbor_sum(ff, gh):
        if bc == "PERIODIC":
            return torch.roll(ff, 1, dims=-1) + torch.roll(ff, -1, dims=-1)
        return torch.cat([ff[:, 1:], gh[1]], dim=-1) + torch.cat([gh[0], ff[:, :-1]], dim=-1)

    def steps(f, om, lrg, dtau_c, e0, e1, o0=None, o1=None):
        dtau = dtau_c[:, None]
        noise_amp = k["c_amp"] * torch.sqrt(div(2.0 * dtau, k["dt"]))
        om_amp = k["zm_c"] * torch.sqrt(2.0 * dtau_c)

        def substep(vals, eta, eta_om):
            f, om, sums, lrg, unstable = vals
            if background:
                bg = act.x_cl(t_grid[None, :], om[:, None]).to(dtype)
                ddv_bg = act.ddV(bg, div).to(dtype)
            gh = None if bc == "PERIODIC" else ghosts(om)

            def drift(ff):
                lap = (neighbor_sum(ff, gh) - 2.0 * ff) * inv_dt2
                if background:
                    return lap - ddv_bg * ff
                return lap - act.dV(ff, div).to(dtype)

            noise = noise_amp * eta
            if k["heun"]:
                f1 = drift(f)
                f_pred = f + dtau * f1 + noise
                det = 0.5 * dtau * (f1 + drift(f_pred))
            else:
                det = drift(f) * dtau
            new_raw = f + det + noise
            finite = torch.isfinite(new_raw)
            newf = torch.where(finite, torch.clamp(new_raw, -clamp, clamp), clamp)
            if bc == "DIRICHLET":
                newf[:, 0] = 0.0
                newf[:, -1] = 0.0
            absdet = torch.where(finite, torch.abs(det), math.inf)
            tripped = torch.amax(absdet, dim=-1) > lrg
            x = f + bg if background else f
            x_new = newf + bg if background else newf
            x2 = x * x
            sums2 = sums + torch.stack([x, x * x[:, mid:mid + 1], x2, x2 * x2])
            lrg2 = torch.maximum(lrg, torch.amax(torch.abs(x_new), dim=-1))
            om2 = _reflect(om + om_amp * eta_om, upper) if has_zm else om
            u = unstable[:, None]
            return (torch.where(u, f, newf), torch.where(unstable, om, om2),
                    torch.where(u[None], sums, sums2), torch.where(unstable, lrg, lrg2),
                    unstable | tripped)

        vals = (f, om, torch.zeros((4, c, n), dtype=dtype, device=dev), lrg,
                torch.zeros((c,), dtype=torch.bool, device=dev))
        for p in range(e0.shape[0]):
            vals = substep(vals, e0[p], o0[p] if has_zm else None)
            if 2 * p + 1 < loops:
                vals = substep(vals, e1[p], o1[p] if has_zm else None)
        return vals

    inputs = (state.f, state.omega, state.lrg_vl, state.dtau,
              *_noise(cfg, chain_ids, state.step, dtype, has_zm))
    if graphs is None:
        return steps(*inputs)
    return graphs.run((c, n, dtype, loops), steps, inputs)


def _runs_after(runs, loops):
    lo = threefry.u32(runs[..., 0] + loops)
    carry = (lo < runs[..., 0]).to(torch.int64)
    hi = threefry.u32(runs[..., 1] + carry)
    return lo, hi, hi.to(torch.float32) * 4294967296.0 + lo.to(torch.float32)


def frame(state: State, cfg: dict, chain_ids: torch.Tensor, graphs=None):
    """One frame and its epilogue: (state', {stable, dtau, max_x}) of the frame;
    ``graphs`` (a :class:`Graphs`) replays the micro-steps on the card."""
    act = action(cfg)
    dtype = state.f.dtype
    div = _divider(dtype, state.f.device)
    f, om, sums, lrg, unstable = _frame_sums(state, cfg, act, chain_ids, graphs)
    loops = cfg["loops"]
    accept = ~unstable
    a1 = accept[:, None]
    lo, hi, total = _runs_after(state.runs, loops)
    n_new = total.to(dtype)[:, None]
    w = div(float(loops), n_new)

    def merged(mean, frame_sum):
        return torch.where(a1, mean + (frame_sum * (1.0 / float(loops)) - mean) * w, mean)

    grow_after = cfg["grow_after"]
    grow = accept & (state.stab_cnt >= grow_after)
    dtau = torch.where(grow, div(state.dtau, cfg["shrink"]),
                       torch.where(accept, state.dtau, state.dtau * cfg["shrink"]))
    if cfg.get("dtau_max") is not None:
        dtau = torch.clamp(dtau, max=float(np.float32(cfg["dtau_max"])))
    stab = torch.where(accept, torch.where(state.stab_cnt >= grow_after, 0, state.stab_cnt + 1),
                       0).to(torch.int32)
    lrg_vl = torch.where(accept, lrg, state.lrg_vl)
    new = State(
        f=torch.where(a1, f, state.f),
        omega=torch.where(accept, om, state.omega),
        x_mean=merged(state.x_mean, sums[0]),
        xx0_mean=merged(state.xx0_mean, sums[1]),
        x2_mean=merged(state.x2_mean, sums[2]),
        x4_mean=merged(state.x4_mean, sums[3]),
        runs=torch.where(accept[:, None], torch.stack([lo, hi], dim=-1), state.runs),
        dtau=dtau, stab_cnt=stab, lrg_vl=lrg_vl,
        step=threefry.u32(state.step + loops),
    )
    return new, {"stable": accept, "dtau": dtau, "max_x": lrg_vl}


def frames(state: State, cfg: dict, chain_ids: torch.Tensor, n: int, graphs=None):
    """``n`` frames: (state', metrics stacked over frames, each (n, C))."""
    per = []
    for _ in range(n):
        state, m = frame(state, cfg, chain_ids, graphs)
        per.append(m)
    return state, {key: torch.stack([m[key] for m in per]) for key in per[0]}


def reset_means(state: State) -> State:
    """The running observables zeroed, as after the burn-in."""
    z = torch.zeros_like(state.x_mean)
    return state._replace(x_mean=z, xx0_mean=z.clone(), x2_mean=z.clone(), x4_mean=z.clone(),
                          runs=torch.zeros_like(state.runs))


def connected_correlator(x_mean, xx0_mean):
    """C_i = ⟨x_i·x_mid⟩ − ⟨x_i⟩·⟨x_mid⟩ per chain."""
    mid = x_mean.shape[-1] // 2
    return xx0_mean - x_mean * x_mean[:, mid:mid + 1]

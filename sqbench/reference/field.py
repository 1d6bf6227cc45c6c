"""The plain reference of a field cell: Langevin chains of a periodic 2-D λφ⁴
lattice in plain PyTorch, written from the semantics the port states (its
plain integrator's expressions, ``integrators/field.py``, frozen here) and
importing nothing of the program.

A frame is ``loops`` Euler-Maruyama micro-steps of every chain on a
synchronous (SYNC) sweep:

    φ ← clamp(φ + Δτ·(∇²φ − V′(φ)) + c·√(2Δτ/a^D)·η)

with the detector that freezes a chain whose largest drift step outgrows its
running max |φ| (or whose update is not finite), and the frame sums of the
pre-update field each micro-step: M, M², M⁴, |M|, ⟨φ²⟩, the action density
and the slice correlator s̄(t)·s̄(0).  The epilogue accepts or rejects the
frame, folds its sums into the running means and adapts Δτ.  Noise is
Threefry-2x32 keyed by (seed, stream FIELD ^ chain << 8) at counter (site,
micro-step), one evaluation serving two micro-steps, so any subset of the
chains can be followed on its own: ``chain_ids`` names the rows a state holds.

Where it departs from the port:

* the frame sums are plain ``torch.mean`` over the lattice; the kernels sum
  in their own order (a block's rows, then the cluster's blocks), so the
  sums and the running means agree to float32 rounding, not bit for bit
  (kernels 3 and 4 read 2e-7 to 3e-7 of each leaf's magnitude on an H100);
  the site update takes the same expressions, each rounded on its own (the
  kernels are built without contraction into fused multiply-adds);
* only what the field cells run: a 2-D lattice, SYNC sweep, the EM scheme,
  Threefry noise; the checkerboard sweep, ``Scheme.EXACT``, Philox and
  lattices split over a mesh are left out.

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
from sqbench.reference.chain import Graphs, _divider, _runs_after

__all__ = ["EXACT_LEAVES", "FLOAT_LEAVES", "Graphs", "OBSERVABLES", "State", "frames",
           "init_state", "observables", "reset_means"]

#: float leaves compared by their gap; the integer ones and ``dtau`` exactly
FLOAT_LEAVES = ("phi", "mag_mean", "mag2_mean", "mag4_mean", "absmag_mean", "phi2_mean",
                "act_mean", "corr_mean", "lrg_vl")
EXACT_LEAVES = ("runs", "dtau", "stab_cnt")
#: the observables a record streams, in its order
OBSERVABLES = ("mag", "abs_mag", "phi2", "susceptibility", "binder")


class State(NamedTuple):
    phi: torch.Tensor          # (C, L0, L1)
    mag_mean: torch.Tensor     # (C,) running ⟨M⟩
    mag2_mean: torch.Tensor    # (C,) running ⟨M²⟩
    mag4_mean: torch.Tensor    # (C,) running ⟨M⁴⟩
    absmag_mean: torch.Tensor  # (C,) running ⟨|M|⟩
    phi2_mean: torch.Tensor    # (C,) running ⟨φ²⟩
    act_mean: torch.Tensor     # (C,) running ⟨s⟩
    corr_mean: torch.Tensor    # (C, L0) running ⟨s̄(t)·s̄(0)⟩
    runs: torch.Tensor         # (C, 2) int64 (lo, hi) uint32 words of the sample count
    dtau: torch.Tensor         # (C,)
    stab_cnt: torch.Tensor     # (C,) int32
    lrg_vl: torch.Tensor       # (C,) running max |φ|
    step: int                  # micro-step counter (uint32)


_MEANS = ("mag_mean", "mag2_mean", "mag4_mean", "absmag_mean", "phi2_mean", "act_mean")


def action(cfg: dict):
    """The action named by ``cfg["action"]``: ``reference/actions/<name>.py``."""
    mod = importlib.import_module(f"sqbench.reference.actions.{cfg['action']}")
    return mod.Action(**cfg.get("action_params", {}))


def _check(cfg: dict) -> None:
    if len(cfg["shape"]) != 2 or cfg["sweep"] != "SYNC" or cfg["scheme"] != "EM":
        raise ValueError("the field reference runs 2-D lattices on the SYNC sweep and the EM "
                         f"scheme, not shape {cfg['shape']}, {cfg['sweep']}, {cfg['scheme']}")


def _sites(cfg: dict, device) -> torch.Tensor:
    """(L0, L1) global site ids in C order."""
    L0, L1 = cfg["shape"]
    return torch.arange(L0 * L1, dtype=torch.int64, device=device).reshape(L0, L1)


def init_state(cfg: dict, chain_ids: torch.Tensor, dtype=torch.float32) -> State:
    """The cold start from the seed: φ = √(2Δτ)·N(0, 1) from the INIT stream
    at micro-step 0, the running means zero, ``lrg_vl`` the initial max |φ|,
    ``step`` 1."""
    _check(cfg)
    dev = chain_ids.device
    rounds = threefry.ROUNDS[cfg["rng_impl"]]
    seed = threefry.u32(int(cfg["seed"]))
    k1 = threefry.chain_key(threefry.INIT, chain_ids)[:, None, None]
    z, _ = threefry.normal_pair(seed, k1, _sites(cfg, dev)[None], 0, rounds)
    phi = torch.sqrt(torch.tensor(2.0 * cfg["dtau"], dtype=dtype, device=dev)) * z.to(dtype)
    c, L0 = chain_ids.shape[0], cfg["shape"][0]
    zc = torch.zeros((c,), dtype=dtype, device=dev)
    return State(phi, zc, zc.clone(), zc.clone(), zc.clone(), zc.clone(), zc.clone(),
                 torch.zeros((c, L0), dtype=dtype, device=dev),
                 torch.zeros((c, 2), dtype=torch.int64, device=dev),
                 torch.full((c,), cfg["dtau"], dtype=dtype, device=dev),
                 torch.zeros((c,), dtype=torch.int32, device=dev),
                 torch.amax(torch.abs(phi), dim=(1, 2)), 1)


def _noise(cfg: dict, chain_ids: torch.Tensor, step: int, dtype):
    """The frame's noise: both Box-Muller fields of each pair of micro-steps,
    each (pairs, C, L0, L1)."""
    dev = chain_ids.device
    rounds = threefry.ROUNDS[cfg["rng_impl"]]
    seed = threefry.u32(int(cfg["seed"]))
    pairs = -(-cfg["loops"] // 2)
    steps = threefry.u32(step + 2 * torch.arange(pairs, dtype=torch.int64, device=dev))
    k1 = threefry.chain_key(threefry.FIELD, chain_ids)[None, :, None, None]
    sites = _sites(cfg, dev)[None, None]
    e0, e1 = threefry.normal_pair(seed, k1, sites, steps[:, None, None, None], rounds)
    return e0.to(dtype), e1.to(dtype)


def _frame_sums(state: State, cfg: dict, act, chain_ids: torch.Tensor, graphs=None):
    """One frame of micro-steps: (φ, the six chain sums stacked (6, C), the
    slice correlator's sum (C, L0), the trip flag, the running max |φ|)."""
    c, L0, L1 = state.phi.shape
    dev, dtype = state.phi.device, state.phi.dtype
    div = _divider(dtype, dev)
    a, ndim, lat = float(cfg["spacing"]), 2, (1, 2)
    measure = a ** ndim
    clamp = float(np.float32(cfg["clamp"]))
    c_amp = float(np.float32(cfg["noise_amp"]))
    loops = cfg["loops"]

    def steps(phi, lrg, dtau_c, e0, e1):
        dtau = dtau_c.reshape(c, 1, 1)
        namp = (c_amp * torch.sqrt(div(2.0 * dtau_c, measure))).reshape(c, 1, 1)

        def micro_step(vals, eta):
            phi, sums, cs, unstable, lrg = vals
            det = act.drift(phi, a, ndim).to(dtype) * dtau
            new_raw = phi + det + namp * eta
            finite = torch.isfinite(new_raw)
            newphi = torch.where(finite, torch.clamp(new_raw, -clamp, clamp), clamp)
            max_det = torch.amax(torch.abs(det), dim=lat)
            bad = ~torch.all(finite.reshape(c, -1), dim=1)
            tripped = (max_det > lrg) | bad
            # observables sample the pre-update field
            mag = torch.mean(phi, dim=lat)
            phi2 = torch.mean(phi * phi, dim=lat)
            act_d = torch.mean(act.action_density(phi, a, ndim).to(dtype), dim=lat)
            s_slice = torch.mean(phi, dim=(2,))
            corr = s_slice * s_slice[:, :1]
            mag2 = mag * mag
            sums2 = sums + torch.stack([mag, mag2, mag2 * mag2, torch.abs(mag), phi2, act_d])
            return (torch.where(unstable.reshape(c, 1, 1), phi, newphi),
                    torch.where(unstable[None], sums, sums2),
                    torch.where(unstable[:, None], cs, cs + corr),
                    unstable | tripped,
                    torch.where(unstable, lrg,
                                torch.maximum(lrg, torch.amax(torch.abs(newphi), dim=lat))))

        vals = (phi, torch.zeros((6, c), dtype=dtype, device=dev),
                torch.zeros((c, L0), dtype=dtype, device=dev),
                torch.zeros((c,), dtype=torch.bool, device=dev), lrg)
        for p in range(e0.shape[0]):
            vals = micro_step(vals, e0[p])
            if 2 * p + 1 < loops:
                vals = micro_step(vals, e1[p])
        return vals

    inputs = (state.phi, state.lrg_vl, state.dtau,
              *_noise(cfg, chain_ids, state.step, dtype))
    if graphs is None:
        return steps(*inputs)
    return graphs.run(("field", c, L0, L1, dtype, loops), steps, inputs)


def frame(state: State, cfg: dict, chain_ids: torch.Tensor, graphs=None):
    """One frame and its epilogue: (state', {stable, dtau, max_phi}) of the
    frame; ``graphs`` (a :class:`Graphs`) replays the micro-steps on the card."""
    act = action(cfg)
    dtype = state.phi.dtype
    div = _divider(dtype, state.phi.device)
    phi, sums, cs, unstable, lrg = _frame_sums(state, cfg, act, chain_ids, graphs)
    loops = cfg["loops"]
    accept = ~unstable
    lo, hi, total = _runs_after(state.runs, loops)
    n_new = total.to(dtype)
    w = div(float(loops), n_new)

    def merged(mean, frame_sum, w, a):
        return torch.where(a, mean + (frame_sum * (1.0 / float(loops)) - mean) * w, mean)

    means = {k: merged(getattr(state, k), sums[i], w, accept) for i, k in enumerate(_MEANS)}
    corr_mean = merged(state.corr_mean, cs, div(float(loops), n_new[:, None]), accept[:, None])
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
        phi=torch.where(accept[:, None, None], phi, state.phi), **means, corr_mean=corr_mean,
        runs=torch.where(accept[:, None], torch.stack([lo, hi], dim=-1), state.runs),
        dtau=dtau, stab_cnt=stab, lrg_vl=lrg_vl, step=threefry.u32(state.step + loops),
    )
    return new, {"stable": accept, "dtau": dtau, "max_phi": lrg_vl}


def frames(state: State, cfg: dict, chain_ids: torch.Tensor, n: int, graphs=None):
    """``n`` frames: (state', metrics stacked over frames, each (n, C))."""
    _check(cfg)
    per = []
    for _ in range(n):
        state, m = frame(state, cfg, chain_ids, graphs)
        per.append(m)
    return state, {key: torch.stack([m[key] for m in per]) for key in per[0]}


def reset_means(state: State) -> State:
    """The running observables zeroed, as after the burn-in."""
    zc = torch.zeros_like(state.mag_mean)
    return state._replace(**{k: zc.clone() for k in _MEANS},
                          corr_mean=torch.zeros_like(state.corr_mean),
                          runs=torch.zeros_like(state.runs))


def observables(means: dict, volume: int) -> dict:
    """Each chain's record observables from its running means (tensors of
    one precision): ⟨M⟩, ⟨|M|⟩, ⟨φ²⟩, χ = V·(⟨M²⟩ − ⟨|M|⟩²) and the Binder
    cumulant U = 1 − ⟨M⁴⟩/(3⟨M²⟩²), its denominator floored at the
    precision's smallest normal."""
    m2 = means["mag2_mean"]
    am = means["absmag_mean"]
    floor = torch.finfo(m2.dtype).tiny
    return {"mag": means["mag_mean"], "abs_mag": am, "phi2": means["phi2_mean"],
            "susceptibility": volume * (m2 - am * am),
            "binder": 1.0 - means["mag4_mean"] / torch.clamp(3.0 * m2 * m2, min=floor)}


def volume(cfg: dict) -> int:
    return math.prod(cfg["shape"])

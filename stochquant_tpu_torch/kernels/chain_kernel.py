"""Hand-written CUDA kernels for batched 1-D Langevin chains, their plain
PyTorch versions, and the frame loop around them.

Port of ``stochquant_tpu/kernels/chain_kernel.py``:

* kernel 1, :func:`chain_frame` — one frame of ``cfg.loops`` micro-steps
  returning the frame sums (``_build_frame_kernel``); the accept/reject
  epilogue runs outside in PyTorch (``langevin.frame_epilogue``).
  Plain version: :func:`chain_frame_ref`.
* kernel 2, :func:`chain_frames_multi` — K frames per launch with the
  epilogue in-kernel (``_build_multiframe_kernel``).
  Plain version: :func:`chain_frames_multi_ref`.

Both are CUDA C++ for ``sm_90a`` (``csrc/chain_kernel.cu``), built by
``_build`` at first use.  A wrapper given CPU tensors runs its plain version;
given CUDA tensors it launches its kernel on PyTorch's current stream, or
raises — it never falls back.  Each wrapper counts its kernel launches in a
plain integer attribute, ``chain_frame.launches`` and
``chain_frames_multi.launches``; launches of the Philox variant
(``rng_impl='hardware'``) are counted on their own as well, in
``chain_frame.launches_hw`` and ``chain_frames_multi.launches_hw``.

``rng_impl='hardware'`` selects each kernel's Philox-4x32-10 variant — the
counterpart of the Pallas kernels' on-core generator branch — and, on CPU
tensors, the plain versions' Philox stream; see ``csrc/chain_kernel.cu`` for
the keying.  The kernels run ``Scheme.EM`` and ``Scheme.HEUN`` without the
power-spectrum channel; the wrappers raise for anything else.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from stochquant_tpu_torch import rng
from stochquant_tpu_torch.actions.base import QMAction
from stochquant_tpu_torch.actions.quantum_mechanics import (
    AnharmonicOscillator,
    DoubleWell,
    HarmonicOscillator,
    PoeschlTeller,
)
from stochquant_tpu_torch.config import ChainConfig
from stochquant_tpu_torch.integrators import langevin
from stochquant_tpu_torch.integrators.langevin import ChainState, FrameSums
from stochquant_tpu_torch.kernels import _build

__all__ = [
    "chain_frame",
    "chain_frame_ref",
    "chain_frames_multi",
    "chain_frames_multi_ref",
    "run_frames_kernel",
    "launch_geometry",
]

MAX_SITES = 4096     # the largest chain the kernels take
MAX_WARPS = 32       # SQ_MAX_WARPS in csrc/chain_kernel.cu: G warps a chain
MAX_SITES_PER_LANE = 7  # SQ_MAX_SPL: the instantiated S are 1 .. 7
SMS = 132            # streaming multiprocessors of an H100 SXM


def max_threads(spl: int) -> int:
    """Threads a block may hold at ``spl`` sites a lane (SQ_MAX_THREADS): the
    kernels' register budget, 65,536 / threads, grows with S."""
    return 1024 if spl <= 2 else 768 if spl <= 4 else 640


def _registers(spl: int) -> int:
    """Registers a thread takes at ``spl`` sites a lane: the whole budget of
    ``max_threads`` (ptxas fills it at every S > 1), in units of 8."""
    return 65536 // max_threads(spl) // 8 * 8


def _layout(n_sites: int, n_chains: int, spl: int):
    """((waves x S), (G, S, chains per block)) of a layout at S sites a lane,
    or None where a block cannot hold the chain."""
    warps = -(-(n_sites + 1) // (32 * spl))
    if warps > MAX_WARPS or 32 * warps > max_threads(spl) or (spl == 1 and warps > 1):
        return None
    cpb = min(4, max(1, n_chains // SMS)) if warps == 1 else 1
    threads = 32 * warps * cpb
    per_sm = min(32, 64 // (warps * cpb), 65536 // (threads * _registers(spl)))
    waves = -(-n_chains // (SMS * per_sm * cpb))
    return waves * spl, (warps, spl, cpb)


def launch_geometry(n_sites: int, n_chains: int = 1):
    """(G, S, chains per block) for ``n_chains`` chains of ``n_sites``.

    A chain lives in G warps and each lane holds S contiguous sites, with room
    for one slot more than the chain's sites (32 G S >= N + 1): slot N draws
    the collective coordinate's noise.  G = 1 puts up to 4 chains in a block
    (fewer when there are too few chains to give every SM a block), G > 1 one
    chain.  S is the one that needs the fewest waves of resident blocks times
    S, the serial site-updates a lane makes per micro-step (ties: the smaller
    S); residency follows from the registers each S is given (``_registers``).
    Timed on an H100 (PERF.md §6): at the headline (200 sites, 65,536
    chains) S = 2 in G = 4 warps beat one warp of S = 7; at config 2 (1024
    sites, 256 chains) S = 3 in 11 warps beat 17 warps of S = 2, which leave
    half the chains for a second wave."""
    if not 2 <= n_sites <= MAX_SITES:
        raise ValueError(f"n_sites={n_sites} is outside the CUDA chain kernels' limit of "
                         f"2 .. {MAX_SITES} sites")
    fits = [f for f in (_layout(n_sites, max(n_chains, 1), spl)
                        for spl in range(1, MAX_SITES_PER_LANE + 1)) if f]
    return min(fits, key=lambda f: (f[0], f[1][1]))[1]


def _action_constants(action: QMAction):
    """(action code, p0..p3, kink w, kink η) for the kernel, with the float32
    constants folded as the JAX actions fold their Python floats."""
    f32 = np.float32
    if type(action) is HarmonicOscillator:
        return 0, (f32(action.k), 0, 0, 0), 0, 0
    if type(action) is DoubleWell:
        e2 = action.eta * action.eta
        w = np.sqrt(2.0 * action.v0 / action.mass) / action.eta
        consts = (f32(4.0 * action.v0), f32(12.0 * action.v0), f32(e2), f32(e2 * e2))
        return 1, consts, f32(w), f32(action.eta)
    if type(action) is AnharmonicOscillator:
        return 2, (f32(action.mu2), f32(4.0 * action.lam), f32(12.0 * action.lam), 0), 0, 0
    if type(action) is PoeschlTeller:
        a = action.a
        consts = (0, f32(a), f32(2.0 * action.v0 / a), f32(2.0 * action.v0 / (a * a)))
        return 3, consts, 0, 0
    raise ValueError(
        f"the CUDA chain kernel implements harmonic, double_well, anharmonic "
        f"and poeschl_teller, not {type(action).__name__}"
    )


def _params(state: ChainState, action: QMAction, cfg: ChainConfig,
            chain_offset: int, n_frames: int):
    C, N = state.f.shape
    warps, spl, cpb = launch_geometry(N, C)
    k = langevin.frame_constants(action, cfg)
    code, (p0, p1, p2, p3), w, eta = _action_constants(action)
    f32 = np.float32
    return _build.ChainParams(
        n_chains=C, n_sites=N, warps_per_chain=warps, sites_per_lane=spl,
        chains_per_block=cpb,
        rounds=rng.rounds_of(cfg.rng_impl), philox=int(_philox(cfg)), loops=cfg.loops,
        n_frames=n_frames,
        seed=rng.u32(cfg.seed), step0=rng.u32(int(state.step)),
        chain0=rng.u32(chain_offset), bc=int(cfg.bc),
        background=int(k["background"]), has_zm=int(k["has_zm"]),
        heun=int(k["heun"]), action=code, grow_after=min(cfg.grow_after, 2**31 - 1),
        has_dtau_max=int(cfg.dtau_max is not None),
        p0=p0, p1=p1, p2=p2, p3=p3, xcl_w=w, xcl_eta=eta,
        dt=k["dt"], inv_dt2=k["inv_dt2"], c_amp=k["c_amp"], zm_c=k["zm_c"],
        clamp=k["clamp"], upper=k["upper"], asym_l=k["asym_l"], asym_r=k["asym_r"],
        t_right=f32(N * cfg.dt), shrink=f32(cfg.shrink),
        dtau_max=f32(cfg.dtau_max if cfg.dtau_max is not None else 0.0),
        inv_loops=f32(1.0 / cfg.loops), loops_f=f32(cfg.loops),
    )


def _philox(cfg: ChainConfig) -> bool:
    """True when the kernels (and their plain versions) draw Philox noise."""
    return cfg.rng_impl == "hardware"


def check_kernel_config(cfg: ChainConfig) -> None:
    """Raise for what the chain kernels (and their plain versions, which keep
    the kernels' contract) do not take."""
    reason = langevin.plain_path_only(cfg)
    if reason:
        raise ValueError(f"the chain kernels cannot run this config: {reason}; "
                         "use langevin.run_frames (backend='torch')")


def _check_cuda_inputs(state: ChainState) -> None:
    C, N = state.f.shape
    _build.check_leaves(state, {
        "f": ((C, N), torch.float32), "omega": ((C,), torch.float32),
        "x_mean": ((C, N), torch.float32), "xx0_mean": ((C, N), torch.float32),
        "x2_mean": ((C, N), torch.float32), "x4_mean": ((C, N), torch.float32),
        "runs": ((C, 2), torch.int64), "dtau": ((C,), torch.float32),
        "stab_cnt": ((C,), torch.int32), "lrg_vl": ((C,), torch.float32),
    }, state.f.device)


def _route(state: ChainState) -> bool:
    """True to launch the CUDA kernel, False to run the plain version."""
    dev = state.f.device
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"chain kernels run on 'cuda' or 'cpu' tensors, not {dev}")
    _check_cuda_inputs(state)
    return True


# ---------------------------------------------------------------------------
# kernel 1: one frame → frame sums
# ---------------------------------------------------------------------------


def chain_frame_ref(state: ChainState, action: QMAction, cfg: ChainConfig,
                    chain_offset: int = 0) -> FrameSums:
    """Plain PyTorch version of kernel 1."""
    check_kernel_config(cfg)
    return langevin.frame_sums(state, action, cfg, chain_offset, philox=_philox(cfg))


def chain_frame(state: ChainState, action: QMAction, cfg: ChainConfig,
                chain_offset: int = 0) -> FrameSums:
    """Kernel 1: one frame of ``cfg.loops`` micro-steps for the chains of
    ``state`` (global ids ``chain_offset …``); returns the frame sums."""
    check_kernel_config(cfg)
    if not _route(state):
        return chain_frame_ref(state, action, cfg, chain_offset)
    params = _params(state, action, cfg, chain_offset, 1)
    C, N = state.f.shape
    dev = state.f.device
    out = FrameSums(
        f=torch.empty((C, N), dtype=torch.float32, device=dev),
        omega=torch.empty((C,), dtype=torch.float32, device=dev),
        xs=torch.empty((C, N), dtype=torch.float32, device=dev),
        xxs=torch.empty((C, N), dtype=torch.float32, device=dev),
        x2s=torch.empty((C, N), dtype=torch.float32, device=dev),
        x4s=torch.empty((C, N), dtype=torch.float32, device=dev),
        lrg_vl=torch.empty((C,), dtype=torch.float32, device=dev),
        unstable=torch.empty((C,), dtype=torch.int32, device=dev),
    )
    _build.launch("sq_chain_frame", params,
                  (state.f, state.omega, state.lrg_vl, state.dtau, *out[:8]), dev)
    chain_frame.launches += 1
    chain_frame.launches_hw += _philox(cfg)
    return out._replace(unstable=out.unstable != 0)


chain_frame.launches = 0
chain_frame.launches_hw = 0


# ---------------------------------------------------------------------------
# kernel 2: K frames per launch, epilogue in-kernel
# ---------------------------------------------------------------------------


def chain_frames_multi_ref(state: ChainState, action: QMAction, cfg: ChainConfig,
                           K: int, chain_offset: int = 0):
    """Plain PyTorch version of kernel 2: K × (frame sums + epilogue).
    Returns (state, metrics) with metrics of shape (K, C)."""
    per_frame = []
    for _ in range(K):
        state, m = langevin.frame_epilogue(
            state, chain_frame_ref(state, action, cfg, chain_offset), cfg
        )
        per_frame.append(m)
    return state, langevin.stack_metrics(per_frame)


def chain_frames_multi(state: ChainState, action: QMAction, cfg: ChainConfig,
                       K: int, chain_offset: int = 0):
    """Kernel 2: K frames in one launch, with accept/reject, running-mean
    merge, the (lo, hi) count carry and adaptive Δτ in-kernel.  Per-frame
    results equal K launches of kernel 1 plus the PyTorch epilogue.
    Returns (state, metrics) with metrics of shape (K, C)."""
    check_kernel_config(cfg)
    if K < 1:
        raise ValueError(f"frames per launch must be >= 1, got {K}")
    if not _route(state):
        return chain_frames_multi_ref(state, action, cfg, K, chain_offset)
    params = _params(state, action, cfg, chain_offset, K)
    C, N = state.f.shape
    dev = state.f.device
    empty = lambda shape, dtype=torch.float32: torch.empty(shape, dtype=dtype, device=dev)
    new = ChainState(
        f=empty((C, N)), omega=empty((C,)), x_mean=empty((C, N)),
        xx0_mean=empty((C, N)), x2_mean=empty((C, N)), x4_mean=empty((C, N)),
        runs=empty((C, 2), torch.int64), dtau=empty((C,)),
        stab_cnt=empty((C,), torch.int32), lrg_vl=empty((C,)),
        spec_mean=state.spec_mean,
        step=langevin.host_step(int(state.step) + cfg.loops * K),
    )
    hist_stable = empty((K, C), torch.int32)
    hist_dtau = empty((K, C))
    hist_lrg = empty((K, C))
    _build.launch(
        "sq_chain_frames", params,
        (
            state.f, state.omega, state.lrg_vl, state.dtau, state.x_mean,
            state.xx0_mean, state.x2_mean, state.x4_mean, state.runs, state.stab_cnt,
            new.f, new.omega, new.lrg_vl, new.dtau, new.x_mean, new.xx0_mean,
            new.x2_mean, new.x4_mean, new.runs, new.stab_cnt,
            hist_stable, hist_dtau, hist_lrg,
        ),
        dev,
    )
    chain_frames_multi.launches += 1
    chain_frames_multi.launches_hw += _philox(cfg)
    return new, {"stable": hist_stable != 0, "dtau": hist_dtau, "max_x": hist_lrg}


chain_frames_multi.launches = 0
chain_frames_multi.launches_hw = 0


# ---------------------------------------------------------------------------
# frame loop
# ---------------------------------------------------------------------------


def run_frames_kernel(state: ChainState, action: QMAction, cfg: ChainConfig,
                      n_frames: int, *, frames_per_launch: int = 1,
                      block_chains: Optional[int] = None, chain_offset: int = 0):
    """``n_frames`` frames through the chain kernels — the counterpart of
    ``stochquant_tpu.kernels.chain_kernel.run_frames_pallas``.

    ``frames_per_launch`` K > 1 runs groups of K frames through kernel 2
    (epilogue in-kernel) and the remainder through kernel 1; per-frame
    results are the same either way.  The rows of ``state`` are the global
    chains ``chain_offset …`` (a shard of a chain mesh, or a process's part of
    the chains), whose noise streams they draw.  ``block_chains`` (the Pallas
    kernels' chains per VMEM block; 0 = autotune there) is accepted and
    ignored: one launch covers every chain (``launch_geometry`` lays them
    out), and noise is keyed by global chain id, so no blocking could change
    the results.  Returns (state, metrics) with metrics of shape
    (n_frames, C).
    """
    check_kernel_config(cfg)
    K = max(frames_per_launch, 1)
    per_group = []
    done = 0
    while done < n_frames:
        if K > 1 and n_frames - done >= K:
            state, m = chain_frames_multi(state, action, cfg, K, chain_offset)
            done += K
        else:
            state, m = langevin.frame_epilogue(
                state, chain_frame(state, action, cfg, chain_offset), cfg)
            m = {k: v[None] for k, v in m.items()}
            done += 1
        per_group.append(m)
    if not per_group:
        return state, {}
    return state, {k: torch.cat([m[k] for m in per_group]) for k in per_group[0]}

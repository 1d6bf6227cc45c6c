"""Hand-written CUDA kernels for 2-D compact Wilson gauge frames, their plain
PyTorch versions, and the frame loop around them.

Port of ``stochquant_tpu/kernels/gauge_kernel.py``:

* kernel 10, :func:`gauge_frame` — one frame of ``cfg.loops`` micro-steps
  per chain (``_frame_call_g``), followed by the PyTorch epilogue
  (``integrators.gauge.gauge_frame_epilogue``).  Plain version:
  :func:`gauge_frame_ref`.
* kernel 11, :func:`gauge_frames_multi` — K frames per launch with the
  epilogue in-kernel (``_multiframe_call``).  Plain version:
  :func:`gauge_frames_multi_ref`.

Both are CUDA C++ for ``sm_90a`` (``csrc/gauge_kernel.cu``), built by
``_build`` at first use, for U(1), SU(2) and SU(3) Wilson actions on 2-D
lattices without cooling (:func:`supports`, the JAX package's rule).  The
kernels hold a chain's links as float32 planes (C, P, L0, L1): P = 2 for
U(1) (direction μ), 8 for SU(2) (plane 2c + μ for quaternion component c)
and 36 for SU(3) (plane 18μ + 2(3r + c) + {re, im}), the state layout of the
first two and a transposition of SU(3)'s complex64 matrices.

A wrapper given CPU tensors runs its plain version; given CUDA tensors it
launches its kernel on PyTorch's current stream, or raises — it never falls
back.  Each wrapper counts its kernel launches in a plain integer
attribute, ``gauge_frame.launches`` and ``gauge_frames_multi.launches``.

Metrics follow the JAX package's XLA frame on every path: a frame's
``drift_max`` metric is the frame's running max even when the frame is
rejected (the JAX package's kernel 11 records the restored state value
there instead).
"""

from __future__ import annotations

import numpy as np
import torch

from stochquant_tpu_torch import rng
from stochquant_tpu_torch.actions.gauge import SU2Wilson, SU3Wilson, U1Wilson
from stochquant_tpu_torch.integrators import gauge as gauge_mod
from stochquant_tpu_torch.integrators.gauge import GaugeConfig, GaugeFrameSums, GaugeState
from stochquant_tpu_torch.integrators.langevin import host_step
from stochquant_tpu_torch.kernels import _build

__all__ = [
    "supports",
    "unsupported_reason",
    "gauge_frame",
    "gauge_frame_ref",
    "gauge_frames_multi",
    "gauge_frames_multi_ref",
    "run_gauge_frames_kernel",
    "links_to_planes",
    "planes_to_links",
]

# action class -> (group code of the CUDA source, link planes, noise planes, force planes)
_GROUPS = {U1Wilson: (0, 2, 2, 2), SU2Wilson: (1, 8, 6, 6), SU3Wilson: (2, 36, 16, 36)}


def unsupported_reason(action, cfg: GaugeConfig):
    """Why kernels 10 and 11 (and their plain versions, which keep the
    kernels' contract) do not take this case, or None: they cover compact
    U(1), SU(2) and SU(3) on 2-D lattices without gauge cooling."""
    if type(action) not in _GROUPS:
        return f"the gauge kernels implement u1, su2 and su3, not {type(action).__name__}"
    if cfg.ndim != 2:
        return (f"the gauge kernels take 2-D lattices, not shape {cfg.shape} (the JAX package "
                "has no kernel for D >= 3 either; backend='torch' runs the plain integrator)")
    if cfg.cooling_rate > 0.0:
        return "the gauge kernels do not run gauge cooling (cooling_rate > 0)"
    return None


def supports(action, cfg: GaugeConfig) -> bool:
    return unsupported_reason(action, cfg) is None


def check_kernel_config(action, cfg: GaugeConfig) -> None:
    """Raise, naming the case, where :func:`supports` is false."""
    reason = unsupported_reason(action, cfg)
    if reason is not None:
        raise ValueError(reason)


def links_to_planes(links: torch.Tensor, action) -> torch.Tensor:
    """State links → the kernels' contiguous float32 (C, P, L0, L1) planes."""
    C, P = links.shape[0], _GROUPS[type(action)][1]
    L0, L1 = links.shape[2:4] if isinstance(action, SU3Wilson) else links.shape[-2:]
    if isinstance(action, SU3Wilson):
        planes = torch.view_as_real(links).permute(0, 1, 4, 5, 6, 2, 3)
        return planes.reshape(C, P, L0, L1).contiguous()
    return links.reshape(C, P, L0, L1).contiguous()


def planes_to_links(planes: torch.Tensor, action) -> torch.Tensor:
    """Inverse of :func:`links_to_planes`."""
    C, _, L0, L1 = planes.shape
    if isinstance(action, SU3Wilson):
        p = planes.reshape(C, 2, 3, 3, 2, L0, L1).permute(0, 1, 5, 6, 2, 3, 4).contiguous()
        return torch.view_as_complex(p)
    if isinstance(action, SU2Wilson):
        return planes.reshape(C, 4, 2, L0, L1)
    return planes.reshape(C, 2, L0, L1)


def kernel_params(action, cfg: GaugeConfig, *, step0: int,
                  n_frames: int = 1) -> "_build.GaugeParams":
    """The ``GaugeParams`` struct of one launch; constants fold as the plain
    version folds its Python floats, then round once to float32."""
    check_kernel_config(action, cfg)
    f32 = np.float32
    group = _GROUPS[type(action)][0]
    coef = (-action.beta, -0.5 * action.beta, action.beta / (4.0 * 3))[group]
    L0, L1 = cfg.shape
    return _build.GaugeParams(
        n_chains=cfg.n_chains, L0=L0, L1=L1, group=group, loops=cfg.loops, n_frames=n_frames,
        grow_after=min(cfg.grow_after, 2**31 - 1), has_dtau_max=int(cfg.dtau_max is not None),
        seed=rng.u32(cfg.seed), step0=rng.u32(int(step0)),
        coef=f32(coef), cap=f32(cfg.drift_cap), clip_hi=f32(1.0 - 1e-6),
        inv_vol=f32(1.0 / (L0 * L1)), shrink=f32(cfg.shrink),
        dtau_max=f32(cfg.dtau_max if cfg.dtau_max is not None else 0.0),
        inv_loops=f32(1.0 / cfg.loops), loops_f=f32(cfg.loops),
    )


def check_cuda_state(state: GaugeState, action, cfg: GaugeConfig) -> None:
    """Device, dtype, shape and contiguity of every leaf a kernel reads."""
    C = cfg.n_chains
    link_dtype = torch.complex64 if isinstance(action, SU3Wilson) else torch.float32
    want = {name: ((C,), torch.float32) for name in ("plaq_mean", "drift_max", "dtau")}
    want.update(links=(action.state_shape(C, cfg.ndim, cfg.shape), link_dtype),
                runs=((C, 2), torch.int64), stab_cnt=((C,), torch.int32))
    _build.check_leaves(state, want, state.links.device)


def route(state: GaugeState, action, cfg: GaugeConfig) -> bool:
    """True to launch a CUDA kernel, False to run the plain version."""
    check_kernel_config(action, cfg)
    dev = state.links.device
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"gauge kernels run on 'cuda' or 'cpu' tensors, not {dev}")
    check_cuda_state(state, action, cfg)
    return True


def _empty(dev):
    return lambda shape, dtype=torch.float32: torch.empty(shape, dtype=dtype, device=dev)


# ---------------------------------------------------------------------------
# kernel 10: one frame, then the PyTorch epilogue
# ---------------------------------------------------------------------------


def gauge_frame_ref(state: GaugeState, action, cfg: GaugeConfig):
    """Plain PyTorch version of kernel 10 + epilogue: the plain path's frame.
    Returns (state, metrics)."""
    check_kernel_config(action, cfg)
    return gauge_mod.make_gauge_frame_fn(action, cfg)(state)


def gauge_frame_sums(state: GaugeState, action, cfg: GaugeConfig) -> GaugeFrameSums:
    """Kernel 10 alone: one frame of micro-steps → the frame's sums."""
    if not route(state, action, cfg):
        return gauge_mod.gauge_frame_sums(state, action, cfg)
    C = cfg.n_chains
    _, P, NP, FP = _GROUPS[type(action)]
    L0, L1 = cfg.shape
    empty = _empty(state.links.device)
    links, ps, dmax, unst = empty((C, P, L0, L1)), empty((C,)), empty((C,)), empty((C,), torch.int32)
    force, zk = empty((C, FP, L0, L1)), empty((C, NP, L0, L1))
    _build.launch("sq_gauge_frame", kernel_params(action, cfg, step0=int(state.step)),
                  (links_to_planes(state.links, action), state.drift_max, state.dtau, links, ps,
                   dmax, unst, force, zk), state.links.device)
    gauge_frame.launches += 1
    return GaugeFrameSums(planes_to_links(links, action), ps, dmax, unst != 0)


def gauge_frame(state: GaugeState, action, cfg: GaugeConfig):
    """Kernel 10 + the PyTorch epilogue: one frame for every chain.
    Returns (state, metrics), metrics of shape (C,)."""
    return gauge_mod.gauge_frame_epilogue(state, gauge_frame_sums(state, action, cfg), cfg)


gauge_frame.launches = 0


# ---------------------------------------------------------------------------
# kernel 11: K frames per launch, epilogue in-kernel
# ---------------------------------------------------------------------------


def gauge_frames_multi_ref(state: GaugeState, action, cfg: GaugeConfig, K: int):
    """Plain PyTorch version of kernel 11: K frames of the plain path.
    Returns (state, metrics) with metrics of shape (K, C)."""
    check_kernel_config(action, cfg)
    return gauge_mod.run_gauge_frames(state, action, cfg, K)


def gauge_frames_multi(state: GaugeState, action, cfg: GaugeConfig, K: int):
    """Kernel 11: K frames in one launch with accept/reject, plaquette merge,
    the (lo, hi) count carry and adaptive Δτ in-kernel.  Per-frame results
    equal K launches of kernel 10 plus the PyTorch epilogue.  Returns (state,
    metrics) with metrics of shape (K, C)."""
    if K < 1:
        raise ValueError(f"frames per launch must be >= 1, got {K}")
    if not route(state, action, cfg):
        return gauge_frames_multi_ref(state, action, cfg, K)
    C = cfg.n_chains
    _, P, NP, FP = _GROUPS[type(action)]
    L0, L1 = cfg.shape
    empty = _empty(state.links.device)
    links, dmax, dtau, pm = empty((C, P, L0, L1)), empty((C,)), empty((C,)), empty((C,))
    runs, stab = empty((C, 2), torch.int64), empty((C,), torch.int32)
    h_stable, h_dtau, h_dmax = empty((K, C), torch.int32), empty((K, C)), empty((K, C))
    work, force, zk = empty((C, P, L0, L1)), empty((C, FP, L0, L1)), empty((C, NP, L0, L1))
    _build.launch(
        "sq_gauge_frames", kernel_params(action, cfg, step0=int(state.step), n_frames=K),
        (links_to_planes(state.links, action), state.drift_max, state.dtau, state.plaq_mean,
         state.runs, state.stab_cnt, links, dmax, dtau, pm, runs, stab, h_stable, h_dtau, h_dmax,
         work, force, zk),
        state.links.device,
    )
    gauge_frames_multi.launches += 1
    new = GaugeState(planes_to_links(links, action), pm, dmax, runs, dtau, stab,
                     host_step(int(state.step) + cfg.loops * K))
    return new, {"stable": h_stable != 0, "dtau": h_dtau, "drift_max": h_dmax,
                 "unitarity_norm": torch.zeros_like(h_dtau)}


gauge_frames_multi.launches = 0


# ---------------------------------------------------------------------------
# frame loop
# ---------------------------------------------------------------------------


def run_gauge_frames_kernel(state: GaugeState, action, cfg: GaugeConfig, n_frames: int, *,
                            frames_per_launch: int = 1):
    """``n_frames`` frames through kernels 10 and 11 — the counterpart of
    ``stochquant_tpu.kernels.gauge_kernel.run_gauge_frames_pallas``.

    ``frames_per_launch`` K > 1 runs groups of K frames through kernel 11
    and the remainder through kernel 10 plus the PyTorch epilogue; per-frame
    results are the same either way.  Returns (state, metrics) with metrics
    of shape (n_frames, C)."""
    K = max(frames_per_launch, 1)
    parts, done = [], 0
    while done < n_frames:
        if K > 1 and n_frames - done >= K:
            state, m = gauge_frames_multi(state, action, cfg, K)
            done += K
        else:
            state, m = gauge_frame(state, action, cfg)
            m = {k: v[None] for k, v in m.items()}
            done += 1
        parts.append(m)
    if not parts:
        return state, {}
    return state, {k: torch.cat([m[k] for m in parts]) for k in parts[0]}

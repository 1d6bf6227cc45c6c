"""Hand-written CUDA kernels for whole-lattice 2-D scalar-field frames, their
plain PyTorch versions, and the frame loop around them.

Port of ``stochquant_tpu/kernels/field_kernel.py``:

* kernel 3, :func:`field_frame` — one frame of ``cfg.loops`` micro-steps per
  chain returning the frame sums (``_build_kernel``); the accept/reject
  epilogue runs outside in PyTorch (``field.field_frame_epilogue``).
  Plain version: :func:`field_frame_ref`.
* kernel 4, :func:`field_frames_multi` — K frames per launch with the
  epilogue in-kernel (``_build_multiframe_kernel``).
  Plain version: :func:`field_frames_multi_ref`.

Both are CUDA C++ for ``sm_90a`` (``csrc/field_kernel.cu``), built by
``_build`` at first use, for float32 2-D lattices and the ``phi4`` and
``free_field`` actions.  A wrapper given CPU tensors runs its plain version;
given CUDA tensors it launches its kernel on PyTorch's current stream, or
raises — it never falls back.  Each wrapper counts its kernel launches in a
plain integer attribute, ``field_frame.launches`` and
``field_frames_multi.launches``; launches of the Philox variant
(``rng_impl='hardware'``) are counted on their own as well, in
``field_frame.launches_hw`` and ``field_frames_multi.launches_hw``.  Each
wrapper runs whole inside a ``tracing.LAUNCH`` span (``tracing.py``).

Each launch runs a chain on a thread-block cluster of B blocks, each holding
a strip of rows in shared memory, or at B = 1 on one block with the field in
global memory: :func:`cluster_geometry` picks B (``_cluster`` has the rule);
the wrappers keep the last launch's geometry in ``field_frame.geometry`` and
``field_frames_multi.geometry``.

``rng_impl='hardware'`` selects each kernel's Philox-4x32-10 variant — the
counterpart of the Pallas kernels' on-core generator branch — and, on CPU
tensors, the plain versions' Philox stream; see ``csrc/field_kernel.cu`` for
the keying.
"""

from __future__ import annotations

import numpy as np
import torch

from stochquant_tpu_torch import rng, tracing
from stochquant_tpu_torch.actions.phi4 import FieldAction, FreeField, ScalarPhi4
from stochquant_tpu_torch.config import FieldConfig, Scheme, Sweep
from stochquant_tpu_torch.integrators import field as field_mod
from stochquant_tpu_torch.integrators.field import FieldFrameSums, FieldState
from stochquant_tpu_torch.integrators.langevin import host_step, stack_metrics
from stochquant_tpu_torch.kernels import _build, _cluster

__all__ = [
    "cluster_candidates",
    "cluster_geometry",
    "field_frame",
    "field_frame_ref",
    "field_frames_multi",
    "field_frames_multi_ref",
    "run_field_frames_kernel",
]

_MEANS = ("mag_mean", "mag2_mean", "mag4_mean", "absmag_mean", "phi2_mean", "act_mean")


def _action_constants(action: FieldAction):
    """(action code, m², float32(½m²), float32(λ/6), float32(λ/24)), folded
    as the JAX actions fold their Python floats."""
    f32 = np.float32
    if type(action) is ScalarPhi4:
        return (0, f32(action.m2), f32(0.5 * action.m2), f32(action.lam / 6.0),
                f32(action.lam / 24.0))
    if type(action) is FreeField:
        return 1, f32(action.m2), f32(0.5 * action.m2), 0, 0
    raise ValueError(
        f"the CUDA field kernels implement phi4 and free_field, not {type(action).__name__}"
    )


def check_kernel_config(cfg: FieldConfig) -> None:
    """Raise for what the 2-D field kernels (and their plain versions, which
    keep the kernels' contract) do not take."""
    if cfg.scheme == Scheme.EXACT:
        raise ValueError(
            "Scheme.EXACT is a plain-path scheme by design (the rfftn-mode propagator): "
            "no field kernel implements it; use field.run_field_frames (backend='torch')"
        )
    if cfg.ndim != 2:
        raise ValueError(
            f"the whole-lattice and strip-tiled field kernels take 2-D lattices, not shape "
            f"{cfg.shape} (D >= 3 lattices run kernels.field_kernel_nd)"
        )
    if cfg.dtype != "float32":
        raise ValueError(f"the field kernels are float32-only, not {cfg.dtype}")


def philox(cfg: FieldConfig) -> bool:
    """True when kernels 3 and 4 (and their plain versions) draw Philox noise."""
    return cfg.rng_impl == "hardware"


def noise_planes(cfg: FieldConfig) -> int:
    """Per-site scratch planes kernels 3 and 4 keep a noise group's later
    outputs in: one under Threefry (pairs), three under Philox (fours)."""
    return (rng.PHILOX_STEPS if philox(cfg) else 2) - 1


def kernel_params(shape, action: FieldAction, cfg: FieldConfig, *, step0: int,
                  chain_offset: int = 0, n_frames: int = 1, tile_rows: int = 0,
                  halo: int = 0, philox: bool = False) -> "_build.FieldParams":
    """The ``FieldParams`` struct of one launch on a (C, *lattice) field.
    ``L0``, ``L1`` and ``inv_l1`` are the 2-D kernels' and stay 0 for another
    lattice rank (kernels 6 and 7 take their geometry in ``FieldNdParams``);
    ``philox`` is kernels 3 and 4's."""
    C, *lattice = shape
    L0, L1 = lattice if len(lattice) == 2 else (0, 0)
    code, m2, hm2, l6, l24 = _action_constants(action)
    f32 = np.float32
    a = cfg.spacing
    return _build.FieldParams(
        n_chains=C, L0=L0, L1=L1, rounds=rng.rounds_of(cfg.rng_impl), philox=int(philox),
        loops=cfg.loops, n_frames=n_frames, checkerboard=int(cfg.sweep == Sweep.CHECKERBOARD),
        action=code,
        grow_after=min(cfg.grow_after, 2**31 - 1), has_dtau_max=int(cfg.dtau_max is not None),
        tile_rows=tile_rows, halo=halo, n_tiles=L0 // tile_rows if tile_rows else 0,
        seed=rng.u32(cfg.seed), step0=rng.u32(int(step0)), chain0=rng.u32(chain_offset),
        m2=m2, hm2=hm2, l6=l6, l24=l24, inv_a2=f32(1.0 / (a * a)),
        measure=f32(a ** len(lattice)),
        c_amp=f32(cfg.noise_amp), clamp=f32(cfg.clamp), shrink=f32(cfg.shrink),
        dtau_max=f32(cfg.dtau_max if cfg.dtau_max is not None else 0.0),
        inv_loops=f32(1.0 / cfg.loops), loops_f=f32(cfg.loops), inv_l1=f32(1.0 / L1 if L1 else 0.0),
        cl_B=1, cl_rows=L0,
    )


def cluster_candidates(shape, noise_planes: int) -> list:
    """B = 1 and every B ≤ L0 whose two strips of a (L0, L1) lattice fit one
    block, the kept noise (``noise_planes`` planes, :func:`noise_planes`) in
    shared memory where it fits too (``_cluster.candidates``)."""
    L0, L1 = shape
    return _cluster.candidates(
        L0, lambda rows, scratch: _cluster.field_smem_floats(rows, L1, noise_planes, scratch))


#: counted operations of one site update of kernels 3 and 4 (the 2-D stencil,
#: update, detector and observables, half a Threefry-20 pair and its
#: Box-Muller: chip_smoke.py's bound)
SITE_OPS = 116


def cluster_geometry(n_chains: int, shape, noise_planes: int, resident) -> _cluster.Geometry:
    """The geometry of kernels 3 and 4 for ``n_chains`` chains of a (L0, L1)
    lattice: ``_cluster.choose``'s least cost among :func:`cluster_candidates`.
    ``resident(g)`` is how many chains the card runs at once in geometry g
    (on the card: ``cudaOccupancyMaxActiveClusters``)."""
    return _cluster.choose(n_chains, cluster_candidates(shape, noise_planes), resident,
                           _cluster.overhead_rows(SITE_OPS, shape[1]))


def _geometry(params, cfg: FieldConfig, multi: bool, dev) -> _cluster.Geometry:
    """This launch's geometry (the one ``_cluster.forced`` pins, else the
    rule's), written into ``params``."""
    shape, npl = (params.L0, params.L1), noise_planes(cfg)
    key = (shape, params.philox, params.rounds)
    g = _cluster.forced_geometry(cluster_candidates(shape, npl)) or cluster_geometry(
        params.n_chains, shape, npl,
        lambda g: _cluster.resident_on_card("sq_field_resident", params, g, multi, dev, key))
    _cluster.apply(params, g)
    return g


def check_cuda_state(state: FieldState) -> None:
    """Device, dtype, shape and contiguity of every leaf a kernel reads."""
    C, L0, L1 = state.phi.shape
    want = {name: ((C,), torch.float32) for name in _MEANS + ("dtau", "lrg_vl")}
    want.update(phi=((C, L0, L1), torch.float32), corr_mean=((C, L0), torch.float32),
                runs=((C, 2), torch.int64), stab_cnt=((C,), torch.int32))
    _build.check_leaves(state, want, state.phi.device)


def route(state: FieldState, cfg: FieldConfig) -> bool:
    """True to launch a CUDA kernel, False to run the plain version."""
    check_kernel_config(cfg)
    if tuple(state.phi.shape[1:]) != tuple(cfg.shape):
        raise ValueError(f"state.phi has lattice {tuple(state.phi.shape[1:])}, cfg {cfg.shape}")
    dev = state.phi.device
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"field kernels run on 'cuda' or 'cpu' tensors, not {dev}")
    check_cuda_state(state)
    return True


# ---------------------------------------------------------------------------
# kernel 3: one frame → frame sums
# ---------------------------------------------------------------------------


def field_frame_ref(state: FieldState, action: FieldAction, cfg: FieldConfig,
                    chain_offset: int = 0) -> FieldFrameSums:
    """Plain PyTorch version of kernel 3."""
    check_kernel_config(cfg)
    return field_mod.field_frame_sums(state, action, cfg, chain_offset, philox=philox(cfg))


def field_frame(state: FieldState, action: FieldAction, cfg: FieldConfig,
                chain_offset: int = 0) -> FieldFrameSums:
    """Kernel 3: one frame of ``cfg.loops`` micro-steps for the chains of
    ``state`` (global ids ``chain_offset …``); returns the frame sums."""
    with tracing.span(tracing.LAUNCH):
        if not route(state, cfg):
            return field_frame_ref(state, action, cfg, chain_offset)
        C, L0, L1 = state.phi.shape
        params = kernel_params((C, L0, L1), action, cfg, step0=int(state.step),
                               chain_offset=chain_offset, philox=philox(cfg))
        dev = state.phi.device
        g = _geometry(params, cfg, False, dev)
        empty = lambda shape, dtype=torch.float32: torch.empty(shape, dtype=dtype, device=dev)  # noqa: E731
        phi, sums, cs = empty((C, L0, L1)), empty((6, C)), empty((C, L0))
        lrg, unst = empty((C,)), empty((C,), torch.int32)
        work, zk, slices = _scratch(empty, g, cfg, (C, L0, L1), 1)
        _build.launch("sq_field_frame", params,
                      (state.phi, state.lrg_vl, state.dtau, phi, sums, cs, lrg, unst, work, zk,
                       slices), dev)
        field_frame.launches += 1
        field_frame.launches_hw += philox(cfg)
        field_frame.geometry = g
        return FieldFrameSums(phi, *sums.unbind(0), cs, lrg, unst != 0)


field_frame.launches = 0
field_frame.launches_hw = 0
field_frame.geometry = None


def _scratch(empty, g: _cluster.Geometry, cfg: FieldConfig, shape, n_work: int):
    """(work, kept noise, slice means) scratch of a launch: at B = 1 the global
    buffers of the one-block body; at B > 1 shared memory holds the field and
    the slice means, and the kept noise unless it lives in global memory."""
    C, L0, L1 = shape
    noise = (noise_planes(cfg), C, L0, L1)
    if g.B == 1:
        return empty((n_work, C, L0, L1)), empty(noise), empty((C, L0))
    one = empty((1,))
    return one, one if g.scratch_in_smem else empty(noise), one


# ---------------------------------------------------------------------------
# kernel 4: K frames per launch, epilogue in-kernel
# ---------------------------------------------------------------------------


def field_frames_multi_ref(state: FieldState, action: FieldAction, cfg: FieldConfig, K: int,
                           chain_offset: int = 0):
    """Plain PyTorch version of kernel 4: K × (frame sums + epilogue).
    Returns (state, metrics) with metrics of shape (K, C)."""
    check_kernel_config(cfg)
    per_frame = []
    for _ in range(K):
        state, m = field_mod.field_frame_epilogue(
            state, field_frame_ref(state, action, cfg, chain_offset), cfg
        )
        per_frame.append(m)
    return state, stack_metrics(per_frame)


def field_frames_multi(state: FieldState, action: FieldAction, cfg: FieldConfig, K: int,
                       chain_offset: int = 0):
    """Kernel 4: K frames in one launch, with accept/reject, running-mean
    merge, the (lo, hi) count carry and adaptive Δτ in-kernel.  Per-frame
    results equal K launches of kernel 3 plus the PyTorch epilogue.
    Returns (state, metrics) with metrics of shape (K, C)."""
    with tracing.span(tracing.LAUNCH):
        if K < 1:
            raise ValueError(f"frames per launch must be >= 1, got {K}")
        if not route(state, cfg):
            return field_frames_multi_ref(state, action, cfg, K, chain_offset)
        C, L0, L1 = state.phi.shape
        params = kernel_params((C, L0, L1), action, cfg, step0=int(state.step),
                               chain_offset=chain_offset, n_frames=K, philox=philox(cfg))
        dev = state.phi.device
        empty = lambda shape, dtype=torch.float32: torch.empty(shape, dtype=dtype, device=dev)  # noqa: E731
        means_in = torch.stack([getattr(state, name) for name in _MEANS])
        phi, lrg, dtau, means = empty((C, L0, L1)), empty((C,)), empty((C,)), empty((6, C))
        cm, runs, stab = empty((C, L0)), empty((C, 2), torch.int64), empty((C,), torch.int32)
        hist_stable, hist_dtau, hist_lrg = empty((K, C), torch.int32), empty((K, C)), empty((K, C))
        g = _geometry(params, cfg, True, dev)
        work, zk, slices = _scratch(empty, g, cfg, (C, L0, L1), 2)
        cs = empty((C, L0))
        _build.launch(
            "sq_field_frames", params,
            (state.phi, state.lrg_vl, state.dtau, means_in, state.corr_mean, state.runs,
             state.stab_cnt, phi, lrg, dtau, means, cm, runs, stab, hist_stable, hist_dtau,
             hist_lrg, work, zk, slices, cs),
            dev,
        )
        field_frames_multi.launches += 1
        field_frames_multi.launches_hw += philox(cfg)
        field_frames_multi.geometry = g
        new = FieldState(phi, *means.unbind(0), cm, runs, dtau, stab, lrg,
                         host_step(int(state.step) + cfg.loops * K))
        return new, {"stable": hist_stable != 0, "dtau": hist_dtau, "max_phi": hist_lrg}


field_frames_multi.launches = 0
field_frames_multi.launches_hw = 0
field_frames_multi.geometry = None


# ---------------------------------------------------------------------------
# frame loop
# ---------------------------------------------------------------------------


def run_field_frames_kernel(state: FieldState, action: FieldAction, cfg: FieldConfig,
                            n_frames: int, *, frames_per_launch: int = 1,
                            chain_offset: int = 0):
    """``n_frames`` frames through kernels 3 and 4 — the counterpart of
    ``stochquant_tpu.kernels.field_kernel.run_field_frames_pallas``.

    ``frames_per_launch`` K > 1 runs groups of K frames through kernel 4
    (epilogue in-kernel) and the remainder through kernel 3 plus the PyTorch
    epilogue; per-frame results are the same either way.  Returns (state,
    metrics) with metrics of shape (n_frames, C)."""
    K = max(frames_per_launch, 1)
    parts = []
    done = 0
    while done < n_frames:
        if K > 1 and n_frames - done >= K:
            state, m = field_frames_multi(state, action, cfg, K, chain_offset)
            done += K
        else:
            state, m = field_mod.field_frame_epilogue(
                state, field_frame(state, action, cfg, chain_offset), cfg
            )
            m = {k: v[None] for k, v in m.items()}
            done += 1
        parts.append(m)
    if not parts:
        return state, {}
    return state, {k: torch.cat([m[k] for m in parts]) for k in parts[0]}

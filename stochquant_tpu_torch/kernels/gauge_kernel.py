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
* kernel 12, :func:`gauge_chunk` — W micro-steps of a shard's block of a
  lattice split along dim 0, extended by H = W halo rows a side
  (``_chunk_call_g`` / ``make_gauge_chunk_step``), for the chunk runner of
  ``parallel.gauge_halo``.  Plain version: :func:`gauge_chunk_ref`.

All are CUDA C++ for ``sm_90a`` (``csrc/gauge_kernel.cu``), built by
``_build`` at first use, for U(1), SU(2) and SU(3) Wilson actions on 2-D
lattices without cooling (:func:`supports`, the JAX package's rule).  The
kernels hold a chain's links as float32 planes (C, P, L0, L1): P = 2 for
U(1) (direction μ), 8 for SU(2) (plane 2c + μ for quaternion component c)
and 36 for SU(3) (plane 18μ + 2(3r + c) + {re, im}), the state layout of the
first two and a transposition of SU(3)'s complex64 matrices.

Kernels 10, 11 and 12 run a chain on a thread-block cluster of B blocks, each
holding a strip of rows of every link plane in shared memory, or at B = 1 on
one block with the links in global memory: :func:`cluster_geometry` and
:func:`chunk_geometry` pick B (``_cluster`` has the rule); the wrappers keep
the last launch's geometry in ``gauge_frame.geometry``,
``gauge_frames_multi.geometry`` and ``gauge_chunk.geometry``.  Kernel 12
cuts the rows of its halo-extended block, updates at step k only the rows
that still reach the owned ones, and combines its blocks' partials once
after the W steps.

A wrapper given CPU tensors runs its plain version; given CUDA tensors it
launches its kernel on PyTorch's current stream, or raises — it never falls
back.  Each wrapper counts its kernel launches in a plain integer
attribute: ``gauge_frame.launches``, ``gauge_frames_multi.launches`` and
``gauge_chunk.launches``.

Metrics follow the JAX package's XLA frame on every path: a frame's
``drift_max`` metric is the frame's running max even when the frame is
rejected (the JAX package's kernel 11 records the restored state value
there instead).
"""

from __future__ import annotations

import contextlib
from types import SimpleNamespace

import numpy as np
import torch

from stochquant_tpu_torch import rng
from stochquant_tpu_torch.actions.gauge import SU2Wilson, SU3Wilson, U1Wilson
from stochquant_tpu_torch.integrators import gauge as gauge_mod
from stochquant_tpu_torch.integrators.gauge import GaugeConfig, GaugeFrameSums, GaugeState
from stochquant_tpu_torch.integrators.langevin import host_step
from stochquant_tpu_torch.kernels import _build, _cluster

__all__ = [
    "cluster_candidates",
    "cluster_geometry",
    "supports",
    "unsupported_reason",
    "gauge_frame",
    "gauge_frame_ref",
    "gauge_frames_multi",
    "gauge_frames_multi_ref",
    "run_gauge_frames_kernel",
    "links_to_planes",
    "planes_to_links",
    "links_to_planes_shaped",
    "planes_to_links_shaped",
    "chunk_candidates",
    "chunk_geometry",
    "gauge_chunk",
    "gauge_chunk_ref",
    "make_gauge_chunk_step",
]

# action class -> (group code of the CUDA source, link planes, noise planes, force planes)
_GROUPS = {U1Wilson: (0, 2, 2, 2), SU2Wilson: (1, 8, 6, 6), SU3Wilson: (2, 36, 16, 36)}


def unsupported_reason(action, cfg: GaugeConfig):
    """Why kernels 10 and 11 (and their plain versions, which keep the
    kernels' contract) do not take this case, or None: they cover compact
    U(1), SU(2) and SU(3) on 2-D lattices without gauge cooling."""
    if type(action) not in _GROUPS:
        return (f"the gauge kernels implement u1, su2 and su3, not group {cfg.group} "
                f"({type(action).__name__})")
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


def links_to_planes_shaped(links: torch.Tensor, action, C: int, shape) -> torch.Tensor:
    """:func:`links_to_planes` for a block of ``C`` chains on a lattice extent
    ``shape`` that need not be ``cfg.shape`` (a shard's local block, or one
    extended by halo rows); the extent is checked."""
    planes = links_to_planes(links, action)
    if tuple(planes.shape) != (C, _GROUPS[type(action)][1]) + tuple(shape):
        raise ValueError(f"links {tuple(links.shape)} are not {C} chains on a {tuple(shape)} block")
    return planes


def planes_to_links_shaped(planes: torch.Tensor, action, C: int, shape) -> torch.Tensor:
    """Inverse of :func:`links_to_planes_shaped`."""
    if tuple(planes.shape) != (C, _GROUPS[type(action)][1]) + tuple(shape):
        raise ValueError(f"planes {tuple(planes.shape)} are not {C} chains on a {tuple(shape)} "
                         "block")
    return planes_to_links(planes, action)


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
        inv_loops=f32(1.0 / cfg.loops), loops_f=f32(cfg.loops), cl_B=1, cl_rows=L0,
    )


def cluster_candidates(shape, group: int) -> list:
    """B = 1 and every B ≤ L0 whose strip of link planes of a (L0, L1) lattice
    of ``group`` (0 u1, 1 su2, 2 su3) fits one block, F and the kept noise in
    shared memory where they fit too (``_cluster.candidates``)."""
    L0, L1 = shape
    _, P, NP, FP = next(v for v in _GROUPS.values() if v[0] == group)
    return _cluster.candidates(
        L0, lambda rows, scratch: _cluster.gauge_smem_floats(rows, L1, P, FP, NP, scratch))


#: counted operations of one site's update (both links) of kernels 10 and 11
#: per group, noise included (chip_smoke.py's bound)
SITE_OPS = (181, 934, 7274)


def cluster_geometry(n_chains: int, shape, group: int, resident) -> _cluster.Geometry:
    """The geometry of kernels 10 and 11 for ``n_chains`` chains of a (L0, L1)
    lattice of ``group``: ``_cluster.choose``'s least cost among
    :func:`cluster_candidates`.  ``resident(g)`` is how many chains the card
    runs at once in geometry g (on the card: ``cudaOccupancyMaxActiveClusters``)."""
    return _cluster.choose(n_chains, cluster_candidates(shape, group), resident,
                           _cluster.overhead_rows(SITE_OPS[group], shape[1]))


def _geometry(params, multi: bool, dev) -> _cluster.Geometry:
    """This launch's geometry (the one ``_cluster.forced`` pins, else the
    rule's), written into ``params``."""
    shape, group = (params.L0, params.L1), params.group
    g = _cluster.forced_geometry(cluster_candidates(shape, group)) or cluster_geometry(
        params.n_chains, shape, group,
        lambda g: _cluster.resident_on_card("sq_gauge_resident", params, g, multi, dev,
                                            (shape, group)))
    _cluster.apply(params, g)
    return g


def _scratch(empty, g: _cluster.Geometry, C: int, FP: int, NP: int, L0: int, L1: int):
    """(force, kept noise) buffers of a launch: at B = 1 (C, planes, L0, L1);
    at B > 1 a strip's planes of rows + 2 rows a block, (C, B, planes, rows +
    2, L1), unless shared memory holds them."""
    if g.B == 1:
        return empty((C, FP, L0, L1)), empty((C, NP, L0, L1))
    if g.scratch_in_smem:
        return empty((1,)), empty((1,))
    return empty((C, g.B, FP, g.rows + 2, L1)), empty((C, g.B, NP, g.rows + 2, L1))


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
    params = kernel_params(action, cfg, step0=int(state.step))
    g = _geometry(params, False, state.links.device)
    force, zk = _scratch(empty, g, C, FP, NP, L0, L1)
    _build.launch("sq_gauge_frame", params,
                  (links_to_planes(state.links, action), state.drift_max, state.dtau, links, ps,
                   dmax, unst, force, zk), state.links.device)
    gauge_frame.launches += 1
    gauge_frame.geometry = g
    return GaugeFrameSums(planes_to_links(links, action), ps, dmax, unst != 0)


def gauge_frame(state: GaugeState, action, cfg: GaugeConfig):
    """Kernel 10 + the PyTorch epilogue: one frame for every chain.
    Returns (state, metrics), metrics of shape (C,)."""
    return gauge_mod.gauge_frame_epilogue(state, gauge_frame_sums(state, action, cfg), cfg,
                                          action)


gauge_frame.launches = 0
gauge_frame.geometry = None


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
    params = kernel_params(action, cfg, step0=int(state.step), n_frames=K)
    g = _geometry(params, True, state.links.device)
    work = empty((C, P, L0, L1)) if g.B == 1 else empty((1,))
    force, zk = _scratch(empty, g, C, FP, NP, L0, L1)
    _build.launch(
        "sq_gauge_frames", params,
        (links_to_planes(state.links, action), state.drift_max, state.dtau, state.plaq_mean,
         state.runs, state.stab_cnt, links, dmax, dtau, pm, runs, stab, h_stable, h_dtau, h_dmax,
         work, force, zk),
        state.links.device,
    )
    gauge_frames_multi.launches += 1
    gauge_frames_multi.geometry = g
    new = GaugeState(planes_to_links(links, action), pm, dmax, runs, dtau, stab,
                     host_step(int(state.step) + cfg.loops * K))
    return new, {"stable": h_stable != 0, "dtau": h_dtau, "drift_max": h_dmax,
                 "unitarity_norm": torch.zeros_like(h_dtau)}


gauge_frames_multi.launches = 0
gauge_frames_multi.geometry = None


# ---------------------------------------------------------------------------
# kernel 12: W micro-steps of a dim-0 halo-extended block
# ---------------------------------------------------------------------------
#
# Chunk mode has no drift-cap rescale (it would need the lattice-wide drift
# max of every micro-step: a collective per step) and no per-chain freeze: a
# step whose owned drift norm exceeds the cap sets ``capped``, a non-finite
# owned link sets ``bad``, and the runner rejects the frame for either.  While
# the cap is quiescent the scale of kernels 10 and 11 is exactly 1.0 and the
# links agree with theirs bit for bit.


def _chunk_halo(action, cfg: GaugeConfig, loc0: int, W: int) -> int:
    """The halo depth H = W of a chunk of ``W`` steps on ``loc0`` owned rows;
    raises for what kernel 12 does not take."""
    check_kernel_config(action, cfg)
    if W % 2 or W < 2:
        raise ValueError(f"the gauge chunk kernel advances an even number of micro-steps "
                         f"(W >= 2), not W={W}")
    if W > loc0 or loc0 > cfg.shape[0]:
        raise ValueError(f"gauge chunk halo depth H={W} exceeds the local slab ({loc0} rows of "
                         f"{cfg.shape[0]}): the exchange is single-hop; lower exchange_steps or "
                         "use the per-step halo runner")
    return W


def _check_chunk(ext, dtau, action, cfg: GaugeConfig, loc0: int, W: int) -> int:
    """Validate one chunk call; returns the halo depth H."""
    H = _chunk_halo(action, cfg, loc0, W)
    want = (ext.shape[0], _GROUPS[type(action)][1], loc0 + 2 * H, cfg.shape[1])
    if tuple(ext.shape) != want or tuple(dtau.shape) != (ext.shape[0],):
        raise ValueError(f"expected extended planes {want} and dtau ({ext.shape[0]},), got "
                         f"{tuple(ext.shape)} and {tuple(dtau.shape)}")
    return H


def gauge_chunk_ref(ext: torch.Tensor, dtau: torch.Tensor, action, cfg: GaugeConfig, loc0: int,
                    W: int, step_base: int, chain_off: int = 0, row_off: int = 0):
    """Plain PyTorch version of kernel 12 (see :func:`gauge_chunk`)."""
    H = _check_chunk(ext, dtau, action, cfg, loc0, W)
    C, _, E0, L1 = ext.shape
    L0g = cfg.shape[0]
    dev = ext.device
    cap = float(np.float32(cfg.drift_cap))
    NP = _GROUPS[type(action)][2]
    noise_shape = action.noise_shape(C, 2, (E0, L1))
    # global noise counters: C-order index over (noise plane, L0g, L1), row r
    # of the extended block being global row (row_off + r - H) mod L0g
    rows = (torch.arange(E0, dtype=torch.int64, device=dev) + (int(row_off) - H)) % L0g
    site = (torch.arange(NP, dtype=torch.int64, device=dev).view(NP, 1, 1) * (L0g * L1)
            + rows.view(1, E0, 1) * L1
            + torch.arange(L1, dtype=torch.int64, device=dev).view(1, 1, L1))
    site = rng.u32(site).reshape((1,) + tuple(noise_shape[1:]))
    chains = rng.u32(torch.arange(C, dtype=torch.int64, device=dev) + int(chain_off))
    k1 = rng.chain_key(rng.Stream.FIELD, chains).view((C,) + (1,) * (len(noise_shape) - 1))
    own = torch.zeros((1, 1, E0, 1), dtype=torch.bool, device=dev)
    own[:, :, H:H + loc0] = True

    links = planes_to_links(ext, action)
    ps = torch.zeros((C,), dtype=torch.float32, device=dev)
    dmax = torch.zeros((C,), dtype=torch.float32, device=dev)
    bad = torch.zeros((C,), dtype=torch.bool, device=dev)
    capped = torch.zeros((C,), dtype=torch.bool, device=dev)
    for k in range(0, W, 2):
        for eta in rng.normal_pair(rng.u32(cfg.seed), k1, site, rng.u32(int(step_base) + k)):
            f = action.drift(links, 2)
            dnorm = torch.amax(torch.where(own, action.drift_magnitude(f), 0.0), dim=(1, 2, 3))
            plaq = torch.where(own[:, 0], action.plaquette_site(links, 0, 1, 2), 0.0)
            links = action.apply_update(links, action.omega(f, eta, dtau))
            fin = torch.isfinite(links_to_planes(links, action)) | ~own
            ps = ps + plaq.sum(dim=(1, 2))
            dmax = torch.maximum(dmax, dnorm)
            bad = bad | ~torch.all(fin.reshape(C, -1), dim=1)
            capped = capped | (dnorm > cap)
    owned = links_to_planes(links, action)[:, :, H:H + loc0].contiguous()
    return owned, ps, dmax, bad, capped


#: threads a block of each group (``Layout<G>::T`` in csrc/gauge_kernel.cu)
THREADS = (1024, 512, 256)


def chunk_candidates(E0: int, L1: int, group: int, W: int) -> list:
    """Kernel 12's geometries for an extended block of ``E0`` rows of ``L1``
    columns and ``W`` steps: B = 1 (the block in global memory) and every B ≤
    E0 whose two buffers of a strip fit one block's shared memory, the kept
    noise there where it fits too (``_cluster.candidates``)."""
    _, P, NP, _ = next(v for v in _GROUPS.values() if v[0] == group)
    return _cluster.candidates(
        E0, lambda rows, scratch: _cluster.gauge_chunk_smem_floats(rows, L1, P, NP, W, scratch))


def chunk_geometry(n_chains: int, E0: int, L1: int, group: int, W: int,
                   resident) -> _cluster.Geometry:
    """Kernel 12's geometry: ``_cluster.choose``'s least cost among
    :func:`chunk_candidates`, as :func:`cluster_geometry` for kernels 10 and 11."""
    return _cluster.choose(n_chains, chunk_candidates(E0, L1, group, W), resident,
                           _cluster.overhead_rows(SITE_OPS[group], L1))


_SPLIT = None


@contextlib.contextmanager
def forced_split(split: bool):
    """Launch kernel 12 with this work item inside this block (the timing tool
    holds both against each other), as ``_cluster.forced`` pins B."""
    global _SPLIT
    before, _SPLIT = _SPLIT, bool(split)
    try:
        yield
    finally:
        _SPLIT = before


def chunk_split(g: _cluster.Geometry, L1: int, group: int) -> bool:
    """Whether kernel 12 gives a thread one link direction of a site (True) or
    a site's two: a direction each where a strip has fewer than two sites a
    thread, so that the threads stay busy (su3 64 wide at B >= 8: 0.79× the
    time of a site a thread; u1 at B = 8, 4.5 sites a thread: 1.19×, PERF.md)."""
    if _SPLIT is not None:
        return _SPLIT
    return g.rows * L1 < 2 * THREADS[group]


def gauge_chunk(ext: torch.Tensor, dtau: torch.Tensor, action, cfg: GaugeConfig, loc0: int,
                W: int, step_base: int, chain_off: int = 0, row_off: int = 0):
    """Kernel 12: ``W`` (even) micro-steps on the extended planes ``ext``
    (C, P, loc0 + 2H, L1), H = W rows of the ring neighbours above and below
    the ``loc0`` owned rows.  Dim 1 spans the whole lattice; dim 0 wraps inside
    the block, and what that gets wrong stops at the owned rows after W steps.
    ``cfg`` carries the global lattice; the noise of extended row r is that of
    global row ``(row_off + r - H) mod L0`` of chain ``chain_off + c``, from
    counter ``step_base`` on.  Returns the owned planes (C, P, loc0, L1), the
    sum over steps and owned sites of the plaquette, the owned drift-norm max
    (NaN propagates), and the ``bad`` and ``capped`` flags, (C,) each."""
    H = _check_chunk(ext, dtau, action, cfg, loc0, W)
    dev = ext.device
    if dev.type == "cpu":
        return gauge_chunk_ref(ext, dtau, action, cfg, loc0, W, step_base, chain_off, row_off)
    if dev.type != "cuda":
        raise ValueError(f"gauge kernels run on 'cuda' or 'cpu' tensors, not {dev}")
    C, P, E0, L1 = ext.shape
    NP = _GROUPS[type(action)][2]
    _build.check_leaves(SimpleNamespace(ext=ext, dtau=dtau),
                        {"ext": ((C, P, E0, L1), torch.float32), "dtau": ((C,), torch.float32)},
                        dev)
    params = kernel_params(action, cfg, step0=step_base)
    params.n_chains, params.L0, params.loops = C, E0, W
    params.chain_off, params.row_off = rng.u32(int(chain_off)), rng.u32(int(row_off))
    params.loc0, params.H, params.W, params.L0g = loc0, H, W, cfg.shape[0]
    group = params.group
    g = _cluster.forced_geometry(chunk_candidates(E0, L1, group, W)) or chunk_geometry(
        C, E0, L1, group, W,
        lambda g: _cluster.resident_on_card("sq_gauge_chunk_resident", params, g, False, dev,
                                            (E0, L1, group, W)))
    _cluster.apply(params, g)
    # kernel 12 has no empty micro-step (cl_empty is kernels 3, 4, 10 and 11's)
    params.cl_empty, params.cl_split = 0, int(chunk_split(g, L1, group))
    empty = _empty(dev)
    owned, ps, dmax = empty((C, P, loc0, L1)), empty((C,)), empty((C,))
    bad, capped = empty((C,), torch.int32), empty((C,), torch.int32)
    # at B = 1 the two link buffers, (C, 2, P, E0 + 2, L1); the kept noise of
    # each block's strip where shared memory does not hold it
    links = empty((C, 2, P, E0 + 2, L1)) if g.B == 1 else empty((1,))
    zk = empty((1,)) if g.scratch_in_smem else empty((C, g.B, NP, g.rows, L1))
    _build.launch("sq_gauge_chunk", params,
                  (ext, dtau, owned, ps, dmax, bad, capped, links, zk), dev)
    gauge_chunk.launches += 1
    gauge_chunk.geometry = g
    return owned, ps, dmax, bad != 0, capped != 0


gauge_chunk.launches = 0
gauge_chunk.geometry = None


def make_gauge_chunk_step(action, cfg: GaugeConfig, c_local: int, loc0: int, W: int, *,
                          chunk=None):
    """``(step, H)`` with ``step(ext_planes, dtau, step_base, chain_off,
    row_off) -> (owned_planes, plaq_sum, dmax, bad, capped)`` for blocks of
    ``c_local`` chains and ``loc0`` owned rows, as the JAX package's
    ``make_gauge_chunk_step``.  ``chunk`` is the kernel wrapper (default
    :func:`gauge_chunk`; :func:`gauge_chunk_ref` forces the plain version)."""
    H = _chunk_halo(action, cfg, loc0, W)
    fn = chunk or gauge_chunk
    want = (c_local, _GROUPS[type(action)][1], loc0 + 2 * H, cfg.shape[1])

    def step(ext_planes, dtau, step_base, chain_off, row_off):
        if tuple(ext_planes.shape) != want:
            raise ValueError(f"expected extended planes {want}, got {tuple(ext_planes.shape)}")
        return fn(ext_planes, dtau, action, cfg, loc0, W, step_base, chain_off, row_off)

    return step, H


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

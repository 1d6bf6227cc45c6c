"""CUDA kernels for D-dimensional (D ≥ 3) scalar-field lattices, their plain
PyTorch versions, and the frames around them.

Port of ``stochquant_tpu/kernels/field_kernel_nd.py``:

* kernel 6, :func:`field_pair_nd` (``_build_pair_kernel`` / ``_pair_call``):
  one pair of micro-steps — both Box–Muller outputs of one Threefry draw —
  of every chain of a periodic D-dim lattice.  Returns φ after the pair, the
  dim-0 slice **means** of the two pre-update fields and per-block statistics.
  Plain version: :func:`field_pair_nd_ref`.  :func:`field_frame_nd` scans the
  pairs of a frame; the last step of an odd ``loops`` is one launch of the
  same code at one micro-step, :func:`field_step_nd` (plain version
  :func:`field_step_nd_ref`), which also ends the strip-tiled 2-D frames.
* kernel 7, :func:`field_chunk_nd` (``_build_sharded_chunk_kernel`` /
  ``make_sharded_chunk_step_md``): W micro-steps (W even) on a block that
  carries ``halos[d]`` extra sites per side in every split dim, with noise
  and checkerboard parity from **global** coordinates (per-dim offsets), so
  the recomputed halo sites take the values their owner computes.  Returns
  the owned block after W steps, the per-step dim-0 slice **sums** over
  owned sites and per-block statistics of the owned sites, for D ≥ 2.  Plain
  version: :func:`field_chunk_nd_ref`.  :func:`field_frame_nd_chunk` runs a
  frame of an unsplit lattice through it, extending dim 0 periodically.
* kernel 8, :func:`field_chunk_rdma_nd` (``_sharded_chunk_call(rdma=True)``
  / ``make_rdma_chunk_step``): kernel 7's W steps on a dim-0 split, given
  the shard's unextended slab and its two dim-0 ring neighbours' slabs, from
  which it reads its H halo rows itself (:func:`rdma_chunk_geometry`).  A
  neighbour's slab is a tensor on this shard's device, or another process's
  memory mapped into this one (``parallel.ipc.Remote``), read through plain
  pointers alike.  Plain version: :func:`field_chunk_rdma_nd_ref`.

The kernels are CUDA C++ for ``sm_90a`` (``csrc/field_kernel_nd.cu``): one
persistent cooperative launch whose blocks stride over work items, a grid
barrier between two stencil applications (W for synchronous sweeps, 2W for
checkerboard half-sweeps).  A work item is one chain's tile of the launch's
**domain** (the lattice, or the block with its array halos); application s
updates the domain shrunk by s sites in every dim with an array halo, so no
site is recomputed beyond the exchange halo itself.  ``cfg.tile_rows`` keeps
its meaning, the dim-0 rows a block owns; the other extents of a tile are
this module's own rule (:func:`resolve_tiles`).  :class:`Geometry` computes
every index map the launch parameters carry (tiles of the domain, where an
item's sites lie at each application, kernel 8's slab rows); the CPU tests
check them.  The trajectory does not depend on the tiles: noise is keyed by
global (chain, site, step).

The statistics come per block, ``stats[c, b, 5·w : 5·w + 5]`` = [Σφ, Σφ²,
Σs, max|det|, max|φ_new|] of micro-step ``w`` over the owned sites of block
``b``, blocks in C order of their tile index; the frames sum them.  The
plain versions cut the same blocks.  Like the JAX kernels, a chain that trips
keeps evolving to the end of the frame; the rollback discards it.

A wrapper given CPU tensors runs its plain version; given CUDA tensors it
launches its kernel, or raises.  ``field_pair_nd.launches``,
``field_step_nd.launches``, ``field_chunk_nd.launches`` and
``field_chunk_rdma_nd.launches`` count launches.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from types import SimpleNamespace

import numpy as np
import torch

from stochquant_tpu_torch import rng
from stochquant_tpu_torch.actions.base import true_divide
from stochquant_tpu_torch.actions.phi4 import FieldAction
from stochquant_tpu_torch.config import FieldConfig, Scheme, Sweep
from stochquant_tpu_torch.integrators import field as field_mod
from stochquant_tpu_torch.integrators.field import FieldState
from stochquant_tpu_torch.integrators.langevin import stack_metrics
from stochquant_tpu_torch.kernels import _build
from stochquant_tpu_torch.kernels.field_kernel import kernel_params
from stochquant_tpu_torch.kernels.field_kernel_tiled import (
    micro_steps, obs_init, obs_step, obs_sums,
)
from stochquant_tpu_torch.parallel.ipc import Remote

__all__ = [
    "field_pair_nd",
    "field_pair_nd_ref",
    "field_step_nd",
    "field_step_nd_ref",
    "field_chunk_nd",
    "field_chunk_nd_ref",
    "field_chunk_rdma_nd",
    "field_chunk_rdma_nd_ref",
    "field_frame_nd",
    "field_frame_nd_chunk",
    "odd_tail",
    "run_field_frames_nd",
    "default_tile_rows",
    "resolve_tiles",
    "chunk_halos",
    "chunk_geometry",
    "rdma_chunk_geometry",
    "default_exchange_steps",
    "Geometry",
]

#: owned tiles a launch should have before the default tiles stop shrinking
#: (an H100 has 132 multiprocessors and holds a few blocks on each)
TARGET_BLOCKS = 512
#: smallest extent the default rule gives a tile in a dim it cuts
MIN_TILE = 2
#: threads per block of kernels 6, 7 and 8 (``ND_THREADS`` in the source)
THREADS = 256
#: rows a 2-D tile keeps while the rule cuts it for more blocks: one per warp
MIN_ROWS = THREADS // 32
#: shared memory a block of kernels 6, 7 and 8 may take for its staged box
#: (a tile and its one-site neighbour layer; the default rule keeps to
#: ``BOX_BUDGET``, a block may use 227 KB)
SMEM_BUDGET = 224 * 1024
BOX_BUDGET = 96 * 1024


def stencil_depth(cfg: FieldConfig, n_steps: int) -> int:
    """Stencil applications of ``n_steps`` micro-steps: one per synchronous
    sweep, two per checkerboard pair of half-sweeps."""
    return n_steps * (2 if cfg.sweep == Sweep.CHECKERBOARD else 1)


def chunk_halos(cfg: FieldConfig, W: int, split_dims) -> tuple:
    """Sites per side a W-step chunk needs beyond the owned block: the stencil
    depth in every split dim, none in the others."""
    depth = stencil_depth(cfg, W)
    return tuple(depth if s else 0 for s in split_dims)


def box_sites(tiles, shape, halos) -> int:
    """Sites of the box a block stages for a tile: the tile and one
    neighbour layer a side, except in a dim the tile spans periodically
    (no array halo, the whole lattice), where the box wraps."""
    return math.prod(t if (h == 0 and t == n) else t + 2
                     for t, n, h in zip(tiles, shape, halos))


def resolve_tiles(cfg: FieldConfig, loc, n_chains: int, tile_rows=None, halos=None) -> tuple:
    """The extents of one tile of the owned block ``loc`` (``halos`` per side
    in the split dims, none by default).

    Dim 0: ``tile_rows``, else ``cfg.tile_rows``, else (None or 0) this rule; the other
    dims: this rule.  It starts from the whole extents and halves the largest
    free extent (the lowest dim on a tie) while the launch has fewer than
    ``TARGET_BLOCKS`` owned tiles or the staged box exceeds ``BOX_BUDGET``,
    and the extent stays even and above ``MIN_TILE``.  At D = 2 the kernel
    gives a tile's rows to the warps, the lanes along them: there the last
    dim stays whole unless the box does not fit otherwise, and a tile keeps
    at least ``MIN_ROWS`` rows where the launch wants more blocks."""
    loc = tuple(loc)
    shape = tuple(cfg.shape)
    halos = tuple(halos) if halos is not None else (0,) * len(loc)
    tiles = list(loc)
    t0 = tile_rows or cfg.tile_rows  # None or 0 (autotune, resolved by the runtime): the rule
    if t0:
        if t0 < 0 or loc[0] % t0:
            raise ValueError(f"tile_rows={t0} must divide the dim-0 extent {loc[0]}")
        tiles[0] = t0
    last = len(loc) - 1
    rows = len(loc) == 2  # the warps take the tile's rows (the kernel's mapping at D = 2)
    free = [d for d in range(len(loc)) if not (d == 0 and t0)]
    while True:
        cand = [d for d in free if tiles[d] % 2 == 0 and tiles[d] > MIN_TILE]
        lead = [d for d in cand if d < last]
        if box_sites(tiles, shape, halos) * 4 > BOX_BUDGET:
            cand = (lead or cand) if rows else cand
        elif n_chains * math.prod(n // t for n, t in zip(loc, tiles)) < TARGET_BLOCKS:
            if rows:
                cand = [d for d in lead if math.prod(tiles[:last]) // 2 >= MIN_ROWS]
        else:
            break
        if not cand:
            break
        d = max(cand, key=lambda d: (tiles[d], -d))
        tiles[d] //= 2
    return tuple(tiles)


def default_tile_rows(cfg: FieldConfig, n_chains=None) -> int:
    """The dim-0 rows a block owns when none are given."""
    return resolve_tiles(cfg, cfg.shape, n_chains or cfg.n_chains)[0]


@dataclasses.dataclass(frozen=True)
class Geometry:
    """Where one launch's work items sit: the global lattice ``shape``, the
    owned block ``loc`` whose origin has global coordinates ``offsets``, the
    ``halos`` the input array (the launch's domain, :attr:`array`) carries
    per side, the ``tiles`` and the stencil ``depth`` of the launch.

    The domain is cut into tiles aligned to the owned block's origin, so a
    tile lies wholly in the owned block (a statistics block) or wholly in a
    halo; per dim ``lead_tiles`` of them precede the owned block and as many
    follow it.  These are the index maps of ``csrc/field_kernel_nd.cu``."""

    shape: tuple
    loc: tuple
    halos: tuple
    offsets: tuple
    tiles: tuple
    depth: int

    @property
    def tile_halos(self) -> tuple:
        """The neighbour layer per side of a staged tile: 0 where the tile
        spans a dim that carries no halo (the box wraps), else 1."""
        return tuple(0 if (h == 0 and t == n) else 1
                     for h, t, n in zip(self.halos, self.tiles, self.shape))

    @property
    def ext(self) -> tuple:
        """Extents of the largest staged box."""
        return tuple(t + 2 * h for t, h in zip(self.tiles, self.tile_halos))

    @property
    def array(self) -> tuple:
        return tuple(n + 2 * h for n, h in zip(self.loc, self.halos))

    @property
    def n_tiles(self) -> tuple:
        return tuple(n // t for n, t in zip(self.loc, self.tiles))

    @property
    def n_blocks(self) -> int:
        return math.prod(self.n_tiles)

    @property
    def lead_tiles(self) -> tuple:
        """Domain tiles per dim before (and after) the owned block: ceil(h / T)."""
        return tuple(-(-h // t) for h, t in zip(self.halos, self.tiles))

    @property
    def item_tiles(self) -> tuple:
        """Domain tiles per dim: the owned block's and the halos'."""
        return tuple(n + 2 * m for n, m in zip(self.n_tiles, self.lead_tiles))

    @property
    def n_items(self) -> int:
        """Work items per chain."""
        return math.prod(self.item_tiles)

    def item_box(self, j, s: int):
        """Per dim (lo, hi) of the domain sites that domain tile ``j`` (per-dim
        tile indices) updates at stencil application ``s`` (1 … depth): its
        extent clipped to the domain shrunk by s in every dim with a halo;
        None when nothing is left."""
        out = []
        for jd, m, t, h, a in zip(j, self.lead_tiles, self.tiles, self.halos, self.array):
            shr = s if h else 0
            lo = max(h + (jd - m) * t, shr)
            hi = min(h + (jd - m + 1) * t, a - shr)
            if hi <= lo:
                return None
            out.append((lo, hi))
        return tuple(out)

    def item_owned(self, j) -> bool:
        """Whether domain tile ``j`` lies in the owned block."""
        return all(0 <= jd - m < n for jd, m, n in zip(j, self.lead_tiles, self.n_tiles))

    def slab_row(self, x0: int) -> tuple:
        """Kernel 8: (slab, row) of domain row ``x0``: slab -1 (the left
        neighbour's), 0 (its own) or 1 (the right neighbour's)."""
        H, L0 = self.halos[0], self.loc[0]
        q = x0 - H
        return (-1, q + L0) if q < 0 else ((1, q - L0) if q >= L0 else (0, q))

    def blocks(self, x: torch.Tensor) -> torch.Tensor:
        """(C, *loc) → (C, n_blocks, sites per tile), blocks in C order."""
        C, D = x.shape[0], len(self.loc)
        view = [C]
        for n, t in zip(self.n_tiles, self.tiles):
            view += [n, t]
        perm = [0] + [1 + 2 * d for d in range(D)] + [2 + 2 * d for d in range(D)]
        return x.reshape(view).permute(perm).reshape(C, self.n_blocks, -1)

    def owned(self, x: torch.Tensor) -> torch.Tensor:
        """The owned block of a (C, *array) tensor."""
        index = (slice(None),) + tuple(slice(h, h + n) for h, n in zip(self.halos, self.loc))
        return x[index]


def _geometry(cfg: FieldConfig, loc, halos, offsets, n_steps, n_chains, tile_rows) -> Geometry:
    return _cached_geometry(cfg, tuple(loc), tuple(halos), tuple(int(o) for o in offsets),
                            n_steps, n_chains, tile_rows, TARGET_BLOCKS, BOX_BUDGET)


@functools.lru_cache(maxsize=256)
def _cached_geometry(cfg, loc, halos, offsets, n_steps, n_chains, tile_rows, _target,
                     _budget) -> Geometry:
    """:func:`_geometry`, once per launch shape (the rule's constants are part
    of the key, so a changed rule computes anew)."""
    shape = tuple(cfg.shape)
    for d, (n, h, g) in enumerate(zip(loc, halos, shape)):
        if h == 0 and n != g:
            raise ValueError(f"dim {d} carries no halo, so the block must span its whole "
                             f"extent {g}, not {n}")
        if n > g:
            raise ValueError(f"the owned block spans {n} sites of dim {d}, the lattice {g}")
    tiles = resolve_tiles(cfg, loc, n_chains, tile_rows, halos)
    geo = Geometry(shape, tuple(loc), tuple(halos), tuple(int(o) for o in offsets), tiles,
                   stencil_depth(cfg, n_steps))
    if math.prod(geo.ext) * 4 > SMEM_BUDGET:
        raise ValueError(f"tiles {geo.tiles}: the staged box of {geo.ext} sites does not fit a "
                         f"block's shared memory; give a smaller tile_rows")
    return geo


def check_nd_config(cfg: FieldConfig) -> None:
    """Raise for what kernels 6, 7 and 8 (and their plain versions, which
    keep the kernels' contract) do not take."""
    if not rng.counter_based(cfg.rng_impl):
        raise ValueError(
            "the D-dim field kernels require counter-based noise (halo sites are "
            "recomputed redundantly by neighbouring shards, which only agrees when noise "
            f"is a pure function of (site, step)), not rng_impl={cfg.rng_impl!r}: use "
            "rng_impl='threefry' or 'threefry13'"
        )
    if cfg.scheme == Scheme.EXACT:
        raise ValueError("Scheme.EXACT is a plain-path scheme by design (the rfftn-mode "
                         "propagator): no field kernel implements it; use backend='torch'")
    if cfg.dtype != "float32":
        raise ValueError(f"the field kernels are float32-only, not {cfg.dtype}")
    if not 2 <= cfg.ndim <= _build.ND_MAX_DIMS:
        raise ValueError(f"the D-dim field kernels take 2 to {_build.ND_MAX_DIMS} lattice "
                         f"dims, not shape {cfg.shape}")
    if math.prod(cfg.shape) > 1 << 32:
        raise ValueError(f"lattice {cfg.shape} has more sites than a 32-bit site id counts")


def _block_stats(geo: Geometry, steps) -> torch.Tensor:
    """(C, n_blocks, 5 per micro-step) from the owned (pre, post, |det|, s)."""
    cols = []
    for pre, post, absdet, act in steps:
        b = geo.blocks
        cols += [b(pre).sum(-1), b(pre * pre).sum(-1), b(act).sum(-1),
                 b(absdet).amax(-1), b(torch.abs(post)).amax(-1)]
    return torch.stack(cols, dim=-1)


def _launch(entry: str, geo: Geometry, srcs, dtau, action, cfg, n_steps, step, chain_offset,
            out=None):
    """Allocate the outputs and the domain buffers of one launch of ``entry``
    and launch it on ``srcs``: one (C, *geo.array) array, or kernel 8's three
    (C, *geo.loc) slabs (own, left, right; a neighbour's may be a ``Remote``,
    checked by the caller).  ``out`` receives the owned block (else a new
    tensor).  Returns (owned block after ``n_steps`` micro-steps, slice sums
    (C, n_steps, L0_loc), stats (C, n_blocks, 5·n_steps))."""
    C, dev = srcs[0].shape[0], srcs[0].device
    if dev.type != "cuda":
        raise ValueError(f"the D-dim field kernels run on 'cuda' or 'cpu' tensors, not {dev}")
    names = ("phi",) if len(srcs) == 1 else ("phi", "left", "right")
    shape = (C,) + (geo.array if len(srcs) == 1 else geo.loc)
    leaves = {n: x for n, x in zip(names, srcs) if not isinstance(x, Remote)}
    if out is not None:
        leaves["out"] = out
    _build.check_leaves(SimpleNamespace(dtau=dtau, **leaves),
                        {**{n: (shape, torch.float32) for n in names if n in leaves},
                         "dtau": ((C,), torch.float32),
                         **({"out": ((C,) + geo.loc, torch.float32)} if out is not None else {})},
                        dev)
    params = _build.FieldNdParams.from_buffer_copy(_launch_params(geo, C, action, cfg, n_steps))
    params.f.step0, params.f.chain0 = rng.u32(int(step)), rng.u32(chain_offset)
    empty = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)  # noqa: E731
    out = empty(C, *geo.loc) if out is None else out
    slp = empty(C, n_steps, geo.loc[0], params.n_inner)
    stats = empty(C, geo.n_blocks, 5 * n_steps)
    scratch = empty(3, C * params.avol)  # two ping-pong buffers of the domain, the kept noise
    _build.launch(entry, params, (*srcs, dtau, out, slp, stats, *scratch.unbind(0)), dev)
    return out, slp.sum(-1), stats


@functools.lru_cache(maxsize=256)
def _launch_params(geo: Geometry, C: int, action, cfg: FieldConfig,
                   n_steps: int) -> "_build.FieldNdParams":
    """The launch parameters of one geometry, counter and chain offset 0
    (:func:`_launch` sets both on a copy)."""
    avol = math.prod(geo.array)
    if avol >= 1 << 31 or C * geo.n_items >= 1 << 31:
        raise ValueError(f"a domain of {geo.array} sites or {C} x {geo.n_items} work items "
                         "exceeds the kernel's 32-bit ranges")
    params = _build.FieldNdParams()
    params.f = kernel_params((C,) + geo.shape, action, cfg, step0=0)
    D = len(geo.shape)
    params.nd, params.n_steps, params.depth = D, n_steps, geo.depth
    params.n_blocks, params.n_inner = geo.n_blocks, geo.n_blocks // geo.n_tiles[0]
    params.n_items, params.box = geo.n_items, math.prod(geo.ext)
    params.avol, params.lvol = avol, math.prod(geo.loc)
    for d in range(D):
        params.G[d], params.A[d], params.loc[d] = geo.shape[d], geo.array[d], geo.loc[d]
        params.h[d], params.T[d] = geo.halos[d], geo.tiles[d]
        params.gb[d] = (geo.offsets[d] - geo.halos[d]) % geo.shape[d]
        params.nl[d], params.ndt[d] = geo.lead_tiles[d], geo.item_tiles[d]
        params.wrap[d] = 1 - geo.tile_halos[d]
        params.as_[d] = math.prod(geo.array[d + 1:])
        params.ls[d] = math.prod(geo.loc[d + 1:])
        params.gs[d] = math.prod(geo.shape[d + 1:])
    return params


# ---------------------------------------------------------------------------
# kernel 6: one micro-step pair of a periodic D-dim lattice
# ---------------------------------------------------------------------------


def _pair_geometry(phi, cfg, tile_rows, n_steps=2) -> Geometry:
    check_nd_config(cfg)
    shape = tuple(cfg.shape)
    if tuple(phi.shape[1:]) != shape:
        raise ValueError(f"phi has lattice {tuple(phi.shape[1:])}, cfg {cfg.shape}")
    zeros = (0,) * len(shape)
    return _geometry(cfg, shape, zeros, zeros, n_steps, phi.shape[0], tile_rows)


def _slice_means(phi, x):
    """(C, L0) dim-0 slice means of ``x``, as the kernel forms them: the sum
    times the float32 reciprocal of a slice's sites."""
    C, L0 = phi.shape[:2]
    return x.reshape(C, L0, -1).sum(-1) * float(np.float32(1.0 / (phi[0, 0].numel())))


def field_pair_nd_ref(phi: torch.Tensor, dtau: torch.Tensor, action: FieldAction,
                      cfg: FieldConfig, step: int, tile_rows=None, chain_offset: int = 0):
    """Plain PyTorch version of kernel 6: two micro-steps of the whole
    periodic lattice from counter ``step`` with per-chain step sizes
    ``dtau``.  Returns (phi after the pair, dim-0 slice means of the two
    pre-update fields (C, L0) each, stats (C, n_blocks, 10))."""
    geo = _pair_geometry(phi, cfg, tile_rows)
    steps = micro_steps(phi, dtau, action, cfg, step, 2, chain_offset=chain_offset)
    return (steps[1][1], _slice_means(phi, phi), _slice_means(phi, steps[0][1]),
            _block_stats(geo, steps))


def field_pair_nd(phi: torch.Tensor, dtau: torch.Tensor, action: FieldAction, cfg: FieldConfig,
                  step: int, tile_rows=None, chain_offset: int = 0):
    """Kernel 6: one micro-step pair of every chain of a D-dim lattice, tile
    by tile.  Returns what :func:`field_pair_nd_ref` returns."""
    geo = _pair_geometry(phi, cfg, tile_rows)
    if phi.device.type == "cpu":
        return field_pair_nd_ref(phi, dtau, action, cfg, step, tile_rows, chain_offset)
    out, sl, stats = _launch("sq_field_pair_nd", geo, (phi,), dtau, action, cfg, 2, step,
                             chain_offset)
    field_pair_nd.launches += 1
    inv_sl = float(np.float32(1.0 / (phi[0, 0].numel())))
    return out, sl[:, 0] * inv_sl, sl[:, 1] * inv_sl, stats


field_pair_nd.launches = 0


def field_step_nd_ref(phi: torch.Tensor, dtau: torch.Tensor, action: FieldAction,
                      cfg: FieldConfig, step: int, tile_rows=None, chain_offset: int = 0):
    """Plain PyTorch version of the one-step tail: the micro-step at counter
    ``step`` with the first Box–Muller output of the pair drawn there, on a
    periodic lattice of any D ≥ 2.  Returns (phi after the step, dim-0 slice
    means of the pre-update field (C, L0), stats (C, n_blocks, 5))."""
    geo = _pair_geometry(phi, cfg, tile_rows, 1)
    steps = micro_steps(phi, dtau, action, cfg, step, 1, chain_offset=chain_offset)
    return steps[0][1], _slice_means(phi, phi), _block_stats(geo, steps)


def field_step_nd(phi: torch.Tensor, dtau: torch.Tensor, action: FieldAction, cfg: FieldConfig,
                  step: int, tile_rows=None, chain_offset: int = 0):
    """The last micro-step of an odd ``loops``: one launch of kernel 6's code
    at one micro-step (entry ``sq_field_step_nd``), for D = 2 … 5.  Returns
    what :func:`field_step_nd_ref` returns."""
    geo = _pair_geometry(phi, cfg, tile_rows, 1)
    if phi.device.type == "cpu":
        return field_step_nd_ref(phi, dtau, action, cfg, step, tile_rows, chain_offset)
    out, sl, stats = _launch("sq_field_step_nd", geo, (phi,), dtau, action, cfg, 1, step,
                             chain_offset)
    field_step_nd.launches += 1
    return out, sl[:, 0] * float(np.float32(1.0 / (phi[0, 0].numel()))), stats


field_step_nd.launches = 0


# ---------------------------------------------------------------------------
# kernel 7: W micro-steps of a halo-extended block
# ---------------------------------------------------------------------------


def default_exchange_steps(cfg: FieldConfig) -> int:
    """Micro-steps per halo exchange (W) when ``cfg.exchange_steps`` is unset:
    the JAX package's rule, 8 for 2-D lattices and 2 for D >= 3."""
    return 8 if cfg.ndim == 2 else 2


def chunk_geometry(cfg: FieldConfig, n_chains: int, loc, W: int, split_dims, offsets=None,
                   tile_rows=None) -> Geometry:
    """The geometry of one chunk launch on an owned block ``loc``; raises
    ``ValueError`` for a (cfg, W, split) the chunk kernel does not admit."""
    check_nd_config(cfg)
    if W % 2 or W < 2:
        raise ValueError(f"the chunk kernel advances an even number of steps, not W={W}")
    split_dims = tuple(bool(s) for s in split_dims)
    if len(split_dims) != cfg.ndim or len(loc) != cfg.ndim:
        raise ValueError(f"split_dims {split_dims} and the block {tuple(loc)} must have "
                         f"the lattice's {cfg.ndim} dims")
    halos = chunk_halos(cfg, W, split_dims)
    for d, (h, n) in enumerate(zip(halos, cfg.shape)):
        if h >= n:
            raise ValueError(f"chunk halo depth {h} on dim {d} reaches the full global extent "
                             f"{n}; reduce exchange_steps")
    if min(loc) < 1:
        raise ValueError(f"the extended block is thinner than its halos {halos}")
    offsets = tuple(offsets) if offsets is not None else (0,) * cfg.ndim
    return _geometry(cfg, tuple(loc), halos, offsets, W, n_chains, tile_rows)


def _chunk_geometry(ext, cfg, W, split_dims, offsets, tile_rows) -> Geometry:
    if ext.dim() != cfg.ndim + 1 or len(split_dims) != cfg.ndim:
        raise ValueError(f"split_dims {tuple(split_dims)} and the block {tuple(ext.shape)} must "
                         f"have the lattice's {cfg.ndim} dims")
    halos = chunk_halos(cfg, W, split_dims)
    loc = tuple(n - 2 * h for n, h in zip(ext.shape[1:], halos))
    return chunk_geometry(cfg, ext.shape[0], loc, W, split_dims, offsets, tile_rows)


def field_chunk_nd_ref(ext: torch.Tensor, dtau: torch.Tensor, action: FieldAction,
                       cfg: FieldConfig, W: int, split_dims, step_base: int, offsets=None,
                       chain_offset: int = 0, tile_rows=None):
    """Plain PyTorch version of kernel 7.  The whole extended block is
    advanced with a periodic wrap inside it; what the wrap gets wrong in a
    split dim moves inward one site per stencil application and stops at the
    owned block's edge.  Returns (owned block after W steps (C, *loc), per-step
    dim-0 slice sums over owned sites (C, W, L0_loc), stats (C, n_blocks,
    5·W) over owned sites)."""
    geo = _chunk_geometry(ext, cfg, W, split_dims, offsets, tile_rows)
    dev, D = ext.device, cfg.ndim
    strides = [math.prod(geo.shape[d + 1:]) for d in range(D)]
    site = torch.zeros((1,) * (D + 1), dtype=torch.int64, device=dev)
    parity = torch.zeros((1,) * (D + 1), dtype=torch.int64, device=dev)
    for d in range(D):
        view = [1] * (D + 1)
        view[d + 1] = geo.array[d]
        g = (torch.arange(geo.array[d], dtype=torch.int64, device=dev)
             + (geo.offsets[d] - geo.halos[d])) % geo.shape[d]
        site = site + g.view(view) * strides[d]
        parity = parity + g.view(view)
    steps = micro_steps(ext, dtau, action, cfg, step_base, W, chain_offset=chain_offset,
                        site_ids=site, even=parity % 2 == 0)
    steps = [tuple(geo.owned(x) for x in s) for s in steps]
    C, L0 = ext.shape[0], geo.loc[0]
    slices = torch.stack([pre.reshape(C, L0, -1).sum(-1) for pre, *_ in steps], dim=1)
    return steps[-1][1].contiguous(), slices, _block_stats(geo, steps)


def field_chunk_nd(ext: torch.Tensor, dtau: torch.Tensor, action: FieldAction, cfg: FieldConfig,
                   W: int, split_dims, step_base: int, offsets=None, chain_offset: int = 0,
                   tile_rows=None):
    """Kernel 7: W micro-steps in one launch on the block ``ext`` (C,
    *(loc + 2·halos)), extended by ``chunk_halos(cfg, W, split_dims)`` sites
    per side in every split dim (an unsplit dim spans the whole lattice and
    wraps).  ``offsets`` are the global coordinates of the owned block's
    origin, ``step_base`` the counter of the first step, ``chain_offset`` the
    global id of chain 0.  ``phi_out`` is the owned block itself (the JAX
    kernel keeps the extended extent in dims ≥ 1 and leaves the cut to its
    caller).  Returns what :func:`field_chunk_nd_ref` returns."""
    geo = _chunk_geometry(ext, cfg, W, split_dims, offsets, tile_rows)
    if ext.device.type == "cpu":
        return field_chunk_nd_ref(ext, dtau, action, cfg, W, split_dims, step_base, offsets,
                                  chain_offset, tile_rows)
    out = _launch("sq_field_chunk_nd", geo, (ext,), dtau, action, cfg, W, step_base,
                  chain_offset)
    field_chunk_nd.launches += 1
    return out


field_chunk_nd.launches = 0


# ---------------------------------------------------------------------------
# kernel 8: W micro-steps of a dim-0 slab, halo rows read from the neighbours
# ---------------------------------------------------------------------------


def rdma_chunk_geometry(cfg: FieldConfig, n_chains: int, loc, W: int, offsets=None,
                        tile_rows=None) -> Geometry:
    """The geometry of one kernel 8 launch on the dim-0 slab ``loc``: a
    dim-0-only split, W even, counter-based noise, float32 (the rules of
    :func:`chunk_geometry`), and one hop: the halo depth H must not exceed
    the slab's rows.  Raises ``ValueError`` otherwise."""
    split = (True,) + (False,) * (cfg.ndim - 1)
    geo = chunk_geometry(cfg, n_chains, loc, W, split, offsets, tile_rows)
    if geo.halos[0] > geo.loc[0]:
        raise ValueError(f"kernel 8 reads its halo from the adjacent shards only (one hop): the "
                         f"halo of {geo.halos[0]} rows exceeds the slab's {geo.loc[0]}; use "
                         f"backend='cuda' (kernel 7, multi-hop) for thin slabs")
    return geo


def _rdma_geometry(phi, left, right, cfg, W, offsets, tile_rows) -> Geometry:
    if phi.dim() != cfg.ndim + 1 or tuple(phi.shape[2:]) != tuple(cfg.shape[1:]):
        raise ValueError(f"phi {tuple(phi.shape)} must be a (C, L0_loc, *{tuple(cfg.shape[1:])}) "
                         f"slab of the dim-0 split lattice {cfg.shape}")
    for name, x in (("left", left), ("right", right)):
        if isinstance(x, Remote):
            # another process's memory mapped into this one (parallel.ipc), on
            # this card or read through peer access: plain pointers alike
            if x.device != phi.device or x.dtype != phi.dtype:
                raise ValueError(f"the {name} neighbour's mapped slab ({x.dtype}, mapped on "
                                 f"{x.device}) does not match this shard's {phi.dtype} on "
                                 f"{phi.device}")
        elif x.device != phi.device:
            raise ValueError(
                f"the {name} neighbour's slab is on {x.device}, this shard's on {phi.device}: "
                "the shards of a dim-0 ring in one process on several devices are not ported; "
                "give each card a process of its own (a neighbour's slab is then read in the "
                "other process's memory, parallel.ipc)")
        if x.shape != phi.shape:
            raise ValueError(f"the {name} neighbour's slab {tuple(x.shape)} differs from this "
                             f"shard's {tuple(phi.shape)}")
    return rdma_chunk_geometry(cfg, phi.shape[0], tuple(phi.shape[1:]), W, offsets, tile_rows)


def field_chunk_rdma_nd_ref(phi: torch.Tensor, left: torch.Tensor, right: torch.Tensor,
                            dtau: torch.Tensor, action: FieldAction, cfg: FieldConfig, W: int,
                            step_base: int, offsets=None, chain_offset: int = 0,
                            tile_rows=None):
    """Plain PyTorch version of kernel 8: the extended block ``[left[:, -H:],
    phi, right[:, :H]]`` through :func:`field_chunk_nd_ref`.  ``left`` /
    ``right`` are the unextended slabs of the dim-0 ring neighbours before
    and after this shard.  Returns what :func:`field_chunk_nd_ref` returns."""
    geo = _rdma_geometry(phi, left, right, cfg, W, offsets, tile_rows)
    H, L0 = geo.halos[0], geo.loc[0]
    ext = torch.cat([left[:, L0 - H:], phi, right[:, :H]], dim=1)
    return field_chunk_nd_ref(ext, dtau, action, cfg, W, (True,) + (False,) * (cfg.ndim - 1),
                              step_base, offsets, chain_offset, tile_rows)


def field_chunk_rdma_nd(phi: torch.Tensor, left, right, dtau: torch.Tensor,
                        action: FieldAction, cfg: FieldConfig, W: int, step_base: int,
                        offsets=None, chain_offset: int = 0, tile_rows=None, *, out=None):
    """Kernel 8: W micro-steps in one launch on the dim-0 slab ``phi`` (C,
    L0_loc, *rest) of a lattice split in dim 0 only, reading its H halo rows
    a side from the neighbours' slabs ``left`` and ``right``: each the same
    shape, a tensor on ``phi``'s device (on a ring of one all three are
    ``phi``) or another process's slab mapped into this one
    (``parallel.ipc.Remote``).  ``out`` (CUDA only) receives φ after the W
    steps, e.g. the runner's exported slab.  ``offsets``, ``step_base`` and
    ``chain_offset`` as for :func:`field_chunk_nd`.  Returns what
    :func:`field_chunk_nd_ref` returns."""
    geo = _rdma_geometry(phi, left, right, cfg, W, offsets, tile_rows)
    if phi.device.type == "cpu":
        if out is not None or isinstance(left, Remote) or isinstance(right, Remote):
            raise ValueError("kernel 8's plain version takes CPU tensors and returns a new φ: "
                             "no mapped slab, no out=")
        return field_chunk_rdma_nd_ref(phi, left, right, dtau, action, cfg, W, step_base,
                                       offsets, chain_offset, tile_rows)
    out = _launch("sq_field_chunk_rdma_nd", geo, (phi, left, right), dtau, action, cfg, W,
                  step_base, chain_offset, out=out)
    field_chunk_rdma_nd.launches += 1
    return out


field_chunk_rdma_nd.launches = 0


# ---------------------------------------------------------------------------
# frames
# ---------------------------------------------------------------------------


def _check_frame(state: FieldState, cfg: FieldConfig) -> None:
    if cfg.ndim < 3:
        raise ValueError("field_kernel_nd covers D >= 3 lattices (2-D has its own kernels), "
                         f"not shape {cfg.shape}")
    check_nd_config(cfg)
    if tuple(state.phi.shape[1:]) != tuple(cfg.shape):
        raise ValueError(f"state.phi has lattice {tuple(state.phi.shape[1:])}, cfg {cfg.shape}")


def odd_tail(phi, vals, state: FieldState, action: FieldAction, cfg: FieldConfig, tile_rows,
             chain_offset: int = 0, tail=None):
    """The last micro-step of an odd ``cfg.loops`` (counter ``state.step +
    loops - 1``) and its statistics step: (phi, vals) after it.  ``tail`` is
    the one-step function (default :func:`field_step_nd`)."""
    tail = tail or field_step_nd
    phi, sl, stats = tail(phi, state.dtau, action, cfg, int(state.step) + cfg.loops - 1,
                          tile_rows, chain_offset)
    return phi, obs_step(vals, sl, stats, float(math.prod(cfg.shape)))


def field_frame_nd(state: FieldState, action: FieldAction, cfg: FieldConfig, *,
                   tile_rows=None, chain_offset: int = 0, pair=None, tail=None):
    """One frame (``cfg.loops`` micro-steps) through the pair kernel: a scan
    over micro-step pairs with the observable and detector step in PyTorch,
    an odd count's last step through :func:`odd_tail`, then the
    accept/reject and adaptive-Δτ epilogue of ``integrators.field``.
    ``pair`` / ``tail`` are the pair and one-step functions (default
    :func:`field_pair_nd` / :func:`field_step_nd`; the ``_ref`` functions
    force the plain versions).  Returns (state, metrics)."""
    _check_frame(state, cfg)
    pair = pair or field_pair_nd
    volume = float(math.prod(cfg.shape))
    vals = obs_init(state)
    phi = state.phi
    step0 = int(state.step)
    for k in range(cfg.loops // 2):
        phi, sl0, sl1, stats = pair(phi, state.dtau, action, cfg, step0 + 2 * k, tile_rows,
                                    chain_offset)
        vals = obs_step(vals, sl0, stats[:, :, :5], volume)
        vals = obs_step(vals, sl1, stats[:, :, 5:], volume)
    if cfg.loops % 2:
        phi, vals = odd_tail(phi, vals, state, action, cfg, tile_rows, chain_offset, tail)
    return field_mod.field_frame_epilogue(state, obs_sums(phi, vals), cfg)


def field_frame_nd_chunk(state: FieldState, action: FieldAction, cfg: FieldConfig, W: int, *,
                         tile_rows=None, chain_offset: int = 0, chunk=None, tail=None):
    """One frame of an unsplit D ≥ 3 lattice through the W-step chunk kernel:
    per chunk dim 0 is extended periodically (``[phi[-H:], phi, phi[:H]]``)
    and one launch advances ``min(W, loops)`` micro-steps; what is left of
    the even part of ``loops`` runs as a shorter tail chunk, and an odd
    count's last step through :func:`odd_tail`.  The per-step statistics step
    and the epilogue are :func:`field_frame_nd`'s, so the trajectory equals
    the pair path's.  ``chunk`` / ``tail`` are the chunk and one-step
    functions (default :func:`field_chunk_nd` / :func:`field_step_nd`).
    Returns (state, metrics)."""
    _check_frame(state, cfg)
    if W % 2:
        raise ValueError(f"the chunk kernel needs an even exchange_steps, not W={W}")
    chunk = chunk or field_chunk_nd
    L0 = cfg.shape[0]
    volume = float(math.prod(cfg.shape))
    n_per_slice = volume / L0
    split = (True,) + (False,) * (cfg.ndim - 1)
    even = cfg.loops - cfg.loops % 2
    W_main = min(W, even)
    n_chunks = even // W_main if W_main else 0
    widths = [W_main] * n_chunks + [even - n_chunks * W_main]
    vals = obs_init(state)
    phi = state.phi
    step = int(state.step)
    for Wx in widths:
        if not Wx:
            continue
        H = chunk_halos(cfg, Wx, split)[0]
        if H >= L0:
            raise ValueError(f"chunk halo depth {H} on dim 0 reaches the full global extent "
                             f"{L0}; reduce exchange_steps")
        ext = torch.cat([phi[:, L0 - H:], phi, phi[:, :H]], dim=1)
        phi, sl, stats = chunk(ext, state.dtau, action, cfg, Wx, split, step, None,
                               chain_offset, tile_rows)
        for w in range(Wx):
            vals = obs_step(vals, true_divide(sl[:, w], n_per_slice),
                            stats[:, :, 5 * w:5 * w + 5], volume)
        step += Wx
    if cfg.loops % 2:
        phi, vals = odd_tail(phi, vals, state, action, cfg, tile_rows, chain_offset, tail)
    return field_mod.field_frame_epilogue(state, obs_sums(phi, vals), cfg)


def run_field_frames_nd(state: FieldState, action: FieldAction, cfg: FieldConfig, n_frames: int,
                        *, tile_rows=None, chain_offset: int = 0, pair=None, chunk=None,
                        tail=None):
    """``n_frames`` frames of a D ≥ 3 lattice — the counterpart of
    ``stochquant_tpu.kernels.field_kernel_nd.run_field_frames_nd``: with
    ``cfg.exchange_steps`` W > 2 (and even ``loops``) through the W-step chunk
    kernel, else through the pair kernel (an odd ``loops`` ends in the
    one-step tail).  Returns (state, metrics) with metrics of shape
    (n_frames, C)."""
    W = cfg.exchange_steps
    per_frame = []
    for _ in range(n_frames):
        if W and W > 2 and cfg.loops % 2 == 0:
            state, m = field_frame_nd_chunk(state, action, cfg, W, tile_rows=tile_rows,
                                            chain_offset=chain_offset, chunk=chunk, tail=tail)
        else:
            state, m = field_frame_nd(state, action, cfg, tile_rows=tile_rows,
                                      chain_offset=chain_offset, pair=pair, tail=tail)
        per_frame.append(m)
    return state, stack_metrics(per_frame)

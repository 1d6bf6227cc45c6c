"""CPU mirrors of the work split of kernels 5-8: the index maps the wrappers
fill the launch parameters from (``field_kernel_nd.Geometry``,
``field_kernel_tiled.strip_units``), held against the sites each pass of the
CUDA kernels must reach.  No GPU needed."""

from __future__ import annotations

import itertools
import math

import numpy as np
import pytest
import torch

from stochquant_tpu_torch import actions
from stochquant_tpu_torch.config import FieldConfig, Sweep
from stochquant_tpu_torch.kernels import field_kernel_nd as nd
from stochquant_tpu_torch.kernels import field_kernel_tiled as ft

# (global shape, owned block, split dims, W, tile_rows); the owned block spans
# the whole lattice in every dim that is not split
ND_CASES = [
    ((16, 12), (16, 12), (False, False), 2, None),          # kernel 6's lattice, 2-D
    ((24, 48), (12, 16), (True, True), 2, 4),               # split in two dims
    ((24, 48), (12, 48), (True, False), 8, 4),              # W = 8, a ragged halo tile
    ((16, 12, 40), (8, 6, 40), (True, True, False), 4, None),
    ((16, 12, 40), (16, 12, 40), (False, False, False), 2, 4),
    ((32, 8, 4, 4), (16, 8, 4, 4), (True, False, False, False), 4, 2),
    ((8, 4, 4, 12), (4, 4, 4, 6), (True, False, False, True), 2, None),
    ((32, 32, 32, 32), (32, 32, 32, 32), (False,) * 4, 2, None),  # 32^4, the pair
    ((8, 6, 4, 4, 4), (4, 6, 4, 4, 4), (True, False, False, False, False), 2, None),  # D = 5
    ((12, 6, 4, 4, 6), (6, 6, 4, 4, 6), (True, False, False, False, False), 4, 3),
]


def _geometry(shape, loc, split, W, tile_rows, sweep, chains=2):
    cfg = FieldConfig(action="phi4", shape=shape, n_chains=chains, sweep=sweep)
    if not any(split):  # kernel 6: the periodic lattice, a pair
        return nd._pair_geometry(torch.zeros((chains,) + shape), cfg, tile_rows)
    offsets = tuple(n if s else 0 for n, s in zip(loc, split))
    return nd.chunk_geometry(cfg, chains, loc, W, split, offsets, tile_rows)


def _items(geo):
    return list(itertools.product(*(range(n) for n in geo.item_tiles)))


def _cover(geo, s) -> np.ndarray:
    """How often each domain site is updated at stencil application s."""
    count = np.zeros(geo.array, dtype=np.int64)
    for j in _items(geo):
        box = geo.item_box(j, s)
        if box is not None:
            count[tuple(slice(lo, hi) for lo, hi in box)] += 1
    return count


@pytest.mark.parametrize("sweep", [Sweep.SYNC, Sweep.CHECKERBOARD])
@pytest.mark.parametrize("shape,loc,split,W,tile_rows", ND_CASES)
def test_every_application_covers_the_shrunk_domain_once(shape, loc, split, W, tile_rows, sweep):
    geo = _geometry(shape, loc, split, W, tile_rows, sweep)
    assert geo.halos == tuple(geo.depth if s else 0 for s in split)
    for s in range(1, geo.depth + 1):
        want = np.zeros(geo.array, dtype=np.int64)
        want[tuple(slice(s, a - s) if h else slice(None)
                   for a, h in zip(geo.array, geo.halos))] = 1
        np.testing.assert_array_equal(_cover(geo, s), want, err_msg=f"application {s}")
    # the last application updates exactly the owned block
    last = _cover(geo, geo.depth)
    owned = np.zeros(geo.array, dtype=np.int64)
    owned[tuple(slice(h, h + n) for h, n in zip(geo.halos, geo.loc))] = 1
    np.testing.assert_array_equal(last, owned)


@pytest.mark.parametrize("shape,loc,split,W,tile_rows", ND_CASES)
def test_owned_items_are_the_statistics_blocks(shape, loc, split, W, tile_rows):
    """Every owned site lies in exactly one item, an owned one, and the owned
    items in C order are geo.blocks' blocks (the stats layout)."""
    geo = _geometry(shape, loc, split, W, tile_rows, Sweep.SYNC)
    owner = np.full(geo.loc, -1, dtype=np.int64)
    n_owned = 0
    for j in _items(geo):
        box = geo.item_box(j, 1)
        inside = geo.item_owned(j)
        if box is None:
            assert not inside
            continue
        region = tuple(slice(lo - h, hi - h) for (lo, hi), h in zip(box, geo.halos))
        in_owned = all(0 <= lo - h and hi - h <= n
                       for (lo, hi), h, n in zip(box, geo.halos, geo.loc))
        assert in_owned == inside, (j, box)  # an item lies wholly in or out of the block
        if inside:
            assert (owner[region] == -1).all()
            owner[region] = n_owned
            n_owned += 1
    assert n_owned == geo.n_blocks and (owner >= 0).all()
    ids = torch.from_numpy(owner)[None].float()
    blocks = geo.blocks(ids)  # (1, n_blocks, sites): block b holds only id b
    assert torch.equal(blocks.amin(-1)[0], torch.arange(geo.n_blocks, dtype=torch.float32))
    assert torch.equal(blocks.amax(-1)[0], torch.arange(geo.n_blocks, dtype=torch.float32))


@pytest.mark.parametrize("shape,loc,split,W,tile_rows", ND_CASES)
def test_launch_parameters_mirror_the_geometry(shape, loc, split, W, tile_rows):
    geo = _geometry(shape, loc, split, W, tile_rows, Sweep.CHECKERBOARD, chains=3)
    cfg = FieldConfig(action="phi4", shape=shape, n_chains=3, sweep=Sweep.CHECKERBOARD)
    n_steps = 2 if not any(split) else W
    p = nd._launch_params(geo, 3, actions.get_field("phi4"), cfg, n_steps)
    D = len(shape)
    assert (p.nd, p.n_steps, p.depth) == (D, n_steps, 2 * n_steps)
    assert p.n_items == math.prod(geo.item_tiles) and p.n_blocks == geo.n_blocks
    assert p.box == math.prod(geo.ext) and p.avol == math.prod(geo.array)
    for d in range(D):
        assert p.nl[d] == -(-p.h[d] // p.T[d]) and p.ndt[d] == p.loc[d] // p.T[d] + 2 * p.nl[d]
        assert p.wrap[d] == int(p.h[d] == 0 and p.T[d] == p.G[d])
        assert p.as_[d] == math.prod(geo.array[d + 1:]) and p.ls[d] == math.prod(geo.loc[d + 1:])
        assert p.gs[d] == math.prod(shape[d + 1:])
        # the global coordinate of domain coordinate 0 and of every other one
        assert p.gb[d] == (geo.offsets[d] - geo.halos[d]) % shape[d]
    assert nd._launch_params.cache_info().currsize >= 1


@pytest.mark.parametrize("shape,n,W", [((64, 128), 2, 8), ((48, 64), 1, 4), ((16, 8, 4, 4), 4, 2),
                                       ((24, 12, 40), 3, 2)])
def test_slab_rows_are_the_extended_block_the_runner_builds(shape, n, W):
    """Kernel 8's domain row x0 comes from the slab and row that the plain
    version's ``cat([left[:, -H:], phi, right[:, :H]])`` puts there."""
    cfg = FieldConfig(action="phi4", shape=shape, n_chains=2)
    loc0 = shape[0] // n
    geo = nd.rdma_chunk_geometry(cfg, 2, (loc0,) + shape[1:], W, (loc0,) + (0,) * (len(shape) - 1))
    H = geo.halos[0]
    slabs = {s: torch.arange(loc0) + 1000 * s for s in (-1, 0, 1)}
    ext = torch.cat([slabs[-1][loc0 - H:], slabs[0], slabs[1][:H]])
    assert ext.numel() == geo.array[0]
    for x0 in range(geo.array[0]):
        slab, row = geo.slab_row(x0)
        assert 0 <= row < loc0 and int(slabs[slab][row]) == int(ext[x0])


@pytest.mark.parametrize("halo", [2, 4])  # E = 20 (synchronous) and 24 (checkerboard) at T0 16
@pytest.mark.parametrize("T0,L1", [(16, 1024), (8, 1024), (64, 256), (16, 96), (4, 33), (1, 2048)])
def test_strip_units_reach_every_site_once_and_keep_every_warp_busy(halo, T0, L1):
    E = T0 + 2 * halo
    passes = [("load", E, 0)] + [(f"application {a}", E - 2 * a, a) for a in range(1, halo + 1)]
    passes.append(("store", T0, halo))
    for name, rows, first in passes:
        nch, cw, units = ft.strip_units(rows, L1)
        assert cw % 64 == 0 and nch * cw >= L1 and (nch - 1) * cw < L1
        seen = np.zeros((E, L1), dtype=np.int64)
        for warp in units:
            for r, chunk in warp:
                for lane in range(32):
                    for c in range(chunk * cw + lane, min(L1, (chunk + 1) * cw), 32):
                        seen[first + r, c] += 1
        want = np.zeros((E, L1), dtype=np.int64)
        want[first:first + rows] = 1
        np.testing.assert_array_equal(seen, want, err_msg=name)
        sizes = [len(w) for w in units]
        assert max(sizes) - min(sizes) <= 1, name  # shares differ by at most one unit
        if rows * nch >= ft.WARPS:
            assert min(sizes) >= 1, name  # every warp works


@pytest.mark.parametrize("halo", [2, 4])
def test_kept_noise_is_drawn_wherever_the_second_step_reads_it(halo):
    """Kernel 5 keeps the second Box-Muller output at the site's strip index:
    each application of the second micro-step updates only rows that the
    same half-sweep of the first one drew."""
    T0 = 16
    E = T0 + 2 * halo
    per_step = halo // 2  # 1 synchronous sweep or 2 half-sweeps a micro-step
    rows = lambda a: set(range(a, E - a))  # noqa: E731  (application a's rows)
    for k in range(per_step):
        assert rows(1 + per_step + k) <= rows(1 + k)
    assert rows(2 * per_step) == set(range(halo, halo + T0))  # the last: the owned rows


@pytest.mark.parametrize("sweep", [Sweep.SYNC, Sweep.CHECKERBOARD])
@pytest.mark.parametrize("shape,chains,want", [
    ((1024, 1024), 16, 16),  # the main path's tiled cell
    ((256, 256), 16, 32),    # fastest at 16 chains in the sweep (32 before 16 and 64)
    ((256, 256), 64, 64),
    ((1024, 1024), 1, 8),    # one chain: shorter strips give more blocks
])
def test_default_strip_takes_fewest_waves_of_rows(sweep, shape, chains, want):
    """Kernel 5's default strip height: of the heights that divide L0 and fit
    shared memory, the least waves of blocks times a thread's sites per pass,
    the tallest of equal cost."""
    cfg = FieldConfig(action="phi4", shape=shape, n_chains=chains, sweep=sweep)
    t0 = ft.resolve_tile_rows(cfg)
    assert t0 == want
    fits = [t for t in range(1, min(shape[0], ft.MAX_DEFAULT_TILE_ROWS) + 1)
            if shape[0] % t == 0 and ft.strip_bytes(t, cfg) <= ft.SMEM_BUDGET]
    cost = {t: ft.strip_cost(t, cfg) for t in fits}
    assert cost[t0] == min(cost.values())
    assert all(t < t0 for t in fits if cost[t] == cost[t0] and t != t0)

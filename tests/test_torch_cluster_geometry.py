"""The cluster geometry of the port's kernels 3, 4, 10, 11 and 12 on the CPU:
the rule that picks B blocks a chain (``kernels/_cluster.py``, each wrapper's
``cluster_geometry`` / ``chunk_geometry``), given the card's occupancy answer
as an argument, and a Python mirror of the strips and halo rows of
``csrc/cluster.cuh`` and of kernel 12's steps over them.  The kernels
themselves run only on the card (``chip_smoke.py`` [6] [10] [17] [20], the
tests marked ``cuda``)."""

import pytest
import torch

from stochquant_tpu_torch import actions
from stochquant_tpu_torch.config import FieldConfig, Sweep
from stochquant_tpu_torch.integrators import field, gauge
from stochquant_tpu_torch.kernels import _build, _cluster
from stochquant_tpu_torch.kernels import field_kernel as fk
from stochquant_tpu_torch.kernels import gauge_kernel as gk

# what an H100 80GB HBM3 answers for these kernels' 1024-thread blocks
# (cudaOccupancyMaxActiveClusters; PERF.md §6): clusters sit inside one GPC
# (14 to 18 SMs), so it holds 30 clusters of 4, 15 of 8 and 7 of 16, not 132 / B
RESIDENT = {1: 132, 2: 66, 4: 30, 8: 15, 16: 7}


def card(g) -> int:
    """Chains the card runs at once in geometry g."""
    return RESIDENT[g.B]


U1, SU2, SU3 = 0, 1, 2


@pytest.mark.parametrize("chains,shape,planes,want", [
    # field 256^2 x 16, the timed shape: 8 blocks a chain would take two waves
    (16, (256, 256), 1, (4, 64, True)),
    (16, (256, 256), 3, (4, 64, False)),     # Philox: three noise planes go to global memory
    (1, (256, 256), 1, (16, 16, True)),      # one chain: the largest cluster
    (256, (256, 256), 1, (1, 256, False)),   # many chains: one block each
    (4, (64, 128), 1, (16, 4, True)),
    (3, (5, 64), 1, (1, 5, False)),          # tiny: a cluster's fixed cost outweighs 5 rows
    (3, (3, 64), 1, (1, 3, False)),
    (2, (1, 16), 1, (1, 1, False)),
])
def test_field_geometry(chains, shape, planes, want):
    g = fk.cluster_geometry(chains, shape, planes, card)
    assert (g.B, g.rows, g.scratch_in_smem) == want
    assert g.B <= shape[0] and g.smem <= _cluster.SMEM_LIMIT
    assert g.B == 1 or g.rows == -(-shape[0] // g.B)


@pytest.mark.parametrize("chains,shape,group,want", [
    (32, (256, 256), U1, (8, 32, True)),     # u1 256^2 x 32: three waves of 8-block clusters
    (16, (128, 128), SU2, (16, 8, True)),
    (8, (64, 64), SU3, (8, 8, True)),
    (256, (16, 128), U1, (1, 16, False)),    # kernel 11's K = 8 cell
    (256, (16, 16), U1, (1, 16, False)),     # cli run --preset u1_2d --chains 256
    (256, (8, 128), SU3, (1, 8, False)),
    (256, (8, 8), SU3, (1, 8, False)),       # --preset su3_2d --chains 256
])
def test_gauge_geometry(chains, shape, group, want):
    g = gk.cluster_geometry(chains, shape, group, card)
    assert (g.B, g.rows, g.scratch_in_smem) == want
    assert g.smem <= _cluster.SMEM_LIMIT


def test_rule_weighs_waves_by_the_rows_a_block_works_through():
    cands = fk.cluster_candidates((256, 256), 1)
    assert [g.B for g in cands] == [1, 4, 8, 16]  # two strips of 128 rows: 266 KB
    resident = RESIDENT
    rows = _cluster.overhead_rows(fk.SITE_OPS, 256)
    assert rows == 16
    # 16 chains: one wave at B = 4 (64 + 16 rows) beats two at B = 8 (2 x 48)
    assert _cluster.choose(16, cands, lambda g: resident[g.B], rows).B == 4
    # without the fixed cost of a cluster step, three waves of 16 rows would win
    assert _cluster.choose(16, cands, lambda g: resident[g.B]).B == 16
    assert _cluster.choose(7, cands, lambda g: resident[g.B], rows).B == 16
    assert _cluster.choose(264, cands, lambda g: resident[g.B], rows).B == 1
    # equal cost: the larger B
    assert _cluster.choose(2, cands[:3], lambda g: {1: 1, 4: 1, 8: 2}[g.B], 0).B == 8
    # a geometry the card cannot hold is never chosen (then B = 8 and 16 tie at
    # 96 rows: the larger); none at all raises
    assert _cluster.choose(16, cands, lambda g: 0 if g.B == 4 else resident[g.B], rows).B == 16
    with pytest.raises(RuntimeError, match="no cluster geometry"):
        _cluster.choose(4, cands, lambda g: 0)


def test_a_strip_that_does_not_fit_is_no_candidate():
    # su3 64^2: two blocks would need 36 planes of 34 rows (313 KB)
    assert [g.B for g in gk.cluster_candidates((64, 64), SU3)] == [1, 4, 8, 16]
    # a wide lattice: no cluster size fits one block's shared memory
    assert [g.B for g in gk.cluster_candidates((16, 4096), SU3)] == [1]
    # the field's kept noise moves to global memory before the strip gives up B
    g = next(g for g in fk.cluster_candidates((256, 512), 3) if g.B == 8)
    assert not g.scratch_in_smem


def test_forced_size_and_what_does_not_fit():
    cands = gk.cluster_candidates((5, 64), U1)
    assert _cluster.forced_geometry(cands) is None
    with _cluster.forced(4):
        g = _cluster.forced_geometry(cands)
        assert (g.B, g.rows) == (4, 2)
    assert _cluster.forced_geometry(cands) is None
    with _cluster.forced(8), pytest.raises(ValueError, match="B=8 does not fit"):
        _cluster.forced_geometry(cands)
    with pytest.raises(ValueError, match="cluster size 3"):
        with _cluster.forced(3):
            pass
    with _cluster.forced(1):
        assert _cluster.forced_geometry(cands) == _cluster.Geometry(1, 5, 0, False)
    with pytest.raises(ValueError, match="only at B > 1"):
        with _cluster.forced(1, empty=True):
            pass


def _strip(rank, B, L0):
    """Python mirror of make_strip in csrc/cluster.cuh."""
    first = lambda b: b * L0 // B  # noqa: E731
    r0, n = first(rank), first(rank + 1) - first(rank)
    up = B - 1 if rank == 0 else rank - 1
    return dict(r0=r0, n=n, up=up, n_up=first(up + 1) - first(up),
                dn=0 if rank + 1 == B else rank + 1)


@pytest.mark.parametrize("L0", [1, 2, 3, 5, 7, 16, 45, 64, 255, 256])
def test_strips_reach_every_row_and_neighbour(L0):
    """Every row owned by exactly one rank; each owned row's neighbour rows
    r - 1 .. r + 1 (the 5-point stencil, the staples and the plaquette) lie in
    the rank's strip or its two halo rows; each halo row is filled by the push
    of the rank that owns it (an edge row into the neighbour's halo row)."""
    for B in _cluster.SIZES:
        if B > L0:
            continue
        assert _cluster.strips(L0, B) == [(s["r0"], s["r0"] + s["n"])
                                          for s in (_strip(b, B, L0) for b in range(B))]
        owner = {}
        for b in range(B):
            s = _strip(b, B, L0)
            assert s["n"] >= 1 and s["n"] <= -(-L0 // B)
            for r in range(s["r0"], s["r0"] + s["n"]):
                assert r not in owner
                owner[r] = b
        assert sorted(owner) == list(range(L0))
        for b in range(B):
            s = _strip(b, B, L0)
            local = {lr: (s["r0"] + lr - 1) % L0 for lr in range(s["n"] + 2)}  # strip_row
            for lr in range(1, s["n"] + 1):
                for d in (-1, 0, 1):
                    assert (local[lr] + d) % L0 == local[lr + d]
            # the halo rows: pushed by the owner of that row, from its edge row
            up, dn = _strip(s["up"], B, L0), _strip(s["dn"], B, L0)
            assert owner[local[0]] == s["up"] and local[0] == (up["r0"] + up["n"] - 1) % L0
            assert owner[local[s["n"] + 1]] == s["dn"] and local[s["n"] + 1] == dn["r0"] % L0
            # what rank b pushes: its first row into up's row n_up + 1, its last into dn's row 0
            assert (up["r0"] + s["n_up"] + 1 - 1) % L0 == s["r0"]
            assert (dn["r0"] + 0 - 1) % L0 == s["r0"] + s["n"] - 1


def test_shared_memory_sizes_mirror_the_sources():
    """The Python sizes are the sources' field_cl_floats / gauge_cl_floats."""
    src = (_build._CSRC / "field_kernel.cu").read_text()
    assert "2 * strip + noise + p.cl_rows + 6 * 32 + 2 * 8 + 8 * SQ_MAX_CLUSTER" in src
    assert "(size_t)(p.philox ? 3 : 1) * p.cl_rows * p.L1" in src
    src = (_build._CSRC / "gauge_kernel.cu").read_text()
    assert "Layout<G>::P * strip + scratch + 3 * 32 + 4 + 3 * SQ_MAX_CLUSTER" in src
    assert "(size_t)(Layout<G>::FP + Layout<G>::NP) * strip" in src
    assert "#define SQ_MAX_CLUSTER 16" in (_build._CSRC / "cluster.cuh").read_text()
    assert ("2 * Layout<G>::P * strip + kept + 32 * (W + 1) + (1 + SQ_MAX_CLUSTER) * (W + 2) + W"
            in src)
    assert "(size_t)Layout<G>::NP * p.cl_rows * p.L1" in src
    assert "cluster.cuh" in _build._HEADERS
    # the timed shapes (bytes a block)
    assert 4 * _cluster.field_smem_floats(32, 256, 1, True) == 103_872
    assert 4 * _cluster.gauge_smem_floats(64, 256, 2, 2, 2, False) == 135_760
    assert 4 * _cluster.gauge_smem_floats(4, 64, 36, 36, 16, True) == 135_760


# kernel 12 at the timed shapes: one shard of u1 256^2 x 32 and su3 64^2 x 8 cut
# in two along dim 0, W = H = 8, so E0 = 128 + 16 and 32 + 16 rows
CHUNK_TIMED = [(32, 144, 256, U1, (8, 18, True)), (8, 48, 64, SU3, (8, 6, True))]


@pytest.mark.parametrize("chains,E0,L1,group,want", CHUNK_TIMED)
def test_chunk_geometry_at_the_timed_shapes(chains, E0, L1, group, want):
    """Every candidate's strip fits a block's shared memory; the rule runs a
    chain over several blocks there (u1: 3 waves of 18 rows beat 2 of 36 and 5
    of 9; su3: 64 rows a side do not fit below B = 8)."""
    cands = gk.chunk_candidates(E0, L1, group, 8)
    assert [g.B for g in cands] == ([1, 4, 8, 16] if group == U1 else [1, 8, 16])
    for g in cands:
        assert g.smem <= _cluster.SMEM_LIMIT
        assert g.B == 1 or g.rows == -(-E0 // g.B)
    g = gk.chunk_geometry(chains, E0, L1, group, 8, card)
    assert (g.B, g.rows, g.scratch_in_smem) == want
    assert g.smem == 4 * _cluster.gauge_chunk_smem_floats(
        g.rows, L1, (2, 8, 36)[group], (2, 6, 16)[group], 8, True)
    # su3's strips hold fewer sites than two a thread: a thread per link direction
    assert gk.chunk_split(g, L1, group) == (group == SU3)
    assert not gk.chunk_split(gk.chunk_candidates(E0, L1, group, 8)[0], L1, group)
    with gk.forced_split(group != SU3):  # the timing tool's pin, undone on leaving
        assert gk.chunk_split(g, L1, group) == (group != SU3)
    assert gk.chunk_split(g, L1, group) == (group == SU3)


def test_chunk_geometry_at_many_chains_and_the_smallest_blocks():
    # 256 chains of a small block: one block a chain, the buffers in global memory
    assert gk.chunk_geometry(256, 24, 64, U1, 8, card).B == 1
    # E0 = 6 rows (loc0 2, W 2): B = 2 and 4 only, and the kept noise moves out
    # of shared memory before a strip gives up its B
    assert [g.B for g in gk.chunk_candidates(6, 64, SU3, 2)] == [1, 2, 4]
    g = next(g for g in gk.chunk_candidates(48, 150, SU3, 8) if g.B == 16)
    assert not g.scratch_in_smem and g.smem <= _cluster.SMEM_LIMIT


def _chunk_steps(E0, W, B):
    """Kernel 12's steps over the strips of an E0-row extended block at B blocks,
    as gauge_chunk_kernel indexes them: each rank's two buffers of local rows
    0 .. n + 1 (local row lr is extended row r0 + lr - 1) hold the step count
    of the value there; step k reads buffer k % 2 and writes the other, at the
    active rows [max(r0, k + 1), min(r0 + n, E0 - 1 - k)), pushing a new first
    row into rank - 1's row n_up + 1 and a new last row into rank + 1's row 0.
    Returns, per rank, (r0, n, buffers) after W steps; raises where a read
    meets a value of another step."""
    ranks = [dict(r0=a, n=b - a, buf=[{}, {}]) for a, b in _cluster.strips(E0, B)]
    for k_rank in ranks:  # the load: rows that exist, at step 0
        for lr in range(k_rank["n"] + 2):
            if 0 <= k_rank["r0"] + lr - 1 < E0:
                k_rank["buf"][0][lr] = 0
    for k in range(W):
        for b, rk in enumerate(ranks):
            r0, n = rk["r0"], rk["n"]
            A, O = rk["buf"][k % 2], rk["buf"][1 - k % 2]
            for r in range(max(r0, k + 1), min(r0 + n, E0 - 1 - k)):
                lr = r - r0 + 1
                for d in (-1, 0, 1):  # the staples and the plaquette read rows r - 1 .. r + 1
                    assert A.get(lr + d) == k, (E0, W, B, k, b, r, d)
                O[lr] = k + 1
                if lr == 1 and b > 0:
                    up = ranks[b - 1]
                    up["buf"][1 - k % 2][up["n"] + 1] = k + 1
                if lr == n and b + 1 < B:
                    ranks[b + 1]["buf"][1 - k % 2][0] = k + 1
    return ranks


@pytest.mark.parametrize("loc0,W", [(2, 2), (4, 4), (8, 8), (13, 4), (128, 8), (32, 8)])
def test_chunk_strips_read_only_the_values_of_their_step(loc0, W):
    """The strips cover every row of the extended block once; no step reads a
    row another step left (a halo row a neighbour did not push, a stale row of
    the other buffer); after the W steps (W even: buffer 0) every owned row
    holds the value of step W."""
    E0 = loc0 + 2 * W
    for B in _cluster.SIZES:
        if B > E0:
            continue
        assert sorted(r for a, b in _cluster.strips(E0, B) for r in range(a, b)) == list(range(E0))
        for rk in _chunk_steps(E0, W, B):
            for r in range(max(rk["r0"], W), min(rk["r0"] + rk["n"], W + loc0)):
                assert rk["buf"][0][r - rk["r0"] + 1] == W


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU interpret mode")
    return torch.device("cuda")


SUMS = {"mag_mean", "mag2_mean", "mag4_mean", "absmag_mean", "phi2_mean", "act_mean",
        "corr_mean", "plaq_mean"}


def _same_but_sums(got, ref):
    (gs, gm), (rs, rm) = got, ref
    for name, x, y in [*zip(gs._fields, gs, rs), *((k, gm[k], rm[k]) for k in rm)]:
        x, y = x.cpu(), y.cpu()
        if x.is_complex():
            x, y = torch.view_as_real(x), torch.view_as_real(y)
        if name in SUMS:
            torch.testing.assert_close(x, y, rtol=3e-5, atol=3e-6, equal_nan=True, msg=name)
        elif x.is_floating_point():
            nan = torch.isnan(x)
            assert torch.equal(nan, torch.isnan(y)) and torch.equal(x[~nan], y[~nan]), name
        else:
            assert torch.equal(x, y), name


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", [
    FieldConfig(shape=(45, 72), dtau=0.01, n_chains=3, loops=7, seed=5),
    FieldConfig(shape=(29, 40), dtau=0.01, n_chains=3, loops=9, seed=4, sweep=Sweep.CHECKERBOARD),
    FieldConfig(shape=(32, 64), dtau=0.5, n_chains=4, loops=4, seed=2, rng_impl="hardware"),
])
def test_cuda_field_kernels_at_every_cluster_size(cuda_device, cfg):
    """Kernels 3 (+ epilogue) and 4 at every B the rule can pick: φ and every
    decision bit for bit those of B = 1, the site sums within the gate."""
    act = actions.get_field(cfg.action)
    s0 = field.init_field_state(cfg, device=cuda_device)
    sizes = [g.B for g in fk.cluster_candidates(cfg.shape, fk.noise_planes(cfg))]
    assert len(sizes) > 1
    ref = {}
    for B in sizes:
        with _cluster.forced(B):
            runs = (fk.run_field_frames_kernel(s0, act, cfg, 2),
                    fk.field_frames_multi(s0, act, cfg, 2))
            assert fk.field_frames_multi.geometry.B == B
        for k, got in enumerate(runs):
            if k in ref:
                _same_but_sums(got, ref[k])
            else:
                ref[k] = got


@pytest.mark.cuda
@pytest.mark.parametrize("group,beta,dtau", [("u1", 1.0, 5e-3), ("su2", 2.0, 2e-3),
                                             ("su3", 5.0, 1e-3)])
def test_cuda_gauge_kernels_at_every_cluster_size(cuda_device, group, beta, dtau):
    """Kernels 10 (+ epilogue) and 11 at every B the rule can pick on a 13-row
    lattice with one chain's link NaN: links and every decision bit for bit
    those of B = 1, ``plaq_mean`` within the gate."""
    cfg = gauge.GaugeConfig(group=group, beta=beta, shape=(13, 64), n_chains=3, dtau=dtau,
                            loops=5, seed=41, hot_start=True)
    act = gauge.resolve_gauge_action(cfg)
    s0 = gauge.init_gauge_state(cfg, act, device=cuda_device)
    links = s0.links.clone()
    links.view(3, -1)[1, 3] = float("nan")
    s0 = s0._replace(links=links)
    sizes = [g.B for g in gk.cluster_candidates(cfg.shape, ("u1", "su2", "su3").index(group))]
    assert len(sizes) > 1
    ref = {}
    for B in sizes:
        with _cluster.forced(B):
            runs = (gk.run_gauge_frames_kernel(s0, act, cfg, 3),
                    gk.gauge_frames_multi(s0, act, cfg, 3))
            assert gk.gauge_frames_multi.geometry.B == B
        for k, got in enumerate(runs):
            if k in ref:
                _same_but_sums(got, ref[k])
            else:
                ref[k] = got

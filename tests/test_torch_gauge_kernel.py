"""The port's gauge kernels 10 and 11: on the CPU the wrappers run their
plain versions, which must match the JAX package's Pallas kernels (interpret
mode, as tests/test_gauge_kernel.py runs them) for U(1) and SU(2), and its
XLA path for SU(3) (whose Pallas interpret run takes about a minute) —
links within rtol 2e-6 / atol 2e-6 (su3: rtol 2e-5), ``plaq_mean`` within
rtol 1e-5 / atol 1e-6, decisions and counters exactly.  The CUDA kernels
themselves are compared with the plain versions on the card (tests marked
``cuda``, and ``chip_smoke.py``)."""

import ctypes
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stochquant_tpu.integrators import gauge as jg
from stochquant_tpu.kernels import gauge_kernel as jgk
from stochquant_tpu_torch import rng
from stochquant_tpu_torch.integrators import gauge as tg
from stochquant_tpu_torch.io import checkpoint
from stochquant_tpu_torch.kernels import _build
from stochquant_tpu_torch.kernels import gauge_kernel as gk

torch.set_num_threads(1)

EXACT = ("runs", "stab_cnt", "step")
LINKS_TOL = {"u1": dict(rtol=2e-6, atol=2e-6), "su2": dict(rtol=2e-6, atol=2e-6),
             "su3": dict(rtol=2e-5, atol=2e-6)}
CFG = {
    "u1": tg.GaugeConfig(group="u1", beta=1.0, shape=(8, 16), n_chains=3, dtau=5e-3, loops=4,
                         seed=17, grow_after=1, dtau_max=5.1e-3, hot_start=True),
    "su2": tg.GaugeConfig(group="su2", beta=2.0, shape=(8, 16), n_chains=3, dtau=2e-3, loops=3,
                          seed=19, drift_cap=1.0, hot_start=True),
    "su3": tg.GaugeConfig(group="su3", beta=5.0, shape=(8, 16), n_chains=2, dtau=1e-3, loops=3,
                          seed=23, hot_start=True),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU interpret mode")
    return torch.device("cuda")


def _start(cfg, nan_chain=None):
    """The JAX package's initial state (optionally one chain's link NaN)
    and the same leaves as the port's state."""
    jcfg = jg.GaugeConfig.from_json(cfg.to_json())
    js = jg.init_gauge_state(jcfg)
    if nan_chain is not None:
        links = np.asarray(js.links).copy()
        links.reshape(cfg.n_chains, -1)[nan_chain, 3] = np.nan
        js = js._replace(links=jnp.asarray(links))
    port = checkpoint.state_from_numpy({n: np.asarray(v) for n, v in zip(js._fields, js)}, "cpu")
    return jcfg, jg.resolve_gauge_action(jcfg), js, port


def _assert_matches(group, got, gm, want, wm, rejected=()):
    stable = gm["stable"].numpy()
    np.testing.assert_array_equal(stable, np.asarray(wm["stable"]))
    np.testing.assert_allclose(gm["dtau"].numpy(), np.asarray(wm["dtau"]), rtol=2e-6)
    keep = np.ones(stable.shape[1], bool)
    keep[list(rejected)] = False
    np.testing.assert_allclose(gm["drift_max"].numpy()[:, keep],
                               np.asarray(wm["drift_max"])[:, keep], rtol=2e-6)
    for name, g, w in zip(got._fields, got, want):
        w = np.asarray(w)
        if name in EXACT:
            np.testing.assert_array_equal(g.numpy().astype(w.dtype), w, err_msg=name)
        elif name == "links":
            np.testing.assert_allclose(g.numpy(), w, err_msg=name, **LINKS_TOL[group])
        elif name == "plaq_mean":
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-6, err_msg=name)
        else:
            np.testing.assert_allclose(g.numpy(), w, rtol=2e-6, err_msg=name)


@pytest.mark.parametrize("group,fpl,nan_chain", [
    ("u1", 1, 1),     # kernel 10 + epilogue, a rejected chain, Δτ growth into dtau_max
    ("u1", 2, None),  # kernel 11, K=2
    ("su2", 1, 2),    # odd loops, capped drift, a rejected chain
    ("su2", 2, None),
])
def test_plain_kernels_match_pallas_interpret(group, fpl, nan_chain):
    cfg = CFG[group]
    jcfg, jact, js, port = _start(cfg, nan_chain)
    want, wm = jgk.run_gauge_frames_pallas(js, jact, jcfg, 2, interpret=True,
                                           frames_per_launch=fpl)
    got, gm = gk.run_gauge_frames_kernel(port, tg.resolve_gauge_action(cfg), cfg, 2,
                                         frames_per_launch=fpl)
    assert gm["stable"].shape == (2, cfg.n_chains)
    if nan_chain is not None:
        assert not gm["stable"][:, nan_chain].any()
        assert torch.isnan(gm["drift_max"][:, nan_chain]).all()
    _assert_matches(group, got, gm, want, wm)


def test_su3_plain_kernels_match_xla():
    cfg = CFG["su3"]
    jcfg, jact, js, port = _start(cfg, nan_chain=1)
    want, wm = jg.run_gauge_frames(js, jact, jcfg, 2)
    act = tg.resolve_gauge_action(cfg)
    got, gm = gk.gauge_frames_multi(port, act, cfg, 2)
    _assert_matches("su3", got, gm, want, wm)
    single, sm = gk.run_gauge_frames_kernel(port, act, cfg, 2)
    for name, x, y in zip(got._fields, got, single):
        torch.testing.assert_close(x, y, rtol=0, atol=0, equal_nan=True, msg=name)


@pytest.mark.parametrize("group", ["u1", "su2", "su3"])
def test_cpu_tensors_run_the_plain_versions_without_launching(group):
    cfg = dataclasses.replace(CFG[group], n_chains=2, shape=(4, 8))
    act = tg.resolve_gauge_action(cfg)
    s0 = tg.init_gauge_state(cfg, act, device="cpu")
    before = (gk.gauge_frame.launches, gk.gauge_frames_multi.launches)
    one, m1 = gk.gauge_frame(s0, act, cfg)
    ref, _ = gk.gauge_frame_ref(s0, act, cfg)
    for name, x, y in zip(one._fields, one, ref):
        torch.testing.assert_close(x, y, rtol=0, atol=0, msg=name)
    multi, mm = gk.gauge_frames_multi(s0, act, cfg, 3)
    seq, sm = gk.run_gauge_frames_kernel(s0, act, cfg, 3, frames_per_launch=2)
    for name, x, y in zip(multi._fields, multi, seq):
        torch.testing.assert_close(x, y, rtol=0, atol=0, msg=name)
    for key in mm:
        torch.testing.assert_close(mm[key], sm[key], rtol=0, atol=0, msg=key)
    assert mm["stable"].shape == (3, 2) and int(multi.step) == 1 + 3 * cfg.loops
    assert m1["unitarity_norm"].abs().sum() == 0
    assert (gk.gauge_frame.launches, gk.gauge_frames_multi.launches) == before
    # the kernels' plane layout round-trips the state layout exactly
    planes = gk.links_to_planes(seq.links, act)
    assert planes.shape == (2, {"u1": 2, "su2": 8, "su3": 36}[group], 4, 8)
    assert planes.dtype == torch.float32 and planes.is_contiguous()
    assert torch.equal(gk.planes_to_links(planes, act), seq.links)


def test_su3_plane_layout():
    cfg = dataclasses.replace(CFG["su3"], shape=(2, 3), n_chains=1)
    act = tg.resolve_gauge_action(cfg)
    links = tg.init_gauge_state(cfg, act, device="cpu").links
    planes = gk.links_to_planes(links, act)
    # plane 18 mu + 2 (3 r + c) + {re, im}
    for mu, r, c, x, y in ((0, 0, 1, 1, 2), (1, 2, 0, 0, 1), (1, 1, 2, 1, 0)):
        p = 18 * mu + 2 * (3 * r + c)
        assert planes[0, p, x, y] == links[0, mu, x, y, r, c].real
        assert planes[0, p + 1, x, y] == links[0, mu, x, y, r, c].imag


def test_kernel_parameters_mirror_the_cuda_struct():
    # 8 integer fields, 2 unsigned and 8 floats, then the chunk kernel's 2 unsigned and
    # 4 integers, the 4 cluster-geometry integers and kernel 12's work item, in the order
    # of csrc/gauge_kernel.cu
    assert ctypes.sizeof(_build.GaugeParams) == 29 * 4
    src = (_build._CSRC / "gauge_kernel.cu").read_text()
    start = src.index("struct GaugeParams {")
    body = src[start:src.index("};", start)]
    names = []
    for line in body.splitlines()[1:]:
        decl = line.split("//")[0].strip().rstrip(";")
        if decl:
            names += [n.strip() for n in decl.split(None, 1)[1].split(",")]
    assert names == [f for f, _ in _build.GaugeParams._fields_]
    assert "gauge_kernel.cu" in _build._SOURCES

    for group, coef in (("u1", -1.5), ("su2", -0.75), ("su3", np.float32(1.5 / 12))):
        cfg = tg.GaugeConfig(group=group, beta=1.5, shape=(8, 16), n_chains=3, loops=5,
                             dtau_max=0.5, grow_after=3, seed=2**32 + 9)
        p = gk.kernel_params(tg.resolve_gauge_action(cfg), cfg, step0=2**32 + 7, n_frames=2)
        assert (p.n_chains, p.L0, p.L1, p.loops, p.n_frames) == (3, 8, 16, 5, 2)
        assert (p.group, p.grow_after, p.has_dtau_max, p.step0, p.seed) == (
            ("u1", "su2", "su3").index(group), 3, 1, 7, 9)
        assert p.coef == coef and p.cap == 20.0 and p.inv_vol == np.float32(1 / 128)
        assert p.clip_hi == np.float32(1.0 - 1e-6) and p.dtau_max == 0.5
        assert p.inv_loops == np.float32(0.2) and p.loops_f == 5.0 and p.shrink == np.float32(0.95)
        assert (p.cl_B, p.cl_rows, p.cl_scratch, p.cl_empty) == (1, 8, 0, 0)


def test_unsupported_inputs_raise():
    cfg = dataclasses.replace(CFG["u1"], shape=(4, 8))
    act = tg.resolve_gauge_action(cfg)
    s0 = tg.init_gauge_state(cfg, act, device="cpu")
    for change, match in ((dict(shape=(4, 4, 4, 4)), "2-D"),
                          (dict(cooling_rate=0.05), "cooling")):
        bad = dataclasses.replace(cfg, **change)
        assert not gk.supports(act, bad)
        with pytest.raises(ValueError, match=match):
            gk.gauge_frame(s0, act, bad)
        with pytest.raises(ValueError, match=match):
            gk.gauge_frames_multi(s0, act, bad, 2)
    assert gk.supports(act, cfg)
    with pytest.raises(ValueError, match="frames per launch"):
        gk.gauge_frames_multi(s0, act, cfg, 0)
    meta = tg.GaugeState(*(t if n == "step" else t.to("meta") for n, t in zip(s0._fields, s0)))
    with pytest.raises(ValueError, match="cuda"):
        gk.gauge_frame(meta, act, cfg)


@pytest.mark.cuda
@pytest.mark.parametrize("group", ["u1", "su2", "su3"])
def test_cuda_kernels_match_plain_versions(cuda_device, group):
    cfg = dataclasses.replace(CFG[group], shape=(16, 128))
    act = tg.resolve_gauge_action(cfg)
    s0 = tg.init_gauge_state(cfg, act, device=cuda_device)
    links = s0.links.clone()
    links.view(cfg.n_chains, -1)[1, 9] = float("nan")
    s0 = s0._replace(links=links)
    plain, pm = gk.gauge_frames_multi_ref(s0, act, cfg, 3)
    before = (gk.gauge_frame.launches, gk.gauge_frames_multi.launches)
    k10, m10 = gk.run_gauge_frames_kernel(s0, act, cfg, 3)
    k11, m11 = gk.gauge_frames_multi(s0, act, cfg, 3)
    torch.cuda.synchronize()
    assert gk.gauge_frame.launches == before[0] + 3
    assert gk.gauge_frames_multi.launches == before[1] + 1
    for got, gm in ((k10, m10), (k11, m11)):
        for leaf, x, y in [*zip(got._fields, got, plain), *((k, gm[k], pm[k]) for k in pm)]:
            if leaf in ("runs", "stab_cnt", "step", "stable"):
                assert torch.equal(x.cpu(), y.cpu()), leaf
            elif leaf == "plaq_mean":
                torch.testing.assert_close(x, y, rtol=3e-5, atol=3e-6, msg=leaf)
            else:
                torch.testing.assert_close(x, y, rtol=0, atol=2e-6, equal_nan=True, msg=leaf)


# ---------------------------------------------------------------------------
# kernel 12: W micro-steps of a dim-0 halo-extended block
# ---------------------------------------------------------------------------


def _extended(planes, row_off, loc0, H):
    """Rows row_off - H .. row_off + loc0 + H of periodic planes (C, P, L0, L1)."""
    idx = (np.arange(loc0 + 2 * H) + row_off - H) % planes.shape[2]
    return np.ascontiguousarray(planes[:, :, idx])


@pytest.mark.parametrize("group,shape,loc0,W,row_off,cap", [
    ("u1", (16, 16), 8, 4, 8, 20.0),    # the halo wraps the global lattice
    ("u1", (16, 16), 8, 6, 0, 20.0),    # tests/test_gauge_halo.py's auto W at x = 2
    ("u1", (16, 16), 4, 2, 12, 1e-6),   # a cap event on every chain
    ("su2", (8, 16), 4, 4, 4, 20.0),
    ("su2", (8, 16), 4, 2, 0, 0.5),
])
def test_chunk_ref_matches_one_pallas_chunk_call(group, shape, loc0, W, row_off, cap):
    """``gauge_chunk_ref`` against ``make_gauge_chunk_step(..., interpret=True)``
    on the same extended block: owned links within 2e-6, the plaquette as a
    mean within rtol 1e-5, the drift max within rtol 2e-6, both flags exactly."""
    cfg = dataclasses.replace(CFG[group], shape=shape, n_chains=2, drift_cap=cap)
    jcfg, jact, js, _ = _start(cfg)
    step, H = jgk.make_gauge_chunk_step(jact, jcfg, 2, loc0, W, interpret=True)
    assert H == W
    planes = np.asarray(jgk.links_to_planes_shaped(js.links, jact, 2, shape))
    ext = _extended(planes, row_off, loc0, H)
    dtau = np.array([cfg.dtau, 1.3 * cfg.dtau], np.float32)
    want = [np.asarray(w) for w in step(jnp.asarray(ext), jnp.asarray(dtau), 5, 3, row_off)]
    got = gk.gauge_chunk_ref(torch.from_numpy(ext), torch.from_numpy(dtau),
                             tg.resolve_gauge_action(cfg), cfg, loc0, W, 5, 3, row_off)
    assert got[0].shape == (2, planes.shape[1], loc0, shape[1]) and got[0].is_contiguous()
    np.testing.assert_allclose(got[0].numpy(), want[0], **LINKS_TOL[group])
    sites = W * loc0 * shape[1]
    np.testing.assert_allclose(got[1].numpy() / sites, want[1] / sites, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[2].numpy(), want[2], rtol=2e-6)
    np.testing.assert_array_equal(got[3].numpy(), want[3])
    np.testing.assert_array_equal(got[4].numpy(), want[4])
    assert not got[3].any() and bool(got[4].all()) == (cap < 1.0)


@pytest.mark.parametrize("group", ["u1", "su2", "su3"])
def test_chunk_on_a_ring_of_one_equals_the_unsplit_frame_while_the_cap_is_quiescent(group):
    """The whole lattice extended by its own rows: W steps of the chunk give
    the links of a frame of W loops bit for bit (the cap's scale is exactly
    1), the frame's plaquette sum and drift max; and so the JAX package's XLA
    frame within the links' tolerance (su3: rtol 2e-5)."""
    W = 4
    cfg = dataclasses.replace(CFG[group], shape=(4, 8), n_chains=2, loops=W, drift_cap=20.0,
                              dtau_max=None, grow_after=10**9)
    jcfg, jact, js, port = _start(cfg)
    act = tg.resolve_gauge_action(cfg)
    planes = gk.links_to_planes_shaped(port.links, act, 2, cfg.shape)
    ext = torch.cat([planes, planes, planes], dim=2)[:, :, 4 - W:8 + W].contiguous()
    owned, ps, dmax, bad, capped = gk.gauge_chunk(ext, port.dtau, act, cfg, 4, W, int(port.step))
    sums = tg.gauge_frame_sums(port, act, cfg)
    assert torch.equal(gk.planes_to_links_shaped(owned, act, 2, cfg.shape), sums.links)
    assert torch.equal(dmax, sums.dmax) and not bad.any() and not capped.any()
    torch.testing.assert_close(ps / 32.0, sums.ps, rtol=1e-5, atol=1e-6)
    want, _ = jg.run_gauge_frames(js, jact, jcfg, 1)
    np.testing.assert_allclose(gk.planes_to_links(owned, act).numpy(), np.asarray(want.links),
                               **LINKS_TOL[group])


def test_chunk_flags_and_nan_rows():
    """``bad`` is per chain and takes the owned rows: a NaN link in an owned
    row, or in the halo row beside them (it moves inward a row per step), sets
    it, and the chain's drift max is NaN; the other chains are untouched."""
    cfg = dataclasses.replace(CFG["u1"], shape=(16, 8), n_chains=3)
    act = tg.resolve_gauge_action(cfg)
    s0 = tg.init_gauge_state(cfg, act, device="cpu")
    W, loc0 = 2, 6
    ext = torch.from_numpy(_extended(gk.links_to_planes(s0.links, act).numpy(), 4, loc0, W))
    clean = gk.gauge_chunk_ref(ext, s0.dtau, act, cfg, loc0, W, 1, 0, 4)
    dirty = ext.clone()
    dirty[1, 1, W + 1, 3] = float("nan")      # an owned row
    dirty[2, 0, W - 1, 5] = float("nan")      # the halo row beside the owned rows
    got = gk.gauge_chunk_ref(dirty, s0.dtau, act, cfg, loc0, W, 1, 0, 4)
    assert got[3].tolist() == [False, True, True] and not clean[3].any()
    for g, c in zip(got, clean):
        assert torch.equal(g[0], c[0])
    assert torch.isnan(got[2][1]) and torch.isnan(got[0][1]).any()


def _chunk_on_the_shrinking_domain(ext, dtau, action, cfg, loc0, W, step_base, chain_off,
                                   row_off):
    """``gauge_chunk_ref``'s W steps, each keeping only kernel 12's domain: step
    k keeps its update of rows [k + 1, E0 - 1 - k) and sets every other row to
    NaN, so a read outside the domain would reach the owned rows."""
    H = W
    C, P, E0, L1 = ext.shape
    L0g, NP = cfg.shape[0], gk._GROUPS[type(action)][2]
    rows = (torch.arange(E0, dtype=torch.int64) + (row_off - H)) % L0g
    site = (torch.arange(NP, dtype=torch.int64).view(NP, 1, 1) * (L0g * L1)
            + rows.view(1, E0, 1) * L1 + torch.arange(L1, dtype=torch.int64).view(1, 1, L1))
    noise_shape = action.noise_shape(C, 2, (E0, L1))
    site = rng.u32(site).reshape((1,) + tuple(noise_shape[1:]))
    chains = rng.u32(torch.arange(C, dtype=torch.int64) + chain_off)
    k1 = rng.chain_key(rng.Stream.FIELD, chains).view((C,) + (1,) * (len(noise_shape) - 1))
    own = torch.zeros((1, 1, E0, 1), dtype=torch.bool)
    own[:, :, H:H + loc0] = True
    cap = float(np.float32(cfg.drift_cap))
    links = gk.planes_to_links(ext, action)
    ps, dmax = torch.zeros((C,)), torch.zeros((C,))
    bad, capped = torch.zeros((C,), dtype=torch.bool), torch.zeros((C,), dtype=torch.bool)
    k = 0
    for j in range(0, W, 2):
        for eta in rng.normal_pair(rng.u32(cfg.seed), k1, site, rng.u32(step_base + j)):
            f = action.drift(links, 2)
            dnorm = torch.amax(torch.where(own, action.drift_magnitude(f), 0.0), dim=(1, 2, 3))
            plaq = torch.where(own[:, 0], action.plaquette_site(links, 0, 1, 2), 0.0)
            planes = gk.links_to_planes(action.apply_update(links, action.omega(f, eta, dtau)),
                                        action)
            keep = torch.zeros((1, 1, E0, 1), dtype=torch.bool)
            keep[:, :, k + 1:E0 - 1 - k] = True
            planes = torch.where(keep, planes, float("nan"))
            links = gk.planes_to_links(planes, action)
            ps = ps + plaq.sum(dim=(1, 2))
            dmax = torch.maximum(dmax, dnorm)
            bad = bad | ~torch.all((torch.isfinite(planes) | ~own).reshape(C, -1), dim=1)
            capped = capped | (dnorm > cap)
            k += 1
    return planes[:, :, H:H + loc0].contiguous(), ps, dmax, bad, capped


@pytest.mark.parametrize("group,loc0,W,row_off", [
    ("u1", 4, 2, 0),     # the upper halo wraps the global lattice
    ("u1", 8, 4, 12),    # the lower halo wraps it
    ("u1", 8, 8, 8),     # the extended block is 1.5 lattices
    ("su2", 4, 2, 14),
    ("su2", 4, 4, 0),
    ("su2", 8, 8, 4),
])
def test_chunk_needs_only_the_rows_that_reach_the_owned_ones(group, loc0, W, row_off):
    """Kernel 12 updates at step k only the rows [k + 1, E0 - 1 - k) of the
    extended block and never wraps in dim 0: ``gauge_chunk_ref`` with every
    other row poisoned after each step gives the owned links, the plaquette
    sum, the drift max and both flags bit for bit."""
    cfg = dataclasses.replace(CFG[group], shape=(16, 8), n_chains=2, drift_cap=0.9)
    act = tg.resolve_gauge_action(cfg)
    s0 = tg.init_gauge_state(cfg, act, device="cpu")
    ext = torch.from_numpy(_extended(gk.links_to_planes(s0.links, act).numpy(), row_off, loc0,
                                     W))
    dtau = torch.tensor([cfg.dtau, 1.5 * cfg.dtau])
    want = gk.gauge_chunk_ref(ext, dtau, act, cfg, loc0, W, 9, 2, row_off)
    got = _chunk_on_the_shrinking_domain(ext, dtau, act, cfg, loc0, W, 9, 2, row_off)
    assert not torch.isnan(got[0]).any()
    for name, g, w in zip(("owned", "plaquette", "dmax", "bad", "capped"), got, want):
        assert torch.equal(g, w), name


@pytest.mark.parametrize("group", ["u1", "su2", "su3"])
def test_cpu_chunk_runs_the_plain_version_without_launching(group):
    cfg = dataclasses.replace(CFG[group], shape=(8, 8), n_chains=2, drift_cap=20.0)
    act = tg.resolve_gauge_action(cfg)
    s0 = tg.init_gauge_state(cfg, act, device="cpu")
    planes = gk.links_to_planes_shaped(s0.links, act, 2, (8, 8))
    ext = torch.from_numpy(_extended(planes.numpy(), 4, 4, 2))
    step, H = gk.make_gauge_chunk_step(act, cfg, 2, 4, 2)
    before = gk.gauge_chunk.launches
    got = step(ext, s0.dtau, 7, 0, 4)
    want = gk.gauge_chunk_ref(ext, s0.dtau, act, cfg, 4, 2, 7, 0, 4)
    assert gk.gauge_chunk.launches == before and H == 2
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # a block alone takes the values the whole lattice has there (the noise is
    # keyed by the global row), and another chain offset gives other noise
    whole = tg.gauge_frame_sums(s0._replace(step=torch.tensor(7)), act,
                                dataclasses.replace(cfg, loops=2)).links
    assert torch.equal(gk.planes_to_links_shaped(got[0], act, 2, (4, 8)),
                       whole.narrow(act.lattice_axes(2)[0], 4, 4))
    assert not torch.equal(step(ext, s0.dtau, 7, 1, 4)[0], got[0])
    with pytest.raises(ValueError, match="expected extended planes"):
        step(ext[:, :, 1:], s0.dtau, 7, 1, 4)
    with pytest.raises(ValueError, match="not 2 chains on a"):
        gk.links_to_planes_shaped(s0.links, act, 2, (4, 8))


@pytest.mark.parametrize("kw,W,loc0,match", [
    ({}, 3, 4, "even number"),
    ({}, 0, 4, "even number"),
    ({}, 6, 4, "exceeds the local slab"),
    (dict(shape=(4, 4, 4, 4)), 2, 4, "2-D"),
    (dict(cooling_rate=0.1), 2, 4, "cooling"),
])
def test_chunk_step_refuses_what_the_kernel_does_not_take(kw, W, loc0, match):
    cfg = dataclasses.replace(CFG["u1"], **kw)
    with pytest.raises(ValueError, match=match):
        gk.make_gauge_chunk_step(tg.resolve_gauge_action(cfg), cfg, 2, loc0, W)


@pytest.mark.cuda
@pytest.mark.parametrize("group", ["u1", "su2", "su3"])
@pytest.mark.parametrize("W,loc0,row_off,cap", [(2, 4, 8, 20.0), (8, 8, 0, 20.0), (4, 8, 4, 0.5)])
def test_cuda_chunk_kernel_matches_plain_version(cuda_device, group, W, loc0, row_off, cap):
    cfg = dataclasses.replace(CFG[group], shape=(16, 32), n_chains=3, drift_cap=cap)
    act = tg.resolve_gauge_action(cfg)
    s0 = tg.init_gauge_state(cfg, act, device="cpu")
    ext = torch.from_numpy(_extended(gk.links_to_planes(s0.links, act).numpy(), row_off, loc0, W))
    ext[0, 0, W - 1, 3] = float("nan")
    ext, dtau = ext.to(cuda_device), s0.dtau.to(cuda_device)
    before = gk.gauge_chunk.launches
    got = gk.gauge_chunk(ext, dtau, act, cfg, loc0, W, 11, 5, row_off)
    want = gk.gauge_chunk_ref(ext, dtau, act, cfg, loc0, W, 11, 5, row_off)
    torch.cuda.synchronize()
    assert gk.gauge_chunk.launches == before + 1
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0, equal_nan=True)
    torch.testing.assert_close(got[2], want[2], rtol=0, atol=0, equal_nan=True)
    assert torch.equal(got[3], want[3]) and torch.equal(got[4], want[4])
    assert got[3].tolist() == [True, False, False]
    sites = W * loc0 * 32
    torch.testing.assert_close(got[1] / sites, want[1] / sites, rtol=3e-5, atol=3e-6,
                               equal_nan=True)
    with pytest.raises(ValueError, match="contiguous"):
        gk.gauge_chunk(ext.transpose(2, 3).contiguous().transpose(2, 3), dtau, act, cfg, loc0, W,
                       11, 5, row_off)

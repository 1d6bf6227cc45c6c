"""The gauge loop records of a split run (``runtime.run_gauge`` with
``measure_loops`` on a mesh: ``gauge_loops.split_polyakov_loop`` and
``split_wilson_loop_table``, shard-local, no gathered lattice) against the
unsplit run of the port and against the JAX package's ``run_gauge`` on the
CPU.  Splits: dim 0 in two and in four (shards thinner than the Wilson
table's halo: several hops), dims 0 and 1 (corners), a chain axis beside
dim 0; groups u1, su2, su3 and the complexified cu1, csu3.

Tolerances: the site-mean bar (PERF.md §2), rtol 3e-5 and atol 3e-6, on
every ``polyakov_re`` / ``_im`` and ``wilson_loops`` entry: the shards'
segments of a line and their site sums associate differently from the
unsplit evaluation (the links themselves are bit for bit the unsplit
run's).  Across processes the records are bitwise the one-process mesh
run's (``tests/test_torch_process_gauge.py``)."""

import dataclasses

import numpy as np
import pytest
import torch

from stochquant_tpu_torch import metrics, parallel, runtime
from stochquant_tpu_torch.integrators import gauge as tg
from stochquant_tpu_torch.observables import gauge_loops

torch.set_num_threads(1)

TOL = dict(rtol=3e-5, atol=3e-6)
BETA = {"u1": 1.0, "su2": 2.0, "su3": 5.0, "cu1": 1.0, "csu3": 5.0}
# name -> (group, mesh, mesh_axes, chain axis)
SPLITS = {
    "u1_x2": ("u1", [("x", 2)], ("x", None), None),
    "su2_x2": ("su2", [("x", 2)], ("x", None), None),
    "su3_x4": ("su3", [("x", 4)], ("x", None), None),          # 2-row shards, 4-row halo
    "u1_xy": ("u1", [("x", 2), ("y", 2)], ("x", "y"), None),
    "su2_xy": ("su2", [("x", 2), ("y", 2)], ("x", "y"), None),
    "u1_chain_x": ("u1", [("chain", 2), ("x", 2)], ("x", None), "chain"),
    "cu1_x2": ("cu1", [("x", 2)], ("x", None), None),
    "csu3_xy": ("csu3", [("x", 2), ("y", 2)], ("x", "y"), None),
}


def _cfg(group, **kw):
    base = dict(group=group, beta=BETA[group], shape=(8, 8), n_chains=2, dtau=2e-3, loops=3,
                seed=3, hot_start=True, frames=2, grow_after=10**9, measure_loops=True)
    if group.startswith("c"):
        base["beta_im"] = 0.3
    base.update(kw)
    return tg.GaugeConfig(**base)


def _records(cfg, **kw):
    out = []
    runtime.run_gauge(cfg, sink=metrics.MetricsSink(callback=out.append), **kw)
    return out


def _loops(records):
    """(frames, 2) Polyakov records and the (rmax, rmax) Wilson table."""
    poly = [(r["polyakov_re"], r["polyakov_im"]) for r in records if r.get("type") == "frame"]
    (table,) = [r["w"] for r in records if r.get("type") == "wilson_loops"]
    return np.array(poly), np.array(table)


@pytest.mark.parametrize("name", list(SPLITS))
def test_split_loop_records_match_the_unsplit_run(name):
    group, mesh_shape, axes, chain = SPLITS[name]
    cfg = _cfg(group)
    want = _loops(_records(cfg, device="cpu"))
    split = dataclasses.replace(cfg, mesh_axes=axes, mesh_chain_axis=chain)
    got = _loops(_records(split, mesh=parallel.make_mesh(mesh_shape, devices="cpu")))
    assert want[1].shape == (4, 4)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)


@pytest.mark.parametrize("group", ["u1", "su2", "su3"])
def test_split_loops_of_given_links_match_the_whole_lattice_functions(group):
    """The two functions on one set of hot links, split 2 × 2, beside
    ``polyakov_loop`` / ``wilson_loop_table`` on the whole links; a 12 × 8
    lattice so that the two dims differ."""
    cfg = _cfg(group, shape=(12, 8), mesh_axes=("x", "y"))
    act = tg.resolve_gauge_action(cfg)
    links = tg.init_gauge_state(cfg, act, device="cpu").links
    mesh = parallel.make_mesh([("x", 2), ("y", 2)], devices="cpu")
    shards = [s.links for s in parallel.shard_gauge_state(
        tg.init_gauge_state(cfg, act, device="cpu"), act, mesh, cfg)]
    np.testing.assert_allclose(gauge_loops.split_polyakov_loop(act, shards, cfg, mesh).numpy(),
                               gauge_loops.polyakov_loop(act, links, 0).numpy(), **TOL)
    np.testing.assert_allclose(
        gauge_loops.split_wilson_loop_table(act, shards, cfg, mesh, 0, 1, 4, 3).numpy(),
        gauge_loops.wilson_loop_table(act, links, 0, 1, 4, 3).numpy(), **TOL)


@pytest.mark.parametrize("name", ["u1_x2", "su2_xy"])
def test_split_loop_records_match_the_jax_run_gauge(name):
    from stochquant_tpu import runtime as jruntime
    from stochquant_tpu.integrators import gauge as jg
    from stochquant_tpu.metrics import MetricsSink as JSink

    group, mesh_shape, axes, chain = SPLITS[name]
    cfg = _cfg(group)
    jrecs = []
    jruntime.run_gauge(jg.GaugeConfig.from_json(cfg.to_json()), backend="xla",
                       sink=JSink(callback=jrecs.append))
    split = dataclasses.replace(cfg, mesh_axes=axes, mesh_chain_axis=chain)
    got = _loops(_records(split, mesh=parallel.make_mesh(mesh_shape, devices="cpu")))
    for g, w in zip(got, _loops(jrecs)):
        np.testing.assert_allclose(g, w, **TOL)

"""The port's package surface against the JAX package's: for the top level
and each of ``integrators``, ``io``, ``actions``, ``observables`` and
``parallel``, the names its ``__init__`` binds (read from the source, so the
order in which tests import submodules plays no part) are the JAX
``__init__``'s, less the names that have no counterpart by design (Pallas
and ``jax.sharding``), plus the port's own listed below.  Code written
against the JAX import paths then imports from the port.

``make_frame_fn`` / ``make_field_frame_fn``: the first frame from the seed's
state against the JAX package's, at the module tests' bars
(``tests/test_torch_langevin.py``: every leaf 2e-6;
``tests/test_torch_field.py``: φ, Δτ, ``lrg_vl`` 2e-6, the site means rtol
3e-5 / atol 3e-6), decisions and counters exact."""

import ast
import importlib
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from stochquant_tpu_torch import actions as tact
from stochquant_tpu_torch.config import BoundaryCondition, ChainConfig, FieldConfig, Formulation
from stochquant_tpu_torch.integrators import field as tfield
from stochquant_tpu_torch.integrators import langevin as tl

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SUBPACKAGES = ["", "integrators", "io", "actions", "observables", "parallel"]
#: JAX names with no counterpart: the ``jax.sharding`` helpers
NOT_PORTED = {"parallel": {"chain_state_sharding", "field_state_sharding",
                           "gauge_state_sharding"}}
#: the port's names beyond the JAX package's: its mesh and the gathers of a split state
PORT_ONLY = {"parallel": {"DeviceMesh", "gather_chain_state", "gather_field_state",
                          "gather_gauge_state", "shard_state_from_numpy"}}


def _bound_names(package: str, sub: str) -> set:
    """The public names an ``__init__.py`` binds at module level."""
    tree = ast.parse((ROOT / package / sub / "__init__.py").read_text())
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names |= {(a.asname or a.name).split(".")[0] for a in node.names}
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
    return {n for n in names if not n.startswith("_")}


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_port_init_binds_the_jax_init_names(sub):
    want = _bound_names("stochquant_tpu", sub) - NOT_PORTED.get(sub, set())
    got = _bound_names("stochquant_tpu_torch", sub)
    assert got - PORT_ONLY.get(sub, set()) == want
    assert PORT_ONLY.get(sub, set()) <= got
    port = importlib.import_module("stochquant_tpu_torch" + (f".{sub}" if sub else ""))
    assert not [n for n in want if not hasattr(port, n)]


def test_the_kernels_init_exports_only_pallas_names():
    """The JAX ``kernels`` package exports its Pallas entry points alone: no
    port name is owed there (the CUDA wrappers live in the kernel modules)."""
    assert _bound_names("stochquant_tpu", "kernels") == {"chain_frame_pallas",
                                                         "run_frames_pallas"}


def test_pot_id_tables_are_the_jax_ones():
    from stochquant_tpu import actions as jact

    assert tact.POT_ID_TO_NAME == jact.POT_ID_TO_NAME
    assert tact.NAME_TO_POT_ID == jact.NAME_TO_POT_ID
    assert set(tact.POT_ID_TO_NAME.values()) <= set(tact.names())


def _compare(got, want, close: dict, exact=("runs", "stab_cnt", "step")):
    for name, g, w in zip(got._fields, got, want):
        w = np.asarray(w)
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        if name in exact:
            np.testing.assert_array_equal(g.astype(w.dtype), w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, err_msg=name, **close.get(name, close[None]))


def test_make_frame_fn_first_frame_matches_jax():
    from stochquant_tpu import actions as jact
    from stochquant_tpu.config import ChainConfig as JChainConfig
    from stochquant_tpu.integrators import langevin as jl

    cfg = ChainConfig(action="harmonic", n_sites=64, dt=0.2, dtau=0.01, n_chains=4, loops=10,
                      bc=BoundaryCondition.PERIODIC, formulation=Formulation.DIRECT, seed=12)
    jcfg = JChainConfig.from_json(cfg.to_json())
    jstate = jl.init_chain_state(jcfg, jact.get(cfg.action))
    want, wm = jax.jit(jl.make_frame_fn(jact.get(cfg.action), jcfg))(jstate)
    act = tact.get(cfg.action)
    got, gm = tl.make_frame_fn(act, cfg)(tl.init_chain_state(cfg, act, device="cpu"))
    _compare(got, want, {None: dict(rtol=2e-6, atol=2e-6)})
    np.testing.assert_array_equal(gm["stable"].numpy(), np.asarray(wm["stable"]))


def test_make_field_frame_fn_first_frame_matches_jax():
    from stochquant_tpu.actions import phi4 as jphi4
    from stochquant_tpu.config import FieldConfig as JFieldConfig
    from stochquant_tpu.integrators import field as jfield

    cfg = FieldConfig(shape=(16, 16), dtau=0.005, n_chains=3, loops=6, seed=23)
    jcfg = JFieldConfig.from_json(cfg.to_json())
    want, wm = jax.jit(jfield.make_field_frame_fn(jphi4.get_field(cfg.action), jcfg))(
        jfield.init_field_state(jcfg))
    got, gm = tfield.make_field_frame_fn(tact.get_field(cfg.action), cfg)(
        tfield.init_field_state(cfg, device="cpu"))
    means = dict(rtol=3e-5, atol=3e-6)
    _compare(got, want, {None: dict(rtol=2e-6, atol=2e-6), "mag_mean": means,
                         "mag2_mean": means, "mag4_mean": means, "absmag_mean": means,
                         "phi2_mean": means, "act_mean": means, "corr_mean": means})
    np.testing.assert_array_equal(gm["stable"].numpy(), np.asarray(wm["stable"]))


def test_make_field_frame_fn_refuses_an_unsupported_config_when_built():
    """As the JAX ``make_field_frame_fn`` (``tests/test_exact_scheme.py``):
    ``Scheme.EXACT`` without ``m2`` or off the SYNC sweep raises before any
    frame runs."""
    from stochquant_tpu_torch.config import Scheme, Sweep

    class NoM2(tact.FieldAction):
        def V(self, p):
            return p * p

    cfg = FieldConfig(action="phi4", scheme=Scheme.EXACT)
    with pytest.raises(ValueError, match="m2"):
        tfield.make_field_frame_fn(NoM2(), cfg)
    tfield.make_field_frame_fn(tact.get_field("phi4"), cfg)
    bad_sweep = FieldConfig(action="free_field", scheme=Scheme.EXACT, sweep=Sweep.CHECKERBOARD)
    with pytest.raises(ValueError, match="SYNC"):
        tfield.make_field_frame_fn(tact.get_field("free_field"), bad_sweep)


def test_run_frames_goes_through_the_frame_fns(monkeypatch):
    """One frame closure, not two copies: ``run_frames`` / ``run_field_frames``
    build theirs with the ``make_*_frame_fn`` that the package exports."""
    built = []
    for mod, name in ((tl, "make_frame_fn"), (tfield, "make_field_frame_fn")):
        original = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _f=original, **k: built.append(_f) or _f(*a, **k))
    cfg = ChainConfig(action="harmonic", n_sites=8, n_chains=2, loops=2)
    act = tact.get(cfg.action)
    tl.run_frames(tl.init_chain_state(cfg, act, device="cpu"), act, cfg, 1)
    fcfg = FieldConfig(shape=(4, 4), n_chains=1, loops=2)
    tfield.run_field_frames(tfield.init_field_state(fcfg, device="cpu"),
                            tact.get_field(fcfg.action), fcfg, 1)
    assert len(built) == 2

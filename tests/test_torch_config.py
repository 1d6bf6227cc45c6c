"""The port's configs (chain, field, gauge and complex Langevin) are
field-for-field copies of the JAX package's, and the port imports neither
JAX nor Triton."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from stochquant_tpu import cli as jcli
from stochquant_tpu import config as jcfg
from stochquant_tpu.integrators import gauge as jgauge
from stochquant_tpu_torch import cli as tcli
from stochquant_tpu_torch import config as tcfg
from stochquant_tpu_torch.integrators import gauge as tgauge

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CHAIN_PRESETS = sorted(k for k, v in jcfg.PRESETS.items() if isinstance(v, jcfg.ChainConfig))
FIELD_PRESETS = sorted(k for k, v in jcfg.PRESETS.items() if isinstance(v, jcfg.FieldConfig))


@pytest.mark.parametrize("name", CHAIN_PRESETS)
def test_chain_preset_json_byte_equal_and_round_trips(name):
    a, b = jcfg.PRESETS[name].to_json(), tcfg.PRESETS[name].to_json()
    assert a == b
    assert tcfg.ChainConfig.from_json(a) == tcfg.PRESETS[name]
    assert jcfg.ChainConfig.from_json(b) == jcfg.PRESETS[name]


def test_non_default_chain_config_json_byte_equal():
    kw = dict(action="anharmonic", n_sites=33, dtau=1e-3, ghost_override=(-0.8, 0.8),
              dtau_max=0.5, grow_after=7, rng_impl="threefry13", frames_per_launch=4,
              block_chains=2, seed=99)
    a = jcfg.ChainConfig(**kw, bc=jcfg.BoundaryCondition.DIRICHLET, scheme=jcfg.Scheme.HEUN,
                         formulation=jcfg.Formulation.DIRECT)
    b = tcfg.ChainConfig(**kw, bc=tcfg.BoundaryCondition.DIRICHLET, scheme=tcfg.Scheme.HEUN,
                         formulation=tcfg.Formulation.DIRECT)
    assert a.to_json() == b.to_json()
    assert tcfg.ChainConfig.from_json(a.to_json()) == b
    assert [f.name for f in jcfg.dataclasses.fields(jcfg.ChainConfig)] == [
        f.name for f in tcfg.dataclasses.fields(tcfg.ChainConfig)
    ]


@pytest.mark.parametrize("name", FIELD_PRESETS)
def test_field_preset_json_byte_equal_and_round_trips(name):
    a, b = jcfg.PRESETS[name].to_json(), tcfg.PRESETS[name].to_json()
    assert a == b
    assert tcfg.FieldConfig.from_json(a) == tcfg.PRESETS[name]
    assert jcfg.FieldConfig.from_json(b) == jcfg.PRESETS[name]


def test_non_default_field_config_json_byte_equal():
    kw = dict(action="free_field", shape=(64, 32), spacing=0.5, dtau=2e-3, n_chains=5,
              loops=12, frames_per_launch=3, dtau_max=0.01, grow_after=4,
              rng_impl="threefry13", tile_rows=16, mesh_axes=("x", None), seed=7)
    a = jcfg.FieldConfig(**kw, sweep=jcfg.Sweep.CHECKERBOARD, scheme=jcfg.Scheme.EXACT)
    b = tcfg.FieldConfig(**kw, sweep=tcfg.Sweep.CHECKERBOARD, scheme=tcfg.Scheme.EXACT)
    assert a.to_json() == b.to_json()
    assert tcfg.FieldConfig.from_json(a.to_json()) == b
    assert [f.name for f in jcfg.dataclasses.fields(jcfg.FieldConfig)] == [
        f.name for f in tcfg.dataclasses.fields(tcfg.FieldConfig)
    ]


@pytest.mark.parametrize("name", sorted(tcli.GAUGE_PRESETS))
def test_gauge_preset_json_byte_equal_and_round_trips(name):
    a, b = jcli._gauge_presets()[name].to_json(), tcli.GAUGE_PRESETS[name].to_json()
    assert a == b
    assert tgauge.GaugeConfig.from_json(a) == tcli.GAUGE_PRESETS[name]


def test_non_default_gauge_config_json_byte_equal():
    kw = dict(group="su3", beta=5.7, shape=(8, 4, 4, 4), n_chains=3, dtau=1e-3, loops=7,
              frames=9, seed=11, drift_cap=5.0, shrink=0.9, grow_after=4, dtau_max=2e-3,
              hot_start=True, measure_loops=True, frames_per_launch=3, mesh_axes=("x", None),
              exchange_steps=4, cooling_rate=0.1, cooling_steps=2)
    a, b = jgauge.GaugeConfig(**kw), tgauge.GaugeConfig(**kw)
    assert a.to_json() == b.to_json()
    assert tgauge.GaugeConfig.from_json(a.to_json()) == b
    assert [f.name for f in jcfg.dataclasses.fields(jgauge.GaugeConfig)] == [
        f.name for f in tcfg.dataclasses.fields(tgauge.GaugeConfig)
    ]
    # every gauge preset of the JAX CLI, the complexified groups' too, is in the port's
    assert set(jcli._gauge_presets()) == set(tcli.GAUGE_PRESETS)


@pytest.mark.parametrize("name", sorted(tcli.COMPLEX_PRESETS))
def test_complex_preset_json_byte_equal_and_round_trips(name):
    a, b = jcli._complex_presets()[name].to_json(), tcli.COMPLEX_PRESETS[name].to_json()
    assert a == b
    assert type(tcli.COMPLEX_PRESETS[name]).from_json(a) == tcli.COMPLEX_PRESETS[name]
    assert set(jcli._complex_presets()) == set(tcli.COMPLEX_PRESETS)


def test_non_default_complex_configs_json_byte_equal():
    from stochquant_tpu.integrators import complex_field as jcf
    from stochquant_tpu.integrators import complex_langevin as jcl
    from stochquant_tpu_torch.integrators import complex_field as tcf
    from stochquant_tpu_torch.integrators import complex_langevin as tcl

    common = dict(n_chains=3, dtau=2e-3, loops=7, frames=9, seed=11, noise_amp=0.5,
                  drift_cap=3.0, clamp=50.0, shrink=0.9, grow_after=4, dtau_max=5e-3)
    pairs = [
        (jcl.ComplexLangevinConfig, tcl.ComplexLangevinConfig,
         dict(common, action="complex_quartic", action_params=(("lam", 2.0),))),
        (jcl.ComplexChainConfig, tcl.ComplexChainConfig,
         dict(common, action="complex_quartic", n_sites=12, dt=0.3, mass=2.0)),
        (jcf.ComplexFieldConfig, tcf.ComplexFieldConfig,
         dict(common, shape=(4, 6, 8), spacing=0.7, action_params=(("sigma_im", 0.25),))),
    ]
    for jcls, tcls, kw in pairs:
        a, b = jcls(**kw), tcls(**kw)
        assert a.to_json() == b.to_json()
        assert tcls.from_json(a.to_json()) == b
        assert [f.name for f in jcfg.dataclasses.fields(jcls)] == [
            f.name for f in tcfg.dataclasses.fields(tcls)]
    cu1 = dict(group="cu1", beta=1.0, beta_im=0.5, shape=(16, 16), n_chains=64, dtau=5e-3,
               cooling_rate=0.05, cooling_steps=3)
    assert jgauge.GaugeConfig(**cu1).to_json() == tgauge.GaugeConfig(**cu1).to_json()


def test_whole_presets_table_is_copied():
    assert sorted(jcfg.PRESETS) == sorted(tcfg.PRESETS)
    for name in jcfg.PRESETS:
        assert jcfg.PRESETS[name].to_json() == tcfg.PRESETS[name].to_json(), name


def test_torch_dtype():
    assert tcfg.ChainConfig().torch_dtype is torch.float32
    assert tcfg.ChainConfig(dtype="float64").torch_dtype is torch.float64


def test_port_imports_without_jax_or_triton():
    code = (
        "import sys\n"
        "import stochquant_tpu_torch, stochquant_tpu_torch.runtime, stochquant_tpu_torch.cli\n"
        "import stochquant_tpu_torch.kernels.chain_kernel, stochquant_tpu_torch.kernels._build\n"
        "import stochquant_tpu_torch.kernels.field_kernel\n"
        "import stochquant_tpu_torch.kernels.field_kernel_tiled\n"
        "import stochquant_tpu_torch.integrators.field, stochquant_tpu_torch.actions.phi4\n"
        "import stochquant_tpu_torch.io.checkpoint\n"
        "import stochquant_tpu_torch.kernels.gauge_kernel, stochquant_tpu_torch.actions.gauge\n"
        "import stochquant_tpu_torch.integrators.gauge\n"
        "import stochquant_tpu_torch.observables.gauge_loops\n"
        "import stochquant_tpu_torch.kernels.field_kernel_nd\n"
        "import stochquant_tpu_torch.kernels.field_halo_kernel\n"
        "import stochquant_tpu_torch.parallel, stochquant_tpu_torch.parallel.mesh\n"
        "import stochquant_tpu_torch.parallel.halo, stochquant_tpu_torch.parallel.gauge_halo\n"
        "import stochquant_tpu_torch.actions.complex_actions\n"
        "import stochquant_tpu_torch.actions.gauge_complex\n"
        "import stochquant_tpu_torch.integrators.complex_langevin\n"
        "import stochquant_tpu_torch.integrators.complex_field\n"
        "import stochquant_tpu_torch.parallel.distributed, stochquant_tpu_torch.kernels.autotune\n"
        "import stochquant_tpu_torch.parallel.ipc\n"
        "import stochquant_tpu_torch.io.reference_fmt, stochquant_tpu_torch.viz\n"
        "import stochquant_tpu_torch.observables.analysis, stochquant_tpu_torch.timing\n"
        "import stochquant_tpu_torch.observables.exact, stochquant_tpu_torch.oracle\n"
        "import stochquant_tpu_torch.physics_gates\n"
        # the JAX package's import surface and its example workflows
        "from stochquant_tpu_torch.integrators import make_frame_fn, make_field_frame_fn\n"
        "from stochquant_tpu_torch.io import save, load, export_reference, reference_fmt\n"
        "from stochquant_tpu_torch.actions import get_gauge, get_complex, NAME_TO_POT_ID\n"
        "import stochquant_tpu_torch.examples.energy_gap\n"
        "import stochquant_tpu_torch.examples.binder_crossing\n"
        "import stochquant_tpu_torch.examples.phi4_phase_scan\n"
        "import stochquant_tpu_torch.examples.scheme_bias_ladder\n"
        "import stochquant_tpu_torch.examples.sharded_4d_scaling\n"
        "from stochquant_tpu_torch.observables import em_stationary_cov, harmonic_drift_matrix\n"
        "em_stationary_cov(harmonic_drift_matrix(8, 0.25), 0.25, 0.01)\n"
        "assert stochquant_tpu_torch.oracle.run_reference(8, 0.1, 1e-3, 1, 4, seed=1).runs >= 0\n"
        # the Philox stream, the plain-path schemes and the spectrum run without them too
        "import dataclasses\n"
        "from stochquant_tpu_torch import rng, runtime, metrics\n"
        "from stochquant_tpu_torch.config import ChainConfig, FieldConfig, Scheme\n"
        "assert int(rng.philox4x32(0, 0, 0, 0, 0, 0)[0]) == 0x6627E8D5\n"
        "quiet = lambda: metrics.MetricsSink(callback=lambda r: 0)\n"
        "c = ChainConfig(action='harmonic', n_sites=8, n_chains=2, loops=4, frames=1)\n"
        "for change in (dict(scheme=Scheme.LM), dict(scheme=Scheme.EXACT),\n"
        "               dict(accumulate_spectrum=True), dict(rng_impl='hardware')):\n"
        "    runtime.run_chain(dataclasses.replace(c, **change), device='cpu', sink=quiet())\n"
        "from stochquant_tpu_torch.kernels import chain_kernel, field_kernel\n"
        "from stochquant_tpu_torch import actions\n"
        "from stochquant_tpu_torch.integrators import field, langevin\n"
        "hw = dataclasses.replace(c, rng_impl='hardware')\n"
        "act = actions.get(hw.action)\n"
        "chain_kernel.run_frames_kernel(langevin.init_chain_state(hw, act, device='cpu'), act,\n"
        "                               hw, 2, frames_per_launch=2)\n"
        "f = FieldConfig(shape=(8, 8), n_chains=2, loops=4, frames=1, rng_impl='hardware')\n"
        "fact = actions.get_field(f.action)\n"
        "field_kernel.run_field_frames_kernel(field.init_field_state(f, device='cpu'), fact, f, 1)\n"
        "runtime.run_field(dataclasses.replace(f, scheme=Scheme.EXACT), device='cpu', sink=quiet())\n"
        # the complex-Langevin sector: the three complex kinds and a complexified group
        "from stochquant_tpu_torch import cli\n"
        "for name, cc in cli.COMPLEX_PRESETS.items():\n"
        "    runtime.run_complex(dataclasses.replace(cc, n_chains=2, loops=2, frames=1),\n"
        "                        device='cpu', sink=quiet())\n"
        "g = dataclasses.replace(cli.GAUGE_PRESETS['csu3_2d_complex'], n_chains=1, loops=1,\n"
        "                        frames=1, shape=(4, 4))\n"
        "runtime.run_gauge(g, device='cpu', sink=quiet())\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'triton', 'stochquant_tpu'))\n"
        "assert not bad, bad\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, check=True, timeout=120)


def test_split_lattice_modules_import_where_jax_is_blocked():
    """The mesh, both halo runners and the new kernel modules import, and a
    split run starts, in a process where importing jax, triton or the JAX
    package raises."""
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'triton', 'stochquant_tpu'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import stochquant_tpu_torch.parallel, stochquant_tpu_torch.parallel.halo\n"
        "import stochquant_tpu_torch.parallel.gauge_halo\n"
        "import stochquant_tpu_torch.kernels.field_halo_kernel\n"
        "import stochquant_tpu_torch.actions.gauge_complex\n"
        "import stochquant_tpu_torch.integrators.complex_langevin\n"
        "import stochquant_tpu_torch.integrators.complex_field\n"
        "import stochquant_tpu_torch.parallel.distributed, stochquant_tpu_torch.kernels.autotune\n"
        "import stochquant_tpu_torch.parallel.ipc\n"
        "import stochquant_tpu_torch.io.reference_fmt, stochquant_tpu_torch.viz\n"
        "import stochquant_tpu_torch.observables.analysis, stochquant_tpu_torch.timing\n"
        "import stochquant_tpu_torch.observables.exact, stochquant_tpu_torch.oracle\n"
        "import stochquant_tpu_torch.physics_gates\n"
        "from stochquant_tpu_torch import runtime, metrics, parallel\n"
        "from stochquant_tpu_torch.config import FieldConfig\n"
        "cfg = FieldConfig(shape=(8, 8), n_chains=2, loops=2, frames=1, mesh_axes=('x', None))\n"
        "mesh = parallel.make_mesh([('x', 2)], devices='cpu')\n"
        "res = runtime.run_field(cfg, mesh=mesh, sink=metrics.MetricsSink(callback=lambda r: 0))\n"
        "assert res.state.phi.shape == (2, 8, 8)\n"
        "from stochquant_tpu_torch.integrators.gauge import GaugeConfig\n"
        "g = GaugeConfig(group='cu1', beta_im=0.5, shape=(8, 8), n_chains=2, loops=2,\n"
        "                frames=1, mesh_axes=('x', None))\n"
        "res = runtime.run_gauge(g, mesh=mesh, sink=metrics.MetricsSink(callback=lambda r: 0))\n"
        "assert res.state.links.dtype.is_complex\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, check=True, timeout=120)


def test_chip_smoke_imports_neither_jax_nor_the_jax_package():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|stochquant_tpu)\b", re.M)
    assert not pattern.search((ROOT / "chip_smoke.py").read_text())


def test_no_port_module_imports_jax_or_triton():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|triton|stochquant_tpu)\b", re.M)
    sources = sorted((ROOT / "stochquant_tpu_torch").rglob("*.py"))
    assert sources
    for path in sources:
        assert not pattern.search(path.read_text()), path

"""The reference's "%a" checkpoint format in the port: the codec
(``io.reference_fmt``), ``checkpoint.export_reference`` /
``import_reference`` and ``cli reference-import`` — the cases of
``tests/test_checkpoint.py:50-110`` and ``tests/test_runtime_cli.py:45``,
and the port's export of a state byte for byte the JAX package's export of
the same state.  Tolerances: hex floats round-trip exactly; the imported
float32 state holds the file's float64 values to float32 rounding (rtol
1e-6); Δτ is written with 17 digits (rtol 1e-15)."""

import numpy as np
import pytest
import torch

from stochquant_tpu import actions as jact
from stochquant_tpu import oracle
from stochquant_tpu.config import ChainConfig as JChainConfig
from stochquant_tpu.integrators import langevin as jl
from stochquant_tpu.io import checkpoint as jck
from stochquant_tpu.io import reference_fmt as jref
from stochquant_tpu_torch import actions, cli
from stochquant_tpu_torch.config import PRESETS, ChainConfig
from stochquant_tpu_torch.integrators import accum, langevin
from stochquant_tpu_torch.io import checkpoint, reference_fmt

torch.set_num_threads(1)


def test_reference_fmt_roundtrip_python(tmp_path):
    rng = np.random.default_rng(0)
    N = 17
    arrs = [rng.normal(size=N) for _ in range(4)]
    p = tmp_path / "ref.txt"
    reference_fmt.write(p, *arrs, omega=1.2345, runs=42000, dtau=3.25e-4)
    d = reference_fmt.read(p, N)
    for got, want in zip([d["xavg"], d["xx0"], d["x"], d["f"]], arrs):
        np.testing.assert_array_equal(got, want)  # hex float: exact
    assert d["omega"] == 1.2345 and d["runs"] == 42000
    np.testing.assert_allclose(d["dtau"], 3.25e-4, rtol=1e-15)
    with pytest.raises(ValueError, match="expected"):
        reference_fmt.read(p, N + 1)


def test_reference_fmt_cpp_and_jax_parity(tmp_path):
    """The native codec (C %a), the JAX package's codec and the port's read
    each other's files exactly, and the two Python writers write the same bytes."""
    rng = np.random.default_rng(1)
    N = 9
    arrs = [rng.normal(size=N) for _ in range(4)]
    p_c = tmp_path / "c.txt"
    oracle.write_reference_checkpoint(p_c, *arrs, omega=0.7, runs=100, dtau=1e-3, width=30)
    d = reference_fmt.read(p_c, N)
    for got, want in zip([d["xavg"], d["xx0"], d["x"], d["f"]], arrs):
        np.testing.assert_array_equal(got, want)
    p_py, p_j = tmp_path / "py.txt", tmp_path / "j.txt"
    reference_fmt.write(p_py, *arrs, omega=0.7, runs=100, dtau=1e-3)
    jref.write(p_j, *arrs, omega=0.7, runs=100, dtau=1e-3)
    assert p_py.read_bytes() == p_j.read_bytes()
    d_c = oracle.read_reference_checkpoint(p_py, N)
    for got, want in zip([d_c["xavg"], d_c["xx0"], d_c["x"], d_c["f"]], arrs):
        np.testing.assert_array_equal(got, want)
    assert d_c["omega"] == 0.7 and d_c["runs"] == 100


def test_import_reference_into_chain_state(tmp_path):
    cfg = ChainConfig(action="double_well", n_sites=12, dt=0.1, dtau=0.001, n_chains=2)
    rng = np.random.default_rng(2)
    arrs = [rng.normal(size=12) for _ in range(4)]
    p = tmp_path / "ref.txt"
    reference_fmt.write(p, *arrs, omega=0.55, runs=7 + (3 << 32), dtau=0.01)
    st = checkpoint.import_reference(p, cfg, "cpu")
    assert st.f.shape == (2, 12) and int(st.step) == 0
    np.testing.assert_allclose(st.f[0].numpy(), arrs[3], rtol=1e-6)
    np.testing.assert_allclose(float(st.dtau[0]), cfg.dtau, rtol=1e-6)  # tauhost.c:131-137 clamp
    assert st.runs.tolist() == [[7, 3], [7, 3]]
    # the same state as the JAX package imports, leaf for leaf
    jst = jck.import_reference(p, JChainConfig.from_json(cfg.to_json()))
    got = checkpoint.state_to_numpy(st)
    for name, leaf in zip(jst._fields, jst):
        np.testing.assert_array_equal(got[name], np.asarray(leaf), err_msg=name)
    out, _ = langevin.run_frames(st, actions.get(cfg.action), cfg, 1)  # must run
    assert torch.isfinite(out.f).all()


def test_export_reference_roundtrip(tmp_path):
    cfg = ChainConfig(action="double_well", n_sites=16, dt=0.1, dtau=0.0005, n_chains=2,
                      loops=10)
    act = actions.get(cfg.action)
    s, _ = langevin.run_frames(langevin.init_chain_state(cfg, act, device="cpu"), act, cfg, 2)
    p = tmp_path / "exp.txt"
    checkpoint.export_reference(p, s, chain=1)
    d = reference_fmt.read(p, 16)
    np.testing.assert_allclose(d["f"], s.f[1].numpy(), rtol=1e-7)
    assert d["runs"] == int(accum.runs_total(s.runs)[1])


@pytest.mark.parametrize("chain", [0, 2])
def test_export_reference_writes_the_jax_packages_bytes(tmp_path, chain):
    cfg = ChainConfig(action="double_well", n_sites=24, dt=0.1, dtau=5e-4, n_chains=3, loops=20,
                      seed=8)
    jcfg = JChainConfig.from_json(cfg.to_json())
    ja = jact.get(cfg.action)
    js, _ = jl.run_frames(jl.init_chain_state(jcfg, ja), ja, jcfg, 2)
    state = checkpoint.state_from_numpy({n: np.asarray(x) for n, x in zip(js._fields, js)}, "cpu")
    jck.export_reference(tmp_path / "j.txt", js, chain=chain)
    checkpoint.export_reference(tmp_path / "p.txt", state, chain=chain)
    assert (tmp_path / "p.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()


def test_cli_run_and_reference_import(tmp_path, capsys):
    m, ck = tmp_path / "run.jsonl", tmp_path / "out.npz"
    cli.main(["run", "--preset", "harmosc", "--frames", "2", "--loops", "5", "--chains", "2",
              "--dtau", "1e-3", "--device", "cpu", "--metrics", str(m), "--out", str(ck)])
    state, cfg = checkpoint.load(ck, "cpu")
    ref = tmp_path / "ref.txt"
    checkpoint.export_reference(ref, state)
    out = tmp_path / "imported.npz"
    cli.main(["reference-import", "--file", str(ref), "--preset", "harmosc", "--out", str(out),
              "--device", "cpu"])
    assert "imported" in capsys.readouterr().out
    st2, cfg2 = checkpoint.load(out, "cpu")
    assert st2.f.shape[1] == PRESETS["harmosc"].n_sites and cfg2 == PRESETS["harmosc"]
    assert torch.equal(st2.f[0], state.f[0])
    with pytest.raises(SystemExit):
        cli.main(["reference-import", "--file", str(ref), "--preset", "phi4_2d", "--device",
                  "cpu"])
    if not torch.cuda.is_available():  # the default device is the card, which is not here
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(["reference-import", "--file", str(ref), "--preset", "harmosc",
                      "--out", str(out)])

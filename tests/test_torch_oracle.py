"""The port's reference oracle (``stochquant_tpu_torch.oracle``, the same C++
source as the JAX package's, built apart) against the JAX package's: the
same runs give the same bits, and the "%a" checkpoint codec reads and writes
the same files as the JAX oracle and as ``io.reference_fmt``."""

import concurrent.futures

import numpy as np
import pytest

from stochquant_tpu import oracle as joracle
from stochquant_tpu_torch import oracle
from stochquant_tpu_torch.io import reference_fmt

# tests/test_oracle.py:14-34: determinism, the adaptive Δτ walking down from
# the reference's double-well preset, and the throughput case
CASES = [
    dict(n_sites=32, dt=0.1, dtau=1e-3, frames=5, loops=50, seed=7),
    dict(n_sites=200, dt=0.02, dtau=0.002, frames=60, loops=100, seed=3),
    dict(n_sites=64, dt=0.05, dtau=1e-4, frames=3, loops=200, seed=1),
    dict(n_sites=32, dt=0.25, dtau=2e-3, frames=4, loops=500, pot_id=0, seed=21),  # harmonic
]


def _same_bits(got, want):
    for name in ("f", "x_mean", "xx0_mean", "xavg"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    assert (got.omega, got.runs, got.dtau) == (want.omega, want.runs, want.dtau)


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"N{c['n_sites']}_seed{c['seed']}")
def test_run_reference_bitwise_the_jax_oracle(case):
    got = oracle.run_reference(**case)
    want = joracle.run_reference(**case)
    _same_bits(got, want)
    assert got.updates_per_sec > 0
    _same_bits(oracle.run_reference(**case), got)  # deterministic


def test_adaptive_dtau_walks_down_from_the_reference_preset():
    r = oracle.run_reference(200, 0.02, 0.002, frames=60, loops=100, seed=3)
    assert r.dtau < 0.002 and r.runs > 0 and np.all(np.isfinite(r.f))


def test_runs_in_threads_give_the_serial_bits():
    """``run_reference`` seeds the C library's global ``rand()`` under a lock,
    so runs in threads (the GIL released in the C call) stay deterministic."""
    case = dict(n_sites=48, dt=0.25, dtau=2e-3, frames=4, loops=200)
    serial = [oracle.run_reference(**case, seed=s) for s in range(1, 9)]
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        threaded = list(pool.map(lambda s: oracle.run_reference(**case, seed=s), range(1, 9)))
    for a, b in zip(threaded, serial):
        _same_bits(a, b)


def _state(n, seed):
    rs = np.random.RandomState(seed)
    arrs = [rs.standard_normal(n) * s for s in (1.0, 1e-3, 7.0, 1e5)]
    arrs[0][0], arrs[1][1] = -0.0, 5e-324  # signed zero and a subnormal survive "%a"
    return arrs


def test_checkpoint_round_trip_against_the_jax_oracle_and_reference_fmt(tmp_path):
    n = 37
    arrs = _state(n, 4)
    meta = dict(omega=1.2345678901234567, runs=123456, dtau=1.7e-4)
    ours, theirs, py = tmp_path / "ours.txt", tmp_path / "jax.txt", tmp_path / "py.txt"
    oracle.write_reference_checkpoint(ours, *arrs, **meta, width=30)
    joracle.write_reference_checkpoint(theirs, *arrs, **meta, width=30)
    assert ours.read_bytes() == theirs.read_bytes()
    reference_fmt.write(py, *arrs, **meta)
    for path in (ours, py):
        for read in (lambda p: oracle.read_reference_checkpoint(p, n),
                     lambda p: joracle.read_reference_checkpoint(p, n),
                     lambda p: reference_fmt.read(p, n)):
            d = read(path)
            for name, a in zip(("xavg", "xx0", "x", "f"), arrs):
                np.testing.assert_array_equal(d[name], a, err_msg=f"{path.name} {name}")
                assert np.array_equal(np.signbit(d[name]), np.signbit(a))
            assert (d["omega"], d["runs"]) == (meta["omega"], meta["runs"])
            assert d["dtau"] == pytest.approx(meta["dtau"], rel=1e-6)  # "%e": 7 digits


def test_a_run_survives_the_checkpoint_file(tmp_path):
    r = oracle.run_reference(64, 0.05, 1e-4, frames=3, loops=200, seed=1)
    p = tmp_path / "run.txt"
    oracle.write_reference_checkpoint(p, r.xavg, r.xx0_mean, r.x_mean, r.f, r.omega, r.runs, r.dtau)
    d = joracle.read_reference_checkpoint(p, 64)
    for name, a in (("xavg", r.xavg), ("xx0", r.xx0_mean), ("x", r.x_mean), ("f", r.f)):
        np.testing.assert_array_equal(d[name], a)
    assert (d["omega"], d["runs"]) == (r.omega, r.runs)


def test_library_is_built_outside_the_source_tree():
    oracle.run_reference(8, 0.1, 1e-3, frames=1, loops=1, seed=1)
    lib = oracle.build_dir() / "liboracle.so"
    assert lib.exists()
    assert "build" in lib.parts and oracle._SOURCE.parent not in lib.parents
    assert not list(oracle._SOURCE.parent.glob("*.so"))

"""ctypes bindings for the native reference oracle (``cc/oracle.cpp``; port of
``stochquant_tpu.oracle``).

The exact reference algorithm (serial, deterministic, float64 on the host)
for statistical cross-validation of the kernels, plus the reference's "%a"
hex-float checkpoint codec.  This is host code, not a kernel: the oracle is
what the kernels are held against.  The shared library is built at first use
with g++ (the JAX package's flags, so both packages' oracles give the same
bits) into ``build/stochquant_tpu_torch/oracle/<hash of source + flags>/``,
under the build lock of ``kernels/_build.py``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import NamedTuple

import numpy as np

from stochquant_tpu_torch.kernels import _build

_SOURCE = Path(__file__).resolve().parent / "cc" / "oracle.cpp"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall", "-shared")
_lib = None
# sq_ref_init seeds the C library's global rand(): one init at a time
_INIT_LOCK = threading.Lock()


def build_dir() -> Path:
    """Directory of the library for the current source and flags."""
    h = hashlib.sha256(_SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return _build.BUILD_ROOT / "oracle" / h.hexdigest()[:16]


def _compile(out: Path) -> None:
    cxx = os.environ.get("CXX", "g++")
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        lib = os.path.join(tmp, out.name)
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", lib, str(_SOURCE)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{cxx} failed ({proc.returncode}) on {_SOURCE}:\n{proc.stdout}")
        os.replace(lib, out)


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(_build.build_once(build_dir() / "liboracle.so", _compile)))
    dp = ctypes.POINTER(ctypes.c_double)
    ip = ctypes.POINTER(ctypes.c_int)
    u64p = ctypes.POINTER(ctypes.c_uint64)

    lib.sq_ref_frame.restype = ctypes.c_int
    lib.sq_ref_frame.argtypes = [
        ctypes.c_int, ctypes.c_double, ctypes.c_double, ctypes.c_int,
        ctypes.c_int, ctypes.c_double, dp, dp, dp, dp, u64p, ip, dp,
        ctypes.c_int, dp, dp, dp,
    ]
    lib.sq_ref_run.restype = ctypes.c_double
    lib.sq_ref_run.argtypes = [
        ctypes.c_int, ctypes.c_double, dp, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_double, ctypes.c_uint64, dp, dp, dp, dp, dp, ip,
    ]
    lib.sq_ref_init.restype = None
    lib.sq_ref_init.argtypes = [
        ctypes.c_int, ctypes.c_double, ctypes.c_double, ctypes.c_uint64,
        dp, dp, dp, dp, dp,
    ]
    lib.sq_ckpt_write.restype = ctypes.c_int
    lib.sq_ckpt_write.argtypes = [
        ctypes.c_char_p, ctypes.c_int, dp, dp, dp, dp,
        ctypes.c_double, ctypes.c_int, ctypes.c_double, ctypes.c_int,
    ]
    lib.sq_ckpt_read.restype = ctypes.c_int
    lib.sq_ckpt_read.argtypes = [
        ctypes.c_char_p, ctypes.c_int, dp, dp, dp, dp, dp, ip, dp,
    ]
    _lib = lib
    return lib


def _dp(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


class OracleResult(NamedTuple):
    f: np.ndarray
    x_mean: np.ndarray
    xx0_mean: np.ndarray
    xavg: np.ndarray       # connected correlator vs midpoint
    omega: float
    runs: int
    dtau: float
    updates_per_sec: float


def run_reference(
    n_sites: int,
    dt: float,
    dtau: float,
    frames: int,
    loops: int,
    pot_id: int = 3,
    noise_amp: float = 1.0,
    seed: int = 12345,
) -> OracleResult:
    """Cold-start + run the reference algorithm; returns final state,
    observables and the measured host throughput (site-updates/sec).  Runs in
    threads are independent (ctypes releases the GIL in the C call)."""
    lib = _load()
    N = n_sites
    f = np.zeros(N)
    x = np.zeros(N)
    xx0 = np.zeros(N)
    xavg = np.zeros(N)
    omega = np.zeros(1)
    runs = ctypes.c_int(0)
    dtau_io = np.array([dtau])
    with _INIT_LOCK:
        lib.sq_ref_init(N, dt, dtau, seed, _dp(f), _dp(x), _dp(xx0), _dp(xavg), _dp(omega))
    ups = lib.sq_ref_run(
        N, dt, _dp(dtau_io), frames, loops, pot_id, noise_amp, seed,
        _dp(f), _dp(x), _dp(xx0), _dp(xavg), _dp(omega), ctypes.byref(runs),
    )
    return OracleResult(
        f=f, x_mean=x, xx0_mean=xx0, xavg=xavg, omega=float(omega[0]),
        runs=int(runs.value), dtau=float(dtau_io[0]), updates_per_sec=float(ups),
    )


def write_reference_checkpoint(path, xavg, xx0, x, f, omega, runs, dtau, width=40):
    lib = _load()
    arrs = [np.ascontiguousarray(a, np.float64) for a in (xavg, xx0, x, f)]
    r = lib.sq_ckpt_write(
        str(path).encode(), len(arrs[0]), *(_dp(a) for a in arrs),
        float(omega), int(runs), float(dtau), int(width),
    )
    if r:
        raise IOError(f"sq_ckpt_write failed: {r}")


def read_reference_checkpoint(path, n_sites):
    lib = _load()
    N = n_sites
    xavg, xx0, x, f = (np.zeros(N) for _ in range(4))
    omega = np.zeros(1)
    runs = ctypes.c_int(0)
    dtau = np.zeros(1)
    r = lib.sq_ckpt_read(
        str(path).encode(), N, _dp(xavg), _dp(xx0), _dp(x), _dp(f),
        _dp(omega), ctypes.byref(runs), _dp(dtau),
    )
    if r:
        raise IOError(f"sq_ckpt_read failed: {r}")
    return dict(
        xavg=xavg, xx0=xx0, x=x, f=f, omega=float(omega[0]),
        runs=int(runs.value), dtau=float(dtau[0]),
    )

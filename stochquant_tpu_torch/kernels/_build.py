"""Build the CUDA kernels with nvcc and bind them with ctypes.

The sources under ``kernels/csrc/`` are compiled at first use into a shared
library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC --fmad=false --resource-usage

The output goes to ``build/stochquant_tpu_torch/<hash of sources + flags>/``
beside the package, so an edited source or flag builds anew and an unchanged
one is reused.  The compiler's report (registers, shared memory, spills per
kernel) is kept next to the library in ``nvcc.log``.  Nothing is built when
the package is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_CSRC = Path(__file__).resolve().parent / "csrc"
_SOURCES = ("chain_kernel.cu",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
    "-Xcompiler", "-fPIC", "--fmad=false", "--resource-usage",
)
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "stochquant_tpu_torch"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found (on PATH or under $CUDA_HOME/bin): cannot build the CUDA kernels")


def build_dir() -> Path:
    """Directory of the library for the current sources and flags."""
    h = hashlib.sha256()
    for name in _SOURCES:
        h.update(name.encode())
        h.update((_CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_ROOT / h.hexdigest()[:16]


def _compile(out: Path) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [_nvcc(), *NVCC_FLAGS, *(str(_CSRC / s) for s in _SOURCES)]
    # compile to a temporary name and rename: a concurrent or interrupted
    # build never leaves a half-written library at the final path
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    try:
        proc = subprocess.run(cmd + ["-o", tmp], capture_output=True, text=True)
        (out.parent / "nvcc.log").write_text(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


class ChainParams(ctypes.Structure):
    """Launch parameters, field for field the ``ChainParams`` struct of
    ``csrc/chain_kernel.cu`` (all 4-byte fields, so no padding rules)."""

    _fields_ = [
        (name, ctypes.c_int32) for name in (
            "n_chains", "n_sites", "threads", "sites_per_thread", "rounds",
            "loops", "n_frames",
        )
    ] + [(name, ctypes.c_uint32) for name in ("seed", "step0", "chain0")] + [
        (name, ctypes.c_int32) for name in (
            "bc", "background", "has_zm", "heun", "action", "grow_after",
            "has_dtau_max",
        )
    ] + [
        (name, ctypes.c_float) for name in (
            "p0", "p1", "p2", "p3", "xcl_w", "xcl_eta", "dt", "inv_dt2",
            "c_amp", "zm_c", "clamp", "upper", "asym_l", "asym_r", "t_right",
            "shrink", "dtau_max", "inv_loops", "loops_f",
        )
    ]


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The compiled kernel library (built on first call in this process),
    with every entry point's argument and result types declared."""
    path = build_dir() / "libsq_chain_kernel.so"
    if not path.exists():
        _compile(path)
    lib = ctypes.CDLL(str(path))
    ptr = ctypes.c_void_p
    params = ctypes.POINTER(ChainParams)
    lib.sq_chain_frame.argtypes = [params] + [ptr] * 12 + [ptr]
    lib.sq_chain_frame.restype = ctypes.c_int
    lib.sq_chain_frames.argtypes = [params] + [ptr] * 23 + [ptr]
    lib.sq_chain_frames.restype = ctypes.c_int
    lib.sq_error_string.argtypes = [ctypes.c_int]
    lib.sq_error_string.restype = ctypes.c_char_p
    return lib

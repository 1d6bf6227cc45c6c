"""Build the CUDA kernels with nvcc and bind them with ctypes.

The sources under ``kernels/csrc/`` (the kernels, and ``ipc.cu``: the
cross-process transport of ``parallel/ipc.py``) are compiled at first use
into one shared library with a plain C interface: one ``nvcc -c`` per source
(three for ``chain_kernel.cu``, each instantiating its share of the kernels),
all started together, then one link:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         -Xcompiler -fPIC --fmad=false --resource-usage [-D...] -c <source>.cu
    nvcc -shared <objects> -o libsq_kernels.so

The output goes to ``build/stochquant_tpu_torch/<hash of sources + flags>/``
beside the package, so an edited source, header or flag builds anew and an
unchanged one is reused.  The compiler's report (registers, shared memory,
spills per kernel) is kept next to the library in ``nvcc.log``.  Nothing is
built when the package is imported.  Processes that start together (the
ranks of a process group on one card) build once: each takes a lock file in
the build directory, and the first to hold it builds while the others wait
and then load its library.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

_CSRC = Path(__file__).resolve().parent / "csrc"
_SOURCES = ("chain_kernel.cu", "field_kernel.cu", "field_kernel_tiled.cu",
            "field_kernel_nd.cu", "field_halo_kernel.cu", "gauge_kernel.cu", "ipc.cu")
_HEADERS = ("sq_rng.cuh", "field_common.cuh", "cluster.cuh")
# sources compiled more than once, with these defines (one object each)
_PARTS = {"chain_kernel.cu": ((), ("-DSQ_CHAIN_PART=1",), ("-DSQ_CHAIN_PART=2",))}
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
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
    for name in _SOURCES + _HEADERS:
        h.update(name.encode())
        h.update((_CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(repr(sorted(_PARTS.items())).encode())
    return BUILD_ROOT / h.hexdigest()[:16]


def _compile(out: Path) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    # compile into a private directory and rename the library into place: a
    # concurrent or interrupted build never leaves a half-written library
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        jobs = []
        for src in _SOURCES:
            for part, defines in enumerate(_PARTS.get(src, ((),))):
                obj = os.path.join(tmp, src.replace(".cu", f"_{part}.o"))
                cmd = [nvcc, *NVCC_FLAGS, *defines, "-c", str(_CSRC / src), "-o", obj]
                proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True)
                jobs.append((cmd, obj, proc))
        log, failed = [], []
        for cmd, _, proc in jobs:
            text, _ = proc.communicate()
            log.append(" ".join(cmd) + "\n" + text)
            if proc.returncode != 0:
                failed.append(f"{cmd[-3]} ({proc.returncode})")
        lib = os.path.join(tmp, out.name)
        if not failed:
            cmd = [nvcc, "-shared", *(obj for _, obj, _ in jobs), "-o", lib]
            proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True)
            log.append(" ".join(cmd) + "\n" + proc.stdout)
            if proc.returncode != 0:
                failed.append(f"link ({proc.returncode})")
        (out.parent / "nvcc.log").write_text("\n".join(log))
        if failed:
            raise RuntimeError(f"nvcc failed: {', '.join(failed)}\n" + "\n".join(log))
        os.replace(lib, out)


class ChainParams(ctypes.Structure):
    """Launch parameters, field for field the ``ChainParams`` struct of
    ``csrc/chain_kernel.cu`` (all 4-byte fields, so no padding rules)."""

    _fields_ = [
        (name, ctypes.c_int32) for name in (
            "n_chains", "n_sites", "warps_per_chain", "sites_per_lane",
            "chains_per_block", "rounds", "philox", "loops", "n_frames",
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


class FieldParams(ctypes.Structure):
    """Launch parameters of the field kernels 3, 4 and 5, field for field the
    ``FieldParams`` struct of ``csrc/field_common.cuh`` (all 4-byte fields).
    The last four are kernels 3 and 4's cluster geometry (``_cluster``)."""

    _fields_ = [
        (name, ctypes.c_int32) for name in (
            "n_chains", "L0", "L1", "rounds", "philox", "loops", "n_frames", "checkerboard",
            "action", "grow_after", "has_dtau_max", "tile_rows", "halo", "n_tiles",
        )
    ] + [(name, ctypes.c_uint32) for name in ("seed", "step0", "chain0")] + [
        (name, ctypes.c_float) for name in (
            "m2", "hm2", "l6", "l24", "inv_a2", "measure", "c_amp", "clamp",
            "shrink", "dtau_max", "inv_loops", "loops_f", "inv_l1",
        )
    ] + [(name, ctypes.c_int32) for name in ("cl_B", "cl_rows", "cl_scratch", "cl_empty")]


#: most lattice dimensions kernels 6, 7 and 8 take (``SQ_ND_MAXD`` in the source)
ND_MAX_DIMS = 5


class FieldNdParams(ctypes.Structure):
    """Launch parameters of the D-dim field kernels 6, 7 and 8, field for field
    the ``FieldNdParams`` struct of ``csrc/field_kernel_nd.cu``: the 2-D
    kernels' ``FieldParams`` (action, noise and launch constants), then the
    geometry of the launch's domain, the owned block and the tiles
    (``field_kernel_nd.Geometry`` computes every value)."""

    _fields_ = [("f", FieldParams)] + [
        (name, ctypes.c_int32) for name in (
            "nd", "n_steps", "depth", "n_blocks", "n_inner", "n_items", "box", "avol", "lvol",
        )
    ] + [
        (name, ctypes.c_int32 * ND_MAX_DIMS) for name in (
            "G", "A", "loc", "h", "gb", "T", "nl", "ndt", "wrap", "as_", "ls",
        )
    ] + [("gs", ctypes.c_uint32 * ND_MAX_DIMS)]


class FieldHaloParams(ctypes.Structure):
    """Launch parameters of the per-micro-step halo kernel 9, field for field
    the ``FieldHaloParams`` struct of ``csrc/field_halo_kernel.cu``: the 2-D
    kernels' ``FieldParams`` of the local block, then where the block sits in
    the global lattice, which Box-Muller output and half-sweep this launch is,
    which dims are split, the strips the chain's block is cut into, and whether
    the split dims' halo slices are inputs."""

    _fields_ = [("f", FieldParams)] + [
        (name, ctypes.c_int32) for name in (
            "gL1", "row_off", "col_off", "parity", "half", "sh0", "sh1", "rows_per_block",
            "n_strips", "halos",
        )
    ]


class GaugeParams(ctypes.Structure):
    """Launch parameters of the gauge kernels 10, 11 and 12, field for field
    the ``GaugeParams`` struct of ``csrc/gauge_kernel.cu`` (all 4-byte
    fields).  ``chain_off`` … ``L0g`` are the chunk kernel's (kernel 12): there
    ``L0`` is the extended block's rows, ``L0g`` the global lattice's; then
    the cluster geometry of kernels 10, 11 and 12 (``_cluster``) and kernel
    12's work item (``cl_split``: a link direction of a site, or a site)."""

    _fields_ = [
        (name, ctypes.c_int32) for name in (
            "n_chains", "L0", "L1", "group", "loops", "n_frames", "grow_after", "has_dtau_max",
        )
    ] + [(name, ctypes.c_uint32) for name in ("seed", "step0")] + [
        (name, ctypes.c_float) for name in (
            "coef", "cap", "clip_hi", "inv_vol", "shrink", "dtau_max", "inv_loops", "loops_f",
        )
    ] + [(name, ctypes.c_uint32) for name in ("chain_off", "row_off")] + [
        (name, ctypes.c_int32) for name in (
            "loc0", "H", "W", "L0g", "cl_B", "cl_rows", "cl_scratch", "cl_empty", "cl_split",
        )
    ]


def build_once(path: Path, compile_fn) -> Path:
    """``path``, built by ``compile_fn(path)`` unless it exists.  The process
    that builds holds the lock file of ``path``'s directory, so processes that
    start together build once and the others load its output."""
    if not path.exists():
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(path.parent / "build.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
            if not path.exists():
                compile_fn(path)
    return path


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The compiled kernel library (built on first call in this process),
    with every entry point's argument and result types declared."""
    path = build_once(build_dir() / "libsq_kernels.so", _compile)
    lib = ctypes.CDLL(str(path))
    ptr = ctypes.c_void_p
    chain = ctypes.POINTER(ChainParams)
    field = ctypes.POINTER(FieldParams)
    gauge = ctypes.POINTER(GaugeParams)
    field_nd = ctypes.POINTER(FieldNdParams)
    field_halo = ctypes.POINTER(FieldHaloParams)
    for fn, params, n_ptr in (
        (lib.sq_chain_frame, chain, 12), (lib.sq_chain_frames, chain, 23),
        (lib.sq_field_frame, field, 11), (lib.sq_field_frames, field, 21),
        (lib.sq_field_pair, field, 7),
        (lib.sq_field_pair_nd, field_nd, 8), (lib.sq_field_step_nd, field_nd, 8),
        (lib.sq_field_chunk_nd, field_nd, 8), (lib.sq_field_chunk_rdma_nd, field_nd, 10),
        (lib.sq_field_halo_step, field_halo, 9),
        (lib.sq_gauge_frame, gauge, 9), (lib.sq_gauge_frames, gauge, 18),
        (lib.sq_gauge_chunk, gauge, 9),
    ):
        fn.argtypes = [params] + [ptr] * n_ptr + [ptr]  # tensors, then the stream
        fn.restype = ctypes.c_int
    for fn, params in ((lib.sq_field_resident, field), (lib.sq_gauge_resident, gauge),
                       (lib.sq_gauge_chunk_resident, gauge)):
        fn.argtypes = [params, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
    lib.sq_error_string.argtypes = [ctypes.c_int]
    lib.sq_error_string.restype = ctypes.c_char_p
    # the cross-process transport of csrc/ipc.cu (parallel/ipc.py)
    for fn, args in (
        (lib.sq_ipc_check, [ctypes.c_int, ptr, ptr, ctypes.POINTER(ctypes.c_int)]),
        (lib.sq_ipc_alloc, [ctypes.c_size_t, ctypes.POINTER(ctypes.c_void_p), ptr]),
        (lib.sq_ipc_free, [ptr]), (lib.sq_ipc_open, [ptr, ctypes.POINTER(ctypes.c_void_p)]),
        (lib.sq_ipc_close, [ptr]), (lib.sq_ipc_signal, [ptr, ptr, ctypes.c_uint]),
        (lib.sq_ipc_wait, [ptr, ptr, ctypes.c_uint]),
        (lib.sq_ipc_copy, [ptr, ptr, ctypes.c_size_t, ptr]),
    ):
        fn.argtypes = args
        fn.restype = ctypes.c_int
    return lib


def check_leaves(state, want: dict, device) -> None:
    """Raise unless every leaf ``name`` of ``state`` in ``want`` (name ->
    (shape, dtype)) lies on ``device`` with that shape and dtype, contiguous:
    what a kernel reads through a bare pointer."""
    for name, (shape, dtype) in want.items():
        t = getattr(state, name)
        if t.device != device:
            raise ValueError(f"state.{name} is on {t.device}, the kernel's input on {device}")
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(
                f"state.{name}: expected {shape} {dtype}, got {tuple(t.shape)} {t.dtype}"
            )
        if not t.is_contiguous():
            raise ValueError(f"state.{name} must be contiguous")


def resident(entry: str, params, multi: bool, device) -> int:
    """Chains the card runs at once in the cluster geometry of ``params``
    (``sq_field_resident``, ``sq_gauge_resident``, ``sq_gauge_chunk_resident``:
    resident clusters of ``cl_B`` blocks, or resident blocks at ``cl_B`` = 1);
    raises if the card refuses the geometry."""
    lib = library()
    out = ctypes.c_int(0)
    with torch.cuda.device(device):
        rc = getattr(lib, entry)(ctypes.byref(params), int(multi), ctypes.byref(out))
    if rc != 0:
        raise RuntimeError(f"{entry} refused cluster B={params.cl_B}: "
                           f"{lib.sq_error_string(rc).decode()} ({rc})")
    return out.value


def launch(entry: str, params, tensors, device) -> None:
    """Launch the library's ``entry`` on PyTorch's current stream of
    ``device`` with ``params`` and the tensors' device pointers, in order;
    raises if the launch is refused."""
    lib = library()
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        rc = getattr(lib, entry)(
            ctypes.byref(params), *(ctypes.c_void_p(t.data_ptr()) for t in tensors),
            ctypes.c_void_p(stream),
        )
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {entry} failed to launch: "
                           f"{lib.sq_error_string(rc).decode()} ({rc})")

#!/usr/bin/env python3
"""Kernel 5's kept-noise placements on the card, and kernel 7's per-block sums.

    python3 tools/kernel5_variants.py kept [--parent DIR]
    python3 tools/kernel5_variants.py sums

``kept`` builds kernel 5 as the package has it (``csrc/field_kernel_tiled.cu``:
the second Box-Muller output waits between the micro-steps in device memory)
beside the placements that keep it on the chip, standalone sources in
``tools/kernel5_variants/``: ``packed.cu`` (the second micro-step's rows of it
in shared memory) and ``reg.cu`` (a register array, a thread's 32-column
segments fixed across the pair) at 1024 threads with 24 kept values and at 512
with 48; with ``--parent`` also the kernel 5 of another checkout (e.g. the
parent commit unpacked with ``git archive``).  Each is held against
``field_pair_ref`` (phi and the maxima bit for bit, the sums within rtol 3e-5 /
atol 3e-6, as ``lattice_kernel_timing.py`` holds them) and timed at 1024^2 x 16
and 256^2 x 16, synchronous and checkerboard, at several strip heights: the
variants in turns, each 4 x 30 back-to-back launches through ctypes, CUDA
events, ms per launch.  A variant that does not fit a shape prints its error
code.

``sums`` holds kernel 7 at 32^4 x 1 and x 8, W = 4 (dim 0 extended
periodically), at the rule's tiles and at tile_rows 4, against its plain
version two ways: the per-block sums as means over a block (how
``lattice_kernel_timing.py`` and ``chip_smoke.py`` hold them) and raw.

JSON lines on stdout, the card's name, power limit and SM clock first.  Needs a
CUDA device and nvcc; builds into ``build/kernel5_variants/``.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

from chain_kernel_timing import emit
from lattice_kernel_timing import ND, agrees, wrap_block

HERE = Path(__file__).resolve().parents[1]
CSRC = HERE / "stochquant_tpu_torch" / "kernels" / "csrc"
VARIANTS = Path(__file__).resolve().parent / "kernel5_variants"
OUT = HERE / "build" / "kernel5_variants"
REG = ("-DFT_THREADS={}", "-DFT_KEPT={}", "-DFT_UNROLL=4")
SHAPES = (((1024, 1024), (8, 16)), ((256, 256), (16, 32, 64)))


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()


def build(parent):
    """{name: ctypes library} of every variant that compiled; nvcc's register
    and spill lines printed."""
    sys.path.insert(0, str(HERE))
    from stochquant_tpu_torch.kernels import _build

    sources = {"zk": (CSRC / "field_kernel_tiled.cu", []),
               "packed": (VARIANTS / "packed.cu", [f"-I{CSRC}"]),
               "reg1024": (VARIANTS / "reg.cu", [f"-I{CSRC}", *(f.format(n) for f, n in
                                                                 zip(REG, (1024, 24, 4)))]),
               "reg512": (VARIANTS / "reg.cu", [f"-I{CSRC}", *(f.format(n) for f, n in
                                                               zip(REG, (512, 48, 4)))])}
    if parent:
        sources["parent"] = (Path(parent) / CSRC.relative_to(HERE) / "field_kernel_tiled.cu", [])
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {name: subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-shared",
                                     str(src), "-o", str(OUT / f"{name}.so")],
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for name, (src, flags) in sources.items()}
    libs = {}
    for name, proc in procs.items():
        text, _ = proc.communicate()
        usage = [line.strip() for line in text.splitlines() if "registers" in line
                 or "spill" in line or "error" in line]
        emit(variant=name, nvcc_rc=proc.returncode, resource_usage=usage)
        if proc.returncode == 0:
            libs[name] = ctypes.CDLL(str(OUT / f"{name}.so"))
    return libs


def kept(parent) -> None:
    libs = build(parent)
    import torch

    from stochquant_tpu_torch import actions
    from stochquant_tpu_torch.config import FieldConfig, Sweep
    from stochquant_tpu_torch.integrators import field
    from stochquant_tpu_torch.kernels import field_kernel_tiled as ft
    from stochquant_tpu_torch.kernels.field_kernel import kernel_params

    dev = torch.device("cuda", 0)
    act = actions.get_field("phi4")
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    empty = lambda *shape: torch.empty(shape, device=dev)  # noqa: E731
    for shape, heights in SHAPES:
        for sweep in (Sweep.SYNC, Sweep.CHECKERBOARD):
            cfg = FieldConfig(shape=shape, n_chains=16, loops=100, seed=13, grow_after=10**9,
                              sweep=sweep)
            s = field.init_field_state(cfg, device=dev)
            C, L0, L1 = s.phi.shape
            H = ft.halo_depth(cfg)
            for t0 in heights:
                ref = ft.field_pair_ref(s.phi, s.dtau, act, cfg, int(s.step), t0)
                params = kernel_params((C, L0, L1), act, cfg, step0=int(s.step), tile_rows=t0,
                                       halo=H)
                outs = (empty(C, L0, L1), empty(C, L0), empty(C, L0), empty(C, L0 // t0, 10))
                zk = empty(C, L0 // t0, t0 + 2 * H, L1)
                ptrs = [ctypes.c_void_p(t.data_ptr()) for t in (s.phi, s.dtau, *outs, zk)]
                calls = {}
                for name, lib in libs.items():
                    call = lambda lib=lib: lib.sq_field_pair(  # noqa: E731
                        ctypes.byref(params), *ptrs, stream)
                    rc = call()
                    torch.cuda.synchronize()
                    if rc:
                        emit(shape=f"{shape[0]}^2x16", sweep=sweep.name, tile_rows=t0,
                             variant=name, rc=rc)
                        continue
                    calls[name] = (call, agrees(torch, outs, ref))
                times = {name: [] for name in calls}
                order = list(calls)
                for _ in range(2):
                    for name in order + order[::-1]:
                        start = torch.cuda.Event(enable_timing=True)
                        stop = torch.cuda.Event(enable_timing=True)
                        start.record()
                        for _ in range(30):
                            calls[name][0]()
                        stop.record()
                        torch.cuda.synchronize()
                        times[name].append(start.elapsed_time(stop) / 30)
                for name, (_, ok) in calls.items():
                    emit(shape=f"{shape[0]}^2x16", sweep=sweep.name, tile_rows=t0, variant=name,
                         ms_mean=sum(times[name]) / len(times[name]), ms_min=min(times[name]),
                         agrees_with_plain=ok)
    emit(card=card())


def sums() -> None:
    sys.path.insert(0, str(HERE))
    import torch

    from stochquant_tpu_torch import actions
    from stochquant_tpu_torch.config import FieldConfig
    from stochquant_tpu_torch.integrators import field
    from stochquant_tpu_torch.kernels import field_kernel_nd as nd

    dev = torch.device("cuda", 0)
    act = actions.get_field("phi4")
    split = (True, False, False, False)
    for C in (1, 8):
        cfg = FieldConfig(**ND, n_chains=C)
        s = field.init_field_state(cfg, device=dev)
        ext = wrap_block(torch, s.phi, 4, 0, 32)
        for tile_rows in (None, 4):
            got = nd.field_chunk_nd(ext, s.dtau, act, cfg, 4, split, 3, tile_rows=tile_rows)
            want = nd.field_chunk_nd_ref(ext, s.dtau, act, cfg, 4, split, 3, tile_rows=tile_rows)
            raw = all(torch.allclose(x.double(), y.double(), rtol=3e-5, atol=3e-6)
                      for x, y in zip(got[1:], want[1:]))
            worst = max(float((x.double() - y.double()).abs().max())
                        for x, y in zip(got[1:], want[1:]))
            emit(kernel=7, shape=f"32^4x{C}", W=4, tile_rows=tile_rows,
                 phi_bit_for_bit=torch.equal(got[0], want[0]),
                 agrees_as_means=agrees(torch, got, want), raw_sums_within_tol=raw,
                 raw_max_abs_diff=worst)
    emit(card=card())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", choices=("kept", "sums"))
    ap.add_argument("--parent", help="kept: another checkout whose kernel 5 joins the turns")
    args = ap.parse_args()
    emit(card=card())
    if args.mode == "kept":
        kept(args.parent)
    else:
        sums()
    return 0


if __name__ == "__main__":
    sys.exit(main())

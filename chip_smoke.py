#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  Phases, in order; any failure exits
non-zero:

1. device: a CUDA device must be present (there is no CPU path); prints its
   name and ``nvidia-smi``'s name and power limit;
2. build: compiles the CUDA kernels from ``stochquant_tpu_torch/kernels/csrc``
   (one nvcc per source, in parallel) and prints the build time and nvcc's
   register, shared-memory and spill report for every kernel, then one line
   each for the entries of kernels 5-8 (registers, stack frame, spills);
3. chain kernels vs plain: each chain kernel's wrapper against its plain
   PyTorch version on the card, for both Threefry variants, every boundary
   condition, Heun, an odd ``loops`` and a case with rejected frames, then
   the edges of the kernels' layout (``layout_gate_cases``: fewer sites than
   a warp with a part-filled last block, N no multiple of 32 S, the periodic
   wrap and Heun across warps, one chain tripping in a block whose others go
   on beside one starting with ``lrg_vl`` NaN), each under both Threefry
   variants with kernel 1 + epilogue ≡ kernel 2 bitwise: max|Δ| of every
   float leaf (state and per-frame metrics) ≤ 2e-6, ``stable``, ``runs``,
   ``stab_cnt`` and ``step`` exact;
4. chain main path: the port's ``cli run`` on preset ``double_well`` at
   65,536 chains and dτ = 2e-4 (one burn-in frame, then 3 frames, then
   ``--resume`` for one more), with kernel launch counts taken over that
   phase; the resumed state must equal an uninterrupted run bitwise.  The
   burn-in frame absorbs the cold start's rejection: 2e-4 sits just above
   Euler–Maruyama's stability bound at Δt = 0.02, so the first frame trips
   the detector and the controller settles at 0.95·2e-4.  Then kernel 2 at
   the run's K=2 from its checkpoint, held against its plain version as in 3;
5. chain timings: MLUPS (chains·sites·loops·frames / s) of the kernel path
   and of the plain version at the headline and config-2 shapes; the timed
   kernel launches (kernel 1 at the headline, kernel 2 at config 2 with
   K=16) are held against their plain versions as in 3;
6. field kernels vs plain: kernels 3 (``field_frame``), 4
   (``field_frames_multi``) and 5 (``field_pair``) against their plain
   versions on small cases that reach every branch — SYNC and CHECKERBOARD,
   threefry and threefry13, odd ``loops``, rejected frames, Δτ growth capped
   by ``dtau_max`` and shrinking, ``free_field``, strips of unequal rows
   (45 and 29 rows), a chain holding a NaN site that trips beside chains that
   go on and one starting at ``lrg_vl`` NaN, kernel 5 at three
   ``tile_rows`` (which must agree with each other) and with a rejected
   frame; kernels 3 and 4 at every cluster size the geometry rule can pick
   for the case (B = 1 forced among them), each B > 1 bit for bit equal to
   B = 1 but for the site sums.  Limits: ``stable``, ``runs``, ``stab_cnt``,
   ``step`` exact; φ, ``lrg_vl``, Δτ and the maxima within 2e-6; the
   site-reduced sums and
   means (M, φ², s, slice means and correlator) within rtol 3e-5, atol 3e-6,
   since the kernels sum in another order than ``torch.mean``;
7. field main path: ``cli run --preset phi4_2d --chains 16 --frames-per-launch
   2`` (one burn-in frame, 3 frames, ``--resume`` for one more, and an
   uninterrupted 4-frame run: bitwise equal; kernels 3 and 4 launched;
   finite observables, stable_frac ≥ 0.99), then the same with
   ``--tile-rows 64`` and with ``--tile-rows 0`` (kernel 5 at the strip
   rule's height, 32 rows at 256², named by the run's ``autotune`` record);
   kernels 4 and 5 from the runs' checkpoints held against their plain
   versions as in 6, and kernel 5 timed at both heights in turns (CUDA
   events, mean of 50) and by its device time (torch.profiler);
8. tiled at a size that needs it: ``runtime.run_field`` on a 1024² lattice ×
   16 chains, which ``auto`` routes to kernel 5 (4 MiB per chain, above the
   1 MiB rule); one frame of it held against ``field_frame_tiled`` with the
   plain pair (``loops`` cut, and the cut printed, if the plain frame would
   take over 60 s);
9. field timings: MLUPS of the kernel path and the plain path at
   ``bench.py``'s field shape (256² × 16, loops 100, seed 13,
   frames_per_launch 1 and 10) and at the tiled 1024² × 16 shape; CUDA-event
   ms per launch of each field kernel and wall ms of its plain version at
   those shapes, held against each other as in 6;
10. gauge kernels vs plain: kernels 10 (``gauge_frame``) and 11
    (``gauge_frames_multi``) against their plain versions for U(1), SU(2)
    and SU(3) on 8×16 and 16×128 (``bench.py``'s gate shapes): a hot start
    with odd ``loops`` and one chain holding a NaN link (its frames
    rejected, Δτ shrinking), and an active drift cap with Δτ growing into
    ``dtau_max``; a 13-row lattice (ragged strips); K = 1 (kernel 10 + the
    PyTorch epilogue) and K = 3, each at every cluster size the geometry rule
    can pick (B = 1 forced among them), B > 1 bit for bit equal to B = 1 but
    for ``plaq_mean``.  Limits: ``stable``, ``runs``, ``stab_cnt``, ``step``
    exact; links, Δτ and ``drift_max`` within 2e-6 (NaN where the plain
    version has NaN);
    ``plaq_mean`` within rtol 3e-5, atol 3e-6;
11. gauge main path: ``cli run --preset u1_2d --chains 256
    --frames-per-launch 2`` (two burn-in frames, one launch of kernel 11;
    then 3 recorded frames, each kernel 10 + the PyTorch epilogue as the JAX
    runner records every frame; ``--resume`` for one more, and an
    uninterrupted 2 + 4-frame run: bitwise equal; kernels 10 and 11
    launched; finite observables, stable_frac ≥ 0.99), then the same for
    ``su3_2d`` with ``--measure-loops`` (Polyakov loop per record, one
    ``wilson_loops`` record); kernel 10 and kernel 11 (K=2) from each run's
    checkpoint held against their plain versions as in 10;
12. gauge timings at ``bench.py``'s full-width cells (u1 256² × 32, su2
    128² × 16, su3 64² × 8, frames_per_launch 1): link-update MLUPS of the
    kernel path and the plain path (``loops`` cut, and the cut printed, if a
    plain frame would take over 60 s), kernel 10's CUDA-event ms beside the
    plain frame's wall ms, held against each other; then K = 8 against
    K = 1 at 256 chains (u1 and su2 on 16×128, su3 on 8×128, loops 10) with
    kernel 11 held against its plain version.

13. D-dim field kernels vs plain: kernels 6 (``field_pair_nd``) and 7
    (``field_chunk_nd``) against their plain versions on small cases that
    reach every branch — 4-D and 3-D, SYNC and CHECKERBOARD, both Threefry
    variants, a block that spans the whole lattice and tiles with a
    recomputed halo, three strips along dim 0, a last dim longer than a
    warp, a chain holding a NaN site and a chain that trips (both rejected),
    W = 2, W = 4 and a W = 4 chunk with a W = 2 tail, the chunk path's
    trajectory equal to the pair path's, and kernel 7 on blocks split in one
    and in two dims away from the origin (2-D, 3-D and 4-D); then the edges of
    the cooperative work split: 300 chains of 8^4 (more work items than the
    card holds blocks, a part-filled last round), W = 8 synchronous on a 4-D
    block, W = 4 and 8 checkerboard on 4-D and 2-D blocks, a split in the last
    dim, a NaN site beside chains that go on, each block equal to the whole
    lattice there bit for bit.  Limits as in 6, the per-block sums and the
    slice sums held as means;
14. D-dim main path: ``cli run --preset phi4_4d --chains 4 --loops 20`` at
    the preset's 32⁴ (one burn-in frame, 3 frames, ``--resume`` for one
    more, and an uninterrupted 4-frame run: bitwise equal; finite
    observables, stable_frac ≥ 0.99), once on the pair path (kernel 6
    launched, kernel 7 not) and once with ``--exchange-steps 4`` (kernel 7
    launched, kernel 6 not); each kernel from its run's checkpoint held
    against its plain version at 32⁴ × 4;
15. D-dim timings at ``bench.py``'s cell (32⁴, loops 20, seed 9, 8 frames)
    at 1 and at 8 chains: MLUPS of the pair path, the chunk path (W = 4) and
    the plain path (medians of 3 reps after a warm-up), CUDA-event ms per
    launch of kernels 6 and 7 beside their plain versions' wall ms, held
    against each other, under ``torch.profiler`` the device's idle share
    (busy and wall time of the same 8 profiled frames) and the top kernels
    of each kernel path, and kernel 6 over several ``tile_rows``.

16. kernel 9 (``field_halo_step``) vs its plain version on small cases that
    reach every branch, without halo inputs (the JAX kernel's mode) and with
    the halo slices of the split dims (the runner's, as strided views of the
    lattice): SYNC and both CHECKERBOARD half-sweeps, every set of split dims,
    non-zero chain, row and column offsets, both Box-Muller outputs, both
    Threefry variants, extents that are no multiple of the block, strips of
    several rows, a NaN on an interior site, on an edge slice, on a block's
    last row and in a halo row and column.  New φ and the detector's maxima
    within 2e-6, its count of non-finite updates exactly, the sums (held as
    means) as in 6;
17. kernel 12 (``gauge_chunk``) vs its plain version for U(1), SU(2) and
    SU(3) at every cluster size its rule can pick (B = 1 forced among them):
    W = 2, 4 and 8, a block away from the origin, one whose halo wraps the
    global lattice, a cap event, a NaN link in an owned and in a halo row,
    and a chain whose NaN drift in one block meets a cap event in another at
    the same step (the chain's max is NaN: not capped).  Links and drift max
    bit for bit the plain version's and B = 1's; the ``bad`` and ``capped``
    flags exactly; the plaquette sum (held as a mean) as in 6;
18. the lattice-split main paths at full width through ``runtime.run_field``
    and ``runtime.run_gauge`` with a mesh on the one card (the device twice:
    a lattice that is really cut; and ``bench.py``'s ring of one): field 256²
    × 16, loops 50 (``bench.py:544-553``) on ``cuda_step`` (kernel 9),
    ``cuda`` and ``auto`` (the chunk path: kernel 7) and ``torch``, φ and
    every decision bitwise equal to the unsplit run (kernel 3) and the means
    within the gate; a chain-only mesh (kernel 3 per shard: 8 chains a
    launch, whose cluster size may differ from 16 chains') likewise; gauge
    u1 256² × 32 loops 100 (``bench.py:397-400``) and su3 64² × 8 loops 50
    on ``cuda`` (the chunk runner: kernel 12) against the
    per-step halo runner (``auto``, which records its choice) and the unsplit
    kernel 10, links bitwise with the cap quiescent.  Every run's launch
    counters are set to 0 before and must afterwards show exactly the
    expected kernels and counts; a resume from the whole-state checkpoint is
    bitwise equal to the uninterrupted run; stable_frac ≥ 0.99; then kernels
    9 and 12 on a shard of the final states against their plain versions;
19. lattice-split timings at those shapes: (link-)MLUPS of every backend
    through the runners (median of 3 reps after a warm-up), the device's idle
    share and the kernels' own time per launch under ``torch.profiler``, and
    kernels 9 (with its halo rows, as the runner calls it) and 12 (its
    cluster size printed) alone (CUDA events, each beside the card's SM
    clock) beside their plain versions' wall ms, held against each other.

20. ``rng_impl='hardware'``: the Philox-4x32-10 variants of kernels 1-4 vs
    their plain versions on every case of 3 (the layout's edges too) and of 6
    (kernel 5 apart, which draws Threefry only; kernels 3 and 4 at every
    cluster size), limits as there; kernel 1 + the PyTorch epilogue and
    kernel 2, kernel 3 + epilogue and kernel 4 (at every B), bitwise equal;
21. the ``--rng hardware`` main paths at full width: ``cli run --preset
    double_well --chains 65536 --dtau 2e-4 --rng hardware`` as in 4,
    ``runtime.run_chain`` on config 2 (anharmonic, N = 1024, 256 chains,
    frames_per_launch 16) and ``cli run --preset phi4_2d --chains 16 --rng
    hardware`` as in 7: every launch a Philox launch, resumes bitwise,
    stable_frac ≥ 0.99, and each ensemble's ⟨x²⟩ / ⟨φ²⟩ within 6 standard
    errors of the Threefry run's;
22. the schemes no kernel implements, on the card through the entry points
    (``auto`` records a ``backend_fallback`` and launches no kernel): ``cli
    run --preset quartic_large`` (256 × 1024, the power spectrum: finite,
    Parseval), ``--preset harmosc --scheme lm`` and ``--scheme exact``,
    ``--preset phi4_2d --scheme exact`` (ETD1) and ``runtime.run_field`` on a
    free field under ``Scheme.EXACT`` (⟨φ²⟩ against the lattice's exact
    value); resumes bitwise; then each at a small size on the card against
    the CPU run of the same code (float leaves within 2e-5, chains under
    EXACT 5e-4, fields under EXACT 5e-5, the spectrum 1e-4 of a chain's
    largest mode);
23. Philox beside Threefry in turns (threefry, hardware, hardware,
    threefry): MLUPS at the headline, config 2 (K = 16) and field 256² × 16
    (frames per launch 1 and 10); each Philox variant's CUDA-event ms beside
    its plain version's wall ms, held against each other.

24. kernel 8 (``field_chunk_rdma_nd``: kernel 7's W steps reading its dim-0
    halo rows from the neighbour shards' slabs) vs its plain version and vs
    kernel 7 on the block the runner would have extended, on every shard of
    2-D and 4-D splits, both sweeps, a ring of one, x = 2, 3 and 4 on the
    repeated card, a chain axis beside the ring and the timed 256² × 16
    shape: φ bitwise, the rest as in 6, kernel 8 ≡ kernel 7 bitwise; the
    one-step tail of an odd ``loops`` (kernel 6's code at one step) vs its
    plain version, and odd-loops frames of the D ≥ 3 pair and chunk routes
    and of the strip-tiled 2-D route vs their plain versions and the plain
    integrator;
25. kernel 8's main path at full width: ``runtime.run_field`` on bench.py's
    halo cell (256² × 16, loops 50, W = 8) with a mesh of the one card at x =
    2 and on the ring of one, ``backend='cuda_rdma'`` and ``auto`` with
    ``prefer_rdma``: exact launch counts (kernel 8 chunks × shards × frames,
    kernel 7 none), every leaf bitwise equal to the kernel 7 run and φ and
    the decisions to the unsplit kernel 3, a bitwise resume, and the one
    ``backend_fallback`` record of ``prefer_rdma`` on a dim-1 split (kernel 7
    runs); the 4-D split 32⁴ × 8 loops 20 at x = 2 against kernel 7 and the
    unsplit kernel 6; kernel 8 on the final state's shards against its plain
    version; then ``cli run --preset phi4_4d --loops 21`` (10 pair launches
    and one tail launch a frame, bitwise resume) against ``--backend torch``;
26. ``cuda_rdma`` beside ``cuda`` (x = 2) and ``cuda_pair`` (ring of one) in
    turns: MLUPS, idle share and each kernel's device time per launch under
    torch.profiler; kernel 8 and kernel 7 alone on the (16, 128, 256) slab at
    W = 8 (CUDA events, in turns) beside kernel 8's plain version; the
    one-step tail beside the pair at 32⁴ × 1 (CUDA events, in turns).

27. complex Langevin, which no kernel implements in either package: ``cli
    run`` on every complex preset (``complex_gaussian``, ``complex_quartic``,
    ``complex_chain``, ``complex_field_2d``) and complexified gauge preset
    (``cu1_2d_complex``, ``csu3_2d_complex``, with gauge cooling) at its JAX
    width: burn 1 + 2 frames, ``--resume`` for 1, an uninterrupted burn 1 +
    3, the resume bitwise, the records finite with the JAX runner's keys,
    every kernel counter at 0, ``auto`` on the gauge presets recording its
    ``backend_fallback``; each family at a small size on the card against
    the CPU run of the same code (integer leaves equal, float leaves and both
    parts of complex ones within 2e-5, site means within rtol 3e-5, atol
    3e-6); ⟨z²⟩ of ``complex_gaussian`` against 1/σ and of
    ``complex_field_2d`` against the lattice propagator, each within 6
    standard errors over chains after a burn-in, and ``cu1_2d_complex``'s
    unitarity norm with cooling below its value without; MLUPS of the chain
    and field presets and of the complex field at 256² × 16 (with the
    device's idle share under ``torch.profiler``), link-MLUPS of the gauge
    presets.

28. chains over a mesh and across processes, sharded checkpoints, on-card
    autotune and the reference format: (a) ``runtime.run_chain`` on the
    headline (65,536 chains) over a mesh of 2 shards on the one card, fpl 1
    and 2, Threefry and Philox, exact launch counts (kernels 1 / 2 per shard),
    every state leaf and record bit for bit the unsplit run's; a
    ``save_sharded`` / ``load_sharded`` round trip and a resume from the
    sharded files bitwise the uninterrupted run; the host times of a
    whole-state and a sharded checkpoint write and read; a frame of the mesh
    beside the unsplit frame in turns; (b) two processes on the card (gloo
    through a file store), each 32,768 chains through kernels 1 and 2 with
    its global chain offset, each writing its ``save_sharded`` file; two new
    processes load them and run a frame more: the files joined bitwise the
    one-process run, the stable fraction summed over the processes by gloo
    the one-process one; (c) ``runtime.run_field`` with ``tile_rows=0`` at 32⁴
    × 4 (kernel 6 at every admitted height, then the run) and with
    ``exchange_steps=0`` on the 256² × 16 split at x = 2 (kernel 7 at every
    admitted W), exact launch counts, each run's φ and decisions bitwise the
    untuned run's (the unsplit kernel 3 for the split), the ``autotune``
    records with each candidate's time; (d) ``export_reference`` of a card
    state and ``import_reference`` of the file: f, the means, ω, the count
    and the clamped Δτ bit for bit.

29. physics at full width on the card (``stochquant_tpu_torch.physics_gates``):
    the JAX package's statistical gates through the entry points (``auto``
    on the card) at the widths of the cells, against exact answers: (a) a
    harmonic BACKGROUND chain at the headline's width (kernels 1 and 1h),
    per-site ⟨x²⟩, ⟨x⁴⟩ against the exact EM covariance; (b) the kink
    coordinate's step law on the headline (kernel 1); (c) the headline's edge
    profile against 64 runs of the reference oracle; (d) a harmonic chain at
    config 2's width (kernels 2 and 2h) against the exact EM covariance and
    its row; (e) config 2 at three Δτ extrapolated to 0 against the transfer
    matrix (⟨x²⟩, ⟨x⁴⟩, gap); (f) the free field at 256² × 16 (kernels 3, 4,
    3h, 4h): ⟨φ²⟩ against the EM propagator sum, Binder U against 0; (g)
    ⟨φ²⟩ on the tiled 1024² × 16 route (kernel 5) and at 32⁴ on kernels 6
    and 7; (h) the 2-D plaquette of u1, su2 and su3 (kernel 10) against its
    exact value at the cells' Δτ and extrapolated to Δτ → 0 from Δτ, Δτ/2
    and Δτ/4.  One line per statistic (value, exact answer, error, limit,
    z, launches); every statistic within its test's limit and every named
    kernel launched, or the phase fails.

30. lattices split across processes on the card (``phase_across_processes``):
    gloo workers on cuda:0, each on its shards of ``distributed.global_mesh``
    through ``runtime.run_field`` / ``run_gauge``, with gloo's all-gathers
    made to raise (a collective of CUDA tensors crosses only through CUDA IPC
    and the stream counters of ``parallel/ipc.py``): (a) field 256² × 16
    loops 50 W = 8 at x = 2 over two processes through ``cuda_rdma`` (kernel
    8 reading its neighbour's slab in the other process's memory), ``cuda``
    (kernel 7) and ``cuda_step`` (kernel 9); (b) 32⁴ × 8 loops 20 W = 2 at x
    = 4 over four processes, ``cuda_rdma`` and ``cuda``; (c) gauge u1 256² ×
    32 loops 100 and su3 64² × 8 loops 50 at x = 2 on the chunk runner
    (kernel 12), u1 one frame of the per-step runner; (d) (a)'s ``cuda_rdma``
    run saved after 2 frames (``save_sharded``) and resumed by two new
    processes for the 3rd.  Every shard, decision and record bitwise the
    one-process run on the repeated-device mesh (run first, in this
    process), each process's launches exactly the one-process run's over the
    number of processes; ms a frame beside the one-process run's and the
    transport's set-up seconds a process.

Every timing phase ([5], [9], [12], [15], [19], [22], [23], [26], [27], [28], [30]) and [29] end
with the range of the card's SM clock, power draw and temperature sampled while it ran.

``python3 chip_smoke.py --log PATH`` also writes every printed line to PATH.

Prints a JSON line with the numbers of the twelve kernels and the four
Philox variants (name, route, source, the cluster size B and where the state
lives for kernels 3, 4, 10, 11 and 12, the device time per launch of kernels
8, 9 and 12, the
TPU kernel it replaces, main-path launches, max|Δ|, ms and plain ms at the
timed shape, the bound: the least ms the card could take for that launch,
the resource that binds it, and the ms of one PyTorch call computing the
same function, null where there is none; kernel 8 also its launches in
[30]'s processes), [30]'s ms a frame and set-up seconds, then the card's
name and power limit, and last ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import collections
import functools
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
GATE = 2e-6  # max |Δ| of every float leaf, kernel vs plain (the JAX kernels' bar)
HEADLINE = dict(action="double_well", n_sites=200, dt=0.02, dtau=2e-4, n_chains=65536,
                loops=1000, seed=2026, grow_after=10**9)
CONFIG2 = dict(action="anharmonic", n_sites=1024, dt=0.25, dtau=0.01, n_chains=256,
               loops=1000, seed=14, grow_after=10**9)
CSRC = "stochquant_tpu_torch/kernels/csrc/"
# name -> (source, the TPU kernel it replaces)
KERNELS = {
    "chain_frame": ("chain_kernel.cu", "stochquant_tpu/kernels/chain_kernel.py:283"),
    "chain_frames_multi": ("chain_kernel.cu", "stochquant_tpu/kernels/chain_kernel.py:624"),
    "field_frame": ("field_kernel.cu", "stochquant_tpu/kernels/field_kernel.py:205"),
    "field_frames_multi": ("field_kernel.cu", "stochquant_tpu/kernels/field_kernel.py:498"),
    "field_pair": ("field_kernel_tiled.cu", "stochquant_tpu/kernels/field_kernel_tiled.py:189"),
    "field_pair_nd": ("field_kernel_nd.cu", "stochquant_tpu/kernels/field_kernel_nd.py:327"),
    "field_chunk_nd": ("field_kernel_nd.cu", "stochquant_tpu/kernels/field_kernel_nd.py:977"),
    "field_chunk_rdma_nd": ("field_kernel_nd.cu",
                            "stochquant_tpu/kernels/field_kernel_nd.py:977 (rdma=True)"),
    "field_halo_step": ("field_halo_kernel.cu", "stochquant_tpu/kernels/field_halo_kernel.py:190"),
    "gauge_frame": ("gauge_kernel.cu", "stochquant_tpu/kernels/gauge_kernel.py:434"),
    "gauge_frames_multi": ("gauge_kernel.cu", "stochquant_tpu/kernels/gauge_kernel.py:1144"),
    "gauge_chunk": ("gauge_kernel.cu", "stochquant_tpu/kernels/gauge_kernel.py:1401"),
    # rng_impl='hardware': the Philox variants, for the TPU kernels' on-core generator branch
    "chain_frame_hw": ("chain_kernel.cu", "stochquant_tpu/kernels/chain_kernel.py:219"),
    "chain_frames_multi_hw": ("chain_kernel.cu", "stochquant_tpu/kernels/chain_kernel.py:412"),
    "field_frame_hw": ("field_kernel.cu", "stochquant_tpu/kernels/field_kernel.py:157"),
    "field_frames_multi_hw": ("field_kernel.cu", "stochquant_tpu/kernels/field_kernel.py:319"),
}
# the kernels [29] must launch: 1, 1h, 2, 2h, 3, 3h, 4, 4h, 5, 6, 7 and 10
PHYSICS_KERNELS = ("chain_frame", "chain_frame_hw", "chain_frames_multi", "chain_frames_multi_hw",
                   "field_frame", "field_frame_hw", "field_frames_multi", "field_frames_multi_hw",
                   "field_pair", "field_pair_nd", "field_chunk_nd", "gauge_frame")
FIELD_RTOL, FIELD_ATOL = 3e-5, 3e-6  # site-reduced sums: tests/test_field_kernel.py:35
BENCH_FIELD = dict(shape=(256, 256), n_chains=16, loops=100, seed=13, grow_after=10**9)
TILED_FIELD = dict(shape=(1024, 1024), n_chains=16, loops=100, seed=13, grow_after=10**9)
# bench.py's gauge cells (bench.py:297-385 at frames_per_launch 1; 444-477 multiframe)
BENCH_GAUGE = {
    "u1": dict(group="u1", beta=1.0, shape=(256, 256), n_chains=32, dtau=5e-3, loops=100,
               seed=15, grow_after=10**9),
    "su2": dict(group="su2", beta=2.0, shape=(128, 128), n_chains=16, dtau=2e-3, loops=100,
                seed=19, grow_after=10**9),
    "su3": dict(group="su3", beta=5.0, shape=(64, 64), n_chains=8, dtau=1e-3, loops=50,
                seed=19, grow_after=10**9),
}
# bench.py's D-dim cell (bench.py:492-534), at 1 chain as there and at 8
BENCH_ND = dict(action="phi4", shape=(32, 32, 32, 32), loops=20, seed=9, grow_after=10**9)
MULTI_GAUGE = {
    "u1": dict(group="u1", beta=1.0, shape=(16, 128), dtau=5e-3),
    "su2": dict(group="su2", beta=2.0, shape=(16, 128), dtau=2e-3),
    "su3": dict(group="su3", beta=5.0, shape=(8, 128), dtau=1e-3),
}


# The bound of a launch: the larger of its bytes over the card's memory rate
# (every input read once, every output written once) and its operations over
# the card's float32 rate outside the tensor cores (NVIDIA's data sheet, H100
# SXM).  Operations are counted per site and micro-step from the kernels'
# sources, every arithmetic, compare/select and transcendental call as one:
#   noise: one Threefry-2x32 evaluation (5 per round + 3 per key injection +
#     4) and Box-Muller (8 for the two uniforms, 4 transcendentals, 4
#     products) per two micro-steps: (119 + 16) / 2 at 20 rounds;
#   Philox noise (rng_impl='hardware', kernels 1-4): one Philox-4x32-10
#     evaluation (8 per round: two high and two low products, four xors; 2 per
#     key bump, nine bumps: 98) and two Box-Mullers (32) per four micro-steps:
#     (98 + 32) / 4;
#   chain (chain_kernel.cu substep): stencil 4, drift 3, update and clamp 7,
#     detector maxima 6, observables 8, and the action's force: double_well
#     on the kink background 11 (x_cl with its tanh, ddV), anharmonic 5;
#   field (field_common.cuh, field_kernel_nd.cu nd_sweep): 4 D + 1 stencil,
#     dV 5, update and clamp 11, observables 5 D + 10, maxima 3: 9 D + 30;
#   gauge (gauge_kernel.cu pass1 + pass2, per site = 2 links, noise apart):
#     u1 46 (4 plaquette angles, 5 transcendentals, 2 wraps), su2 391 + 138
#     (13 quaternion products, exponential, normalisation), su3 2770 + 3424
#     (26 3x3 complex products, Cayley-Hamilton exponential, projection);
#     noise draws per link: 1, 3 and 8.
HBM_BYTES_PER_S, FP32_OPS_PER_S = 3.35e12, 67e12
NOISE_OPS = (119 + 16) / 2
PHILOX_NOISE_OPS = (98 + 32) / 4
CHAIN_OPS = {"double_well": 28 + 11, "anharmonic": 28 + 5}
GAUGE_PLANES = {"u1": 2, "su2": 8, "su3": 36}  # float32 planes of a chain's links
GAUGE_OPS = {"u1": 46 + 2 * 1 * NOISE_OPS, "su2": 391 + 138 + 2 * 3 * NOISE_OPS,
             "su3": 2770 + 3424 + 2 * 8 * NOISE_OPS}


def field_ops(ndim: int, noise: float = NOISE_OPS) -> float:
    return 9 * ndim + 30 + noise


def bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """(least ms the card could take, which resource binds)."""
    by_bytes, by_ops = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / FP32_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def kernel_bounds() -> dict:
    """The bound of each kernel's timed launch, from that launch's shapes."""
    prod = math.prod
    h, c2 = HEADLINE, CONFIG2
    sites = h["n_chains"] * h["n_sites"]
    out = {"chain_frame": bound(  # f in; f and the four per-site sums out
        sites * 4 * 6, sites * h["loops"] * (CHAIN_OPS[h["action"]] + NOISE_OPS))}
    sites = c2["n_chains"] * c2["n_sites"]
    out["chain_frames_multi"] = bound(  # f and four per-site means in and out, K = 16
        sites * 4 * 10, sites * c2["loops"] * 16 * (CHAIN_OPS[c2["action"]] + NOISE_OPS))
    f = BENCH_FIELD
    sites = f["n_chains"] * prod(f["shape"])
    out["field_frame"] = bound(sites * 4 * 2, sites * f["loops"] * field_ops(2))
    out["field_frames_multi"] = bound(sites * 4 * 2, sites * f["loops"] * 10 * field_ops(2))
    # the Philox variants at the same shapes: the same bytes, their own noise count
    sites = h["n_chains"] * h["n_sites"]
    out["chain_frame_hw"] = bound(
        sites * 4 * 6, sites * h["loops"] * (CHAIN_OPS[h["action"]] + PHILOX_NOISE_OPS))
    sites = c2["n_chains"] * c2["n_sites"]
    out["chain_frames_multi_hw"] = bound(
        sites * 4 * 10, sites * c2["loops"] * 16 * (CHAIN_OPS[c2["action"]] + PHILOX_NOISE_OPS))
    sites = f["n_chains"] * prod(f["shape"])
    hw_ops = field_ops(2, PHILOX_NOISE_OPS)
    out["field_frame_hw"] = bound(sites * 4 * 2, sites * f["loops"] * hw_ops)
    out["field_frames_multi_hw"] = bound(sites * 4 * 2, sites * f["loops"] * 10 * hw_ops)
    sites = TILED_FIELD["n_chains"] * prod(TILED_FIELD["shape"])
    out["field_pair"] = bound(sites * 4 * 2, sites * 2 * field_ops(2))
    shape = BENCH_ND["shape"]
    sites = prod(shape)  # 1 chain
    out["field_pair_nd"] = bound(sites * 4 * 2, sites * 2 * field_ops(len(shape)))
    ext = sites // shape[0] * (shape[0] + 2 * 4)  # W = 4, synchronous: halo 4 on dim 0
    out["field_chunk_nd"] = bound((ext + sites) * 4, sites * 4 * field_ops(len(shape)))
    # kernel 8 on one shard of the split 256^2 x 16 lattice (x = 2), W = H = 8:
    # kernel 7's operations there; the slab and 2 H neighbour rows in, the slab out
    loc0, W = f["shape"][0] // 2, 8
    cols = f["n_chains"] * f["shape"][1]
    out["field_chunk_rdma_nd"] = bound(cols * (2 * loc0 + 2 * W) * 4,
                                       cols * loc0 * W * field_ops(2))
    # kernel 9 on one shard of the split 256^2 x 16 lattice (x = 2): phi in and
    # out; a launch is one step, so it draws a whole Threefry pair per site
    sites = f["n_chains"] * prod(f["shape"]) // 2
    out["field_halo_step"] = bound(sites * 4 * 2, sites * (field_ops(2) + NOISE_OPS))
    for group, g in BENCH_GAUGE.items():  # the kernels line reports u1
        planes = GAUGE_PLANES[group]
        sites = g["n_chains"] * prod(g["shape"])
        out["gauge_frame_" + group] = bound(sites * planes * 4 * 2,
                                            sites * g["loops"] * GAUGE_OPS[group])
        sites = 256 * prod(MULTI_GAUGE[group]["shape"])  # loops 10, K = 8
        out["gauge_frames_multi_" + group] = bound(sites * planes * 4 * 2,
                                                   sites * 10 * 8 * GAUGE_OPS[group])
        # kernel 12 on one shard (x = 2), W = H = 8: the extended block in, the
        # owned rows out; step k needs the owned rows and 2 (W - 1 - k) more
        loc0, W = g["shape"][0] // 2, 8
        cols = g["n_chains"] * g["shape"][1]
        out["gauge_chunk_" + group] = bound(
            cols * (2 * loc0 + 2 * W) * planes * 4,
            cols * (W * loc0 + W * (W - 1)) * GAUGE_OPS[group])
    for name in ("gauge_frame", "gauge_frames_multi", "gauge_chunk"):
        out[name] = out[name + "_u1"]
    return out


LOG_FILE = None  # with --log PATH: every printed line goes there too


def log(msg: str) -> None:
    print(msg, flush=True)
    if LOG_FILE is not None:
        LOG_FILE.write(msg + "\n")
        LOG_FILE.flush()


def resource_summary(nvcc_log: str, names) -> list:
    """One line per compiled entry whose name holds one of ``names``: its
    registers, stack frame and spills, from nvcc's --resource-usage report."""
    out, entry, frame = [], None, ""
    for line in nvcc_log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1] if "'" in line else None
            entry = entry if entry and any(n in entry for n in names) else None
            frame = ""
        elif entry and "spill" in line:
            frame = line.split(":", 1)[-1].strip()
        elif entry and "Used" in line:
            out.append(f"{entry}: {line.split(':', 1)[-1].strip()}; {frame}")
            entry = None
    return out


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


class CardSampler:
    """Samples the card's SM clock, power draw and temperature every 200 ms
    (``nvidia-smi -lms``) while a timing phase runs and logs their range when
    it ends: the same binary runs slower on a card that is clocked down, so a
    time is only read beside the clock it was taken at."""

    QUERY = ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
             "--format=csv,noheader,nounits", "-lms", "200"]

    def __init__(self, label: str):
        self.label, self.proc = label, None

    def __enter__(self):
        try:
            self.proc = subprocess.Popen(self.QUERY, stdout=subprocess.PIPE,
                                         stderr=subprocess.DEVNULL, text=True)
        except OSError:
            self.proc = None
        return self

    def __exit__(self, *exc):
        if self.proc is None:
            log(f"  card during {self.label}: nvidia-smi unavailable")
            return False
        self.proc.terminate()
        try:
            text, _ = self.proc.communicate(timeout=10)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            text, _ = self.proc.communicate()
        rows = []
        for line in text.splitlines():
            try:
                rows.append([float(v) for v in line.split(",")])
            except ValueError:
                continue
        if rows:
            mhz, watts, temp = (sorted(col) for col in zip(*rows))
            log(f"  card during {self.label}: SM clock {mhz[0]:.0f}-{mhz[-1]:.0f} MHz (median "
                f"{mhz[len(mhz) // 2]:.0f}), power {watts[0]:.1f}-{watts[-1]:.1f} W, "
                f"{temp[0]:.0f}-{temp[-1]:.0f} C over {len(rows)} samples")
        else:  # shorter than a sampling period: one reading just after it
            try:
                now = subprocess.run(self.QUERY[:3], capture_output=True, text=True,
                                     timeout=30).stdout.strip()
                mhz, watts, temp = (v.strip() for v in now.split(","))
                log(f"  card just after {self.label} (too short to sample): SM clock {mhz} MHz, "
                    f"power {watts} W, {temp} C")
            except (OSError, ValueError, subprocess.TimeoutExpired):
                log(f"  card during {self.label}: no samples")
        return False


def gate_cases(ChainConfig, BoundaryCondition, Formulation, Scheme):
    """(name, config, n_frames): small cases for every branch of the kernels."""
    dw = dict(action="double_well", n_sites=200, dt=0.02, dtau=2e-4, n_chains=256,
              loops=100, seed=11, grow_after=10**9)
    direct = dict(formulation=Formulation.DIRECT)
    return [
        ("gate_threefry", ChainConfig(**dw), 2),
        ("gate_threefry13", ChainConfig(**dw, rng_impl="threefry13"), 2),
        ("periodic_anharmonic_n1024", ChainConfig(
            action="anharmonic", n_sites=1024, dt=0.25, dtau=0.01, n_chains=16, loops=50,
            seed=13, bc=BoundaryCondition.PERIODIC, **direct), 2),
        ("periodic_anharmonic_n2000_tf13", ChainConfig(
            action="anharmonic", n_sites=2000, dt=0.3, dtau=0.005, n_chains=8, loops=20,
            seed=15, bc=BoundaryCondition.PERIODIC, rng_impl="threefry13", **direct), 2),
        ("dirichlet_harmonic", ChainConfig(
            action="harmonic", n_sites=96, dt=0.2, dtau=0.01, n_chains=16, loops=40,
            seed=14, bc=BoundaryCondition.DIRICHLET, **direct), 2),
        ("heun_double_well", ChainConfig(**{**dw, "n_chains": 64, "loops": 40},
                                         scheme=Scheme.HEUN), 2),
        ("odd_loops_harmosc", ChainConfig(
            action="harmonic", n_sites=100, dt=0.1, dtau=0.002, n_chains=32, loops=21,
            seed=3, rng_impl="threefry13"), 2),
        ("rejections_double_well", ChainConfig(
            action="double_well", n_sites=32, dt=0.05, dtau=0.05, n_chains=16, loops=6,
            seed=5), 4),
        ("grow_shrink_dtau_max", ChainConfig(
            action="double_well", n_sites=32, dt=0.05, dtau=1.2e-3, n_chains=64, loops=50,
            seed=6, grow_after=1, dtau_max=1.4e-3), 8),
    ]


def layout_gate_cases(ChainConfig, BoundaryCondition, Formulation, Scheme):
    """(name, config, n_frames, tripped chain, NaN chain): the edges of kernels
    1 and 2's layout (G warps a chain, S sites a lane, several one-warp chains
    a block): fewer sites than a warp in blocks of 4 chains with the last
    block part-filled; N no multiple of 32 S; chains over several warps under
    PERIODIC (the wrap across warps) and under Heun; and a block of 4 chains
    in which one chain (lrg_vl 1e-6) trips while the others go on, beside one
    that starts with lrg_vl NaN (the max must carry the NaN)."""
    dw = dict(action="double_well", dt=0.05, dtau=1e-3, loops=20, seed=21, grow_after=10**9)
    anh = dict(action="anharmonic", dt=0.25, dtau=0.01, loops=20, seed=22,
               bc=BoundaryCondition.PERIODIC, formulation=Formulation.DIRECT)
    return [
        ("layout_n20_part_filled_block", ChainConfig(**dw, n_sites=20, n_chains=530), 2, None,
         None),
        ("layout_n230_periodic", ChainConfig(**anh, n_sites=230, n_chains=16), 2, None, None),
        ("layout_n1500_periodic_warps", ChainConfig(**anh, n_sites=1500, n_chains=8), 2, None,
         None),
        ("layout_n700_heun_warps", ChainConfig(**dw, n_sites=700, n_chains=8,
                                               scheme=Scheme.HEUN), 2, None, None),
        ("layout_trip_and_nan_lrg_in_block", ChainConfig(**dw, n_sites=40, n_chains=600), 2, 3,
         5),
    ]


def chain_gate(ck, langevin, actions, cfgmod, device, label, cfg, n, tripped=None, nan=None):
    """Kernel 1 + epilogue and kernel 2 against the plain version, and against
    each other bitwise, from a start with DIRICHLET edges at 0, chain
    ``tripped`` at lrg_vl 1e-6 and chain ``nan`` at lrg_vl NaN.  Returns the
    plain version's (state, metrics)."""
    act = actions.get(cfg.action)
    s0 = langevin.init_chain_state(cfg, act, device=device)
    if cfg.bc == cfgmod.BoundaryCondition.DIRICHLET:
        s0.f[:, 0] = 0.0
        s0.f[:, -1] = 0.0
    if tripped is not None:
        s0.lrg_vl[tripped] = 1e-6
    if nan is not None:
        s0.lrg_vl[nan] = float("nan")
    plain = ck.chain_frames_multi_ref(s0, act, cfg, n)
    check_layout_case(label, plain, tripped, nan)
    one = ck.run_frames_kernel(s0, act, cfg, n, frames_per_launch=1)
    gate(f"{label} {ck.launch_geometry(cfg.n_sites, cfg.n_chains)} chain_frame x{n} + epilogue",
         one, plain)
    multi = ck.chain_frames_multi(s0, act, cfg, n)
    gate(f"{label} chain_frames_multi K={n}", multi, plain)
    same_leaves(label, one, multi)
    return plain


def check_layout_case(name, plain, tripped, nan) -> None:
    """The trip case must have rejected its tripped chain's frames and kept
    the others', and carried the NaN chain's lrg_vl."""
    import torch

    if tripped is None:
        return
    stable = plain[1]["stable"]
    if bool(stable[:, tripped].any()) or bool(stable.all(dim=0).sum() < 2):
        raise SystemExit(f"{name}: chain {tripped} should trip while the others go on: "
                         f"{stable.cpu().tolist()}")
    if not bool(torch.isnan(plain[0].lrg_vl[nan])):
        raise SystemExit(f"{name}: chain {nan}'s lrg_vl should stay NaN")


def same_leaves(label: str, one, multi) -> None:
    """Kernel 1 (3) + the PyTorch epilogue and kernel 2 (4) must agree bit for
    bit (NaN where the other has NaN)."""
    import torch

    for (leaf, x), (_, y) in zip(leaves(one), leaves(multi)):
        x, y = x.cpu(), y.cpu()
        if x.is_floating_point():
            nan = torch.isnan(x)
            same = torch.equal(nan, torch.isnan(y)) and torch.equal(x[~nan], y[~nan])
        else:
            same = torch.equal(x, y)
        if not same:
            raise SystemExit(f"{label}: the one-frame kernel + epilogue and the multi-frame "
                             f"kernel differ in {leaf}")


EXACT = ("runs", "stab_cnt", "step", "unstable", "stable", "n_bad", "bad", "capped")


# field leaves whose values are sums over sites, taken in another order by
# the kernels than by torch.mean / torch.sum in the plain versions
SITE_REDUCED = {"mag_mean", "mag2_mean", "mag4_mean", "absmag_mean", "phi2_mean", "act_mean",
                "corr_mean", "ms", "m2s", "m4s", "ams", "p2s", "acs", "cs", "sl0", "sl1",
                "strip_means", "slice_means", "plaq_mean"}


def leaves(result) -> list:
    """(name, tensor) leaves of a kernel's result: frame sums, a (state,
    metrics) pair, a field pair kernel's (phi, sl0, sl1, stats) or the chunk
    kernel's (phi, slice sums, stats), whose per-block sums and slice sums
    are compared as means (a sum of 16k sites near zero carries the rounding
    of its terms, not of its value)."""
    if hasattr(result, "_fields"):  # an optional leaf that is off (FrameSums.specs) is None
        return [(n, t) for n, t in zip(result._fields, result) if t is not None]
    if len(result) in (3, 4):
        phi, stats = result[0], result[-1]
        sites = phi[0].numel() // stats.shape[1]
        cols = range(stats.shape[2])
        sums, maxima = [c for c in cols if c % 5 < 3], [c for c in cols if c % 5 >= 3]
        slices = ([("sl0", result[1]), ("sl1", result[2])] if len(result) == 4 else
                  [("slice_means", result[1] / (phi[0].numel() // phi.shape[1]))])
        return [("phi", phi), *slices, ("strip_means", stats[..., sums] / sites),
                ("strip_max", stats[..., maxima])]
    state, metrics = result
    return list(zip(state._fields, state)) + list(metrics.items())


def gate(label: str, got, want) -> float:
    """Hold a kernel's result against its plain version's: exact leaves
    equal, the site-reduced leaves of the field and gauge kernels within
    FIELD_RTOL / FIELD_ATOL, every other float leaf within GATE (complex
    leaves by their parts; NaN must stand where the plain version has NaN).
    Returns max|Δ| over every float leaf."""
    import torch

    torch.cuda.synchronize()
    worst, worst_elem, bad = 0.0, 0.0, []
    for (name, x), (_, y) in zip(leaves(got), leaves(want)):
        if name in EXACT:
            if not torch.equal(x.cpu(), y.cpu()):
                bad.append(name)
            continue
        if x.is_complex():
            x, y = torch.view_as_real(x), torch.view_as_real(y)
        nan = torch.isnan(x)
        if not torch.equal(nan, torch.isnan(y)):  # NaN must meet NaN (a rejected chain)
            bad.append(name + " (NaN)")
            continue
        x, y = x[~nan], y[~nan]
        diff = torch.where(x == y, 0.0, (x.double() - y.double()).abs())  # inf meets inf
        err = float(diff.max()) if diff.numel() else 0.0
        worst = max(worst, err)
        if name in SITE_REDUCED:
            if bool((diff > FIELD_ATOL + FIELD_RTOL * y.double().abs()).any()):
                bad.append(name)
        else:
            worst_elem = max(worst_elem, err)
            if err > GATE:
                bad.append(name)
    log(f"  {label:60s} max|Δ| {worst:.3e} (leaves held to {GATE:g}: {worst_elem:.3e})  "
        f"out of bounds {bad or 'none'}")
    if bad:
        raise SystemExit(f"kernel vs plain gate failed: {label}: {bad}")
    return worst


# per-chain means of the main paths' final states, kept for [21]'s comparison of
# the Philox runs with the Threefry runs of [4] and [7]
SANITY = {}


def same_mean(label: str, a, b, card: str) -> None:
    """Two ensembles' per-chain means of one observable must agree within 6
    standard errors of their difference (independent noise, same physics)."""
    a, b = a.double().cpu(), b.double().cpu()
    se = math.sqrt(float(a.var()) / a.numel() + float(b.var()) / b.numel())
    z = abs(float(a.mean()) - float(b.mean())) / max(se, 1e-300)
    log(f"  {label}: {float(a.mean()):.6f} (Philox) against {float(b.mean()):.6f} (Threefry), "
        f"{z:.2f} standard errors apart (limit 6) [{card}]")
    if not z < 6.0:
        raise SystemExit(f"{label}: the Philox ensemble's mean is {z:.1f} standard errors off")


def phase_gate(ck, langevin, actions, cfgmod, device) -> None:
    """Kernel wrapper vs plain version on the card, on small cases that
    reach every branch of the kernels."""
    for name, cfg, n in gate_cases(cfgmod.ChainConfig, cfgmod.BoundaryCondition,
                                   cfgmod.Formulation, cfgmod.Scheme):
        act = actions.get(cfg.action)
        s0 = langevin.init_chain_state(cfg, act, device=device)
        if cfg.bc == cfgmod.BoundaryCondition.DIRICHLET:
            s0.f[:, 0] = 0.0
            s0.f[:, -1] = 0.0
        gate(f"{name} chain_frame ×{n} + epilogue",
             ck.run_frames_kernel(s0, act, cfg, n, frames_per_launch=1),
             langevin.run_frames(s0, act, cfg, n))
        gate(f"{name} chain_frames_multi K={n}",
             ck.chain_frames_multi(s0, act, cfg, n), ck.chain_frames_multi_ref(s0, act, cfg, n))
    import dataclasses

    for name, cfg, n, tripped, nan in layout_gate_cases(
            cfgmod.ChainConfig, cfgmod.BoundaryCondition, cfgmod.Formulation, cfgmod.Scheme):
        for rng in ("threefry", "threefry13"):
            chain_gate(ck, langevin, actions, cfgmod, device, f"{name} {rng}",
                       dataclasses.replace(cfg, rng_impl=rng), n, tripped, nan)


def phase_main_path(torch, ck, cli, checkpoint, actions, tmp: Path,
                    extra: tuple = ()) -> tuple[dict, float]:
    """The port's CLI on the double_well preset at 65,536 chains (``extra``:
    more options, e.g. ``--rng hardware``); then kernel 2 at the K=2 it ran
    with, from the run's checkpoint, against its plain version.  Returns the
    launch counts (with the Philox variants' own under ``*_hw``) and that
    max|Δ|."""
    common = ["run", "--preset", "double_well", "--chains", "65536", "--dtau", "2e-4",
              "--device", "cuda", "--frames-per-launch", "2", *extra]
    for fn in (ck.chain_frame, ck.chain_frames_multi):
        fn.launches = fn.launches_hw = 0
    t0 = time.time()
    cli.main(common + ["--burn", "1", "--frames", "3", "--fps", "3", "--out", str(tmp / "a.npz"),
                       "--metrics", str(tmp / "a.jsonl")])
    cli.main(common + ["--frames", "1", "--resume", str(tmp / "a.npz"),
                       "--out", str(tmp / "b.npz"), "--metrics", str(tmp / "b.jsonl")])
    cli.main(common + ["--burn", "1", "--frames", "4", "--fps", "4", "--out", str(tmp / "c.npz"),
                       "--metrics", str(tmp / "c.jsonl")])
    torch.cuda.synchronize()
    launches = {"chain_frame": ck.chain_frame.launches,
                "chain_frames_multi": ck.chain_frames_multi.launches,
                "chain_frame_hw": ck.chain_frame.launches_hw,
                "chain_frames_multi_hw": ck.chain_frames_multi.launches_hw}
    if not extra:  # the Threefry run: the Philox variants must not have run
        if launches.pop("chain_frame_hw") or launches.pop("chain_frames_multi_hw"):
            raise SystemExit(f"a Philox variant ran without --rng hardware: {launches}")
    log(f"  main path {' '.join(extra)}: 3 + resume 1 + uninterrupted 4 frames in "
        f"{time.time() - t0:.1f}s; launch counts {launches}")
    if min(launches.values()) < 1:
        raise SystemExit(f"a kernel of the main path was never launched: {launches}")

    for part in ("a", "b", "c"):
        recs = [json.loads(line) for line in open(tmp / f"{part}.jsonl")]
        frames = [r for r in recs if r["type"] == "frame"]
        if not frames or recs[-1]["type"] != "summary":
            raise SystemExit(f"run {part}: missing frame or summary records")
        for r in frames:
            corr = r["log_abs_corr"]
            if len(corr) != 200 or not all(isinstance(v, float) and abs(v) < 1e6 for v in corr):
                raise SystemExit(f"run {part}: non-finite log_abs_corr")
            if r["stable_frac"] < 0.99:
                raise SystemExit(f"run {part}: stable_frac {r['stable_frac']} < 0.99")
        log(f"  run {part}: {len(frames)} frame record(s), last stable_frac "
            f"{frames[-1]['stable_frac']}, dtau {frames[-1]['dtau']:.3e}, "
            f"avg_mlups {recs[-1]['avg_mlups']}")

    resumed, _ = checkpoint.load(tmp / "b.npz", "cpu")
    straight, _ = checkpoint.load(tmp / "c.npz", "cpu")
    for name, x, y in zip(resumed._fields, resumed, straight):
        if not torch.equal(x, y):
            raise SystemExit(f"resumed run differs from the uninterrupted one in {name}")
    if tuple(resumed.f.shape) != (65536, 200) or int(resumed.step) != 2 + (1 + 4) * 1000:
        raise SystemExit(f"unexpected final state: f {tuple(resumed.f.shape)}, step {int(resumed.step)}")
    for name in ("f", "x_mean", "xx0_mean", "x2_mean", "x4_mean", "lrg_vl", "omega"):
        if not torch.isfinite(getattr(resumed, name)).all():
            raise SystemExit(f"non-finite {name} in the final state")
    log("  resumed 4th frame is bitwise equal to the uninterrupted run; final state finite")
    SANITY["chain_hw" if extra else "chain"] = straight.x2_mean.mean(dim=1)

    state, cfg = checkpoint.load(tmp / "a.npz", "cuda")
    act = actions.get(cfg.action)
    err = gate(f"main path C={cfg.n_chains} N={cfg.n_sites} loops={cfg.loops} "
               f"chain_frames_multi K=2",
               ck.chain_frames_multi(state, act, cfg, 2), ck.chain_frames_multi_ref(state, act, cfg, 2))
    return launches, err


def timed(torch, fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def phase_timings(torch, device, ck, langevin, actions, cfgmod, card: str) -> dict:
    """MLUPS of the kernel path (median of 3 reps after a warm-up that lets
    the Δτ controller settle), then each kernel alone and its plain version
    on the same warmed states: kernel 1 at the headline, kernel 2 (K=16) at
    config 2.  A cold start is not timed: its first frame trips the detector
    and the frozen chains leave the kernel early."""
    ChainConfig, bc, form = cfgmod.ChainConfig, cfgmod.BoundaryCondition, cfgmod.Formulation
    out, warm = {}, {}

    def mlups(cfg, frames, seconds):
        return cfg.n_chains * cfg.n_sites * cfg.loops * frames / seconds / 1e6

    config2 = ChainConfig(**CONFIG2, bc=bc.PERIODIC, formulation=form.DIRECT)
    cases = [
        ("headline_threefry", ChainConfig(**HEADLINE), 3, 1),
        ("headline_threefry13", ChainConfig(**HEADLINE, rng_impl="threefry13"), 3, 1),
        ("config2_fpl1", config2, 16, 1),
        ("config2_fpl16", config2, 16, 16),
    ]
    for name, cfg, frames, fpl in cases:
        act = actions.get(cfg.action)
        state = langevin.init_chain_state(cfg, act, device=device)
        run = lambda s: ck.run_frames_kernel(s, act, cfg, frames, frames_per_launch=fpl)
        state, _ = run(state)  # warm-up
        reps = []
        for _ in range(3):
            holder = {}
            reps.append(timed(torch, lambda: holder.update(r=run(state))))
            state, m = holder["r"]
        warm[name] = (cfg, act, state)
        t = sorted(reps)[1]
        stable = float(m["stable"].float().mean())
        out[name] = dict(mlups=mlups(cfg, frames, t), seconds=t, reps=reps, stable=stable)
        log(f"  {name:22s} kernel path: {out[name]['mlups']:.1f} MLUPS (median of 3 reps of "
            f"{frames} frames, {t:.4f}s; reps {[round(r, 4) for r in reps]}; "
            f"stable {stable:.4f}) [{card}]")

    for kname, case, K in (("chain_frame", "headline_threefry", 1),
                           ("chain_frames_multi", "config2_fpl16", 16)):
        cfg, act, state = warm[case]
        if K == 1:
            launch = lambda: ck.chain_frame(state, act, cfg)
            plain = lambda: ck.chain_frame_ref(state, act, cfg)
        else:
            launch = lambda: ck.chain_frames_multi(state, act, cfg, K)
            plain = lambda: ck.chain_frames_multi_ref(state, act, cfg, K)
        got = launch()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(3):
            launch()
        end.record()
        torch.cuda.synchronize()
        out[kname + "_ms"] = start.elapsed_time(end) / 3
        holder = {}
        out[kname + "_plain_ms"] = timed(torch, lambda: holder.update(r=plain())) * 1e3
        out[kname + "_err"] = gate(
            f"{case} C={cfg.n_chains} N={cfg.n_sites} loops={cfg.loops} {kname} K={K}",
            got, holder["r"])
        log(f"  {kname:19s} kernel {out[kname + '_ms']:.3f} ms/launch (CUDA events, mean of "
            f"3), plain version {out[kname + '_plain_ms']:.1f} ms (once), at C={cfg.n_chains} "
            f"N={cfg.n_sites} loops={cfg.loops} K={K} [{card}]")

    # the plain path's MLUPS: one full frame (frame sums + epilogue) at the headline
    for name in ("headline_threefry", "headline_threefry13"):
        cfg, act, state = warm[name]
        t = timed(torch, lambda: langevin.run_frames(state, act, cfg, 1))
        out[name + "_plain_mlups"] = mlups(cfg, 1, t)
        log(f"  {name + ' plain':26s} {out[name + '_plain_mlups']:.2f} MLUPS (1 frame, "
            f"{t:.3f}s) [{card}]")
    out["config2_plain_mlups"] = mlups(config2, 16, out["chain_frames_multi_plain_ms"] / 1e3)
    log(f"  {'config2 plain':26s} {out['config2_plain_mlups']:.2f} MLUPS (16 frames, "
        f"chain_frames_multi_ref) [{card}]")
    return out


# ---------------------------------------------------------------------------
# field path: kernels 3, 4 and 5
# ---------------------------------------------------------------------------

def field_gate_cases(FieldConfig, Sweep):
    """(name, config, n_frames, initial stab_cnt or None): small cases for
    every branch of kernels 3, 4 and 5."""
    return [
        ("sync_threefry", FieldConfig(shape=(64, 128), dtau=0.01, n_chains=4, loops=10,
                                      seed=3), 2, None),
        ("sync_odd_loops", FieldConfig(shape=(48, 96), dtau=0.01, n_chains=3, loops=7,
                                       seed=5), 2, None),
        ("checkerboard_threefry13_odd_loops", FieldConfig(
            shape=(64, 96), dtau=0.01, n_chains=3, loops=9, seed=4, sweep=Sweep.CHECKERBOARD,
            rng_impl="threefry13"), 2, None),
        ("checkerboard_threefry", FieldConfig(shape=(32, 160), dtau=0.01, n_chains=3,
                                              loops=8, seed=9, sweep=Sweep.CHECKERBOARD),
         2, None),
        ("rejections", FieldConfig(shape=(32, 64), dtau=0.5, n_chains=4, loops=4, seed=2),
         4, None),
        # near EM's stability bound 2/(8 + m²): some frames trip and shrink Δτ,
        # others grow it into the dtau_max cap
        ("grow_shrink_dtau_max", FieldConfig(shape=(8, 16), dtau=0.17, n_chains=3, loops=4,
                                             seed=7, grow_after=1, dtau_max=0.1734),
         3, [0, 1, 2]),
        ("free_field_checkerboard", FieldConfig(
            action="free_field", shape=(48, 80), dtau=0.02, n_chains=3, loops=8, seed=8,
            sweep=Sweep.CHECKERBOARD), 2, None),
        # strips of unequal rows at every cluster size (45 and 29 rows)
        ("ragged_sync_odd_loops", FieldConfig(shape=(45, 72), dtau=0.01, n_chains=3, loops=7,
                                              seed=5), 2, None),
        ("ragged_checkerboard_odd_loops", FieldConfig(
            shape=(29, 40), dtau=0.01, n_chains=3, loops=9, seed=4, sweep=Sweep.CHECKERBOARD),
         2, None),
        # chain 1 holds a NaN site (it trips, every frame) beside chains that go on;
        # chain 2 starts at lrg_vl NaN (its detector cannot trip; the frame's max
        # |phi_new| replaces it)
        ("trip_beside_nan_lrg", FieldConfig(shape=(64, 128), dtau=0.01, n_chains=4, loops=10,
                                            seed=3), 2, None),
    ]


def field_gate_state(torch, field, name, cfg, stab, device):
    """The initial state of a field gate case."""
    s0 = field.init_field_state(cfg, device=device)
    if stab is not None:
        s0 = s0._replace(stab_cnt=torch.tensor(stab, dtype=torch.int32, device=device))
    if name == "trip_beside_nan_lrg":
        phi, lrg = s0.phi.clone(), s0.lrg_vl.clone()
        phi[1, 3, 5] = float("nan")
        lrg[2] = float("nan")
        s0 = s0._replace(phi=phi, lrg_vl=lrg)
    return s0


def same_bits(label: str, got, ref) -> None:
    """A kernel at B > 1 blocks a chain against the same kernel at B = 1:
    every leaf but the site-reduced sums bit for bit (NaN where the other has
    NaN), those within FIELD_RTOL / FIELD_ATOL (another summation order)."""
    import torch

    for (name, x), (_, y) in zip(leaves(got), leaves(ref)):
        x, y = x.cpu(), y.cpu()
        if x.is_complex():
            x, y = torch.view_as_real(x), torch.view_as_real(y)
        if name in SITE_REDUCED:
            same = torch.allclose(x.double(), y.double(), rtol=FIELD_RTOL, atol=FIELD_ATOL,
                                  equal_nan=True)
        elif x.is_floating_point():
            nan = torch.isnan(x)
            same = torch.equal(nan, torch.isnan(y)) and torch.equal(x[~nan], y[~nan])
        else:
            same = torch.equal(x, y)
        if not same:
            raise SystemExit(f"{label}: the cluster kernel differs from B = 1 in {name}")


def at_every_cluster_size(label: str, sizes, run, plain) -> None:
    """``run()`` (a kernel path) at every cluster size in ``sizes`` (B = 1
    first) held against ``plain`` (gate) and, at B > 1, against B = 1 bit
    for bit."""
    from stochquant_tpu_torch.kernels import _cluster

    ref = None
    for B in sizes:
        with _cluster.forced(B):
            got = run()
        gate(f"{label} B={B}", got, plain)
        if ref is None:
            ref = got
        else:
            same_bits(f"{label} B={B}", got, ref)


def field_sizes(fk, cfg) -> list:
    """Every cluster size the rule can pick for this lattice, B = 1 first."""
    return [g.B for g in fk.cluster_candidates(cfg.shape, fk.noise_planes(cfg))]


def phase_field_gate(torch, fk, ft, field, actions, cfgmod, device) -> None:
    """Kernels 3, 4 and 5 against their plain versions on the card; kernels
    3 and 4 at every cluster size the rule can pick for the case's lattice."""
    for name, cfg, n, stab in field_gate_cases(cfgmod.FieldConfig, cfgmod.Sweep):
        act = actions.get_field(cfg.action)
        s0 = field_gate_state(torch, field, name, cfg, stab, device)
        plain = field.run_field_frames(s0, act, cfg, n)
        sizes = field_sizes(fk, cfg)
        at_every_cluster_size(f"{name} field_frame x{n} + epilogue", sizes,
                              lambda: fk.run_field_frames_kernel(s0, act, cfg, n), plain)
        at_every_cluster_size(f"{name} field_frames_multi K={n}", sizes,
                              lambda: fk.field_frames_multi(s0, act, cfg, n),
                              fk.field_frames_multi_ref(s0, act, cfg, n))
        if name == "rejections" and bool(plain[1]["stable"].all()):
            raise SystemExit("gate case 'rejections' rejected no frame")
        if name == "trip_beside_nan_lrg":
            stable = plain[1]["stable"]
            if bool(stable[:, 1].any()) or not bool(stable[:, [0, 2, 3]].all()):
                raise SystemExit(f"gate case {name}: chain 1 alone must be rejected: {stable}")
        if name.startswith(("ragged", "trip")):
            continue  # kernel 5 keeps its own cases
        if name == "grow_shrink_dtau_max":
            d = plain[1]["dtau"]
            if not (bool((d == cfg.dtau_max).any()) and bool((d < cfg.dtau).any())):
                raise SystemExit(f"gate case {name} did not both grow into the cap and shrink")
        if cfg.loops % 2:
            continue
        t = min(8, cfg.shape[0] // 2)
        runs = {}
        heights = [h for h in (t // 2, t, 2 * t) if h and cfg.shape[0] % h == 0]
        for tile_rows in heights:
            runs[tile_rows] = ft.run_field_frames_tiled(s0, act, cfg, n, tile_rows=tile_rows)
            gate(f"{name} field_pair tile_rows={tile_rows} x{n} frames", runs[tile_rows],
                       ft.run_field_frames_tiled(s0, act, cfg, n, tile_rows=tile_rows,
                                                 pair=ft.field_pair_ref))
        for h in heights[1:]:
            gate(f"{name} field_pair tile_rows={heights[0]} vs {h}", runs[heights[0]], runs[h])


def check_field_records(tmp: Path, part: str) -> None:
    recs = [json.loads(line) for line in open(tmp / f"{part}.jsonl")]
    frames = [r for r in recs if r["type"] == "frame"]
    if not frames or recs[-1]["type"] != "summary":
        raise SystemExit(f"run {part}: missing frame or summary records")
    for r in frames:
        for key in ("mag", "abs_mag", "phi2", "susceptibility", "binder"):
            if not (isinstance(r[key], float) and abs(r[key]) < 1e6):
                raise SystemExit(f"run {part}: non-finite {key} {r[key]!r}")
        if r["stable_frac"] < 0.99:
            raise SystemExit(f"run {part}: stable_frac {r['stable_frac']} < 0.99")
    log(f"  run {part}: {len(frames)} frame record(s), last stable_frac "
        f"{frames[-1]['stable_frac']}, phi2 {frames[-1]['phi2']:.5f}, binder "
        f"{frames[-1]['binder']:.4f}, avg_mlups {recs[-1]['avg_mlups']}")


def field_cli_runs(torch, cli, checkpoint, counters, tmp: Path, tag: str, extra: list,
                   preset: str = "phi4_2d", chains: int = 16) -> dict:
    """Burn-in + 3 frames, --resume for 1, and an uninterrupted burn-in + 4
    frames of a field preset (phi4_2d at 16 chains unless told otherwise);
    every launch count set to 0 just before and read just after.  Returns
    the counts."""
    common = ["run", "--preset", preset, "--chains", str(chains), "--device", "cuda",
              "--frames-per-launch", "2", *extra]
    for fn in counters.values():
        fn.launches = 0
        if hasattr(fn, "launches_hw"):
            fn.launches_hw = 0
    t0 = time.time()
    cli.main(common + ["--burn", "1", "--frames", "3", "--fps", "3",
                       "--out", str(tmp / f"{tag}a.npz"), "--metrics", str(tmp / f"{tag}a.jsonl")])
    cli.main(common + ["--frames", "1", "--resume", str(tmp / f"{tag}a.npz"),
                       "--out", str(tmp / f"{tag}b.npz"), "--metrics", str(tmp / f"{tag}b.jsonl")])
    cli.main(common + ["--burn", "1", "--frames", "4", "--fps", "4",
                       "--out", str(tmp / f"{tag}c.npz"), "--metrics", str(tmp / f"{tag}c.jsonl")])
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    hw = {name + "_hw": fn.launches_hw for name, fn in counters.items()
          if hasattr(fn, "launches_hw")}
    if "hardware" in extra:
        launches.update(hw)
    elif any(hw.values()):
        raise SystemExit(f"a Philox variant ran without --rng hardware: {hw}")
    log(f"  {preset} {' '.join(extra) or '(defaults)'}: 3 + resume 1 + uninterrupted 4 frames in "
        f"{time.time() - t0:.1f}s; launch counts {launches}")
    for part in "abc":
        check_field_records(tmp, tag + part)
    resumed, cfg = checkpoint.load(tmp / f"{tag}b.npz", "cpu")
    straight, _ = checkpoint.load(tmp / f"{tag}c.npz", "cpu")
    for name, x, y in zip(resumed._fields, resumed, straight):
        if not torch.equal(x, y):
            raise SystemExit(f"{tag}: resumed run differs from the uninterrupted one in {name}")
    if (tuple(resumed.phi.shape) != (cfg.n_chains, *cfg.shape)
            or int(resumed.step) != 1 + 5 * cfg.loops):
        raise SystemExit(f"unexpected final state: phi {tuple(resumed.phi.shape)}, "
                         f"step {int(resumed.step)}")
    for name in ("phi", "mag_mean", "phi2_mean", "act_mean", "corr_mean", "lrg_vl"):
        if not torch.isfinite(getattr(resumed, name)).all():
            raise SystemExit(f"non-finite {name} in the final state")
    log("  resumed 4th frame is bitwise equal to the uninterrupted run; final state finite")
    SANITY["field_" + tag] = straight.phi2_mean
    return launches


def phase_field_main_path(torch, fk, ft, cli, checkpoint, actions, tmp: Path, card: str):
    """The port's CLI on preset phi4_2d through kernels 3 and 4, then with
    --tile-rows 64 and with --tile-rows 0 (the strip rule's default height)
    through kernel 5; then kernels 4 and 5 from the runs' checkpoints against
    their plain versions, and kernel 5 timed at both heights.  Returns (launch
    counts, max|Δ| per kernel, kernel 5's ms per height)."""
    counters = {"field_frame": fk.field_frame, "field_frames_multi": fk.field_frames_multi,
                "field_pair": ft.field_pair}
    whole = field_cli_runs(torch, cli, checkpoint, counters, tmp, "w", [])
    if min(whole["field_frame"], whole["field_frames_multi"]) < 1 or whole["field_pair"]:
        raise SystemExit(f"the whole-lattice main path did not run kernels 3 and 4 alone: {whole}")
    tiled = field_cli_runs(torch, cli, checkpoint, counters, tmp, "t", ["--tile-rows", "64"])
    if tiled["field_pair"] < 1 or tiled["field_frame"] or tiled["field_frames_multi"]:
        raise SystemExit(f"the --tile-rows main path did not run kernel 5 alone: {tiled}")
    default = field_cli_runs(torch, cli, checkpoint, counters, tmp, "d", ["--tile-rows", "0"])
    if default["field_pair"] != tiled["field_pair"] or default["field_frame"] or \
            default["field_frames_multi"]:
        raise SystemExit(f"the --tile-rows 0 main path did not run kernel 5 alone as often as "
                         f"--tile-rows 64: {default}")
    tuned = [json.loads(line) for line in open(tmp / "da.jsonl")][0]
    state, cfg = checkpoint.load(tmp / "da.npz", "cuda")
    height = ft.resolve_tile_rows(cfg)
    if tuned.get("type") != "autotune" or tuned.get("tile_rows") != height:
        raise SystemExit(f"--tile-rows 0: the first record is {tuned}, not the strip rule's "
                         f"height {height}")
    log(f"  --tile-rows 0 resolves to the strip rule's {height} rows: {json.dumps(tuned)}")

    err = {}
    state, cfg = checkpoint.load(tmp / "wa.npz", "cuda")
    act = actions.get_field(cfg.action)
    err["field_frames_multi"] = gate(
        f"main path C={cfg.n_chains} {cfg.shape} loops={cfg.loops} field_frames_multi K=2",
        fk.field_frames_multi(state, act, cfg, 2), fk.field_frames_multi_ref(state, act, cfg, 2))
    state, cfg = checkpoint.load(tmp / "ta.npz", "cuda")
    step = int(state.step)
    err["field_pair"] = gate(
        f"main path C={cfg.n_chains} {cfg.shape} field_pair tile_rows=64",
        ft.field_pair(state.phi, state.dtau, act, cfg, step, 64),
        ft.field_pair_ref(state.phi, state.dtau, act, cfg, step, 64))
    act = actions.get_field(cfg.action)
    step = int(state.step)
    err["field_pair"] = max(err["field_pair"], gate(
        f"main path C={cfg.n_chains} {cfg.shape} field_pair tile_rows={height} (the rule's)",
        ft.field_pair(state.phi, state.dtau, act, cfg, step, height),
        ft.field_pair_ref(state.phi, state.dtau, act, cfg, step, height)))
    ms = {}
    for t0 in (height, 64, height, 64):  # in turns
        ms.setdefault(t0, []).append(cuda_ms(
            torch, lambda t0=t0: ft.field_pair(state.phi, state.dtau, act, cfg, step, t0), reps=50))
    pair_ms = {}
    for t0, v in ms.items():
        _, _, rows = device_profile(torch, lambda t0=t0: [ft.field_pair(
            state.phi, state.dtau, act, cfg, step, t0) for _ in range(20)])
        own = [r for r in rows if "field_pair" in r[0]]
        device_us = sum(r[1] for r in own) / max(sum(r[2] for r in own), 1) * 1e6
        pair_ms[t0] = {"ms": min(v), "device_us": device_us}
        log(f"  field_pair at {cfg.shape} x {cfg.n_chains}, tile_rows {t0}"
            f"{' (the rule)' if t0 == height else ''}: {min(v):.4f} ms/launch (CUDA events, "
            f"mean of 50, least of 2 turns: {[round(x, 4) for x in v]}); {device_us:.2f} µs of "
            f"device time a launch (torch.profiler, 20 launches) [{card}]")
    launches = {"field_frame": whole["field_frame"],
                "field_frames_multi": whole["field_frames_multi"],
                "field_pair": tiled["field_pair"] + default["field_pair"]}
    return launches, err, pair_ms


def phase_field_tiled_large(torch, ft, runtime, metrics, cfgmod, actions, tmp: Path, card: str):
    """runtime.run_field on 1024² x 16 chains: auto must route to kernel 5;
    then one frame of kernel 5 against the plain pair.  Returns (state,
    max|Δ|, the plain pair's ms, the plain frame's s, the loops it ran)."""
    import dataclasses

    cfg = cfgmod.FieldConfig(**TILED_FIELD, frames=1)
    route = runtime.select_field_backend(cfg, "auto", torch.device("cuda"))
    if route != "cuda_tiled":
        raise SystemExit(f"1024^2 x 16 routed to {route!r}, not the tiled kernel")
    ft.field_pair.launches = 0
    t0 = time.time()
    with open(tmp / "large.jsonl", "w") as fh:
        res = runtime.run_field(cfg, device="cuda", sink=metrics.MetricsSink(stream=fh))
    torch.cuda.synchronize()
    if ft.field_pair.launches != cfg.loops // 2:
        raise SystemExit(f"run_field at 1024^2 launched kernel 5 {ft.field_pair.launches} times")
    check_field_records(tmp, "large")
    log(f"  runtime.run_field {cfg.shape} x {cfg.n_chains}: route {route}, tile_rows "
        f"{ft.resolve_tile_rows(cfg)}, {ft.field_pair.launches} pair launches, "
        f"{time.time() - t0:.2f}s")

    state, act = res.state, actions.get_field(cfg.action)
    step, tile_rows = int(state.step), ft.resolve_tile_rows(cfg)
    plain_s = timed(torch, lambda: ft.field_pair_ref(state.phi, state.dtau, act, cfg, step,
                                                     tile_rows))
    loops = cfg.loops
    if plain_s * cfg.loops / 2 > 60.0:
        loops = max(2, 2 * int(60.0 / plain_s / 2))
        log(f"  cut: the plain pair takes {plain_s:.2f}s, so the frame held against it runs "
            f"loops={loops} instead of {cfg.loops}")
    short = dataclasses.replace(cfg, loops=loops)
    got = ft.field_frame_tiled(state, act, short)
    holder = {}
    plain_frame_s = timed(torch, lambda: holder.update(
        r=ft.field_frame_tiled(state, act, short, pair=ft.field_pair_ref)))
    log(f"  plain frame (loops={loops}) {plain_frame_s:.2f}s [{card}]")
    err = gate(f"1024^2 x 16 loops={loops} field_frame_tiled, kernel vs plain pair",
                     got, holder["r"])
    return state, err, plain_s * 1e3, plain_frame_s, loops


def cuda_ms(torch, fn, reps: int = 3) -> float:
    """Mean CUDA-event ms of ``fn`` over ``reps`` calls (after one warm call)."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_field_timings(torch, device, fk, ft, field, actions, cfgmod, large, card: str) -> dict:
    """MLUPS of the field kernel paths (median of 3 reps after a warm-up)
    and of the plain paths, and each field kernel's CUDA-event ms beside its
    plain version's wall ms, held against each other."""
    FieldConfig = cfgmod.FieldConfig
    out = {}
    cfg = FieldConfig(**BENCH_FIELD)
    act = actions.get_field(cfg.action)
    ups = cfg.n_chains * cfg.shape[0] * cfg.shape[1] * cfg.loops
    state = field.init_field_state(cfg, device=device)
    state, _ = fk.run_field_frames_kernel(state, act, cfg, 1)  # warm-up
    for fpl in (1, 10):
        reps = []
        for _ in range(3):
            holder = {}
            reps.append(timed(torch, lambda: holder.update(r=fk.run_field_frames_kernel(
                state, act, cfg, 10, frames_per_launch=fpl))))
        t = sorted(reps)[1]
        stable = float(holder["r"][1]["stable"].float().mean())
        out[f"field_256_fpl{fpl}"] = dict(mlups=ups * 10 / t / 1e6, seconds=t, reps=reps)
        log(f"  field 256^2 x 16 fpl={fpl:<2d} kernel path: {ups * 10 / t / 1e6:.1f} MLUPS "
            f"(median of 3 reps of 10 frames, {t:.4f}s; reps {[round(r, 4) for r in reps]}; "
            f"stable {stable:.4f}) [{card}]")
    t = timed(torch, lambda: field.run_field_frames(state, act, cfg, 1))
    out["field_256_plain_mlups"] = ups / t / 1e6
    log(f"  field 256^2 x 16 plain path: {ups / t / 1e6:.2f} MLUPS (1 frame, {t:.3f}s) [{card}]")

    got = fk.field_frame(state, act, cfg)
    out["field_frame_ms"] = cuda_ms(torch, lambda: fk.field_frame(state, act, cfg))
    out["field_frame_geometry"] = fk.field_frame.geometry
    holder = {}
    out["field_frame_plain_ms"] = timed(torch, lambda: holder.update(
        r=fk.field_frame_ref(state, act, cfg))) * 1e3
    out["field_frame_err"] = gate("256^2 x 16 loops=100 field_frame", got, holder["r"])
    got = fk.field_frames_multi(state, act, cfg, 10)
    out["field_frames_multi_ms"] = cuda_ms(torch, lambda: fk.field_frames_multi(state, act, cfg, 10))
    out["field_frames_multi_geometry"] = fk.field_frames_multi.geometry
    out["field_frames_multi_plain_ms"] = timed(torch, lambda: holder.update(
        r=fk.field_frames_multi_ref(state, act, cfg, 10))) * 1e3
    out["field_frames_multi_err"] = gate("256^2 x 16 loops=100 field_frames_multi K=10",
                                               got, holder["r"])
    for k in ("field_frame", "field_frames_multi"):
        g = out[k + "_geometry"]
        log(f"  {k:19s} kernel {out[k + '_ms']:.3f} ms/launch (CUDA events, mean of 3; B = {g.B}, "
            f"{g.placement}), plain version {out[k + '_plain_ms']:.1f} ms (once) at 256^2 x 16, "
            f"loops 100 [{card}]")

    state, err, _, plain_frame_s, plain_loops = large
    cfg = FieldConfig(**TILED_FIELD)
    ups = cfg.n_chains * cfg.shape[0] * cfg.shape[1] * cfg.loops
    tile_rows, step = ft.resolve_tile_rows(cfg), int(state.step)
    reps = []
    for _ in range(3):
        holder = {}
        reps.append(timed(torch, lambda: holder.update(
            r=ft.run_field_frames_tiled(state, act, cfg, 2))))
    t = sorted(reps)[1]
    out["field_1024_tiled"] = dict(mlups=ups * 2 / t / 1e6, seconds=t, reps=reps)
    log(f"  field 1024^2 x 16 tiled kernel path: {ups * 2 / t / 1e6:.1f} MLUPS (median of 3 "
        f"reps of 2 frames, {t:.4f}s; reps {[round(r, 4) for r in reps]}) [{card}]")
    out["field_1024_plain_mlups"] = ups / cfg.loops * plain_loops / plain_frame_s / 1e6
    log(f"  field 1024^2 x 16 plain path: {out['field_1024_plain_mlups']:.2f} MLUPS (1 frame "
        f"of loops {plain_loops} with the plain pair, {plain_frame_s:.2f}s) [{card}]")
    pair = lambda: ft.field_pair(state.phi, state.dtau, act, cfg, step, tile_rows)  # noqa: E731
    got = pair()
    out["field_pair_ms"] = cuda_ms(torch, pair)
    out["field_pair_plain_ms"] = timed(torch, lambda: holder.update(
        r=ft.field_pair_ref(state.phi, state.dtau, act, cfg, step, tile_rows))) * 1e3
    out["field_pair_err"] = max(err, gate(
        f"1024^2 x 16 field_pair tile_rows={tile_rows}", got, holder["r"]))
    log(f"  field_pair          kernel {out['field_pair_ms']:.3f} ms/launch (CUDA events, mean "
        f"of 3), plain version {out['field_pair_plain_ms']:.1f} ms (once) at 1024^2 x 16, "
        f"tile_rows {tile_rows} [{card}]")
    log(f"  tiled frame: {cfg.loops // 2} x {out['field_pair_ms']:.3f} ms of kernel 5 against "
        f"{t / 2 * 1e3:.2f} ms of wall per frame: the device works "
        f"{cfg.loops // 2 * out['field_pair_ms'] / (t / 2 * 1e3):.1%} of the time")
    return out


# ---------------------------------------------------------------------------
# gauge path: kernels 10 and 11
# ---------------------------------------------------------------------------

def gauge_gate_cases(GaugeConfig):
    """(name, config, chain given a NaN link or None): per group, on 8×16 and
    on 16×128, a hot start with odd loops and a chain whose frames are
    rejected (Δτ shrinks), and a hot start under an active drift cap with
    Δτ growing into dtau_max."""
    cases = []
    for group, beta, dtau in (("u1", 1.0, 5e-3), ("su2", 2.0, 2e-3), ("su3", 5.0, 1e-3)):
        for shape in ((8, 16), (16, 128)):
            base = dict(group=group, beta=beta, shape=shape, n_chains=3, dtau=dtau)
            cases.append((f"{group}_{shape[0]}x{shape[1]}_hot_odd_rejected",
                          GaugeConfig(**base, loops=5, seed=31, hot_start=True), 1))
            cases.append((f"{group}_{shape[0]}x{shape[1]}_cap_grow_dtau_max",
                          GaugeConfig(**base, loops=6, seed=37, hot_start=True, drift_cap=0.5,
                                      grow_after=1, dtau_max=dtau * 1.03), None))
        # strips of unequal rows at every cluster size (13 rows)
        cases.append((f"{group}_13x64_ragged_hot_odd_rejected",
                      GaugeConfig(group=group, beta=beta, shape=(13, 64), n_chains=3, dtau=dtau,
                                  loops=5, seed=41, hot_start=True), 1))
    return cases


def with_nan_link(state, chain):
    links = state.links.clone()
    links.view(links.shape[0], -1)[chain, 3] = float("nan")
    return state._replace(links=links)


def gauge_sizes(gk, act, cfg) -> list:
    """Every cluster size the rule can pick for this lattice, B = 1 first."""
    group = gk.kernel_params(act, cfg, step0=0).group
    return [g.B for g in gk.cluster_candidates(cfg.shape, group)]


def phase_gauge_gate(torch, gk, gauge, device) -> None:
    """Kernels 10 and 11 against their plain versions on the card, K = 1
    (three launches of kernel 10 + the PyTorch epilogue) and K = 3, at every
    cluster size the rule can pick for the case's lattice."""
    for name, cfg, nan_chain in gauge_gate_cases(gauge.GaugeConfig):
        act = gauge.resolve_gauge_action(cfg)
        s0 = gauge.init_gauge_state(cfg, act, device=device)
        if nan_chain is not None:
            s0 = with_nan_link(s0, nan_chain)
        plain = gk.gauge_frames_multi_ref(s0, act, cfg, 3)
        sizes = gauge_sizes(gk, act, cfg)
        at_every_cluster_size(f"{name} gauge_frame x3 + epilogue", sizes,
                              lambda: gk.run_gauge_frames_kernel(s0, act, cfg, 3), plain)
        at_every_cluster_size(f"{name} gauge_frames_multi K=3", sizes,
                              lambda: gk.gauge_frames_multi(s0, act, cfg, 3), plain)
        stable, dtau = plain[1]["stable"], plain[1]["dtau"]
        if nan_chain is not None and not (bool(stable.all(dim=0).sum() == 2)
                                          and bool((dtau[:, nan_chain] < cfg.dtau).all())):
            raise SystemExit(f"gate case {name} did not reject exactly its NaN chain")
        if nan_chain is None and not (bool(stable.all())
                                      and bool((dtau == float(cfg.dtau_max)).any())
                                      and bool((plain[1]["drift_max"] > cfg.drift_cap).all())):
            raise SystemExit(f"gate case {name} did not cap the drift and grow into dtau_max")


def check_gauge_records(tmp: Path, part: str, loops: bool) -> None:
    recs = [json.loads(line) for line in open(tmp / f"{part}.jsonl")]
    frames = [r for r in recs if r["type"] == "frame"]
    if not frames or recs[-1]["type"] != "summary":
        raise SystemExit(f"run {part}: missing frame or summary records")
    keys = ("plaquette", "plaquette_exact_2d", "drift_max") + (
        ("polyakov_re", "polyakov_im") if loops else ())
    for r in frames:
        for key in keys:
            if not (isinstance(r[key], float) and abs(r[key]) < 1e6):
                raise SystemExit(f"run {part}: non-finite {key} {r[key]!r}")
        if r["stable_frac"] < 0.99:
            raise SystemExit(f"run {part}: stable_frac {r['stable_frac']} < 0.99")
    if loops:
        w = [r for r in recs if r["type"] == "wilson_loops"]
        if len(w) != 1 or not all(abs(v) <= 1.0 for row in w[0]["w"] for v in row):
            raise SystemExit(f"run {part}: missing or bad wilson_loops record")
    log(f"  run {part}: {len(frames)} frame record(s), last stable_frac "
        f"{frames[-1]['stable_frac']}, plaquette {frames[-1]['plaquette']:.5f} (exact 2-D "
        f"{frames[-1]['plaquette_exact_2d']:.5f}), drift_max {frames[-1]['drift_max']:.4f}, "
        f"avg_mlups {recs[-1]['avg_mlups']}")


def gauge_cli_runs(torch, cli, checkpoint, counters, tmp: Path, preset: str, extra: list) -> dict:
    """2 burn-in frames + 3 frames, --resume for 1, and an uninterrupted 2 +
    4 frames of ``preset`` at 256 chains, K = 2 (the burn-in is one launch of
    kernel 11; each recorded frame is kernel 10 + the PyTorch epilogue, as
    the JAX runner records every frame); every launch count set to 0 just
    before and read just after.  Returns the counts."""
    common = ["run", "--preset", preset, "--chains", "256", "--device", "cuda",
              "--frames-per-launch", "2", *extra]
    for fn in counters.values():
        fn.launches = 0
    t0 = time.time()
    cli.main(common + ["--burn", "2", "--frames", "3", "--out", str(tmp / f"{preset}a.npz"),
                       "--metrics", str(tmp / f"{preset}a.jsonl")])
    cli.main(common + ["--frames", "1", "--resume", str(tmp / f"{preset}a.npz"),
                       "--out", str(tmp / f"{preset}b.npz"),
                       "--metrics", str(tmp / f"{preset}b.jsonl")])
    cli.main(common + ["--burn", "2", "--frames", "4", "--out", str(tmp / f"{preset}c.npz"),
                       "--metrics", str(tmp / f"{preset}c.jsonl")])
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    log(f"  {preset} {' '.join(extra)}: 2 + 3 + resume 1 + uninterrupted 2 + 4 frames in "
        f"{time.time() - t0:.1f}s; launch counts {launches}")
    if min(launches.values()) < 1:
        raise SystemExit(f"a kernel of the gauge main path was never launched: {launches}")
    for part in "abc":
        check_gauge_records(tmp, preset + part, "--measure-loops" in extra)
    resumed, cfg = checkpoint.load(tmp / f"{preset}b.npz", "cpu")
    straight, _ = checkpoint.load(tmp / f"{preset}c.npz", "cpu")
    for name, x, y in zip(resumed._fields, resumed, straight):
        if not torch.equal(x, y):
            raise SystemExit(f"{preset}: resumed run differs from the uninterrupted one in {name}")
    if resumed.links.shape[0] != 256 or int(resumed.step) != 1 + 6 * cfg.loops:
        raise SystemExit(f"unexpected final state: links {tuple(resumed.links.shape)}, "
                         f"step {int(resumed.step)}")
    for name in ("links", "plaq_mean", "drift_max", "dtau"):
        if not torch.isfinite(getattr(resumed, name)).all():
            raise SystemExit(f"non-finite {name} in the final state")
    log("  resumed 4th frame is bitwise equal to the uninterrupted run; final state finite")
    return launches


def phase_gauge_main_path(torch, gk, gauge, cli, checkpoint, tmp: Path):
    """The port's CLI on presets u1_2d and su3_2d (with --measure-loops)
    through kernels 10 and 11; then kernel 10 and kernel 11 (K=2) from each
    run's checkpoint against their plain versions.  Returns (launch counts,
    max|Δ| per kernel)."""
    counters = {"gauge_frame": gk.gauge_frame, "gauge_frames_multi": gk.gauge_frames_multi}
    launches, err = {k: 0 for k in counters}, {k: 0.0 for k in counters}
    for preset, extra in (("u1_2d", []), ("su3_2d", ["--measure-loops"])):
        for k, v in gauge_cli_runs(torch, cli, checkpoint, counters, tmp, preset, extra).items():
            launches[k] += v
        state, cfg = checkpoint.load(tmp / f"{preset}a.npz", "cuda")
        act = gauge.resolve_gauge_action(cfg)
        where = f"main path {preset} C={cfg.n_chains} {cfg.shape} loops={cfg.loops}"
        err["gauge_frame"] = max(err["gauge_frame"], gate(
            f"{where} gauge_frame + epilogue",
            gk.gauge_frame(state, act, cfg), gk.gauge_frame_ref(state, act, cfg)))
        err["gauge_frames_multi"] = max(err["gauge_frames_multi"], gate(
            f"{where} gauge_frames_multi K=2",
            gk.gauge_frames_multi(state, act, cfg, 2), gk.gauge_frames_multi_ref(state, act, cfg, 2)))
    return launches, err


def link_updates(cfg, frames: int) -> int:
    return cfg.n_chains * cfg.ndim * math.prod(cfg.shape) * cfg.loops * frames


def phase_gauge_timings(torch, device, gk, gauge, card: str) -> dict:
    """Link-update MLUPS (chains·D·volume·loops·frames / s) of the kernel
    path (median of 3 reps after a warm-up frame) and of the plain path (one
    frame, ``loops`` cut if it would take over 60 s) at bench.py's full-width
    gauge cells, kernel 10's CUDA-event ms beside the plain frame's wall ms,
    each held against the other; then K = 8 against K = 1 at 256 chains."""
    import dataclasses

    out, err10, err11 = {}, 0.0, 0.0
    for group, kw in BENCH_GAUGE.items():
        cfg = gauge.GaugeConfig(**kw)
        act = gauge.resolve_gauge_action(cfg)
        state, _ = gk.run_gauge_frames_kernel(gauge.init_gauge_state(cfg, act, device=device),
                                              act, cfg, 1)  # warm-up
        reps = []
        for _ in range(3):
            holder = {}
            reps.append(timed(torch, lambda: holder.update(
                r=gk.run_gauge_frames_kernel(state, act, cfg, 3))))
        t = sorted(reps)[1]
        stable = float(holder["r"][1]["stable"].float().mean())
        name = f"gauge_{group}"
        out[name] = dict(mlups=link_updates(cfg, 3) / t / 1e6, seconds=t, reps=reps)
        log(f"  {group} {cfg.shape[0]}x{cfg.shape[1]} x {cfg.n_chains} loops {cfg.loops} fpl 1 "
            f"kernel path: "
            f"{out[name]['mlups']:.1f} MLUPS (median of 3 reps of 3 frames, {t:.4f}s; reps "
            f"{[round(r, 4) for r in reps]}; stable {stable:.4f}) [{card}]")
        ms = cuda_ms(torch, lambda: gk.gauge_frame(state, act, cfg))
        got = gk.gauge_frame(state, act, cfg)
        out[name + "_geometry"] = geom = gk.gauge_frame.geometry
        loops = cfg.loops
        probe = timed(torch, lambda: gk.gauge_frame_ref(state, act, dataclasses.replace(cfg,
                                                                                       loops=2)))
        if probe / 2 * cfg.loops > 60.0:
            loops = max(2, int(60.0 / (probe / 2)))
            log(f"  cut: a plain micro-step takes {probe / 2:.2f}s, so the plain frame runs "
                f"loops={loops} instead of {cfg.loops}")
        short = dataclasses.replace(cfg, loops=loops)
        holder = {}
        plain_s = timed(torch, lambda: holder.update(r=gk.gauge_frame_ref(state, act, short)))
        out[name + "_plain_mlups"] = link_updates(short, 1) / plain_s / 1e6
        if loops != cfg.loops:
            got = gk.gauge_frame(state, act, short)
        e = gate(f"{group} {cfg.shape} x {cfg.n_chains} loops={loops} gauge_frame", got,
                 holder["r"])
        err10 = max(err10, e)
        out[name + "_ms"], out[name + "_plain_ms"] = ms, plain_s * 1e3 * cfg.loops / loops
        log(f"  {group} gauge_frame kernel {ms:.3f} ms/launch (CUDA events, mean of 3; B = "
            f"{geom.B}, {geom.placement}), plain "
            f"version {plain_s * 1e3:.1f} ms (once, loops {loops}): plain path "
            f"{out[name + '_plain_mlups']:.2f} MLUPS [{card}]")
    out["gauge_frame_ms"], out["gauge_frame_plain_ms"] = out["gauge_u1_ms"], out["gauge_u1_plain_ms"]

    for group, kw in MULTI_GAUGE.items():
        cfg = gauge.GaugeConfig(**kw, n_chains=256, loops=10, seed=29, grow_after=10**9)
        act = gauge.resolve_gauge_action(cfg)
        state, _ = gk.run_gauge_frames_kernel(gauge.init_gauge_state(cfg, act, device=device),
                                              act, cfg, 1)
        mlups = {}
        for K in (1, 8):
            reps = [timed(torch, lambda: gk.run_gauge_frames_kernel(
                state, act, cfg, 8, frames_per_launch=K)) for _ in range(3)]
            t = sorted(reps)[1]
            mlups[K] = link_updates(cfg, 8) / t / 1e6
            out[f"gauge_{group}_multi_K{K}"] = dict(mlups=mlups[K], seconds=t, reps=reps)
        ms = cuda_ms(torch, lambda: gk.gauge_frames_multi(state, act, cfg, 8))
        got = gk.gauge_frames_multi(state, act, cfg, 8)
        out[f"gauge_{group}_multi_geometry"] = geom = gk.gauge_frames_multi.geometry
        holder = {}
        plain_s = timed(torch, lambda: holder.update(r=gk.gauge_frames_multi_ref(state, act,
                                                                                 cfg, 8)))
        err11 = max(err11, gate(f"{group} {cfg.shape} x 256 loops=10 gauge_frames_multi K=8",
                                got, holder["r"]))
        out[f"gauge_{group}_multi_ms"], out[f"gauge_{group}_multi_plain_ms"] = ms, plain_s * 1e3
        log(f"  {group} {cfg.shape} x 256 loops 10: K=1 {mlups[1]:.1f}, K=8 {mlups[8]:.1f} "
            f"MLUPS (x{mlups[8] / mlups[1]:.2f}, medians of 3 reps of 8 frames); "
            f"gauge_frames_multi K=8 {ms:.3f} ms/launch (B = {geom.B}), plain version "
            f"{plain_s * 1e3:.1f} ms "
            f"(once) [{card}]")
    out["gauge_frames_multi_ms"] = out["gauge_u1_multi_ms"]
    out["gauge_frames_multi_plain_ms"] = out["gauge_u1_multi_plain_ms"]
    out["gauge_frame_err"], out["gauge_frames_multi_err"] = err10, err11
    return out


# ---------------------------------------------------------------------------
# D-dim field path: kernels 6 and 7
# ---------------------------------------------------------------------------

def nd_gate_cases(FieldConfig, Sweep):
    """(name, config, tile_rows, chain given a NaN site or None, per-chain Δτ
    or None): small cases for every branch of kernels 6 and 7."""
    kw = dict(action="phi4", dtau=0.01, loops=6, seed=9)
    return [
        # 128 chains: every block spans its whole lattice and wraps inside the tile
        ("4d_sync_whole_lattice", FieldConfig(shape=(4, 6, 4, 4), n_chains=128, **kw),
         None, None, None),
        ("4d_sync_tiles_threefry13", FieldConfig(shape=(8, 8, 4, 4), n_chains=2,
                                                 rng_impl="threefry13", **kw), 2, None, None),
        ("4d_checkerboard_three_strips", FieldConfig(shape=(12, 12, 8, 8), n_chains=2,
                                                     sweep=Sweep.CHECKERBOARD, **kw),
         4, None, None),
        ("3d_sync_long_last_dim", FieldConfig(shape=(8, 12, 40), n_chains=3, **kw), 4, None, None),
        ("3d_checkerboard_free_field", FieldConfig(**{**kw, "action": "free_field"},
                                                   shape=(16, 8, 6), n_chains=2,
                                                   sweep=Sweep.CHECKERBOARD), None, None, None),
        ("4d_nan_site", FieldConfig(shape=(8, 8, 4, 4), n_chains=3, **kw), 4, 1, None),
        ("4d_one_chain_trips", FieldConfig(shape=(8, 8, 4, 4), n_chains=3, **kw), 2, None,
         [0.01, 50.0, 0.01]),
    ]


def extended_block(torch, phi, halos, offsets, loc):
    """The block at ``offsets`` of the periodic lattice ``phi`` (C, *shape),
    extended by ``halos[d]`` sites per side."""
    for d, (h, o, n) in enumerate(zip(halos, offsets, loc)):
        idx = (torch.arange(n + 2 * h, device=phi.device) + (o - h)) % phi.shape[d + 1]
        phi = phi.index_select(d + 1, idx)
    return phi.contiguous()


def phase_nd_gate(torch, nd, ft, field, actions, cfgmod, device) -> None:
    """Kernels 6 and 7 against their plain versions on the card."""
    import dataclasses

    for name, cfg, tile, nan_chain, dtaus in nd_gate_cases(cfgmod.FieldConfig, cfgmod.Sweep):
        act = actions.get_field(cfg.action)
        s0 = field.init_field_state(cfg, device=device)
        if nan_chain is not None:
            phi = s0.phi.clone()
            phi.view(phi.shape[0], -1)[nan_chain, 5] = float("nan")
            s0 = s0._replace(phi=phi)
        if dtaus is not None:
            s0 = s0._replace(dtau=torch.tensor(dtaus, dtype=torch.float32, device=device))
        tiles = nd.resolve_tiles(cfg, cfg.shape, cfg.n_chains, tile)
        step = int(s0.step)
        gate(f"{name} field_pair_nd tiles {tiles}",
             nd.field_pair_nd(s0.phi, s0.dtau, act, cfg, step, tile),
             nd.field_pair_nd_ref(s0.phi, s0.dtau, act, cfg, step, tile))
        pair = nd.run_field_frames_nd(s0, act, cfg, 2, tile_rows=tile)
        plain = nd.run_field_frames_nd(s0, act, cfg, 2, tile_rows=tile,
                                       pair=nd.field_pair_nd_ref)
        gate(f"{name} field_pair_nd x2 frames", pair, plain)
        # exchange_steps 4 with loops 6: a W = 4 chunk and a W = 2 tail per frame
        chunk_cfg = dataclasses.replace(cfg, exchange_steps=4)
        if nd.chunk_halos(cfg, 4, (True,))[0] < cfg.shape[0]:
            chunk = nd.run_field_frames_nd(s0, act, chunk_cfg, 2, tile_rows=tile)
            gate(f"{name} field_chunk_nd W=4+2 x2 frames", chunk,
                 nd.run_field_frames_nd(s0, act, chunk_cfg, 2, tile_rows=tile,
                                        chunk=nd.field_chunk_nd_ref))
            gate(f"{name} chunk path vs pair path", chunk, pair)
        gate(f"{name} field_chunk_nd W=2 x1 frame",
             nd.field_frame_nd_chunk(s0, act, cfg, 2, tile_rows=tile),
             nd.field_frame_nd_chunk(s0, act, cfg, 2, tile_rows=tile,
                                     chunk=nd.field_chunk_nd_ref))
        stable = plain[1]["stable"]
        if nan_chain is not None or dtaus is not None:
            bad = 1
            if not (bool(stable.all(dim=0).sum() == cfg.n_chains - 1)
                    and not bool(stable[:, bad].any())):
                raise SystemExit(f"gate case {name} did not reject exactly chain {bad}")
        elif not bool(stable.all()):
            raise SystemExit(f"gate case {name} rejected a frame")

    # kernel 7 on blocks of a split lattice, away from the origin
    FieldConfig, Sweep = cfgmod.FieldConfig, cfgmod.Sweep
    for name, cfg, W, split, loc, off, tile in [
        ("2d_split_01", FieldConfig(shape=(24, 48), n_chains=3, seed=5), 6, (True, True),
         (12, 16), (12, 32), 4),
        ("3d_split_01_checkerboard", FieldConfig(shape=(16, 12, 40), n_chains=2, seed=5,
                                                 sweep=Sweep.CHECKERBOARD), 2,
         (True, True, False), (8, 6, 40), (8, 6, 0), None),
        ("4d_split_0", FieldConfig(shape=(16, 8, 4, 4), n_chains=2, seed=5), 4,
         (True, False, False, False), (8, 8, 4, 4), (8, 0, 0, 0), 2),
        ("4d_split_03", FieldConfig(shape=(8, 4, 4, 12), n_chains=2, seed=5,
                                    rng_impl="threefry13"), 2, (True, False, False, True),
         (4, 4, 4, 6), (4, 0, 0, 6), None),
    ]:
        act = actions.get_field(cfg.action)
        s0 = field.init_field_state(cfg, device=device)
        ext = extended_block(torch, s0.phi, nd.chunk_halos(cfg, W, split), off, loc)
        got = nd.field_chunk_nd(ext, s0.dtau, act, cfg, W, split, 3, off, 5, tile)
        gate(f"{name} field_chunk_nd W={W} block {loc} at {off}", got,
             nd.field_chunk_nd_ref(ext, s0.dtau, act, cfg, W, split, 3, off, 5, tile))
        # the block alone takes the values the whole lattice has there
        whole = ft.micro_steps(s0.phi, s0.dtau, act, cfg, 3, W, chain_offset=5)[-1][1]
        index = (slice(None),) + tuple(slice(o, o + n) for o, n in zip(off, loc))
        if not torch.equal(got[0], whole[index]):
            raise SystemExit(f"gate case {name}: the block differs from the whole lattice")
    phase_nd_edges(torch, nd, ft, field, actions, cfgmod, device)


def nd_edge_cases(FieldConfig, Sweep):
    """(name, config, W, split dims, owned block, offsets, chain given a NaN
    site or None): the edges of the cooperative design of kernels 6-8 --
    more work items than the card holds blocks (a part-filled last round),
    W = 2, 4 and 8 under both sweeps, a NaN site beside chains that go on."""
    cb = dict(sweep=Sweep.CHECKERBOARD)
    return [
        ("4d_300_chains_pair", FieldConfig(shape=(8, 8, 8, 8), n_chains=300, seed=3), 2,
         None, None, None, None),
        ("4d_split_0_W8_sync", FieldConfig(shape=(32, 8, 8, 8), n_chains=5, seed=3), 8,
         (True, False, False, False), (16, 8, 8, 8), (16, 0, 0, 0), 2),
        ("4d_split_01_W4_checkerboard", FieldConfig(shape=(24, 20, 4, 8), n_chains=3, seed=3,
                                                    **cb), 4,
         (True, True, False, False), (12, 10, 4, 8), (12, 10, 0, 0), None),
        ("3d_split_2_W2_checkerboard", FieldConfig(shape=(6, 8, 40), n_chains=4, seed=3, **cb),
         2, (False, False, True), (6, 8, 20), (0, 0, 20), 1),
        ("2d_split_0_W8_checkerboard", FieldConfig(shape=(96, 256), n_chains=16, seed=3, **cb),
         8, (True, False), (48, 256), (48, 0), 7),
    ]


def phase_nd_edges(torch, nd, ft, field, actions, cfgmod, device) -> None:
    """Kernels 6 and 7 at the edges of their work split (nd_edge_cases):
    against their plain versions, kernel 7 against the whole lattice, bit
    for bit in phi; the NaN chain's block NaN, the others' finite.  Then
    kernel 7 at 32^4 x 8, W = 4, at the rule's tiles and at tile_rows 4."""
    for name, cfg, W, split, loc, off, nan_chain in nd_edge_cases(cfgmod.FieldConfig,
                                                                   cfgmod.Sweep):
        act = actions.get_field(cfg.action)
        s0 = field.init_field_state(cfg, device=device)
        phi = s0.phi
        if nan_chain is not None:
            phi = phi.clone()
            phi.view(phi.shape[0], -1)[nan_chain, 7] = float("nan")
        if split is None:
            got = nd.field_pair_nd(phi, s0.dtau, act, cfg, 5)
            gate(f"{name} field_pair_nd ({cfg.n_chains} x {nd._pair_geometry(phi, cfg, None).n_items}"
                 f" work items)", got, nd.field_pair_nd_ref(phi, s0.dtau, act, cfg, 5))
            continue
        ext = extended_block(torch, phi, nd.chunk_halos(cfg, W, split), off, loc)
        got = nd.field_chunk_nd(ext, s0.dtau, act, cfg, W, split, 5, off, 2)
        gate(f"{name} field_chunk_nd W={W} block {loc} at {off}", got,
             nd.field_chunk_nd_ref(ext, s0.dtau, act, cfg, W, split, 5, off, 2))
        whole = ft.micro_steps(phi, s0.dtau, act, cfg, 5, W, chain_offset=2)[-1][1]
        index = (slice(None),) + tuple(slice(o, o + n) for o, n in zip(off, loc))
        if not torch.equal(got[0], whole[index]):
            raise SystemExit(f"edge case {name}: the block differs from the whole lattice")
        if nan_chain is not None:
            bad = torch.isnan(got[0]).flatten(1).any(1)
            if bool(bad[[c for c in range(cfg.n_chains) if c != nan_chain]].any()):
                raise SystemExit(f"edge case {name}: a NaN reached a chain that had none")
    # kernel 7 at its timed 32^4 x 8, W = 4 shape (dim 0 extended periodically;
    # more work items than resident blocks) at the rule's tiles and at 4-row tiles
    cfg = cfgmod.FieldConfig(**BENCH_ND, n_chains=8)
    act = actions.get_field(cfg.action)
    s0 = field.init_field_state(cfg, device=device)
    split = (True, False, False, False)
    halos = nd.chunk_halos(cfg, 4, split)
    ext = extended_block(torch, s0.phi, halos, (0,) * 4, cfg.shape)
    for tile in (None, 4):
        got = nd.field_chunk_nd(ext, s0.dtau, act, cfg, 4, split, 3, tile_rows=tile)
        want = nd.field_chunk_nd_ref(ext, s0.dtau, act, cfg, 4, split, 3, tile_rows=tile)
        tiles = nd.resolve_tiles(cfg, cfg.shape, cfg.n_chains, tile, halos)
        gate(f"32^4x8 field_chunk_nd W=4 tiles {tiles}", got, want)
        if not torch.equal(got[0], want[0]):
            raise SystemExit(f"32^4x8 field_chunk_nd W=4 tiles {tiles}: phi not bit for bit")


def phase_nd_main_path(torch, nd, cli, checkpoint, actions, tmp: Path):
    """The port's CLI on preset phi4_4d at its 32^4, 4 chains, loops 20: on
    the pair path (kernel 6) and with --exchange-steps 4 (kernel 7); then each
    kernel from its run's checkpoint against its plain version.  Returns
    (launch counts, max|Δ| per kernel)."""
    counters = {"field_pair_nd": nd.field_pair_nd, "field_chunk_nd": nd.field_chunk_nd}
    sized = ["--loops", "20"]
    pair = field_cli_runs(torch, cli, checkpoint, counters, tmp, "p", sized,
                          preset="phi4_4d", chains=4)
    if pair["field_pair_nd"] < 1 or pair["field_chunk_nd"]:
        raise SystemExit(f"the phi4_4d main path did not run kernel 6 alone: {pair}")
    chunk = field_cli_runs(torch, cli, checkpoint, counters, tmp, "c",
                           sized + ["--exchange-steps", "4"], preset="phi4_4d", chains=4)
    if chunk["field_chunk_nd"] < 1 or chunk["field_pair_nd"]:
        raise SystemExit(f"the --exchange-steps 4 main path did not run kernel 7 alone: {chunk}")

    err = {}
    state, cfg = checkpoint.load(tmp / "pa.npz", "cuda")
    if tuple(cfg.shape) != (32, 32, 32, 32):
        raise SystemExit(f"phi4_4d ran at {cfg.shape}, not at its 32^4")
    act, step = actions.get_field(cfg.action), int(state.step)
    err["field_pair_nd"] = gate(
        f"main path C={cfg.n_chains} {cfg.shape} field_pair_nd",
        nd.field_pair_nd(state.phi, state.dtau, act, cfg, step),
        nd.field_pair_nd_ref(state.phi, state.dtau, act, cfg, step))
    state, cfg = checkpoint.load(tmp / "ca.npz", "cuda")
    split = (True, False, False, False)
    ext = extended_block(torch, state.phi, nd.chunk_halos(cfg, 4, split), (0,) * 4, cfg.shape)
    step = int(state.step)
    err["field_chunk_nd"] = gate(
        f"main path C={cfg.n_chains} {cfg.shape} field_chunk_nd W=4",
        nd.field_chunk_nd(ext, state.dtau, act, cfg, 4, split, step),
        nd.field_chunk_nd_ref(ext, state.dtau, act, cfg, 4, split, step))
    return {"field_pair_nd": pair["field_pair_nd"],
            "field_chunk_nd": chunk["field_chunk_nd"]}, err


def device_profile(torch, fn):
    """(wall seconds, device-busy seconds, [(kernel name, seconds, calls)] by
    time) of ``fn`` under torch.profiler: wall and busy time of the same
    window, so that 1 - busy / wall is the device's idle share of it."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        if us > 0:
            rows.append((ev.key, us * 1e-6, ev.count))
    rows.sort(key=lambda r: -r[1])
    return wall, sum(r[1] for r in rows), rows


def phase_nd_timings(torch, device, nd, field, actions, cfgmod, card: str) -> dict:
    """MLUPS of the pair path, the chunk path (W = 4) and the plain path at
    bench.py's 32^4 cell at 1 and 8 chains (medians of 3 reps of 8 frames
    after a warm-up; the plain path 2 frames), kernels 6 and 7 alone beside
    their plain versions, held against each other, and the device's idle
    share of each kernel path under torch.profiler."""
    import dataclasses

    out = {}
    split = (True, False, False, False)
    for C in (1, 8):
        cfg = cfgmod.FieldConfig(**BENCH_ND, n_chains=C)
        chunk_cfg = dataclasses.replace(cfg, exchange_steps=4)
        act = actions.get_field(cfg.action)
        ups = C * math.prod(cfg.shape) * cfg.loops
        state, _ = nd.run_field_frames_nd(field.init_field_state(cfg, device=device), act, cfg, 1)
        tiles = nd.resolve_tiles(cfg, cfg.shape, C)
        for label, run_cfg in (("pair", cfg), ("chunk", chunk_cfg)):
            run = lambda n: nd.run_field_frames_nd(state, act, run_cfg, n)  # noqa: E731
            run(1)
            reps = []
            for _ in range(3):
                holder = {}
                reps.append(timed(torch, lambda: holder.update(r=run(8))))
            t = sorted(reps)[1]
            stable = float(holder["r"][1]["stable"].float().mean())
            wall, busy, rows = device_profile(torch, lambda: run(8))
            idle = 1.0 - busy / wall
            key = f"nd_32_4_x{C}_{label}"
            out[key] = dict(mlups=ups * 8 / t / 1e6, seconds=t, reps=reps, idle=idle)
            log(f"  32^4 x {C} {label:5s} path (tiles {tiles}): {ups * 8 / t / 1e6:.1f} MLUPS "
                f"(median of 3 reps of 8 frames, {t:.4f}s = {t / 8 * 1e3:.3f} ms per frame; reps "
                f"{[round(r, 4) for r in reps]}; stable {stable:.4f}); 8 more frames under "
                f"torch.profiler: device busy {busy / 8 * 1e3:.3f} ms of {wall / 8 * 1e3:.3f} ms "
                f"wall per frame, idle {idle:.1%} of that window [{card}]")
            for kname, sec, _ in rows[:4]:
                log(f"      {sec / busy:6.1%} of device time  {kname[:90]}")
        t = timed(torch, lambda: field.run_field_frames(state, act, cfg, 2))
        out[f"nd_32_4_x{C}_plain"] = dict(mlups=ups * 2 / t / 1e6, seconds=t, reps=[t])
        log(f"  32^4 x {C} plain path: {ups * 2 / t / 1e6:.2f} MLUPS (2 frames, {t:.3f}s) [{card}]")

        step = int(state.step)
        ext = extended_block(torch, state.phi, nd.chunk_halos(cfg, 4, split), (0,) * 4, cfg.shape)
        launch = {
            "field_pair_nd": (lambda: nd.field_pair_nd(state.phi, state.dtau, act, cfg, step),
                              lambda: nd.field_pair_nd_ref(state.phi, state.dtau, act, cfg, step)),
            "field_chunk_nd": (lambda: nd.field_chunk_nd(ext, state.dtau, act, cfg, 4, split, step),
                               lambda: nd.field_chunk_nd_ref(ext, state.dtau, act, cfg, 4, split,
                                                             step)),
        }
        for kname, (kernel, plain) in launch.items():
            got = kernel()
            ms = cuda_ms(torch, kernel, reps=10)
            plain()  # warm-up of the allocator
            holder = {}
            plain_ms = timed(torch, lambda: holder.update(r=plain())) * 1e3
            err = gate(f"32^4 x {C} {kname}", got, holder["r"])
            log(f"  {kname:15s} kernel {ms:.3f} ms/launch (CUDA events, mean of 10), plain "
                f"version {plain_ms:.1f} ms (once) at 32^4 x {C}, tiles {tiles} [{card}]")
            out[f"{kname}_x{C}_ms"] = ms
            out[kname + "_err"] = max(out.get(kname + "_err", 0.0), err)
            if C == 1:  # the kernels line reports bench.py's cell
                out[kname + "_ms"], out[kname + "_plain_ms"] = ms, plain_ms
        for rows0 in ((2, 4, 8) if C == 1 else (4, 8, 16, 32)):
            pair = lambda: nd.field_pair_nd(state.phi, state.dtau, act, cfg, step, rows0)  # noqa: E731
            pair()
            log(f"  field_pair_nd   tile_rows {rows0:2d} (tiles "
                f"{nd.resolve_tiles(cfg, cfg.shape, C, rows0)}): "
                f"{cuda_ms(torch, pair, reps=10):.3f} ms/launch at 32^4 x {C} [{card}]")
    return out


# ---------------------------------------------------------------------------
# the lattice-split halo paths: kernels 9 and 12, the mesh and the runners
# ---------------------------------------------------------------------------

HaloStep = collections.namedtuple(
    "HaloStep", "phi ms p2s acs slice_means max_det n_bad max_new")
GaugeChunk = collections.namedtuple("GaugeChunk", "planes plaq_mean dmax bad capped")


def halo_step_leaves(out) -> HaloStep:
    """Kernel 9's eight outputs with the site sums held as means (a sum of
    many sites near zero carries the rounding of its terms, not of its value)."""
    phi, mag, phi2, act, sl, max_det, n_bad, max_new = out
    sites = phi[0].numel()
    return HaloStep(phi, mag / sites, phi2 / sites, act / sites, sl / phi.shape[2], max_det,
                    n_bad, max_new)


def halo_step_cases(FieldConfig, Sweep):
    """(name, global config, block shape, (chain, row, column) offsets, split
    dims, Box-Muller parity, half-sweep, [(chain, row, column)] of NaN sites
    in the global lattice, halo inputs): small cases for every branch of
    kernel 9, without halo inputs (the JAX kernel's mode) and with the halo
    slices of every split dim (the runner's)."""
    kw = dict(action="phi4", dtau=0.01, seed=21)
    cb = dict(sweep=Sweep.CHECKERBOARD)
    cases = []
    for halos in (False, True):
        tag = "halos_" if halos else ""
        cases += [
            (tag + "sync_split_0", FieldConfig(shape=(48, 40), n_chains=3, **kw), (24, 40),
             (3, 24, 0), (True, False), 0, 0, [], halos),
            (tag + "sync_split_1_threefry13", FieldConfig(shape=(16, 96), n_chains=2,
                                                          rng_impl="threefry13", **kw),
             (16, 48), (0, 0, 48), (False, True), 1, 0, [], halos),
            (tag + "sync_split_01_ragged", FieldConfig(shape=(50, 70), n_chains=3, **kw),
             (25, 35), (7, 25, 35), (True, True), 1, 0, [], halos),
            (tag + "checkerboard_even_half", FieldConfig(shape=(50, 70), n_chains=3, **cb, **kw),
             (25, 35), (1, 25, 35), (True, True), 0, 0, [], halos),
            (tag + "checkerboard_odd_half", FieldConfig(shape=(50, 70), n_chains=3, **cb, **kw),
             (25, 35), (1, 25, 35), (True, True), 1, 1, [], halos),
            (tag + "strips_of_4_rows", FieldConfig(shape=(40, 64), n_chains=64, **kw), (20, 64),
             (64, 20, 0), (True, False), 0, 0, [], halos),
        ]
    return cases + [
        ("sync_unsplit_free_field", FieldConfig(**{**kw, "action": "free_field"}, shape=(20, 33),
                                                n_chains=2), (20, 33), (0, 0, 0),
         (False, False), 0, 0, [], False),
        ("nan_interior_site", FieldConfig(shape=(48, 40), n_chains=3, **kw), (24, 40), (0, 24, 0),
         (True, False), 0, 0, [(1, 29, 7)], False),
        ("nan_edge_slice", FieldConfig(shape=(48, 40), n_chains=3, **kw), (24, 40), (0, 0, 0),
         (True, False), 1, 0, [(2, 0, 9)], False),
        # chain 1: a NaN on the block's last row; chain 2: one in the halo row below it
        ("halos_nan_edge_site_and_halo_row", FieldConfig(shape=(48, 40), n_chains=3, **kw),
         (24, 40), (0, 24, 0), (True, False), 1, 0, [(1, 47, 3), (2, 23, 9)], True),
        ("halos_nan_edge_column", FieldConfig(shape=(50, 70), n_chains=3, **cb, **kw), (25, 35),
         (1, 25, 35), (True, True), 0, 0, [(0, 31, 34), (1, 40, 69)], True),
    ]


def block_halos(lattice, offs, loc, split) -> dict:
    """The halo slices {dim: (below / left, above / right)} of the block at
    offs of a periodic lattice (C, L0, L1), for the split dims: strided views,
    as the runner's narrowed slices of its neighbours' blocks are."""
    _, L0, L1 = lattice.shape
    r, c = offs[1], offs[2]
    out = {}
    if split[0]:
        out[0] = tuple(lattice[:, x:x + 1, c:c + loc[1]] for x in ((r - 1) % L0, (r + loc[0]) % L0))
    if split[1]:
        out[1] = tuple(lattice[:, r:r + loc[0], x:x + 1] for x in ((c - 1) % L1, (c + loc[1]) % L1))
    return out


def phase_halo_step_gate(torch, fh, field, actions, cfgmod, device) -> None:
    """Kernel 9 against its plain version on the card, without and with the
    halo inputs."""
    for name, cfg, loc, offs, split, parity, half, nans, with_halos in halo_step_cases(
            cfgmod.FieldConfig, cfgmod.Sweep):
        act = actions.get_field(cfg.action)
        lattice = field.init_field_state(cfg, device=device).phi.clone()
        dtau = torch.full((cfg.n_chains,), cfg.dtau, device=device) * (
            1.0 + 0.1 * torch.arange(cfg.n_chains, device=device))
        for at in nans:
            lattice[at] = float("nan")
        phi = lattice[:, offs[1]:offs[1] + loc[0], offs[2]:offs[2] + loc[1]].contiguous()
        halos = block_halos(lattice, offs, loc, split) if with_halos else None
        args = (phi, dtau, act, cfg, 6, parity, half, offs, split)
        got, want = fh.field_halo_step(*args, halos), fh.field_halo_step_ref(*args, halos)
        gate(f"{name} field_halo_step block {loc} at {offs}", halo_step_leaves(got),
             halo_step_leaves(want))
        n_bad = [int(x) for x in want[6].tolist()]
        expect = {"nan_interior_site": [0, 5, 0], "halos_nan_edge_site_and_halo_row": [0, 4, 1]}
        if name in expect and n_bad != expect[name]:
            raise SystemExit(f"gate case {name}: non-finite counts {n_bad}, expected "
                             f"{expect[name]}")
        if name == "halos_nan_edge_column" and not (n_bad[0] >= 1 and n_bad[1] >= 1):
            raise SystemExit(f"gate case {name}: non-finite counts {n_bad}")


def gauge_chunk_leaves(out, W: int) -> GaugeChunk:
    planes, ps, dmax, bad, capped = out
    return GaugeChunk(planes, ps / (W * planes.shape[2] * planes.shape[3]), dmax, bad, capped)


def extended_planes(torch, planes, row_off: int, loc0: int, H: int):
    """Rows row_off - H .. row_off + loc0 + H of the periodic planes (C, P, L0, L1)."""
    idx = (torch.arange(loc0 + 2 * H, device=planes.device) + (row_off - H)) % planes.shape[2]
    return planes.index_select(2, idx).contiguous()


def gauge_chunk_at_every_size(torch, gk, label: str, args, W: int):
    """Kernel 12 at every cluster size its rule can pick for this block (B = 1
    forced among them): the links and the drift max bit for bit the plain
    version's (NaN where it has NaN) and the flags exact at each, the
    plaquette as a mean within the gate; at B > 1 against B = 1 likewise.
    Returns (the sizes, the plain version's result)."""
    from stochquant_tpu_torch.kernels import _cluster

    ext, act, cfg = args[0], args[2], args[3]
    group = gk.kernel_params(act, cfg, step0=0).group
    sizes = [g.B for g in gk.chunk_candidates(ext.shape[2], ext.shape[3], group, W)]
    want = gk.gauge_chunk_ref(*args)
    ref = None
    for B in sizes:
        with _cluster.forced(B):
            got = gk.gauge_chunk(*args)
        g = gk.gauge_chunk.geometry  # None where no launch ran (CPU tensors)
        split = f" split={int(gk.chunk_split(g, ext.shape[3], group))}" if g else ""
        gate(f"{label} B={B}{split}", gauge_chunk_leaves(got, W), gauge_chunk_leaves(want, W))
        for name, x, y in (("links", got[0], want[0]), ("drift max", got[2], want[2])):
            nan = torch.isnan(y)
            if not (torch.equal(torch.isnan(x), nan) and torch.equal(x[~nan], y[~nan])):
                raise SystemExit(f"{label} B={B}: {name} not bit for bit the plain version's")
        if ref is None:
            ref = got
        else:
            same_bits(f"{label} B={B}", gauge_chunk_leaves(got, W), gauge_chunk_leaves(ref, W))
    return sizes, want


def phase_gauge_chunk_gate(torch, gk, gauge, device) -> None:
    """Kernel 12 against its plain version on the card at every cluster size
    its rule can pick: per group W = 2, 4 and 8, a block away from the
    origin, one whose halo wraps the global lattice, a cap event, a NaN link
    in an owned and in a halo row, and a chain whose NaN drift in one block
    meets a cap event in another at the same step (not capped: the chain's
    max is NaN)."""
    import dataclasses

    for group, beta, dtau in (("u1", 1.0, 5e-3), ("su2", 2.0, 2e-3), ("su3", 5.0, 1e-3)):
        base = gauge.GaugeConfig(group=group, beta=beta, shape=(16, 32), n_chains=3, dtau=dtau,
                                 seed=41, hot_start=True)
        act = gauge.resolve_gauge_action(base)
        s0 = gauge.init_gauge_state(base, act, device=device)
        planes = gk.links_to_planes(s0.links, act)
        for name, W, loc0, row_off, cap, nan in [
            ("W2_away_from_origin", 2, 4, 8, 20.0, False),
            ("W4_halo_wraps_the_lattice", 4, 8, 8, 20.0, False),
            ("W8_whole_lattice_owned_half", 8, 8, 0, 20.0, False),
            ("W4_cap_event", 4, 8, 4, 0.5, False),
            ("W4_nan_links", 4, 8, 4, 20.0, True),
        ]:
            cfg = dataclasses.replace(base, drift_cap=cap)
            ext = extended_planes(torch, planes, row_off, loc0, W)
            if nan:  # chain 0: the halo row beside the owned rows; chain 1: an owned row
                ext[0, 0, W - 1, 3] = float("nan")
                ext[1, 1, W + 2, 5] = float("nan")
            args = (ext, s0.dtau, act, cfg, loc0, W, 11, 5, row_off)
            sizes, want = gauge_chunk_at_every_size(
                torch, gk, f"{group} {name} gauge_chunk rows {row_off}..{row_off + loc0}", args, W)
            bad, capped = want[3].tolist(), want[4].tolist()
            if nan and bad != [True, True, False]:
                raise SystemExit(f"gate case {group} {name}: bad flags {bad}")
            if not nan and (any(bad) or capped != [cap < 1.0] * 3):
                raise SystemExit(f"gate case {group} {name}: flags bad {bad} capped {capped}")
        # a cold start: chain 0 a NaN link in the first owned row and a kicked link
        # in the last, chain 1 the kick alone, chain 2 neither; the owned rows 4 ..
        # 12 of the 16-row extended block lie in two blocks from B = 2 on
        cold = dataclasses.replace(base, hot_start=False, drift_cap=0.05)
        planes0 = gk.links_to_planes(gauge.init_gauge_state(cold, act, device=device).links, act)
        W, loc0 = 4, 8
        ext = extended_planes(torch, planes0, 4, loc0, W)
        kick = {"u1": (0, 1.5), "su2": (2, 0.6), "su3": (1, 0.6)}[group]
        for ch in (0, 1):
            ext[ch, kick[0], W + loc0 - 1, 7] += kick[1]
        ext[0, 0, W, 20] = float("nan")
        # a tiny step: the noise leaves the drift far below the cap, the kick far above
        args = (ext, torch.full_like(s0.dtau, 1e-8), act, cold, loc0, W, 3, 0, 4)
        sizes, want = gauge_chunk_at_every_size(
            torch, gk, f"{group} nan_in_one_block_cap_in_another gauge_chunk", args, W)
        if want[3].tolist() != [True, False, False] or want[4].tolist() != [False, True, False]:
            raise SystemExit(f"gate case {group} nan_in_one_block_cap_in_another: bad "
                             f"{want[3].tolist()}, capped {want[4].tolist()}")
        log(f"  {group}: kernel 12 held at cluster sizes {sizes}")


def counted(torch, counters: dict, want: dict, label: str, fn):
    """Run ``fn`` with every launch counter set to 0 just before and read just
    after; the kernels launched, and how often, must be exactly ``want``."""
    for c in counters.values():
        c.launches = 0
    t0 = time.time()
    result = fn()
    torch.cuda.synchronize()
    got = {k: c.launches for k, c in counters.items() if c.launches}
    log(f"  {label}: {time.time() - t0:.2f}s, launches {got or 'none'}")
    if got != want:
        raise SystemExit(f"{label}: launches {got}, expected {want}")
    return result


def check_records(recs: list, label: str, keys) -> None:
    frames = [r for r in recs if r["type"] == "frame"]
    if not frames or recs[-1]["type"] != "summary":
        raise SystemExit(f"{label}: missing frame or summary records")
    for r in frames:
        if r["stable_frac"] < 0.99:
            raise SystemExit(f"{label}: stable_frac {r['stable_frac']} < 0.99")
        if not all(isinstance(r[k], float) and math.isfinite(r[k]) for k in keys):
            raise SystemExit(f"{label}: non-finite observables in {r}")


def same_state(torch, label: str, got, want, bitwise) -> None:
    """``bitwise`` leaves equal bit for bit; the others through the gate."""
    gate(label, got, want)
    names = got._fields if bitwise == "all" else bitwise
    for name in names:
        if not torch.equal(getattr(got, name), getattr(want, name)):
            raise SystemExit(f"{label}: {name} is not bitwise equal")


FIELD_EXACT = ("phi", "runs", "dtau", "stab_cnt", "lrg_vl", "step")
GAUGE_EXACT = ("links", "drift_max", "runs", "dtau", "stab_cnt", "step")
SPLIT_FIELD = dict(BENCH_FIELD, loops=50)  # bench.py:544-553


def phase_split_main_path(torch, mods, tmp: Path):
    """The lattice-split main paths at full width through runtime.run_field /
    run_gauge with a mesh on the one card (the device twice, and bench.py's
    ring of one).  Returns (launch counts per kernel, max|Δ| per kernel)."""
    import dataclasses

    runtime, metrics, cfgmod, gauge = mods["runtime"], mods["metrics"], mods["cfgmod"], mods["gauge"]
    parallel, fh, gk, actions = mods["parallel"], mods["fh"], mods["gk"], mods["actions"]
    counters = mods["counters"]
    totals = {k: 0 for k in counters}

    def run(kind, cfg, label, want, keys, **kw):
        recs = []
        fn = runtime.run_field if kind == "field" else runtime.run_gauge
        res = counted(torch, counters, want, label,
                      lambda: fn(cfg, sink=metrics.MetricsSink(callback=recs.append), **kw))
        check_records(recs, label, keys)
        for k, v in want.items():
            totals[k] += v
        return res.state, recs

    dev = "cuda:0"
    x2 = parallel.make_mesh([("x", 2)], devices=dev)
    x1 = parallel.make_mesh([("x", 1)], devices=dev)
    c2 = parallel.make_mesh([("chain", 2)], devices=dev)

    # ---- field: 256^2 x 16, loops 50 ------------------------------------
    frames, fkeys = 3, ("mag", "phi2", "binder")
    base = cfgmod.FieldConfig(**SPLIT_FIELD, frames=frames)
    cfg = dataclasses.replace(base, mesh_axes=("x", None))
    loops = cfg.loops
    chunks = -(-loops // 8)  # W = 8: six chunks and a W = 2 tail
    where = f"field {cfg.shape} x {cfg.n_chains} loops {loops}"
    unsplit, _ = run("field", base, f"{where} unsplit, backend cuda",
                     {"field_frame": frames}, fkeys, device=dev, backend="cuda")
    step, _ = run("field", cfg, f"{where} x=2, backend cuda_step",
                  {"field_halo_step": loops * frames * 2}, fkeys, mesh=x2, backend="cuda_step")
    chunk, _ = run("field", cfg, f"{where} x=2, backend cuda (the chunk path)",
                   {"field_chunk_nd": chunks * frames * 2}, fkeys, mesh=x2, backend="cuda")
    auto, _ = run("field", cfg, f"{where} x=2, backend auto", {"field_chunk_nd": chunks * frames * 2},
                  fkeys, mesh=x2)
    plain, _ = run("field", cfg, f"{where} x=2, backend torch", {}, fkeys, mesh=x2,
                   backend="torch")
    for name, got in (("cuda_step", step), ("cuda", chunk), ("auto", auto), ("torch", plain)):
        same_state(torch, f"{where} x=2 {name} vs unsplit kernel 3", got, unsplit, FIELD_EXACT)
    ccfg = dataclasses.replace(base, mesh_axes=(None, None), mesh_chain_axis="chain")
    got, _ = run("field", ccfg, f"{where} chain=2, backend cuda (kernel 3 per shard)",
                 {"field_frame": frames * 2}, fkeys, mesh=c2, backend="cuda")
    # 8 chains a launch may take another cluster size than 16: the site sums'
    # order moves with it, so they are held to the gate, the rest bit for bit
    same_state(torch, f"{where} chain=2 vs unsplit kernel 3", got, unsplit, FIELD_EXACT)
    got, _ = run("field", cfg, f"{where} ring of one, backend cuda_step",
                 {"field_halo_step": loops * frames}, fkeys, mesh=x1, backend="cuda_step")
    same_state(torch, f"{where} ring of one cuda_step vs unsplit", got, unsplit, FIELD_EXACT)
    got, _ = run("field", cfg, f"{where} ring of one, backend cuda_pair",
                 {"field_chunk_nd": chunks * frames}, fkeys, mesh=x1, backend="cuda_pair")
    same_state(torch, f"{where} ring of one cuda_pair vs unsplit", got, unsplit, FIELD_EXACT)
    # resume from the whole-state checkpoint of a split run
    ck = str(tmp / "split_field.npz")
    run("field", dataclasses.replace(cfg, frames=2), f"{where} x=2 cuda_step, 2 frames",
        {"field_halo_step": loops * 2 * 2}, fkeys, mesh=x2, backend="cuda_step", checkpoint_out=ck)
    got, _ = run("field", cfg, f"{where} x=2 cuda_step, resumed for the 3rd",
                 {"field_halo_step": loops * 2}, fkeys, mesh=x2, backend="cuda_step",
                 checkpoint_in=ck, resume_progress=True)
    same_state(torch, f"{where} x=2 cuda_step resumed vs uninterrupted", got, step, "all")

    # kernel 9 at the shape the main path gives it: shard 1 of the final state
    err = {}
    act = actions.get_field(cfg.action)
    other, shard = parallel.shard_field_state(step, x2, cfg)
    args = (shard.phi, shard.dtau, act, cfg, int(step.step), 1, 0,
            (0, cfg.shape[0] // 2, 0), (True, False), {0: (other.phi[:, -1:], other.phi[:, :1])})
    err["field_halo_step"] = gate(
        f"main path shard {tuple(shard.phi.shape)} field_halo_step",
        halo_step_leaves(fh.field_halo_step(*args)),
        halo_step_leaves(fh.field_halo_step_ref(*args)))

    # ---- gauge: u1 256^2 x 32 loops 100, su3 64^2 x 8 loops 50 -------------
    gkeys = ("plaquette", "drift_max")
    for group, frames in (("u1", 2), ("su3", 1)):
        base = gauge.GaugeConfig(**BENCH_GAUGE[group], frames=frames)
        cfg = dataclasses.replace(base, mesh_axes=("x", None))
        per_frame = -(-cfg.loops // 8)  # W = 8
        where = f"gauge {group} {cfg.shape} x {cfg.n_chains} loops {cfg.loops}"
        unsplit, _ = run("gauge", base, f"{where} unsplit, backend cuda",
                         {"gauge_frame": frames}, gkeys, device=dev, backend="cuda")
        chunk, _ = run("gauge", cfg, f"{where} x=2, backend cuda (the chunk runner)",
                       {"gauge_chunk": per_frame * frames * 2}, gkeys, mesh=x2, backend="cuda")
        plain, recs = run("gauge", cfg, f"{where} x=2, backend auto (the per-step halo runner)",
                          {}, gkeys, mesh=x2)
        if recs[0]["type"] != "backend_fallback":
            raise SystemExit(f"{where}: auto under a mesh did not record its choice of runner")
        if not float(unsplit.drift_max.max()) < cfg.drift_cap:
            raise SystemExit(f"{where}: the drift cap was not quiescent")
        same_state(torch, f"{where} x=2 chunk runner vs unsplit kernel 10", chunk, unsplit,
                   GAUGE_EXACT)
        same_state(torch, f"{where} x=2 chunk runner vs per-step halo runner", chunk, plain,
                   GAUGE_EXACT)
        if group == "u1":
            got, _ = run("gauge", cfg, f"{where} ring of one, backend cuda",
                         {"gauge_chunk": per_frame * frames}, gkeys, mesh=x1, backend="cuda")
            same_state(torch, f"{where} ring of one vs unsplit", got, unsplit, GAUGE_EXACT)
            ck = str(tmp / "split_gauge.npz")
            run("gauge", dataclasses.replace(cfg, frames=1), f"{where} x=2 chunk, 1 frame",
                {"gauge_chunk": per_frame * 2}, gkeys, mesh=x2, backend="cuda", checkpoint_out=ck)
            got, _ = run("gauge", cfg, f"{where} x=2 chunk, resumed for the 2nd",
                         {"gauge_chunk": per_frame * 2}, gkeys, mesh=x2, backend="cuda",
                         checkpoint_in=ck, resume_progress=True)
            same_state(torch, f"{where} x=2 chunk resumed vs uninterrupted", got, chunk, "all")
        # kernel 12 at the shape the main path gives it: shard 1's extended block
        act = gauge.resolve_gauge_action(cfg)
        loc0 = cfg.shape[0] // 2
        ext = extended_planes(torch, gk.links_to_planes(chunk.links, act), loc0, loc0, 8)
        args = (ext, chunk.dtau, act, cfg, loc0, 8, int(chunk.step), 0, loc0)
        got = gk.gauge_chunk(*args)
        g = gk.gauge_chunk.geometry
        err["gauge_chunk"] = max(err.get("gauge_chunk", 0.0), gate(
            f"main path {group} block {tuple(ext.shape)} gauge_chunk W=8 B={g.B}",
            gauge_chunk_leaves(got, 8), gauge_chunk_leaves(gk.gauge_chunk_ref(*args), 8)))
    return totals, err


#: name prefixes of the split runners' own kernels in the profiler's rows
RUNNER_KERNELS = ("void field_halo_step_kernel", "void gauge_chunk_kernel",
                  "void field_nd_kernel")  # kernels 7 and 8 share field_nd_kernel


def time_runner(torch, out: dict, card: str, key, label, runner, shards, frames, ups, profile):
    """(Link-)MLUPS of a split runner into ``out[key]``: a warm-up frame, the
    median of 3 reps of ``frames``, then (``profile``) the same frames under
    torch.profiler for the device's idle share and the runner's own kernel's
    device time per launch.  Returns the shards after the warm-up."""
    shards, _ = runner(shards, 1)  # warm-up
    reps = []
    for _ in range(3):
        holder = {}
        reps.append(timed(torch, lambda: holder.update(r=runner(shards, frames))))
    t = sorted(reps)[1]
    stable = float(holder["r"][1]["stable"].float().mean())
    out[key] = dict(mlups=ups * frames / t / 1e6, seconds=t, reps=reps)
    msg = (f"  {label}: {out[key]['mlups']:.1f} MLUPS (median of 3 reps of {frames} frames, "
           f"{t / frames * 1e3:.3f} ms per frame; reps {[round(r, 4) for r in reps]}; stable "
           f"{stable:.4f})")
    if profile:
        wall, busy, rows = device_profile(torch, lambda: runner(shards, frames))
        out[key]["idle"] = 1.0 - busy / wall
        msg += (f"; {frames} more under torch.profiler: device busy {busy / frames * 1e3:.3f} "
                f"of {wall / frames * 1e3:.3f} ms wall per frame, idle {out[key]['idle']:.1%}")
    log(msg + f" [{card}]")
    if profile:
        for kname, sec, calls in rows[:4]:
            log(f"      {sec / busy:6.1%} of device time  {kname[:90]}")
        for kname, sec, calls in rows:  # the hand-written kernel alone, per launch
            if kname.startswith(RUNNER_KERNELS):
                out[key]["kernel_us"] = sec / calls * 1e6
                log(f"      {kname[5:33]}: {sec / calls * 1e6:.2f} µs of device time per "
                    f"launch over {calls} launches (profiler)")
    return shards


def phase_split_timings(torch, mods, card: str) -> dict:
    """(Link-)MLUPS of each split backend at the main paths' shapes through the
    runners (median of 3 reps after a warm-up), the device's idle share under
    torch.profiler, and kernels 9 and 12 alone (CUDA events) beside their plain
    versions' wall ms, held against each other."""
    import dataclasses

    cfgmod, gauge, field, actions = mods["cfgmod"], mods["gauge"], mods["field"], mods["actions"]
    parallel, halo, gauge_halo = mods["parallel"], mods["halo"], mods["gauge_halo"]
    fh, gk = mods["fh"], mods["gk"]
    out = {}
    meshes = {"x=2": parallel.make_mesh([("x", 2)], devices="cuda:0"),
              "x=1": parallel.make_mesh([("x", 1)], devices="cuda:0")}
    dev = meshes["x=2"].devices[0]

    run_timed = functools.partial(time_runner, torch, out, card)

    # ---- field 256^2 x 16, loops 50 ---------------------------------------
    cfg = cfgmod.FieldConfig(**SPLIT_FIELD, mesh_axes=("x", None))
    act = actions.get_field(cfg.action)
    s0 = field.init_field_state(cfg, device=dev)
    ups = cfg.n_chains * math.prod(cfg.shape) * cfg.loops
    shards = None
    for mname, backend, frames in (("x=2", "cuda_step", 4), ("x=2", "cuda", 8), ("x=2", "torch", 2),
                                   ("x=1", "cuda_step", 4), ("x=1", "cuda_pair", 8)):
        mesh = meshes[mname]
        runner = halo.make_halo_runner(act, cfg, mesh, backend=backend)
        got = run_timed(f"split_field_{mname}_{backend}",
                        f"field {cfg.shape} x {cfg.n_chains} loops {cfg.loops}, {mname}, {backend} ({runner.backend})",
                        runner, parallel.shard_field_state(s0, mesh, cfg), frames, ups,
                        profile=backend != "torch")
        if (mname, backend) == ("x=2", "cuda_step"):
            shards = got
    ccfg = dataclasses.replace(cfg, mesh_axes=(None, None), mesh_chain_axis="chain")
    cmesh = parallel.make_mesh([("chain", 2)], devices=dev)
    run_timed("split_field_chain=2_cuda",
              f"field {cfg.shape} x {cfg.n_chains} loops {cfg.loops}, chain=2, cuda (kernel 3)",
              halo.make_halo_runner(act, ccfg, cmesh, backend="cuda"),
              parallel.shard_field_state(s0, cmesh, ccfg), 8, ups, profile=True)

    # kernel 9 as the cuda_step runner calls it: shard 1 with its halo rows,
    # narrowed views of shard 0's block
    sh, nb = shards[1], shards[0]
    args = (sh.phi, sh.dtau, act, cfg, int(sh.step), 0, 0, (0, cfg.shape[0] // 2, 0),
            (True, False), {0: (nb.phi[:, -1:], nb.phi[:, :1])})
    got = fh.field_halo_step(*args)
    with CardSampler("[19] kernel 9"):
        call_ms = cuda_ms(torch, lambda: fh.field_halo_step(*args), reps=50)
    fh.field_halo_step_ref(*args)
    holder = {}
    plain_ms = timed(torch, lambda: holder.update(r=fh.field_halo_step_ref(*args))) * 1e3
    out["field_halo_step_err"] = gate(f"shard {tuple(sh.phi.shape)} field_halo_step with halos",
                                      halo_step_leaves(got), halo_step_leaves(holder["r"]))
    # "ms" is CUDA events around the wrapper, as for every other kernel; a launch
    # here is shorter than the host takes to issue it, so that is the host's
    # pace, and the kernel's own time is kept beside it: the profiler's device
    # time per launch in the x = 2 cuda_step run above (the same shape)
    kernel_us = out["split_field_x=2_cuda_step"].get("kernel_us")
    if not kernel_us:
        raise SystemExit("[19] torch.profiler showed no field_halo_step_kernel row in the x=2 "
                         "cuda_step run: the kernel's device time was not measured")
    out["field_halo_step_ms"], out["field_halo_step_plain_ms"] = call_ms, plain_ms
    out["field_halo_step_device_us"] = kernel_us
    log(f"  field_halo_step {call_ms:.4f} ms per call of the wrapper with the halo rows, its "
        f"allocations and the two reductions of the per-strip partials (CUDA events, mean of "
        f"50: the host's pace); the kernel alone {kernel_us:.2f} µs of device time per launch "
        f"(profiler); plain version {plain_ms:.2f} ms (once) at {tuple(sh.phi.shape)} [{card}]")

    # ---- gauge u1 256^2 x 32 loops 100, su3 64^2 x 8 loops 50 ---------------
    for group in ("u1", "su3"):
        cfg = gauge.GaugeConfig(**BENCH_GAUGE[group], mesh_axes=("x", None))
        act = gauge.resolve_gauge_action(cfg)
        s0 = gauge.init_gauge_state(cfg, act, device=dev)
        ups = link_updates(cfg, 1)
        where = f"gauge {group} {cfg.shape} x {cfg.n_chains} loops {cfg.loops}"
        for mname, kind, frames in (("x=2", "chunk", 3), ("x=1", "chunk", 3), ("x=2", "halo", 1)):
            if group == "su3" and mname == "x=1":
                continue
            mesh = meshes[mname]
            make = (gauge_halo.make_gauge_chunk_runner if kind == "chunk"
                    else gauge_halo.make_gauge_halo_runner)
            got = run_timed(f"split_gauge_{group}_{mname}_{kind}", f"{where}, {mname}, {kind} runner",
                            make(act, cfg, mesh), parallel.shard_gauge_state(s0, act, mesh, cfg),
                            frames, ups, profile=kind == "chunk")
            if (mname, kind) == ("x=2", "chunk"):
                shards = got
        loc0 = cfg.shape[0] // 2
        whole = parallel.gather_gauge_state(shards, act, meshes["x=2"], cfg)
        ext = extended_planes(torch, gk.links_to_planes(whole.links, act), loc0, loc0, 8)
        args = (ext, whole.dtau, act, cfg, loc0, 8, int(whole.step), 0, loc0)
        got = gk.gauge_chunk(*args)
        g, params_group = gk.gauge_chunk.geometry, ("u1", "su2", "su3").index(group)
        with CardSampler(f"[19] kernel 12 {group}"):
            ms = cuda_ms(torch, lambda: gk.gauge_chunk(*args), reps=20)
        holder = {}
        plain_ms = timed(torch, lambda: holder.update(r=gk.gauge_chunk_ref(*args))) * 1e3
        e = gate(f"{group} block {tuple(ext.shape)} gauge_chunk W=8", gauge_chunk_leaves(got, 8),
                 gauge_chunk_leaves(holder["r"], 8))
        out["gauge_chunk_err"] = max(out.get("gauge_chunk_err", 0.0), e)
        out[f"gauge_chunk_{group}_ms"], out[f"gauge_chunk_{group}_plain_ms"] = ms, plain_ms
        out[f"gauge_chunk_{group}_geometry"] = g
        kernel_us = out[f"split_gauge_{group}_x=2_chunk"].get("kernel_us")
        out[f"gauge_chunk_{group}_device_us"] = kernel_us
        log(f"  {group} gauge_chunk kernel {ms:.4f} ms/launch (CUDA events, mean of 20), "
            f"{kernel_us:.2f} µs of device time per launch (profiler, the x=2 chunk run), B = "
            f"{g.B} ({g.placement}, a thread per "
            f"{'link direction' if gk.chunk_split(g, ext.shape[3], params_group) else 'site'}"
            f"), plain version {plain_ms:.1f} ms (once) at {tuple(ext.shape)}, W = 8 [{card}]")
    for k in ("ms", "plain_ms", "geometry", "device_us"):
        out[f"gauge_chunk_{k}"] = out[f"gauge_chunk_u1_{k}"]
    return out


# ---------------------------------------------------------------------------
# rng_impl='hardware': the Philox variants of kernels 1-4
# ---------------------------------------------------------------------------

def phase_philox_gate(torch, ck, fk, langevin, field, actions, cfgmod, device) -> None:
    """The Philox variants of kernels 1-4 against their plain versions on the
    card, on the small gate cases of [3] and [6] under rng_impl='hardware'
    (the Threefry-13 cases become Philox cases like the others)."""
    import dataclasses

    hw = lambda cfg: dataclasses.replace(cfg, rng_impl="hardware")  # noqa: E731
    cases = [(name, cfg, n, None, None) for name, cfg, n in gate_cases(
        cfgmod.ChainConfig, cfgmod.BoundaryCondition, cfgmod.Formulation, cfgmod.Scheme)]
    cases += layout_gate_cases(cfgmod.ChainConfig, cfgmod.BoundaryCondition,
                               cfgmod.Formulation, cfgmod.Scheme)
    for name, cfg, n, tripped, nan in cases:
        plain = chain_gate(ck, langevin, actions, cfgmod, device, f"hw {name}", hw(cfg), n,
                           tripped, nan)
        if name == "rejections_double_well" and bool(plain[1]["stable"].all()):
            raise SystemExit("hw gate case 'rejections_double_well' rejected no frame")
    from stochquant_tpu_torch.kernels import _cluster

    for name, cfg, n, stab in field_gate_cases(cfgmod.FieldConfig, cfgmod.Sweep):
        cfg = hw(cfg)
        act = actions.get_field(cfg.action)
        s0 = field_gate_state(torch, field, name, cfg, stab, device)
        plain = fk.field_frames_multi_ref(s0, act, cfg, n)
        sizes = field_sizes(fk, cfg)
        at_every_cluster_size(f"hw {name} field_frame x{n} + epilogue", sizes,
                              lambda: fk.run_field_frames_kernel(s0, act, cfg, n), plain)
        at_every_cluster_size(f"hw {name} field_frames_multi K={n}", sizes,
                              lambda: fk.field_frames_multi(s0, act, cfg, n), plain)
        for B in sizes:
            with _cluster.forced(B):
                one = fk.run_field_frames_kernel(s0, act, cfg, n)
                multi = fk.field_frames_multi(s0, act, cfg, n)
            same_leaves(f"hw {name} B={B}", one, multi)
        if name == "rejections" and bool(plain[1]["stable"].all()):
            raise SystemExit("hw gate case 'rejections' rejected no frame")


def phase_philox_timings(torch, device, ck, fk, langevin, field, actions, cfgmod,
                         card: str) -> dict:
    """Philox beside Threefry in one call, in turns (threefry, hardware,
    hardware, threefry): MLUPS of the kernel paths at the headline, config 2
    (K = 16) and field 256^2 x 16 (frames per launch 1 and 10), medians of 3
    reps after a warm-up; then each Philox variant alone (CUDA events) beside
    its plain version's wall ms, held against it."""
    import dataclasses

    ChainConfig, bc, form = cfgmod.ChainConfig, cfgmod.BoundaryCondition, cfgmod.Formulation
    out, warm = {}, {}
    chain_cases = [
        ("headline", ChainConfig(**HEADLINE), 3, 1),
        ("config2_fpl16", ChainConfig(**CONFIG2, bc=bc.PERIODIC, formulation=form.DIRECT),
         16, 16),
    ]
    fcfg = cfgmod.FieldConfig(**BENCH_FIELD)
    field_cases = [("field_256_fpl1", fcfg, 10, 1), ("field_256_fpl10", fcfg, 10, 10)]

    def measure(name, cfg, frames, fpl, is_field):
        if is_field:
            act = actions.get_field(cfg.action)
            init = lambda: field.init_field_state(cfg, device=device)  # noqa: E731
            run = lambda s: fk.run_field_frames_kernel(  # noqa: E731
                s, act, cfg, frames, frames_per_launch=fpl)
            ups = cfg.n_chains * math.prod(cfg.shape) * cfg.loops
        else:
            act = actions.get(cfg.action)
            init = lambda: langevin.init_chain_state(cfg, act, device=device)  # noqa: E731
            run = lambda s: ck.run_frames_kernel(  # noqa: E731
                s, act, cfg, frames, frames_per_launch=fpl)
            ups = cfg.n_chains * cfg.n_sites * cfg.loops
        key = (name, cfg.rng_impl)
        if key not in warm:
            warm[key] = (cfg, act, run(init())[0])  # warm-up: the controller settles
        state = warm[key][2]
        reps = []
        for _ in range(3):
            holder = {}
            reps.append(timed(torch, lambda: holder.update(r=run(state))))
        stable = float(holder["r"][1]["stable"].float().mean())
        t = sorted(reps)[1]
        return dict(mlups=ups * frames / t / 1e6, seconds=t, reps=reps, stable=stable)

    for cases, is_field in ((chain_cases, False), (field_cases, True)):
        for name, cfg, frames, fpl in cases:
            hw = dataclasses.replace(cfg, rng_impl="hardware")
            turns = [(cfg, "threefry"), (hw, "hardware"), (hw, "hardware"), (cfg, "threefry")]
            got = collections.defaultdict(list)
            for c, tag in turns:
                got[tag].append(measure(name, c, frames, fpl, is_field))
            for tag, runs in got.items():
                best = max(runs, key=lambda r: r["mlups"])
                out[f"{name}_{tag}"] = dict(best, both=[r["mlups"] for r in runs])
                log(f"  {name:16s} {tag:9s} kernel path: {[round(r['mlups'], 1) for r in runs]} "
                    f"MLUPS in its two turns (each a median of 3 reps of {frames} frames; reps "
                    f"{[[round(x, 4) for x in r['reps']] for r in runs]}; stable "
                    f"{runs[-1]['stable']:.4f}) [{card}]")
            a, b = out[f"{name}_threefry"]["both"], out[f"{name}_hardware"]["both"]
            log(f"  {name:16s} hardware / threefry: {sum(b) / sum(a):.4f} (means of the two turns)")

    def alone(kname, launch, plain, label):
        got = launch()
        out[kname + "_ms"] = cuda_ms(torch, launch)
        holder = {}
        out[kname + "_plain_ms"] = timed(torch, lambda: holder.update(r=plain())) * 1e3
        out[kname + "_err"] = gate(f"{label} {kname}", got, holder["r"])
        log(f"  {kname:22s} kernel {out[kname + '_ms']:.3f} ms/launch (CUDA events, mean of 3), "
            f"plain version {out[kname + '_plain_ms']:.1f} ms (once) at {label} [{card}]")

    cfg, act, state = warm[("headline", "hardware")]
    alone("chain_frame_hw", lambda: ck.chain_frame(state, act, cfg),
          lambda: ck.chain_frame_ref(state, act, cfg),
          f"C={cfg.n_chains} N={cfg.n_sites} loops={cfg.loops}")
    cfg2, act2, state2 = warm[("config2_fpl16", "hardware")]
    alone("chain_frames_multi_hw", lambda: ck.chain_frames_multi(state2, act2, cfg2, 16),
          lambda: ck.chain_frames_multi_ref(state2, act2, cfg2, 16),
          f"C={cfg2.n_chains} N={cfg2.n_sites} loops={cfg2.loops} K=16")
    cfgf, actf, statef = warm[("field_256_fpl1", "hardware")]
    alone("field_frame_hw", lambda: fk.field_frame(statef, actf, cfgf),
          lambda: fk.field_frame_ref(statef, actf, cfgf), "256^2 x 16 loops=100")
    out["field_frame_hw_geometry"] = fk.field_frame.geometry
    alone("field_frames_multi_hw", lambda: fk.field_frames_multi(statef, actf, cfgf, 10),
          lambda: fk.field_frames_multi_ref(statef, actf, cfgf, 10), "256^2 x 16 loops=100 K=10")
    out["field_frames_multi_hw_geometry"] = fk.field_frames_multi.geometry
    return out


def phase_philox_main_path(torch, mods, tmp: Path, card: str):
    """--rng hardware at full width through the entry points: `cli run` on
    double_well at 65,536 chains (kernels 1 and 2), `runtime.run_chain` on
    config 2 at frames_per_launch 16 (kernel 2) and `cli run` on phi4_2d at 16
    chains (kernels 3 and 4).  Every launch of these runs must be a Philox
    launch; resumes are bitwise; each ensemble's mean is held against the
    Threefry run's.  Returns (launch counts, max|Δ| per kernel)."""
    import dataclasses

    ck, fk, ft, cli, checkpoint = (mods[k] for k in ("ck", "fk", "ft", "cli", "checkpoint"))
    runtime, metrics, cfgmod, actions = (mods[k] for k in ("runtime", "metrics", "cfgmod",
                                                           "actions"))
    hw_dir = tmp / "hw"
    hw_dir.mkdir()
    launches, err = {}, {}
    got, err["chain_frames_multi_hw"] = phase_main_path(
        torch, ck, cli, checkpoint, actions, hw_dir, extra=("--rng", "hardware"))
    if (got["chain_frame_hw"] != got["chain_frame"] or got["chain_frame_hw"] < 1
            or got["chain_frames_multi_hw"] != got["chain_frames_multi"]
            or got["chain_frames_multi_hw"] < 1):
        raise SystemExit(f"--rng hardware did not run the Philox variants of kernels 1 and 2 "
                         f"alone: {got}")
    launches.update({k: v for k, v in got.items() if k.endswith("_hw")})
    same_mean("double_well 65,536 chains, site-averaged <x^2> after 1 + 4 frames",
              SANITY["chain_hw"], SANITY["chain"], card)

    # config 2 (quartic_large without its spectrum channel) at frames_per_launch 16
    base = dataclasses.replace(cfgmod.PRESETS["quartic_large"], accumulate_spectrum=False,
                               frames_per_launch=16, fps=16, frames=16)
    finals = {}
    for impl in ("hardware", "threefry"):
        cfg = dataclasses.replace(base, rng_impl=impl)
        for fn in (ck.chain_frame, ck.chain_frames_multi):
            fn.launches = fn.launches_hw = 0
        recs = []
        sink = lambda: metrics.MetricsSink(callback=recs.append)  # noqa: E731
        t0 = time.time()
        if impl == "hardware":  # burn-in 16, then 16 + resumed 16 against 32 uninterrupted
            a, b = str(tmp / "c2a.npz"), str(tmp / "c2b.npz")
            runtime.run_chain(cfg, device="cuda", burn_frames=16, sink=sink(), checkpoint_out=a)
            resumed = runtime.run_chain(cfg, device="cuda", sink=sink(), checkpoint_in=a,
                                        checkpoint_out=b).state
        straight = runtime.run_chain(dataclasses.replace(cfg, frames=32), device="cuda",
                                     burn_frames=16, sink=sink()).state
        torch.cuda.synchronize()
        counts = (ck.chain_frame.launches, ck.chain_frames_multi.launches,
                  ck.chain_frame.launches_hw, ck.chain_frames_multi.launches_hw)
        want = (0, 6, 0, 6) if impl == "hardware" else (0, 3, 0, 0)
        log(f"  config 2 (anharmonic N=1024 C=256 loops 1000, fpl 16, burn-in 16) rng {impl}: "
            f"{time.time() - t0:.2f}s, launches (k1, k2, k1 Philox, k2 Philox) {counts}")
        if counts != want:
            raise SystemExit(f"config 2 rng {impl}: launches {counts}, expected {want}")
        check_records(recs, f"config 2 rng {impl}", ())
        if impl == "hardware":
            launches["chain_frames_multi_hw"] += counts[3]
            for name, x, y in zip(resumed._fields, resumed, straight):
                if not torch.equal(x, y):
                    raise SystemExit(f"config 2 rng hardware: 16 + resumed 16 frames differ from "
                                     f"32 uninterrupted in {name}")
            log("  config 2 rng hardware: 16 + resumed 16 frames bitwise equal to 32 uninterrupted")
        finals[impl] = straight
    same_mean("config 2, site-averaged <x^2> after 16 + 32 frames",
              finals["hardware"].x2_mean.mean(dim=1), finals["threefry"].x2_mean.mean(dim=1), card)

    # phi4_2d at 16 chains: kernels 3 and 4
    counters = {"field_frame": fk.field_frame, "field_frames_multi": fk.field_frames_multi,
                "field_pair": ft.field_pair}
    got = field_cli_runs(torch, cli, checkpoint, counters, tmp, "h", ["--rng", "hardware"])
    if (got["field_frame_hw"] != got["field_frame"] or got["field_frame_hw"] < 1
            or got["field_frames_multi_hw"] != got["field_frames_multi"]
            or got["field_frames_multi_hw"] < 1 or got["field_pair"]):
        raise SystemExit(f"--rng hardware did not run the Philox variants of kernels 3 and 4 "
                         f"alone: {got}")
    launches.update({k: v for k, v in got.items() if k.endswith("_hw")})
    same_mean("phi4_2d 256^2 x 16, <phi^2> after 1 + 4 frames", SANITY["field_h"],
              SANITY["field_w"], card)
    state, cfg = checkpoint.load(tmp / "ha.npz", "cuda")
    act = actions.get_field(cfg.action)
    err["field_frames_multi_hw"] = gate(
        f"main path rng hardware C={cfg.n_chains} {cfg.shape} field_frames_multi K=2",
        fk.field_frames_multi(state, act, cfg, 2), fk.field_frames_multi_ref(state, act, cfg, 2))
    return launches, err


PLAIN_TOL = 2e-5        # card vs CPU, the plain path's float32 leaves (other transcendentals)
PLAIN_TOL_EXACT = 5e-4  # under Scheme.EXACT (chains): two libraries' float32 eigh
PLAIN_TOL_SPEC = 1e-4   # the spectrum, relative to a chain's largest mode (cuFFT vs pocketfft)
PLAIN_TOL_FIELD_EXACT = 5e-5  # fields under Scheme.EXACT: float32 rfftn round trips


def card_vs_cpu(torch, label: str, run, tol: float, card: str, sums=()) -> None:
    """``run(device)`` -> final state on the card and on the CPU: integer
    leaves equal, float leaves and both parts of complex ones within ``tol``
    (the spectrum within PLAIN_TOL_SPEC of each chain's largest mode; the
    site-reduced means named in ``sums`` within rtol FIELD_RTOL, atol
    FIELD_ATOL)."""
    on_card, on_cpu = run("cuda"), run("cpu")
    worst, spec, worst_sum = 0.0, None, 0.0
    for name, x, y in zip(on_card._fields, on_card, on_cpu):
        x = x.cpu()
        if x.is_complex():
            x, y = torch.view_as_real(x), torch.view_as_real(y)
        if not x.is_floating_point():
            if not torch.equal(x, y):
                raise SystemExit(f"{label}: {name} differs between the card and the CPU")
            continue
        d = (x.double() - y.double()).abs()
        if name == "spec_mean":
            spec = float((d / (y.double().abs().amax(dim=1, keepdim=True) + 1e-30)).max())
        elif name in sums:
            worst_sum = max(worst_sum, float((d / (FIELD_ATOL + FIELD_RTOL
                                                   * y.double().abs())).max()))
        else:
            worst = max(worst, float(d.max()))
    log(f"  {label}: card vs CPU max|Δ| {worst:.3e} (limit {tol:g})"
        + (f", spectrum {spec:.3e} of the largest mode (limit {PLAIN_TOL_SPEC:g})"
           if spec is not None else "")
        + (f", site means at {worst_sum:.3f} of rtol {FIELD_RTOL:g} + atol {FIELD_ATOL:g}"
           if sums else "") + f" [{card}]")
    if (not worst <= tol or (spec is not None and not spec <= PLAIN_TOL_SPEC)
            or not worst_sum <= 1.0):
        raise SystemExit(f"{label}: the plain path on the card disagrees with the CPU")


def phase_plain_schemes(torch, mods, tmp: Path, card: str) -> dict:
    """The schemes no kernel implements (in either package), at full width on
    the card through the entry points: `cli run` on quartic_large (the power
    spectrum), harmosc with --scheme lm and --scheme exact, phi4_2d with
    --scheme exact (ETD1), and `runtime.run_field` on a free field under
    Scheme.EXACT.  `auto` must record why it runs the plain integrator and
    launch no kernel; a resume equals the uninterrupted run; then each at a
    small size on the card against the CPU run of the same code."""
    import dataclasses

    cli, checkpoint, runtime, metrics, cfgmod = (mods[k] for k in (
        "cli", "checkpoint", "runtime", "metrics", "cfgmod"))
    langevin = mods["langevin"]
    Scheme = cfgmod.Scheme
    counters = [mods["ck"].chain_frame, mods["ck"].chain_frames_multi, mods["fk"].field_frame,
                mods["fk"].field_frames_multi, mods["ft"].field_pair]
    out = {}

    def records(path):
        return [json.loads(line) for line in open(path)]

    def cli_runs(tag, args, keys):
        """Burn-in 1 + 2 frames, --resume for 1, uninterrupted 1 + 3."""
        for fn in counters:
            fn.launches = 0
        common = ["run", *args, "--device", "cuda"]
        t0 = time.time()
        cli.main(common + ["--burn", "1", "--frames", "2", "--out", str(tmp / f"{tag}a.npz"),
                           "--metrics", str(tmp / f"{tag}a.jsonl")])
        cli.main(common + ["--frames", "1", "--resume", str(tmp / f"{tag}a.npz"),
                           "--out", str(tmp / f"{tag}b.npz"),
                           "--metrics", str(tmp / f"{tag}b.jsonl")])
        cli.main(common + ["--burn", "1", "--frames", "3", "--out", str(tmp / f"{tag}c.npz"),
                           "--metrics", str(tmp / f"{tag}c.jsonl")])
        torch.cuda.synchronize()
        seconds = time.time() - t0
        if any(fn.launches for fn in counters):
            raise SystemExit(f"{tag}: a kernel was launched on a plain-path run")
        for part in "abc":
            recs = records(tmp / f"{tag}{part}.jsonl")
            if recs[0].get("type") != "backend_fallback" or recs[0].get("backend") != "torch":
                raise SystemExit(f"{tag}{part}: auto did not record why it runs the plain path")
            check_records(recs[1:], tag + part, keys)
        resumed, cfg = checkpoint.load(tmp / f"{tag}b.npz", "cpu")
        straight, _ = checkpoint.load(tmp / f"{tag}c.npz", "cpu")
        for name, x, y in zip(resumed._fields, resumed, straight):
            if not torch.equal(x, y):
                raise SystemExit(f"{tag}: resumed run differs from the uninterrupted one in {name}")
        last = records(tmp / f"{tag}c.jsonl")[-1]
        out[tag + "_mlups"] = {"mlups": last["avg_mlups"]}
        log(f"  cli run {' '.join(args)}: 2 + resume 1 + uninterrupted 3 frames (and a burn-in "
            f"each) in {seconds:.1f}s on the plain path, no kernel launched, fallback recorded, "
            f"resume bitwise, stable_frac >= 0.99; avg_mlups {last['avg_mlups']} [{card}]")
        return straight, cfg

    # quartic_large: the power-spectrum channel
    state, cfg = cli_runs("ql", ["--preset", "quartic_large"], ())
    spec = state.spec_mean.double()
    if not (torch.isfinite(spec).all() and float(spec.min()) >= 0 and float(spec.max()) > 0):
        raise SystemExit("quartic_large: the power spectrum is not finite and non-negative")
    lag0 = langevin.translation_averaged_correlator(state)[:, 0].double()
    x2 = state.x2_mean.double().mean(dim=1)
    rel = float(((lag0 - x2).abs() / x2).max())
    log(f"  quartic_large {tuple(state.spec_mean.shape)} spectrum: lag 0 of the translation-"
        f"averaged correlator against the site-averaged <x^2>: max relative Δ {rel:.3e} "
        f"(limit 1e-4; Parseval)")
    if not rel < 1e-4:
        raise SystemExit("quartic_large: the spectrum breaks Parseval's identity")
    small = dataclasses.replace(cfg, n_sites=64, n_chains=8, loops=20, frames=2)
    card_vs_cpu(torch, "quartic_large cut to N=64 C=8 loops 20, 2 frames",
                lambda dev: runtime.run_chain(small, device=dev, sink=metrics.MetricsSink(
                    callback=lambda r: None)).state, PLAIN_TOL, card)

    # harmosc under LM and under the exact-OU scheme
    # (the preset's dtau 0.3 is the exact scheme's: LM, like EM, needs dtau < dt^2 / 2)
    for scheme, tol, more in (("lm", PLAIN_TOL, ["--dtau", "2e-3"]),
                              ("exact", PLAIN_TOL_EXACT, [])):
        state, cfg = cli_runs("h" + scheme, ["--preset", "harmosc", "--chains", "256",
                                             "--scheme", scheme, *more], ())
        for name in ("f", "x_mean", "x2_mean", "x4_mean"):
            if not torch.isfinite(getattr(state, name)).all():
                raise SystemExit(f"harmosc --scheme {scheme}: non-finite {name}")
        if scheme == "exact" and not torch.equal(
                state.dtau, torch.full_like(state.dtau, cfg.dtau)):
            raise SystemExit("harmosc --scheme exact: dtau moved (it is frozen under EXACT)")
        small = dataclasses.replace(cfg, n_sites=32, n_chains=8, loops=20, frames=2)
        card_vs_cpu(torch, f"harmosc --scheme {scheme} cut to N=32 C=8 loops 20, 2 frames",
                    lambda dev: runtime.run_chain(small, device=dev, sink=metrics.MetricsSink(
                        callback=lambda r: None)).state, tol, card)

    # fields: ETD1 on phi4_2d through the CLI, the exact propagator on a free field
    keys = ("mag", "abs_mag", "phi2", "susceptibility", "binder")
    state, cfg = cli_runs("fe", ["--preset", "phi4_2d", "--chains", "16", "--scheme", "exact"],
                          keys)
    if not torch.isfinite(state.phi).all():
        raise SystemExit("phi4_2d --scheme exact: non-finite phi")
    free = cfgmod.FieldConfig(action="free_field", shape=(256, 256), n_chains=16, loops=100,
                              dtau=0.5, seed=13, scheme=Scheme.EXACT, frames=2)
    for fn in counters:
        fn.launches = 0
    recs = []
    t0 = time.time()
    res = runtime.run_field(free, device="cuda", burn_frames=1,
                            sink=metrics.MetricsSink(callback=recs.append))
    torch.cuda.synchronize()
    if any(fn.launches for fn in counters) or recs[0].get("type") != "backend_fallback":
        raise SystemExit("free_field Scheme.EXACT: a kernel ran or no fallback was recorded")
    check_records(recs[1:], "free_field exact", keys)
    act = mods["actions"].get_field("free_field")
    k = 2.0 * math.pi * torch.fft.fftfreq(256, dtype=torch.float64)
    bhat = 2.0 * (1.0 - torch.cos(k))[:, None] + 2.0 * (1.0 - torch.cos(k))[None, :] + act.m2
    want = float((1.0 / bhat).mean())
    phi2 = res.state.phi2_mean.double().cpu()
    z = abs(float(phi2.mean()) - want) / (float(phi2.std()) / math.sqrt(phi2.numel()))
    log(f"  runtime.run_field free_field 256^2 x 16 Scheme.EXACT dtau 0.5 (1 + 2 frames, "
        f"{time.time() - t0:.1f}s, avg_mlups {recs[-1]['avg_mlups']}): <phi^2> "
        f"{float(phi2.mean()):.6f} against the lattice's exact {want:.6f}, {z:.2f} standard "
        f"errors (limit 6); dtau frozen [{card}]")
    out["free_field_exact_mlups"] = {"mlups": recs[-1]["avg_mlups"]}
    if not z < 6.0 or not torch.equal(res.state.dtau, torch.full_like(res.state.dtau, 0.5)):
        raise SystemExit("free_field Scheme.EXACT: <phi^2> off its exact value, or dtau moved")
    for action, dtau in (("free_field", 0.5), ("phi4", 0.1)):
        small = cfgmod.FieldConfig(action=action, shape=(32, 32), n_chains=4, loops=10,
                                   dtau=dtau, seed=5, scheme=Scheme.EXACT, frames=2)
        card_vs_cpu(torch, f"{action} Scheme.EXACT at 32^2 x 4 loops 10, 2 frames",
                    lambda dev: runtime.run_field(small, device=dev, sink=metrics.MetricsSink(
                        callback=lambda r: None)).state, PLAIN_TOL_FIELD_EXACT, card)
    return out


# ---------------------------------------------------------------------------
# kernel 8 (cuda_rdma, prefer_rdma) and the one-step tail of an odd loops
# ---------------------------------------------------------------------------

TailStep = collections.namedtuple("TailStep", "phi slice_means strip_means strip_max")


def tail_leaves(out) -> TailStep:
    """The one-step tail's (phi, slice means, per-block stats) with the block
    sums held as means."""
    phi, sl, stats = out
    sites = phi[0].numel() // stats.shape[1]
    return TailStep(phi, sl, stats[..., :3] / sites, stats[..., 3:])


def rdma_launch_args(parallel, cfg, mesh, shards, i, W, step):
    """Kernel 8's arguments for shard ``i`` of a dim-0 split: its slab, its
    dim-0 ring neighbours' slabs, and its offsets."""
    ax = cfg.mesh_axes[0]
    ring = mesh.axis_size(ax) > 1
    left = mesh.neighbor(i, ax, -1) if ring else i
    right = mesh.neighbor(i, ax, +1) if ring else i
    _, _, _, ch_offs, lat_offs = parallel.mesh.split_geometry(cfg, mesh)
    sh = shards[i]
    return (sh.phi, shards[left].phi, shards[right].phi, sh.dtau), (W, step, lat_offs[i], ch_offs[i])


def gate_rdma_shards(torch, nd, parallel, actions, label, cfg, mesh, shards, W, step) -> float:
    """Kernel 8 on every shard against its plain version (φ bitwise, the rest
    through the gate) and against kernel 7 on the block the runner would have
    extended (every output bitwise).  Returns max|Δ| against the plain version."""
    act = actions.get_field(cfg.action)
    split = (True,) + (False,) * (cfg.ndim - 1)
    worst = 0.0
    for i in range(mesh.size):
        (phi, left, right, dtau), (W_, step_, off, ch) = rdma_launch_args(
            parallel, cfg, mesh, shards, i, W, step)
        got = nd.field_chunk_rdma_nd(phi, left, right, dtau, act, cfg, W_, step_, off, ch)
        want = nd.field_chunk_rdma_nd_ref(phi, left, right, dtau, act, cfg, W_, step_, off, ch)
        H, L0 = nd.chunk_halos(cfg, W, split)[0], phi.shape[1]
        ext = torch.cat([left[:, L0 - H:], phi, right[:, :H]], dim=1)
        k7 = nd.field_chunk_nd(ext, dtau, act, cfg, W_, split, step_, off, ch)
        worst = max(worst, gate(f"{label} shard {i} {tuple(phi.shape)} field_chunk_rdma_nd W={W}",
                                got, want))
        if not torch.equal(got[0], want[0]):
            raise SystemExit(f"{label} shard {i}: kernel 8's phi is not bitwise its plain version's")
        if not all(torch.equal(x, y) for x, y in zip(got, k7)):
            raise SystemExit(f"{label} shard {i}: kernel 8 differs from kernel 7 on the extended "
                             "block")
    log(f"  {label}: kernel 8 bitwise equal to kernel 7 on the extended block on all "
        f"{mesh.size} shards")
    return worst


def phase_rdma_gate(torch, nd, ft, field, actions, cfgmod, parallel, device) -> None:
    """Kernel 8 against its plain version and against kernel 7 on small cases
    and at the timed shape (2-D and 4-D, both sweeps, a ring of one, x = 2, 4
    and 3 on the repeated card, a chain axis beside the ring), then the
    one-step tail of kernel 6's code against its plain version and odd-loops
    frames of the D >= 3 and strip-tiled routes against their plain versions."""
    FieldConfig, Sweep = cfgmod.FieldConfig, cfgmod.Sweep
    cb = dict(sweep=Sweep.CHECKERBOARD)
    for name, shape, mesh_axes, W, kw in [
        ("2d_sync_x2", (64, 128), [("x", 2)], 8, {}),
        ("2d_checkerboard_ring_of_one", (48, 64), [("x", 1)], 4, cb),
        ("4d_sync_x4", (16, 8, 4, 4), [("x", 4)], 2, {}),
        ("4d_checkerboard_x2", (16, 8, 4, 4), [("x", 2)], 2, cb),
        ("3d_threefry13_chain_axis", (24, 12, 40), [("chain", 2), ("x", 3)], 2,
         dict(rng_impl="threefry13", mesh_chain_axis="chain")),
        ("256^2_x16_x2_the_timed_shape", (256, 256), [("x", 2)], 8, dict(n_chains=16)),
    ]:
        kw = {"n_chains": 4, **kw}
        cfg = FieldConfig(action="phi4", shape=shape, dtau=0.01, seed=21,
                          mesh_axes=("x",) + (None,) * (len(shape) - 1), **kw)
        mesh = parallel.make_mesh(mesh_axes, devices=device)
        s0 = field.init_field_state(cfg, device=device)
        shards = parallel.shard_field_state(s0, mesh, cfg)
        gate_rdma_shards(torch, nd, parallel, actions, name, cfg, mesh, shards, W, 7)

    for name, cfg, tile in [
        ("2d_sync", FieldConfig(shape=(64, 96), n_chains=3, dtau=0.01, seed=5), None),
        ("4d_checkerboard_threefry13", FieldConfig(shape=(8, 8, 4, 4), n_chains=3, dtau=0.01,
                                                   seed=5, rng_impl="threefry13", **cb), 2),
        ("3d_sync_long_last_dim", FieldConfig(shape=(8, 12, 40), n_chains=3, dtau=0.01, seed=5),
         4),
    ]:
        act = actions.get_field(cfg.action)
        s0 = field.init_field_state(cfg, device=device)
        got = nd.field_step_nd(s0.phi, s0.dtau, act, cfg, 9, tile, 3)
        want = nd.field_step_nd_ref(s0.phi, s0.dtau, act, cfg, 9, tile, 3)
        gate(f"{name} one-step tail (kernel 6's code at n_steps 1)", tail_leaves(got),
             tail_leaves(want))
        if not torch.equal(got[0], want[0]):
            raise SystemExit(f"{name}: the one-step tail's phi is not bitwise its plain version's")
    for name, cfg, run in [
        ("4d_sync_loops_5", FieldConfig(shape=(8, 8, 4, 4), n_chains=3, dtau=0.01, seed=5,
                                        loops=5), "nd"),
        ("3d_checkerboard_loops_7_chunk_W4", FieldConfig(shape=(16, 8, 6), n_chains=3, dtau=0.01,
                                                         seed=5, loops=7, **cb), "chunk"),
        ("2d_tiled_loops_7", FieldConfig(shape=(64, 96), n_chains=3, dtau=0.01, seed=5, loops=7,
                                         tile_rows=16), "tiled"),
    ]:
        act = actions.get_field(cfg.action)
        s0 = field.init_field_state(cfg, device=device)
        if run == "nd":
            got = nd.run_field_frames_nd(s0, act, cfg, 2)
            want = nd.run_field_frames_nd(s0, act, cfg, 2, pair=nd.field_pair_nd_ref,
                                          tail=nd.field_step_nd_ref)
        elif run == "chunk":
            got = nd.field_frame_nd_chunk(s0, act, cfg, 4)
            want = nd.field_frame_nd_chunk(s0, act, cfg, 4, chunk=nd.field_chunk_nd_ref,
                                           tail=nd.field_step_nd_ref)
        else:
            got = ft.run_field_frames_tiled(s0, act, cfg, 2)
            want = ft.run_field_frames_tiled(s0, act, cfg, 2, pair=ft.field_pair_ref,
                                             tail=nd.field_step_nd_ref)
        gate(f"{name} frames, kernels vs plain", got, want)
        whole = field.run_field_frames(s0, act, cfg, 2 if run != "chunk" else 1)
        same_state(torch, f"{name} frames vs the plain integrator", got[0], whole[0], FIELD_EXACT)


def phase_rdma_main_path(torch, mods, tmp: Path):
    """Kernel 8's main path at full width through runtime.run_field with a
    mesh of the one card: bench.py's halo cell (256^2 x 16, loops 50, W = 8)
    at x = 2 and on the ring of one, backend 'cuda_rdma' and 'auto' with
    prefer_rdma, bitwise against the kernel 7 runs and the unsplit kernels,
    exact launch counts, a bitwise resume and the ineligible prefer_rdma
    record; the 4-D split 32^4 x 8 loops 20 x = 2 W = 2; then `cli run
    --preset phi4_4d --loops 21` (pairs and one tail launch a frame) against
    --backend torch.  Returns (launch counts per kernel, max|Δ| per kernel)."""
    import dataclasses

    runtime, metrics, cfgmod, parallel = (mods[k] for k in ("runtime", "metrics", "cfgmod",
                                                            "parallel"))
    nd, actions, cli, checkpoint = mods["nd"], mods["actions"], mods["cli"], mods["checkpoint"]
    counters = mods["counters"]
    totals = {k: 0 for k in counters}

    def run(cfg, label, want, **kw):
        recs = []
        res = counted(torch, counters, want, label, lambda: runtime.run_field(
            cfg, sink=metrics.MetricsSink(callback=recs.append), **kw))
        check_records(recs, label, ("mag", "phi2", "binder"))
        for k, v in want.items():
            totals[k] += v
        return res.state, recs

    def no_record(recs, label):
        if any(r["type"] == "backend_fallback" for r in recs):
            raise SystemExit(f"{label}: an unexpected backend_fallback record")

    dev = "cuda:0"
    x2 = parallel.make_mesh([("x", 2)], devices=dev)
    x1 = parallel.make_mesh([("x", 1)], devices=dev)
    xy = parallel.make_mesh([("x", 2), ("y", 2)], devices=dev)

    # ---- bench.py's halo cell: 256^2 x 16, loops 50, W = 8 (six chunks and a W = 2 tail)
    frames = 3
    base = cfgmod.FieldConfig(**SPLIT_FIELD, frames=frames)
    cfg = dataclasses.replace(base, mesh_axes=("x", None))
    pref = dataclasses.replace(cfg, prefer_rdma=True)
    chunks = -(-cfg.loops // 8)
    where = f"field {cfg.shape} x {cfg.n_chains} loops {cfg.loops}"
    k8 = "field_chunk_rdma_nd"
    unsplit, _ = run(base, f"{where} unsplit, backend cuda", {"field_frame": frames},
                     device=dev, backend="cuda")
    k7_x2, _ = run(cfg, f"{where} x=2, backend cuda (kernel 7)",
                   {"field_chunk_nd": chunks * frames * 2}, mesh=x2, backend="cuda")
    k7_x1, _ = run(cfg, f"{where} ring of one, backend cuda_pair (kernel 7)",
                   {"field_chunk_nd": chunks * frames}, mesh=x1, backend="cuda_pair")
    rdma_x2, _ = run(cfg, f"{where} x=2, backend cuda_rdma", {k8: chunks * frames * 2}, mesh=x2,
                     backend="cuda_rdma")
    auto_x2, recs = run(pref, f"{where} x=2, auto with prefer_rdma", {k8: chunks * frames * 2},
                        mesh=x2)
    no_record(recs, "auto with prefer_rdma at x=2")
    rdma_x1, _ = run(cfg, f"{where} ring of one, backend cuda_rdma", {k8: chunks * frames},
                     mesh=x1, backend="cuda_rdma")
    auto_x1, recs = run(pref, f"{where} ring of one, auto with prefer_rdma", {k8: chunks * frames},
                        mesh=x1)
    no_record(recs, "auto with prefer_rdma on the ring of one")
    for label, got, k7 in (("x=2 cuda_rdma", rdma_x2, k7_x2), ("x=2 auto prefer_rdma", auto_x2, k7_x2),
                           ("ring of one cuda_rdma", rdma_x1, k7_x1),
                           ("ring of one auto prefer_rdma", auto_x1, k7_x1)):
        same_state(torch, f"{where} {label} vs kernel 7's run", got, k7, "all")
        same_state(torch, f"{where} {label} vs unsplit kernel 3", got, unsplit, FIELD_EXACT)
    ck = str(tmp / "rdma.npz")
    run(dataclasses.replace(cfg, frames=2), f"{where} x=2 cuda_rdma, 2 frames", {k8: chunks * 2 * 2},
        mesh=x2, backend="cuda_rdma", checkpoint_out=ck)
    got, _ = run(cfg, f"{where} x=2 cuda_rdma, resumed for the 3rd", {k8: chunks * 2}, mesh=x2,
                 backend="cuda_rdma", checkpoint_in=ck, resume_progress=True)
    same_state(torch, f"{where} x=2 cuda_rdma resumed vs uninterrupted", got, rdma_x2, "all")
    # a dim-1 split: kernel 8 does not apply, prefer_rdma gives way to kernel 7 with a record
    one = dataclasses.replace(base, frames=1)
    unsplit1, _ = run(one, f"{where} unsplit, 1 frame", {"field_frame": 1}, device=dev,
                      backend="cuda")
    got, recs = run(dataclasses.replace(one, mesh_axes=("x", "y"), prefer_rdma=True),
                    f"{where} x=2 y=2, auto with prefer_rdma", {"field_chunk_nd": chunks * 4},
                    mesh=xy)
    fallbacks = [r for r in recs if r["type"] == "backend_fallback"]
    if (len(fallbacks) != 1 or fallbacks[0]["backend"] != "cuda"
            or "dim-0-only" not in fallbacks[0]["reason"]):
        raise SystemExit(f"prefer_rdma on a dim-1 split: records {fallbacks}")
    log(f"  the ineligible prefer_rdma run's record: {fallbacks[0]}")
    same_state(torch, f"{where} x=2 y=2 kernel 7 vs unsplit", got, unsplit1, FIELD_EXACT)

    # kernel 8 at the shape the main path gives it: the final state's shards
    err = {}
    err[k8] = gate_rdma_shards(torch, nd, parallel, actions, "main path x=2", cfg, x2,
                               parallel.shard_field_state(rdma_x2, x2, cfg), 8,
                               int(rdma_x2.step))

    # ---- the 4-D split: 32^4 x 8, loops 20, x = 2, W = 2
    base4 = cfgmod.FieldConfig(**{**BENCH_ND, "n_chains": 8, "exchange_steps": 2, "frames": 2})
    cfg4 = dataclasses.replace(base4, mesh_axes=("x", None, None, None))
    where = f"field {cfg4.shape} x {cfg4.n_chains} loops {cfg4.loops}"
    n4 = cfg4.loops // 2 * cfg4.frames
    unsplit4, _ = run(base4, f"{where} unsplit, backend cuda (kernel 6)", {"field_pair_nd": n4},
                      device=dev, backend="cuda")
    k7_4, _ = run(cfg4, f"{where} x=2, backend cuda (kernel 7)", {"field_chunk_nd": n4 * 2},
                  mesh=x2, backend="cuda")
    rdma_4, _ = run(cfg4, f"{where} x=2, backend cuda_rdma", {k8: n4 * 2}, mesh=x2,
                    backend="cuda_rdma")
    same_state(torch, f"{where} x=2 cuda_rdma vs kernel 7's run", rdma_4, k7_4, "all")
    same_state(torch, f"{where} x=2 cuda_rdma vs unsplit kernel 6", rdma_4, unsplit4, FIELD_EXACT)

    # ---- phi4_4d with an odd loops through the CLI: pairs and one tail a frame
    nd_counters = {k: counters[k] for k in ("field_pair_nd", "field_step_nd", "field_chunk_nd")}
    odd = field_cli_runs(torch, cli, checkpoint, nd_counters, tmp, "o", ["--loops", "21"],
                         preset="phi4_4d", chains=4)
    frames_run = 1 + 3 + 1 + 1 + 4  # burn-in + 3, resume 1, burn-in + 4
    if odd != {"field_pair_nd": 10 * frames_run, "field_step_nd": frames_run, "field_chunk_nd": 0}:
        raise SystemExit(f"phi4_4d --loops 21 did not run 10 pairs and one tail a frame: {odd}")
    plain = field_cli_runs(torch, cli, checkpoint, nd_counters, tmp, "q",
                           ["--loops", "21", "--backend", "torch"], preset="phi4_4d", chains=4)
    if any(plain.values()):
        raise SystemExit(f"--backend torch launched a kernel: {plain}")
    got, _ = checkpoint.load(tmp / "oc.npz", "cuda")
    want, _ = checkpoint.load(tmp / "qc.npz", "cuda")
    same_state(torch, "phi4_4d --loops 21: the kernels vs --backend torch", got, want, FIELD_EXACT)
    state, cfgo = checkpoint.load(tmp / "oa.npz", "cuda")
    act = actions.get_field(cfgo.action)
    tail_step = int(state.step) + cfgo.loops - 1
    err["field_step_nd"] = gate(
        f"main path C={cfgo.n_chains} {cfgo.shape} one-step tail",
        tail_leaves(nd.field_step_nd(state.phi, state.dtau, act, cfgo, tail_step)),
        tail_leaves(nd.field_step_nd_ref(state.phi, state.dtau, act, cfgo, tail_step)))
    for k in ("field_pair_nd", "field_step_nd"):
        totals[k] += odd[k]
    return totals, err


def phase_rdma_timings(torch, mods, card: str) -> dict:
    """cuda_rdma beside cuda (kernel 7) at x = 2 and beside cuda_pair on the
    ring of one at 256^2 x 16 loops 50, in turns (kernel 7, kernel 8, kernel 8,
    kernel 7): MLUPS, the device's idle share and each kernel's device time per
    launch under torch.profiler; then kernel 8 and kernel 7 alone on shard 1's
    (16, 128, 256) slab, W = 8 (CUDA events, in turns), and kernel 8's plain
    version, held against each other; the one-step tail beside the pair at
    32^4 x 1."""
    parallel, halo, field, actions, cfgmod, nd = (mods[k] for k in (
        "parallel", "halo", "field", "actions", "cfgmod", "nd"))
    out = {}
    run_timed = functools.partial(time_runner, torch, out, card)
    meshes = {"x=2": parallel.make_mesh([("x", 2)], devices="cuda:0"),
              "x=1": parallel.make_mesh([("x", 1)], devices="cuda:0")}
    cfg = cfgmod.FieldConfig(**SPLIT_FIELD, mesh_axes=("x", None))
    act = actions.get_field(cfg.action)
    s0 = field.init_field_state(cfg, device="cuda:0")
    ups = cfg.n_chains * math.prod(cfg.shape) * cfg.loops
    where = f"field {cfg.shape} x {cfg.n_chains} loops {cfg.loops}"
    shards = None
    for turn, (mname, backend) in enumerate((("x=2", "cuda"), ("x=2", "cuda_rdma"),
                                             ("x=1", "cuda_pair"), ("x=1", "cuda_rdma"),
                                             ("x=1", "cuda_rdma"), ("x=1", "cuda_pair"),
                                             ("x=2", "cuda_rdma"), ("x=2", "cuda"))):
        mesh = meshes[mname]
        key = f"rdma_field_{mname}_{backend}" + ("" if turn < 4 else "_again")
        got = run_timed(key, f"{where}, {mname}, {backend}", halo.make_halo_runner(
            act, cfg, mesh, backend=backend), parallel.shard_field_state(s0, mesh, cfg), 8, ups,
            profile=turn < 4)
        if (mname, backend) == ("x=2", "cuda_rdma"):
            shards = got
    for mname, k7 in (("x=2", "cuda"), ("x=1", "cuda_pair")):
        a, b = out[f"rdma_field_{mname}_cuda_rdma"], out[f"rdma_field_{mname}_{k7}"]
        log(f"  {mname}: cuda_rdma / {k7} {a['mlups'] / b['mlups']:.4f}x (first turn), "
            f"{out[f'rdma_field_{mname}_cuda_rdma_again']['mlups'] / out[f'rdma_field_{mname}_{k7}_again']['mlups']:.4f}x "
            f"(second); kernel 8 {a.get('kernel_us', float('nan')):.2f} µs against kernel 7 "
            f"{b.get('kernel_us', float('nan')):.2f} µs of device time per launch (profiler) "
            f"[{card}]")

    # kernel 8 and kernel 7 alone on shard 1's slab at W = 8, in turns
    mesh = meshes["x=2"]
    (phi, left, right, dtau), (W, step, off, ch) = rdma_launch_args(parallel, cfg, mesh, shards,
                                                                     1, 8, int(shards[1].step))
    H = nd.chunk_halos(cfg, W, (True, False))[0]
    ext = torch.cat([left[:, phi.shape[1] - H:], phi, right[:, :H]], dim=1)
    k8 = lambda: nd.field_chunk_rdma_nd(phi, left, right, dtau, act, cfg, W, step, off, ch)  # noqa: E731
    k7 = lambda: nd.field_chunk_nd(ext, dtau, act, cfg, W, (True, False), step, off, ch)  # noqa: E731
    times = {"k7": [], "k8": []}
    for name in ("k7", "k8", "k8", "k7"):
        times[name].append(cuda_ms(torch, k8 if name == "k8" else k7, reps=20))
    got = k8()
    holder = {}
    nd.field_chunk_rdma_nd_ref(phi, left, right, dtau, act, cfg, W, step, off, ch)  # warm-up
    plain_ms = timed(torch, lambda: holder.update(
        r=nd.field_chunk_rdma_nd_ref(phi, left, right, dtau, act, cfg, W, step, off, ch))) * 1e3
    out["field_chunk_rdma_nd_err"] = gate(f"shard {tuple(phi.shape)} field_chunk_rdma_nd W=8",
                                          got, holder["r"])
    ms, ms7 = sum(times["k8"]) / 2, sum(times["k7"]) / 2
    out["field_chunk_rdma_nd_ms"], out["field_chunk_rdma_nd_plain_ms"] = ms, plain_ms
    out["field_chunk_nd_shard_ms"] = ms7
    log(f"  field_chunk_rdma_nd kernel {ms:.4f} ms/launch ({', '.join(f'{t:.4f}' for t in times['k8'])}; "
        f"CUDA events, mean of 20, in turns with kernel 7), kernel 7 on the extended block "
        f"{ms7:.4f} ms ({', '.join(f'{t:.4f}' for t in times['k7'])}): {ms / ms7:.4f}x; plain "
        f"version {plain_ms:.1f} ms (once), at the {tuple(phi.shape)} slab, W = 8 [{card}]")

    # the one-step tail beside the pair it ends, at 32^4 x 1 (kernel 6's timed shape)
    ncfg = cfgmod.FieldConfig(**BENCH_ND, n_chains=1)
    s0 = field.init_field_state(ncfg, device="cuda:0")
    nact = actions.get_field(ncfg.action)
    calls = {"pair": lambda: nd.field_pair_nd(s0.phi, s0.dtau, nact, ncfg, 1),
             "tail": lambda: nd.field_step_nd(s0.phi, s0.dtau, nact, ncfg, 1)}
    times = {"pair": [], "tail": []}
    for name in ("pair", "tail", "tail", "pair"):
        times[name].append(cuda_ms(torch, calls[name], reps=20))
    tail_ms, pair_ms = sum(times["tail"]) / 2, sum(times["pair"]) / 2
    out["field_step_nd_ms"] = tail_ms
    log(f"  one-step tail (kernel 6's code at n_steps 1) {tail_ms:.4f} ms/launch "
        f"({', '.join(f'{t:.4f}' for t in times['tail'])}), the pair {pair_ms:.4f} ms "
        f"({', '.join(f'{t:.4f}' for t in times['pair'])}): {tail_ms / pair_ms:.4f}x; CUDA events, "
        f"mean of 20, in turns, at {ncfg.shape} x 1 [{card}]")
    return out


# ---------------------------------------------------------------------------
# complex Langevin: the complex actions and the complexified gauge groups
# (no kernel in either package)
# ---------------------------------------------------------------------------

CL_PRESETS = ("complex_gaussian", "complex_quartic", "complex_chain", "complex_field_2d",
              "cu1_2d_complex", "csu3_2d_complex")
CL_KEYS = ("re_z2", "im_z2", "drift_max")  # stochquant_tpu/runtime.py:283-287
CL_GAUGE_KEYS = ("plaquette", "plaquette_exact_2d", "drift_max", "plaquette_im",
                 "plaquette_exact_2d_im", "unitarity_norm")  # stochquant_tpu/runtime.py:418-436


def phase_complex_langevin(torch, mods, tmp: Path, card: str) -> dict:
    """The complex-Langevin sector on the card, no kernel in either package:
    every complex and complexified-gauge preset at its JAX width through `cli
    run` (burn 1 + 2 frames, --resume for 1, uninterrupted burn 1 + 3: the
    resume bitwise, records finite with the JAX runner's keys, no kernel
    launched, `auto` on the gauge presets recording its fallback); each
    family at a small size on the card against the CPU run of the same code;
    the known answers ⟨z²⟩ = 1/σ (0-D) and the lattice propagator (2-D
    field) within 6 standard errors over chains, and the unitarity norm of
    cu1 with cooling below its value without; then rates."""
    import dataclasses

    cli, checkpoint, runtime, metrics = (mods[k] for k in ("cli", "checkpoint", "runtime",
                                                           "metrics"))
    counters = dict(mods["counters"], chain_frame=mods["ck"].chain_frame,
                    chain_frames_multi=mods["ck"].chain_frames_multi)
    from stochquant_tpu_torch.actions import complex_actions
    from stochquant_tpu_torch.integrators import complex_field as cfield
    from stochquant_tpu_torch.integrators import complex_langevin as cl
    gauge = mods["gauge"]
    presets = {**cli.COMPLEX_PRESETS, **cli.GAUGE_PRESETS}
    quiet = lambda: metrics.MetricsSink(callback=lambda r: None)  # noqa: E731
    out = {}

    def records(path):
        return [json.loads(line) for line in open(path)]

    # 1. each preset at its width through the CLI
    for preset in CL_PRESETS:
        is_gauge = preset in cli.GAUGE_PRESETS
        common = ["run", "--preset", preset, "--device", "cuda"]
        paths = {p: (str(tmp / f"cl_{preset}_{p}.npz"), str(tmp / f"cl_{preset}_{p}.jsonl"))
                 for p in "abc"}

        def three_runs():
            cli.main(common + ["--burn", "1", "--frames", "2", "--out", paths["a"][0],
                               "--metrics", paths["a"][1]])
            cli.main(common + ["--frames", "1", "--resume", paths["a"][0], "--out",
                               paths["b"][0], "--metrics", paths["b"][1]])
            cli.main(common + ["--burn", "1", "--frames", "3", "--out", paths["c"][0],
                               "--metrics", paths["c"][1]])

        counted(torch, counters, {}, f"cli run --preset {preset} (burn 1 + 2, resume 1, "
                f"burn 1 + 3 frames)", three_runs)
        for part in "abc":
            recs = records(paths[part][1])
            if is_gauge:
                if recs[0].get("type") != "backend_fallback" or recs[0].get("backend") != "torch":
                    raise SystemExit(f"{preset}{part}: auto did not record why it runs the "
                                     "plain path")
                recs = recs[1:]
            check_records(recs, preset + part, CL_GAUGE_KEYS if is_gauge else CL_KEYS)
        resumed, cfg = checkpoint.load(paths["b"][0], "cpu")
        straight, _ = checkpoint.load(paths["c"][0], "cpu")
        for name, x, y in zip(resumed._fields, resumed, straight):
            if not torch.equal(x, y):
                raise SystemExit(f"{preset}: resumed run differs from the uninterrupted one "
                                 f"in {name}")
        last = records(paths["c"][1])[-2]
        keys = CL_GAUGE_KEYS if is_gauge else CL_KEYS
        log(f"    {preset} at {preset_width(cfg)}: records finite with the JAX runner's keys, "
            f"no kernel launched{', fallback recorded' if is_gauge else ''}, resume bitwise; "
            f"last frame {json.dumps({k: last[k] for k in keys})}")

    # 2. the card against the CPU, each family at a small size
    small = {
        "complex_quartic": dict(n_chains=256, loops=10, frames=2),
        "complex_chain": dict(n_chains=64, loops=11, frames=2),
        "complex_field_2d": dict(n_chains=8, shape=(16, 16), loops=10, frames=2),
        "cu1_2d_complex": dict(n_chains=8, shape=(8, 8), loops=10, frames=2),
        "csu3_2d_complex": dict(n_chains=8, shape=(8, 8), loops=10, frames=2),
    }
    for preset, change in small.items():
        cfg = dataclasses.replace(presets[preset], **change)
        is_gauge = preset in cli.GAUGE_PRESETS
        entry = runtime.run_gauge if is_gauge else runtime.run_complex

        def run(device, cfg=cfg, entry=entry):
            return entry(cfg, device=device, sink=quiet()).state

        sums = (("plaq_mean",) if is_gauge else ("z2r_mean", "z2i_mean", "zim_mean")
                if preset == "complex_field_2d" else ())
        card_vs_cpu(torch, f"{preset} cut to {change}", run, PLAIN_TOL, card, sums)

    # 3. known answers at the preset widths (Δτ held: grow_after 10**9)
    for preset, burn, frames in (("complex_gaussian", 40, 40), ("complex_field_2d", 30, 20)):
        cfg = dataclasses.replace(presets[preset], grow_after=10**9, frames=frames, seed=21)
        t0 = time.time()
        res = counted(torch, counters, {}, f"runtime.run_complex {preset} burn {burn} + "
                      f"{frames} frames", lambda cfg=cfg, burn=burn: runtime.run_complex(
                          cfg, device="cuda", burn_frames=burn, sink=quiet()))
        seconds = time.time() - t0
        act = complex_actions.get_complex(cfg.action)
        want = (1.0 / act.sigma if preset == "complex_gaussian" else
                cfield.exact_gaussian_z2(cfg.shape, cfg.spacing, act.sigma))
        re = res.state.z2r_mean.double().cpu().reshape(cfg.n_chains, -1).mean(dim=1)
        im = res.state.z2i_mean.double().cpu().reshape(cfg.n_chains, -1).mean(dim=1)
        got = complex(float(re.mean()), float(im.mean()))
        err = math.hypot(float(re.std()), float(im.std())) / math.sqrt(cfg.n_chains)
        z = abs(got - want) / err
        log(f"  {preset} ({cfg.n_chains} chains, dtau {cfg.dtau:g}, loops {cfg.loops}; burn "
            f"{burn} + {frames} frames, {seconds:.1f}s): <z^2> {got:.5f} against the exact "
            f"{want:.5f}, {z:.2f} standard errors over chains (limit 6; the Euler-Maruyama "
            f"step's bias dtau/2 = {cfg.dtau / 2:.1e}, standard error {err:.1e}) [{card}]")
        if not (torch.isfinite(res.state.zr).all() and z < 6.0):
            raise SystemExit(f"{preset}: <z^2> is not within 6 standard errors of its exact value")

    # cu1's drift is a lattice curl, so from unitary links Im θ stays free of
    # divergence and cooling has nothing to remove: start from an imaginary
    # gauge transform of the cold links, Im θ_μ(x) = b(x) − b(x+μ̂)
    base = dataclasses.replace(presets["cu1_2d_complex"], frames=3)
    cold = gauge.init_gauge_state(base, gauge.resolve_gauge_action(base), device="cuda")
    b = 0.3 * torch.randn((base.n_chains,) + base.shape,
                          generator=torch.Generator().manual_seed(27)).to("cuda")
    im = torch.stack([b - torch.roll(b, -1, dims=1 + mu) for mu in range(base.ndim)], dim=1)
    start = tmp / "cu1_gauge_transformed.npz"
    checkpoint.save(start, cold._replace(links=torch.complex(cold.links.real, im)), base)
    norms = {}
    for rate in (base.cooling_rate, 0.0):
        recs = []
        runtime.run_gauge(dataclasses.replace(base, cooling_rate=rate), device="cuda",
                          checkpoint_in=str(start), sink=metrics.MetricsSink(callback=recs.append))
        norms[rate] = [r["unitarity_norm"] for r in recs if r["type"] == "frame"]
    log(f"  cu1_2d_complex, 3 frames from a gauge transform of the cold links (Im part 0.3 "
        f"N(0,1) gradients): unitarity norm (max over chains) {norms[base.cooling_rate]} with "
        f"cooling rate {base.cooling_rate}, {norms[0.0]} without")
    if not (all(math.isfinite(v) for v in norms[base.cooling_rate])
            and norms[base.cooling_rate][-1] < norms[0.0][-1]):
        raise SystemExit("cu1_2d_complex: cooling did not keep the unitarity norm below its "
                         "value without cooling")

    # 4. rates: median of 3 frames after a warm-up frame, loops 20, at the widths
    cells = [
        ("complex_chain", presets["complex_chain"]),
        ("complex_field_2d", presets["complex_field_2d"]),
        ("complex_field_256x256x16", dataclasses.replace(presets["complex_field_2d"],
                                                         shape=(256, 256), n_chains=16)),
        ("cu1_2d_complex", presets["cu1_2d_complex"]),
        ("csu3_2d_complex", presets["csu3_2d_complex"]),
    ]
    for key, cfg in cells:
        cfg = dataclasses.replace(cfg, loops=20, grow_after=10**9)
        if isinstance(cfg, gauge.GaugeConfig):
            act = gauge.resolve_gauge_action(cfg)
            state, run_n = gauge.init_gauge_state(cfg, act, device="cuda"), gauge.run_gauge_frames
            ups, unit = cfg.n_chains * cfg.ndim * math.prod(cfg.shape) * cfg.loops, "link-MLUPS"
        elif isinstance(cfg, cfield.ComplexFieldConfig):
            act = complex_actions.get_complex(cfg.action)
            state, run_n = cfield.init_cfield_state(cfg, device="cuda"), cfield.run_cfield_frames
            ups, unit = cfg.n_chains * math.prod(cfg.shape) * cfg.loops, "MLUPS"
        else:
            act = complex_actions.get_complex(cfg.action)
            state, run_n = cl.init_ccl_state(cfg, device="cuda"), cl.run_ccl_frames
            ups, unit = cfg.n_chains * cfg.n_sites * cfg.loops, "MLUPS"

        def step(s, run_n=run_n, act=act, cfg=cfg):
            return run_n(s, act, cfg, 1)[0]

        holder = {"s": step(state)}  # warm-up
        reps = [timed(torch, lambda: holder.update(s=step(holder["s"]))) for _ in range(3)]
        t = sorted(reps)[1]
        out["cl_" + key] = dict(mlups=ups / t / 1e6, seconds=t, reps=reps)
        msg = (f"  {key} {preset_width(cfg)} loops {cfg.loops}: {ups / t / 1e6:.3f} {unit} "
               f"(median of 3 frames after a warm-up, {t * 1e3:.2f} ms a frame; reps "
               f"{[round(r, 5) for r in reps]})")
        if key == "complex_field_256x256x16":
            wall, busy, rows = device_profile(torch, lambda: step(holder["s"]))
            out["cl_" + key]["idle"] = 1.0 - busy / wall
            msg += (f"; one more frame under torch.profiler: device busy {busy * 1e3:.3f} of "
                    f"{wall * 1e3:.3f} ms wall, idle {1.0 - busy / wall:.1%}")
        log(msg + f" [{card}]")
    return out


# ---------------------------------------------------------------------------
# [28] chains over a mesh and across processes, sharded checkpoints, on-card
# autotune, the reference format
# ---------------------------------------------------------------------------

#: one process of [28](b): its half of the headline chains through kernels 1 and 2
#: with its global chain offset, then its save_sharded file; no JAX anywhere
MESH_WORKER = r"""
import dataclasses, json, sys, time
import torch
from stochquant_tpu_torch import actions
from stochquant_tpu_torch.config import ChainConfig
from stochquant_tpu_torch.integrators import langevin
from stochquant_tpu_torch.io import checkpoint
from stochquant_tpu_torch.kernels import chain_kernel as ck
from stochquant_tpu_torch.parallel import distributed, mesh as mesh_mod

rank, store, ckdir, phase = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
cfg = ChainConfig.from_json(sys.argv[5])
distributed.initialize(f"file://{store}", world_size=2, rank=rank, timeout_s=120)
act = actions.get(cfg.action)
per, off = distributed.process_local_chains(cfg.n_chains)
mesh = distributed.global_mesh([("chain", 2)], devices="cuda:0")
c_local, offsets = mesh_mod.chain_split(cfg.n_chains, mesh, "chain")
assert offsets == [off] and c_local == per, (offsets, off)
local = dataclasses.replace(cfg, n_chains=c_local, mesh_chain_axis=None)
if phase == "first":
    shards = mesh_mod.shard_chain_state(langevin.init_chain_state(cfg, act, device="cuda:0"), mesh)
    n, done = 3, 3
else:
    shards, loaded = checkpoint.load_sharded(f"{ckdir}/first", mesh)
    assert loaded == cfg
    n, done = 1, 4
for fn in (ck.chain_frame, ck.chain_frames_multi):
    fn.launches = fn.launches_hw = 0
torch.cuda.synchronize()
t0 = time.perf_counter()
out = [ck.run_frames_kernel(s, act, local, n, frames_per_launch=2, chain_offset=o)
       for s, o in zip(shards, offsets)]
torch.cuda.synchronize()
seconds = time.perf_counter() - t0
launches = {"chain_frame": ck.chain_frame.launches,
            "chain_frames_multi": ck.chain_frames_multi.launches}
stable, chains = distributed.all_sum([sum(float(o[1]["stable"][-1].sum()) for o in out), per])
checkpoint.save_sharded(f"{ckdir}/{phase}", [o[0] for o in out], cfg, mesh, frames_done=done)
torch.distributed.barrier()
torch.distributed.destroy_process_group()
assert "jax" not in sys.modules
print("WORKER " + json.dumps({"rank": rank, "phase": phase, "offset": off, "chains": per,
                              "launches": launches, "seconds": seconds,
                              "stable_frac": stable / chains}), flush=True)
"""


def chain_counted(torch, ck, label: str, want: dict, fn):
    """``fn`` with kernels 1 and 2's counters set to 0 just before and read
    just after; they must be exactly ``want``, Threefry launches under the
    kernel's name and Philox ones under ``*_hw``."""
    fns = {"chain_frame": ck.chain_frame, "chain_frames_multi": ck.chain_frames_multi}
    for f in fns.values():
        f.launches = f.launches_hw = 0
    t0 = time.time()
    result = fn()
    torch.cuda.synchronize()
    got = {k: f.launches - f.launches_hw for k, f in fns.items() if f.launches - f.launches_hw}
    got.update({k + "_hw": f.launches_hw for k, f in fns.items() if f.launches_hw})
    log(f"  {label}: {time.time() - t0:.2f}s, launches {got or 'none'}")
    if got != want:
        raise SystemExit(f"{label}: launches {got}, expected {want}")
    return result


TIMING_KEYS = ("wall_time", "mlups", "avg_mlups", "elapsed_s")


def same_records(label: str, a: list, b: list) -> None:
    """Two runs' records equal but for their wall times."""
    def norm(recs):
        return json.dumps([{k: v for k, v in r.items() if k not in TIMING_KEYS} for r in recs],
                          default=lambda o: o.tolist())
    if norm(a) != norm(b):
        raise SystemExit(f"{label}: the records differ from the unsplit run's")


def run_workers(torch, tmp: Path, phase: str, cfg) -> list:
    """The two processes of [28](b) for one phase; each must exit 0 within its
    time limit (a hang is killed and fails the phase)."""
    import os

    script = tmp / "mesh_worker.py"
    script.write_text(MESH_WORKER)
    # modules loaded with the context, so the timed frames hold no first-launch load
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""),
               CUDA_MODULE_LOADING="EAGER")
    store = tmp / f"store_{phase}"
    procs = [subprocess.Popen([sys.executable, str(script), str(rank), str(store), str(tmp),
                               phase, cfg.to_json()], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for rank in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    except subprocess.TimeoutExpired:
        raise SystemExit(f"[28](b) {phase}: a worker did not finish within 240 s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    reports = []
    for rank, (p, out) in enumerate(zip(procs, outs)):
        line = next((ln for ln in out.splitlines() if ln.startswith("WORKER ")), None)
        if p.returncode != 0 or line is None:
            raise SystemExit(f"[28](b) {phase} rank {rank} failed ({p.returncode}):\n{out[-3000:]}")
        reports.append(json.loads(line[len("WORKER "):]))
    return reports


def phase_chain_mesh(torch, mods, tmp: Path, card: str):
    """[28]: (a) the headline chains over a 2-shard chain mesh of the card,
    bitwise the unsplit run, then sharded checkpoints and their times; (b) two
    processes on the card (gloo) with their sharded files; (c) the autotuners
    on kernels 6 and 7; (d) the reference format.  Returns the main paths'
    launch counts and the timings."""
    import dataclasses

    runtime, metrics, cfgmod, parallel = (mods["runtime"], mods["metrics"], mods["cfgmod"],
                                          mods["parallel"])
    ck, checkpoint, langevin, actions, nd = (mods["ck"], mods["checkpoint"], mods["langevin"],
                                             mods["actions"], mods["nd"])
    autotune, mesh_mod, field = mods["autotune"], mods["mesh_mod"], mods["field"]
    totals, out = collections.Counter(), {}
    mesh = parallel.make_mesh([("chain", 2)], devices=["cuda:0", "cuda:0"])
    base = cfgmod.ChainConfig(**HEADLINE, frames=2)
    act = actions.get(base.action)
    ups = base.n_chains * base.n_sites * base.loops

    # (a) run_chain(mesh=) at the headline width, fpl 1 and 2, Threefry and Philox
    states = {}
    for rng in ("threefry", "hardware"):
        for K in (1, 2):
            cfg = dataclasses.replace(base, rng_impl=rng, frames_per_launch=K, fps=K)
            hw = "_hw" if rng == "hardware" else ""
            per_run = ({"chain_frame": 3} if K == 1 else {"chain_frame": 1, "chain_frames_multi": 1})
            want = {k + hw: v for k, v in per_run.items()}
            label = f"headline {rng} fpl {K}: burn 1 + {cfg.frames} frames"
            ra, rb = [], []
            a = chain_counted(torch, ck, f"{label}, unsplit", want, lambda: runtime.run_chain(
                cfg, device="cuda", burn_frames=1, sink=metrics.MetricsSink(callback=ra.append)))
            split = dataclasses.replace(cfg, mesh_chain_axis="chain")
            b = chain_counted(torch, ck, f"{label}, run_chain(mesh=chain 2 on cuda:0)",
                              {k: 2 * v for k, v in want.items()}, lambda: runtime.run_chain(
                                  split, mesh=mesh, burn_frames=1,
                                  sink=metrics.MetricsSink(callback=rb.append)))
            totals.update({k: 2 * v for k, v in want.items()})
            check_records(rb, label, ("dtau", "stable_frac"))
            same_state(torch, f"{label}: mesh vs unsplit", b.state, a.state, "all")
            same_records(label, ra, rb)
            log(f"  {label}: every leaf and record bitwise the unsplit run's; stable_frac "
                f"{[r['stable_frac'] for r in rb if r['type'] == 'frame']}")
            states[(rng, K)] = (split, a.state)

    # sharded save, load_sharded and resume, against the uninterrupted run (threefry, fpl 2)
    split, uninterrupted = states[("threefry", 2)]
    first = runtime.run_chain(dataclasses.replace(split, frames=1), mesh=mesh, burn_frames=1,
                              sink=metrics.MetricsSink())
    shards = mesh_mod.shard_chain_state(first.state, mesh)
    path, got = str(tmp / "headline_sharded"), {}
    out["ckpt_sharded_save_s"] = timed(torch, lambda: checkpoint.save_sharded(
        path, shards, split, mesh, frames_done=1))
    out["ckpt_sharded_load_s"] = timed(torch, lambda: got.update(
        sharded=checkpoint.load_sharded(path, mesh)[0]))
    loaded = got["sharded"]
    for i, (x, y) in enumerate(zip(shards, loaded)):
        same_state(torch, f"headline shard {i}: load_sharded vs the saved shard", y, x, "all")
    resumed = chain_counted(torch, ck, "headline threefry fpl 2: resumed from the sharded files "
                            "for the 2nd frame", {"chain_frame": 2}, lambda: runtime.run_chain(
                                split, mesh=mesh, checkpoint_in=path, resume_progress=True,
                                sink=metrics.MetricsSink()))
    totals.update({"chain_frame": 2})
    same_state(torch, "headline: sharded resume vs uninterrupted", resumed.state, uninterrupted,
               "all")
    whole_path = str(tmp / "headline_whole.npz")
    out["ckpt_whole_save_s"] = timed(torch, lambda: checkpoint.save(
        whole_path, first.state, split, frames_done=1))
    out["ckpt_whole_load_s"] = timed(torch, lambda: got.update(
        whole=checkpoint.load(whole_path, "cuda")[0]))
    same_state(torch, "headline: whole-state save/load", got["whole"], first.state, "all")
    size = sum(Path(f).stat().st_size for f in Path(tmp).glob("headline_sharded.proc*"))
    log(f"  checkpoints of the headline state ({size / 2**20:.1f} MiB on disk): whole-state "
        f"save {out['ckpt_whole_save_s']:.3f} s, load {out['ckpt_whole_load_s']:.3f} s; "
        f"sharded (2 shards, one file) save {out['ckpt_sharded_save_s']:.3f} s, load "
        f"{out['ckpt_sharded_load_s']:.3f} s (host clock, device synchronised) [{card}]")
    # one frame of the mesh against the unsplit run, timed in turns (one card: not a mesh cost)
    cfg1 = dataclasses.replace(base, frames=1)
    s0 = langevin.init_chain_state(cfg1, act, device="cuda")
    s0, _ = ck.run_frames_kernel(s0, act, cfg1, 1)
    c_local, offsets = mesh_mod.chain_split(cfg1.n_chains, mesh, "chain")
    local = dataclasses.replace(cfg1, n_chains=c_local)
    sh = mesh_mod.shard_chain_state(s0, mesh)
    reps = {"unsplit": [], "mesh": []}
    for name in ("unsplit", "mesh", "mesh", "unsplit"):
        if name == "unsplit":
            reps[name].append(timed(torch, lambda: ck.run_frames_kernel(s0, act, cfg1, 1)))
        else:
            reps[name].append(timed(torch, lambda: [
                ck.run_frames_kernel(x, act, local, 1, chain_offset=o)
                for x, o in zip(sh, offsets)]))
    for name, v in reps.items():
        out[f"chain_mesh_{name}"] = dict(mlups=ups / min(v) / 1e6, seconds=min(v), reps=v)
    log(f"  headline frame, kernel 1, in turns: unsplit {ups / min(reps['unsplit']) / 1e6:.1f} "
        f"MLUPS, 2 shards on the one card {ups / min(reps['mesh']) / 1e6:.1f} MLUPS (least of 2; "
        f"two launches of half the chains in turn on one card: not a mesh cost) [{card}]")

    # (b) two processes on cuda:0, gloo through a file store, each half the chains
    pcfg = cfgmod.ChainConfig(**HEADLINE, mesh_chain_axis="chain")
    t0 = time.perf_counter()
    first_r = run_workers(torch, tmp, "first", pcfg)
    resume_r = run_workers(torch, tmp, "resume", pcfg)
    wall = time.perf_counter() - t0
    for r in first_r + resume_r:
        want = ({"chain_frame": 1, "chain_frames_multi": 1} if r["phase"] == "first"
                else {"chain_frame": 1, "chain_frames_multi": 0})
        if r["launches"] != want or r["chains"] != pcfg.n_chains // 2:
            raise SystemExit(f"[28](b) rank {r['rank']} {r['phase']}: {r}")
        totals.update(r["launches"])
        log(f"  process {r['rank']} {r['phase']}: chains {r['offset']}..{r['offset'] + r['chains'] - 1}"
            f", launches {r['launches']}, {r['seconds']:.3f} s of frames "
            f"({r['chains'] * pcfg.n_sites * pcfg.loops * (3 if r['phase'] == 'first' else 1) / r['seconds'] / 1e6:.1f}"
            f" MLUPS a process, both on one card: not a mesh cost), stable_frac over both "
            f"processes {r['stable_frac']} [{card}]")
    if not all((tmp / f"resume.proc{i}-of-2.npz").exists() for i in range(2)):
        raise SystemExit("[28](b): the resumed processes did not write their sharded files")
    pact = actions.get(pcfg.action)
    ref = langevin.init_chain_state(pcfg, pact, device="cuda")
    ref3, m3 = ck.run_frames_kernel(ref, pact, pcfg, 3, frames_per_launch=2)
    ref4, m4 = ck.run_frames_kernel(ref3, pact, pcfg, 1, frames_per_launch=2)
    one = parallel.make_mesh([("chain", 2)], devices="cuda:0")
    for phase, want, m in (("first", ref3, m3), ("resume", ref4, m4)):
        got, _ = checkpoint.load_sharded(str(tmp / phase), one)
        same_state(torch, f"two processes, {phase}: their sharded files vs one process",
                   mesh_mod.gather_chain_state(got, one), want, "all")
        frac = float(m["stable"][-1].float().mean())
        if any(r["stable_frac"] != frac for r in (first_r if phase == "first" else resume_r)):
            raise SystemExit(f"[28](b) {phase}: the stable fraction summed over the processes "
                             f"differs from one process's {frac}")
    log(f"  two processes: 3 frames, save_sharded, new processes load and run 1: the files "
        f"joined bitwise the one-process run; {wall:.1f} s with process start-up")

    # (c) the autotuners: tile_rows=0 at 32^4 x 4 (kernel 6), exchange_steps=0 on the split
    autotune.clear_cache()
    fcfg = cfgmod.FieldConfig(**BENCH_ND, n_chains=4, frames=1, tile_rows=0)
    admitted, skipped = autotune.tile_rows_candidates(fcfg)
    pairs = fcfg.loops // 2
    tune = (1 + autotune._TUNE_REPS) * autotune._TUNE_FRAMES * pairs
    recs = []
    counters = {k: mods["counters"][k] for k in ("field_pair_nd", "field_chunk_nd")}
    tuned = counted(torch, counters, {"field_pair_nd": tune * len(admitted) + pairs},
                    f"run_field {fcfg.shape} x {fcfg.n_chains} tile_rows=0 (kernel 6 for "
                    f"{admitted})", lambda: runtime.run_field(
                        fcfg, device="cuda", sink=metrics.MetricsSink(callback=recs.append)))
    totals.update({"field_pair_nd": tune * len(admitted) + pairs})
    rec = recs[0]
    if rec["type"] != "autotune" or rec["tile_rows"] not in admitted or \
            sorted(map(int, rec["candidates_ms"])) != admitted:
        raise SystemExit(f"tile_rows=0: unexpected record {rec}")
    check_records(recs, "tile_rows=0", ("mag", "phi2", "binder"))
    plain_tile = runtime.run_field(dataclasses.replace(fcfg, tile_rows=None), device="cuda",
                                   sink=metrics.MetricsSink())
    same_state(torch, f"tile_rows=0 (picked {rec['tile_rows']}) vs the tile rule",
               tuned.state, plain_tile.state, FIELD_EXACT)
    log(f"  autotune record: {json.dumps(rec)} [{card}]")

    scfg = cfgmod.FieldConfig(**SPLIT_FIELD, frames=1, mesh_axes=("x", None), exchange_steps=0)
    x2 = parallel.make_mesh([("x", 2)], devices="cuda:0")
    fact = actions.get_field(scfg.action)
    admitted, skipped = autotune.exchange_steps_candidates(fact, scfg, x2)
    chunks = lambda W: scfg.loops // W + (1 if scfg.loops % W else 0)  # noqa: E731
    tune_chunks = (1 + autotune._TUNE_REPS) * autotune._TUNE_FRAMES * 2 * sum(map(chunks, admitted))
    recs = []
    res = [None]

    def split_run():
        res[0] = runtime.run_field(scfg, mesh=x2, sink=metrics.MetricsSink(callback=recs.append))
    for c in counters.values():
        c.launches = 0
    t0 = time.time()
    split_run()
    torch.cuda.synchronize()
    rec = recs[0]
    want = tune_chunks + 2 * chunks(rec["exchange_steps"])
    got = {k: c.launches for k, c in counters.items() if c.launches}
    log(f"  run_field {scfg.shape} x {scfg.n_chains} loops {scfg.loops} x=2 exchange_steps=0 "
        f"(kernel 7 for W in {admitted}; skipped {skipped}): {time.time() - t0:.2f}s, "
        f"launches {got}")
    if got != {"field_chunk_nd": want} or rec["type"] != "autotune" or \
            sorted(map(int, rec["candidates_ms"])) != admitted:
        raise SystemExit(f"exchange_steps=0: launches {got} (expected {want}), record {rec}")
    totals.update(got)
    check_records(recs, "exchange_steps=0", ("mag", "phi2", "binder"))
    unsplit = runtime.run_field(dataclasses.replace(scfg, mesh_axes=None, exchange_steps=None),
                                device="cuda", backend="cuda", sink=metrics.MetricsSink())
    same_state(torch, f"exchange_steps=0 (picked W={rec['exchange_steps']}) x=2 vs unsplit "
               f"kernel 3", res[0].state, unsplit.state, FIELD_EXACT)
    log(f"  autotune record: {json.dumps(rec)} [{card}]")

    # (d) the reference "%a" format from a card state
    state = uninterrupted
    ref_path = tmp / "headline_chain5.txt"
    checkpoint.export_reference(ref_path, state, chain=5)
    icfg = dataclasses.replace(base, n_chains=2)
    imp = checkpoint.import_reference(ref_path, icfg, "cuda")
    pairs = (("f", imp.f[1], state.f[5]), ("x_mean", imp.x_mean[0], state.x_mean[5]),
             ("xx0_mean", imp.xx0_mean[1], state.xx0_mean[5]),
             ("omega", imp.omega[0], state.omega[5]),
             ("dtau", imp.dtau[0], torch.clamp(state.dtau[5], max=icfg.dtau)),
             ("runs", imp.runs[1], state.runs[5]))
    for name, x, y in pairs:
        if not torch.equal(x, y):
            raise SystemExit(f"export_reference -> import_reference: {name} differs")
    if int(imp.step) != 0 or not torch.equal(imp.lrg_vl, imp.f.abs().amax(dim=1)):
        raise SystemExit("import_reference: step or lrg_vl not as the reference reader's")
    log(f"  export_reference -> import_reference of chain 5 of the headline state: f, means, "
        f"omega, runs and the clamped dtau bitwise ({ref_path.stat().st_size} bytes)")
    return dict(totals), out


# ---------------------------------------------------------------------------
# [30] lattices split across processes on the card
# ---------------------------------------------------------------------------

#: one process of [30]: its shards of a global mesh on cuda:0 through
#: runtime.run_field / run_gauge, job by job (launch counters at 0 before each
#: run), with gloo's all-gathers made to raise: no collective of CUDA tensors
#: goes through gloo or the host.  No JAX anywhere.
LATTICE_WORKER = r"""
import json, sys, time
import torch
from stochquant_tpu_torch import metrics, runtime
from stochquant_tpu_torch.config import FieldConfig
from stochquant_tpu_torch.integrators.gauge import GaugeConfig
from stochquant_tpu_torch.kernels import field_halo_kernel as fh, field_kernel as fk
from stochquant_tpu_torch.kernels import field_kernel_nd as nd, gauge_kernel as gk
from stochquant_tpu_torch.parallel import distributed, ipc

rank, world, store, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
jobs = json.loads(open(sys.argv[5]).read())
distributed.initialize(f"file://{store}", world_size=world, rank=rank, timeout_s=120)

def refuse(*args, **kw):
    raise AssertionError("a collective of CUDA tensors reached gloo")

distributed.all_gather = torch.distributed.all_gather = refuse
counters = {"field_frame": fk.field_frame, "field_chunk_nd": nd.field_chunk_nd,
            "field_chunk_rdma_nd": nd.field_chunk_rdma_nd, "field_halo_step": fh.field_halo_step,
            "gauge_chunk": gk.gauge_chunk}
report = {"rank": rank, "jobs": {}}
# the transport's set-up alone: counters, handles, the board, kernel 8's two slabs a shard
mesh = distributed.global_mesh([tuple(a) for a in jobs[0]["mesh"]], devices="cuda:0")
torch.cuda.synchronize()
t0 = time.perf_counter()
transport = ipc.Transport(mesh)
transport.publish([torch.zeros(4, device="cuda:0")] * mesh.size).done()
ipc.Ring(transport, jobs[0]["slab"])
torch.cuda.synchronize()
report["ipc_setup_s"] = time.perf_counter() - t0
transport.close()
for job in jobs:
    mesh = distributed.global_mesh([tuple(a) for a in job["mesh"]], devices="cuda:0")
    is_field = job["kind"] == "field"
    cfg = (FieldConfig if is_field else GaugeConfig).from_json(job["cfg"])
    recs = []
    for c in counters.values():
        c.launches = 0
    torch.cuda.synchronize()
    distributed.barrier()
    t0 = time.perf_counter()
    res = (runtime.run_field if is_field else runtime.run_gauge)(
        cfg, mesh=mesh, backend=job["backend"], sink=metrics.MetricsSink(callback=recs.append),
        checkpoint_out=job.get("out"), checkpoint_in=job.get("in"),
        resume_progress=bool(job.get("in")))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    torch.save({"shards": [{n: x.cpu() for n, x in zip(s._fields, s)} for s in res.state],
                "records": recs}, f"{tmp}/{job['name']}.rank{rank}.pt")
    report["jobs"][job["name"]] = {
        "seconds": seconds, "launches": {k: c.launches for k, c in counters.items() if c.launches}}
distributed.barrier()
torch.distributed.destroy_process_group()
assert "jax" not in sys.modules and "stochquant_tpu" not in sys.modules
print("WORKER " + json.dumps(report), flush=True)
"""


def spawn_lattice_workers(tmp: Path, tag: str, world: int, jobs: list, limit: float) -> list:
    """``world`` processes of [30] on the card running ``jobs``; each must
    exit 0 within ``limit`` seconds (a hang is killed and fails the phase).
    Returns their reports in rank order."""
    import os

    script = tmp / "lattice_worker.py"
    script.write_text(LATTICE_WORKER)
    (tmp / f"{tag}.json").write_text(json.dumps(jobs))
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""),
               CUDA_MODULE_LOADING="EAGER")
    procs = [subprocess.Popen([sys.executable, str(script), str(r), str(world),
                               str(tmp / f"store_{tag}"), str(tmp), str(tmp / f"{tag}.json")],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=limit)[0])
    except subprocess.TimeoutExpired:
        raise SystemExit(f"[30]({tag}): a worker did not finish within {limit:g} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    reports = []
    for r, (p, out) in enumerate(zip(procs, outs)):
        line = next((ln for ln in out.splitlines() if ln.startswith("WORKER ")), None)
        if p.returncode != 0 or line is None:
            raise SystemExit(f"[30]({tag}) rank {r} failed ({p.returncode}):\n{out[-4000:]}")
        reports.append(json.loads(line[len("WORKER "):]))
    return reports


def frame_ms(recs: list):
    """Milliseconds a frame between a run's first and last frame records (the
    first frame holds the run's set-up); None for a run of one frame."""
    wall = [r["wall_time"] for r in recs if r["type"] == "frame"]
    return (wall[-1] - wall[0]) / (len(wall) - 1) * 1e3 if len(wall) > 1 else None


def phase_across_processes(torch, mods, tmp: Path, card: str):
    """[30]: (a) field 256^2 x 16 loops 50 W = 8 at x = 2 over two processes
    on cuda:0 through cuda_rdma (kernel 8 reading its neighbour's slab in the
    other process's memory), cuda (kernel 7) and cuda_step (kernel 9); (b)
    32^4 x 8 loops 20 W = 2 at x = 4 over four processes, cuda_rdma and cuda;
    (c) gauge u1 256^2 x 32 loops 100 and su3 64^2 x 8 loops 50 at x = 2 on
    the chunk runner (kernel 12), u1 one frame of the per-step runner; (d)
    (a)'s cuda_rdma run saved after 2 frames (save_sharded) and resumed by two
    new processes for the 3rd.  Every process's shards, decisions and records
    bitwise the one-process run on the repeated-device mesh (run first, in
    this process), launches per kernel and process exactly the one-process
    run's over the number of processes.  Returns (launches summed over the
    processes, timings)."""
    import dataclasses

    runtime, metrics, cfgmod = mods["runtime"], mods["metrics"], mods["cfgmod"]
    gauge, parallel, mesh_mod, counters = (mods[k] for k in ("gauge", "parallel", "mesh_mod",
                                                             "counters"))

    field = cfgmod.FieldConfig(**SPLIT_FIELD, frames=3, mesh_axes=("x", None))
    nd4 = cfgmod.FieldConfig(**{**BENCH_ND, "n_chains": 8, "exchange_steps": 2, "frames": 2},
                             mesh_axes=("x", None, None, None))
    u1 = gauge.GaugeConfig(**BENCH_GAUGE["u1"], frames=2, mesh_axes=("x", None))
    su3 = gauge.GaugeConfig(**BENCH_GAUGE["su3"], frames=1, mesh_axes=("x", None))
    ck = str(tmp / "across_rdma")
    x2, x4 = [("x", 2)], [("x", 4)]

    def job(name, kind, mesh, backend, cfg, **kw):
        slab = [cfg.n_chains, cfg.shape[0] // mesh[0][1], *cfg.shape[1:]]
        return {"name": name, "kind": kind, "mesh": mesh, "backend": backend,
                "cfg": cfg.to_json(), "slab": slab, **kw}

    two = [job("a cuda_rdma", "field", x2, "cuda_rdma", field),
           job("a cuda", "field", x2, "cuda", field),
           job("a cuda_step", "field", x2, "cuda_step", field),
           job("d first 2 frames", "field", x2, "cuda_rdma", dataclasses.replace(field, frames=2),
               out=ck),
           job("c u1 chunk", "gauge", x2, "cuda", u1),
           job("c su3 chunk", "gauge", x2, "cuda", su3),
           job("c u1 per-step", "gauge", x2, "auto", dataclasses.replace(u1, frames=1))]
    four = [job("b cuda_rdma", "field", x4, "cuda_rdma", nd4),
            job("b cuda", "field", x4, "cuda", nd4)]
    resume = [job("d resumed 3rd frame", "field", x2, "cuda_rdma", field, **{"in": ck})]

    # the one-process runs on the repeated-device mesh, first (the card to itself)
    ref = {}
    for j in two + four:
        if j["name"].startswith("d "):
            continue
        mesh = parallel.make_mesh(j["mesh"], devices="cuda:0")
        cls = cfgmod.FieldConfig if j["kind"] == "field" else gauge.GaugeConfig
        cfg = cls.from_json(j["cfg"])
        recs = []
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        res = (runtime.run_field if j["kind"] == "field" else runtime.run_gauge)(
            cfg, mesh=mesh, backend=j["backend"], sink=metrics.MetricsSink(callback=recs.append))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        shards = mesh_mod.shard_state(res.state, mesh_mod.state_spec(type(res.state), cfg), mesh)
        ref[j["name"]] = {"shards": shards, "records": recs, "seconds": seconds,
                          "launches": {k: c.launches for k, c in counters.items() if c.launches}}
        check_records(recs, f"[30] one process, {j['name']}",
                      ("mag", "phi2") if j["kind"] == "field" else ("plaquette", "drift_max"))

    t0 = time.perf_counter()
    reports = {"two": spawn_lattice_workers(tmp, "two", 2, two, 420)}
    reports["four"] = spawn_lattice_workers(tmp, "four", 4, four, 300)
    reports["resume"] = spawn_lattice_workers(tmp, "resume", 2, resume, 180)
    log(f"  [30] the workers took {time.perf_counter() - t0:.1f} s; IPC set-up s a process: "
        + ", ".join(f"{tag} {[round(r['ipc_setup_s'], 3) for r in rs]}"
                    for tag, rs in reports.items()) + f" [{card}]")

    def joined(name, world):
        parts = [torch.load(tmp / f"{name}.rank{r}.pt", weights_only=False) for r in range(world)]
        return [s for p in parts for s in p["shards"]], [p["records"] for p in parts]

    def same_shards(label, got, want):
        if len(got) != len(want):
            raise SystemExit(f"[30] {label}: {len(got)} shards, the one-process run {len(want)}")
        for g, w in zip(got, want):
            for name in w._fields:
                if not torch.equal(g[name], getattr(w, name).cpu()):
                    raise SystemExit(f"[30] {label}: {name} is not bitwise the one-process run's")

    launches, timings = collections.Counter(), {}
    for tag, jobs in (("two", two), ("four", four)):
        world = len(reports[tag])
        for j in jobs:
            name = j["name"]
            got, recs = joined(name, world)
            per = [r["jobs"][name]["launches"] for r in reports[tag]]
            if name.startswith("d "):
                want_launches = {k: v * 2 // 3 for k, v in ref["a cuda_rdma"]["launches"].items()}
            else:
                want_launches = ref[name]["launches"]
                same_shards(name, got, ref[name]["shards"])
                for r in recs:
                    same_records(f"[30] {name}", r, ref[name]["records"])
            for rank, p in enumerate(per):
                want = {k: v // world for k, v in want_launches.items()}
                if p != want:
                    raise SystemExit(f"[30] {name} rank {rank}: launches {p}, expected {want}")
                launches.update(p)
            if name.startswith("d "):
                continue
            ms = [frame_ms(r) for r in recs]
            one = frame_ms(ref[name]["records"])
            timings[name] = {"ms_per_frame": ms, "one_process_ms_per_frame": one,
                             "processes": world}
            if one is not None:
                rate = f"ms a frame {[round(m, 1) for m in ms]} against {one:.1f} in one process"
            else:
                secs = [round(r["jobs"][name]["seconds"], 2) for r in reports[tag]]
                rate = (f"one frame: {secs} s a process against {ref[name]['seconds']:.2f} s in "
                        "one process")
            log(f"  [30]({name[0]}) {name[2:]} over {world} processes: shards, decisions and "
                f"records bitwise the one-process run; launches a process {per[0] or 'none'}; "
                f"{rate} [{card}]")
    # (d): the resumed processes against the uninterrupted runs of (a)
    got, recs = joined("d resumed 3rd frame", 2)
    same_shards("(d) resumed vs one process", got, ref["a cuda_rdma"]["shards"])
    uninterrupted, _ = joined("a cuda_rdma", 2)
    for g, w in zip(got, uninterrupted):
        if any(not torch.equal(g[k], w[k]) for k in w):
            raise SystemExit("[30](d): the resumed run is not bitwise the uninterrupted one")
    third = [r for r in ref["a cuda_rdma"]["records"] if r["type"] == "frame"][2:]
    for r in recs:
        same_records("[30](d) resumed", [x for x in r if x["type"] == "frame"], third)
    per = [r["jobs"]["d resumed 3rd frame"]["launches"] for r in reports["resume"]]
    want = {k: v // 3 // 2 for k, v in ref["a cuda_rdma"]["launches"].items()}
    if any(p != want for p in per):
        raise SystemExit(f"[30](d) resumed: launches {per}, expected {want} a process")
    for p in per:
        launches.update(p)
    log(f"  [30](d) cuda_rdma saved after 2 frames (save_sharded, one file a process), resumed by "
        f"two new processes for the 3rd: shards and record bitwise the uninterrupted runs; "
        f"launches a process {per[0]}")
    if not launches["field_chunk_rdma_nd"]:
        raise SystemExit("[30]: kernel 8 did not launch across processes")
    timings["ipc_setup_s"] = {tag: [r["ipc_setup_s"] for r in rs] for tag, rs in reports.items()}
    return dict(launches), timings


def preset_width(cfg) -> str:
    shape = getattr(cfg, "shape", None) or (getattr(cfg, "n_sites", None),)
    shape = tuple(s for s in shape if s is not None)
    return f"{cfg.n_chains} chains" + (f" x {'x'.join(map(str, shape))}" if shape else "")



def main() -> int:
    global LOG_FILE
    if not (ROOT / "stochquant_tpu_torch").is_dir():
        print("chip_smoke.py: run it from a checkout of the repository "
              "(stochquant_tpu_torch/ not found beside it)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import torch

    # 1. device
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device available; the port's smoke test "
              "needs a GPU and has no CPU path", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    if len(sys.argv) == 3 and sys.argv[1] == "--log":
        Path(sys.argv[2]).parent.mkdir(parents=True, exist_ok=True)
        LOG_FILE = open(sys.argv[2], "w")
    elif len(sys.argv) > 1:
        print("usage: python3 chip_smoke.py [--log PATH]", file=sys.stderr)
        return 2
    card = card_line()
    log(f"[1] device: {name}; torch {torch.__version__} CUDA {torch.version.cuda}; "
        f"nvidia-smi: {card}")

    from stochquant_tpu_torch import actions, cli, metrics, runtime
    from stochquant_tpu_torch import config as cfgmod
    from stochquant_tpu_torch.integrators import field, gauge, langevin
    from stochquant_tpu_torch.io import checkpoint
    from stochquant_tpu_torch.kernels import _build
    from stochquant_tpu_torch.kernels import chain_kernel as ck
    from stochquant_tpu_torch.kernels import field_kernel as fk
    from stochquant_tpu_torch.kernels import field_kernel_nd as nd
    from stochquant_tpu_torch.kernels import field_kernel_tiled as ft
    from stochquant_tpu_torch.kernels import field_halo_kernel as fh
    from stochquant_tpu_torch.kernels import gauge_kernel as gk
    from stochquant_tpu_torch import parallel
    from stochquant_tpu_torch.parallel import gauge_halo, halo

    # 2. build
    t0 = time.time()
    _build.library()
    log(f"[2] build: {time.time() - t0:.1f}s into {_build.build_dir()}")
    nvcc_log = (_build.build_dir() / "nvcc.log").read_text().strip()
    log(nvcc_log)
    for line in resource_summary(nvcc_log, ("field_pair_kernel", "field_nd_kernel")):
        log("  " + line)

    # 3. chain kernels vs plain on the card
    log("[3] chain kernels vs plain PyTorch version on the card (every float leaf within "
        f"{GATE:g}, exact leaves equal):")
    phase_gate(ck, langevin, actions, cfgmod, device)

    with tempfile.TemporaryDirectory() as tmp:
        # 4. chain main path
        log("[4] chain main path: cli run --preset double_well --chains 65536 --dtau 2e-4:")
        launches, main_k2_err = phase_main_path(torch, ck, cli, checkpoint, actions, Path(tmp))

        # 5. chain timings, with kernel vs plain at the main path's shapes
        log(f"[5] chain timings [{card}]:")
        with CardSampler("[5]"):
            t = phase_timings(torch, device, ck, langevin, actions, cfgmod, card)

        # 6. field kernels vs plain on the card
        log(f"[6] field kernels vs plain PyTorch versions on the card (exact leaves equal; φ, "
            f"lrg, Δτ, maxima within {GATE:g}; site sums within rtol {FIELD_RTOL:g}, atol "
            f"{FIELD_ATOL:g}):")
        phase_field_gate(torch, fk, ft, field, actions, cfgmod, device)

        # 7. field main path
        log("[7] field main path: cli run --preset phi4_2d --chains 16 --frames-per-launch 2, "
            "then with --tile-rows 64 and --tile-rows 0 (the strip rule's height):")
        field_launches, field_err, pair_256_ms = phase_field_main_path(
            torch, fk, ft, cli, checkpoint, actions, Path(tmp), card)
        launches.update(field_launches)

        # 8. tiled at a size that needs it
        log("[8] tiled at 1024^2 x 16 through runtime.run_field (auto):")
        large = phase_field_tiled_large(torch, ft, runtime, metrics, cfgmod, actions, Path(tmp),
                                        card)

    # 9. field timings, with kernel vs plain at the timed shapes
    log(f"[9] field timings [{card}]:")
    with CardSampler("[9]"):
        t.update(phase_field_timings(torch, device, fk, ft, field, actions, cfgmod, large, card))

    # 10. gauge kernels vs plain on the card
    log(f"[10] gauge kernels vs plain PyTorch versions on the card (exact leaves equal; links, "
        f"Δτ, drift_max within {GATE:g}; plaq_mean within rtol {FIELD_RTOL:g}, atol "
        f"{FIELD_ATOL:g}):")
    phase_gauge_gate(torch, gk, gauge, device)

    with tempfile.TemporaryDirectory() as tmp:
        # 11. gauge main path
        log("[11] gauge main path: cli run --preset u1_2d / su3_2d --chains 256 "
            "--frames-per-launch 2 --burn 2:")
        gauge_launches, gauge_main_err = phase_gauge_main_path(torch, gk, gauge, cli, checkpoint,
                                                               Path(tmp))
        launches.update(gauge_launches)

    # 12. gauge timings at bench.py's shapes, with kernel vs plain there
    log(f"[12] gauge timings [{card}]:")
    with CardSampler("[12]"):
        t.update(phase_gauge_timings(torch, device, gk, gauge, card))

    # 13. D-dim field kernels vs plain on the card
    log(f"[13] D-dim field kernels vs plain PyTorch versions on the card (exact leaves equal; "
        f"φ, lrg, Δτ, maxima within {GATE:g}; per-block and slice means within rtol "
        f"{FIELD_RTOL:g}, atol {FIELD_ATOL:g}):")
    phase_nd_gate(torch, nd, ft, field, actions, cfgmod, device)

    with tempfile.TemporaryDirectory() as tmp:
        # 14. D-dim main path
        log("[14] D-dim main path: cli run --preset phi4_4d --chains 4 --loops 20, then with "
            "--exchange-steps 4:")
        nd_launches, nd_main_err = phase_nd_main_path(torch, nd, cli, checkpoint, actions,
                                                      Path(tmp))
        launches.update(nd_launches)

    # 15. D-dim timings at bench.py's 32^4 cell, with kernel vs plain there
    log(f"[15] D-dim field timings [{card}]:")
    with CardSampler("[15]"):
        t.update(phase_nd_timings(torch, device, nd, field, actions, cfgmod, card))

    # 16, 17. kernels 9 and 12 vs plain on the card
    log(f"[16] kernel 9 (field_halo_step) vs its plain PyTorch version on the card (new φ, the "
        f"maxima within {GATE:g}, the count exact; means within rtol {FIELD_RTOL:g}, atol "
        f"{FIELD_ATOL:g}):")
    phase_halo_step_gate(torch, fh, field, actions, cfgmod, device)
    log(f"[17] kernel 12 (gauge_chunk) vs its plain PyTorch version on the card (flags exact; "
        f"links, drift max within {GATE:g}; plaquette mean within rtol {FIELD_RTOL:g}, atol "
        f"{FIELD_ATOL:g}):")
    phase_gauge_chunk_gate(torch, gk, gauge, device)

    mods = dict(runtime=runtime, metrics=metrics, cfgmod=cfgmod, gauge=gauge, field=field,
                actions=actions, parallel=parallel, halo=halo, gauge_halo=gauge_halo, fh=fh, gk=gk,
                nd=nd,
                counters={"field_frame": fk.field_frame, "field_frames_multi": fk.field_frames_multi,
                          "field_pair": ft.field_pair, "field_pair_nd": nd.field_pair_nd,
                          "field_step_nd": nd.field_step_nd, "field_chunk_nd": nd.field_chunk_nd,
                          "field_chunk_rdma_nd": nd.field_chunk_rdma_nd,
                          "field_halo_step": fh.field_halo_step,
                          "gauge_frame": gk.gauge_frame,
                          "gauge_frames_multi": gk.gauge_frames_multi,
                          "gauge_chunk": gk.gauge_chunk})
    with tempfile.TemporaryDirectory() as tmp:
        # 18. the lattice-split main paths
        log("[18] lattice-split main paths: runtime.run_field / run_gauge with a mesh on the one "
            "card (field 256^2 x 16 loops 50; gauge u1 256^2 x 32 loops 100, su3 64^2 x 8 loops "
            "50):")
        split_launches, split_err = phase_split_main_path(torch, mods, Path(tmp))
    for k, v in split_launches.items():  # a kernel on several main paths: the sum of its runs
        launches[k] = launches.get(k, 0) + v

    # 19. timings of the split paths, with kernels 9 and 12 vs plain at those shapes
    log(f"[19] lattice-split timings [{card}]:")
    with CardSampler("[19]"):
        t.update(phase_split_timings(torch, mods, card))

    # 20. the Philox variants of kernels 1-4 vs plain on the card
    log(f"[20] rng_impl='hardware': the Philox variants of kernels 1-4 vs their plain PyTorch "
        f"versions on the card, on the cases of [3] and [6] (limits as there; kernel 1 + "
        f"epilogue and kernel 2, kernel 3 + epilogue and kernel 4 bitwise equal):")
    phase_philox_gate(torch, ck, fk, langevin, field, actions, cfgmod, device)

    mods.update(ck=ck, fk=fk, ft=ft, cli=cli, checkpoint=checkpoint, langevin=langevin)
    with tempfile.TemporaryDirectory() as tmp:
        # 21. the --rng hardware main paths
        log("[21] --rng hardware main paths: cli run --preset double_well --chains 65536 --dtau "
            "2e-4, runtime.run_chain on config 2 (frames_per_launch 16), cli run --preset "
            "phi4_2d --chains 16:")
        hw_launches, hw_err = phase_philox_main_path(torch, mods, Path(tmp), card)
        launches.update(hw_launches)

        # 22. the schemes of the plain path, on the card
        log(f"[22] plain-path schemes on the card (no kernel in either package): quartic_large, "
            f"harmosc --scheme lm / exact, phi4_2d --scheme exact, free_field Scheme.EXACT "
            f"[{card}]:")
        with CardSampler("[22]"):
            t.update(phase_plain_schemes(torch, mods, Path(tmp), card))

    # 23. Philox beside Threefry, and each Philox variant vs plain at the timed shapes
    log(f"[23] rng_impl='hardware' timings beside threefry [{card}]:")
    with CardSampler("[23]"):
        t.update(phase_philox_timings(torch, device, ck, fk, langevin, field, actions, cfgmod,
                                      card))

    # 24. kernel 8 and the one-step tail vs plain on the card
    t_rdma = time.perf_counter()
    log(f"[24] kernel 8 (field_chunk_rdma_nd) vs its plain version (φ bitwise; maxima within "
        f"{GATE:g}; sums within rtol {FIELD_RTOL:g}, atol {FIELD_ATOL:g}) and vs kernel 7 on the "
        f"extended block (bitwise); the one-step tail of kernel 6's code and odd-loops frames vs "
        f"plain:")
    phase_rdma_gate(torch, nd, ft, field, actions, cfgmod, parallel, device)

    with tempfile.TemporaryDirectory() as tmp:
        # 25. kernel 8's main path, and phi4_4d with an odd loops
        log("[25] kernel 8's main path: runtime.run_field with a mesh of the one card, "
            "backend cuda_rdma and auto with prefer_rdma (field 256^2 x 16 loops 50 at x=2 and "
            "on the ring of one; 32^4 x 8 loops 20 at x=2), then cli run --preset phi4_4d "
            "--loops 21:")
        rdma_launches, rdma_err = phase_rdma_main_path(torch, mods, Path(tmp))
    for k, v in rdma_launches.items():
        launches[k] = launches.get(k, 0) + v

    # 26. kernel 8 beside kernel 7 in turns
    log(f"[26] cuda_rdma (kernel 8) beside cuda / cuda_pair (kernel 7) [{card}]:")
    with CardSampler("[26]"):
        t.update(phase_rdma_timings(torch, mods, card))
    log(f"  phases [24]-[26] took {time.perf_counter() - t_rdma:.1f} s")

    with tempfile.TemporaryDirectory() as tmp:
        # 27. complex Langevin: complex actions and complexified gauge groups
        t_cl = time.perf_counter()
        log(f"[27] complex Langevin on the card (no kernel in either package): cli run on "
            f"{', '.join(CL_PRESETS)}; card vs CPU; known answers; rates [{card}]:")
        with CardSampler("[27]"):
            t.update(phase_complex_langevin(torch, mods, Path(tmp), card))
        log(f"  phase [27] took {time.perf_counter() - t_cl:.1f} s")

    from stochquant_tpu_torch.kernels import autotune
    from stochquant_tpu_torch.parallel import mesh as mesh_mod

    mods.update(autotune=autotune, mesh_mod=mesh_mod)
    with tempfile.TemporaryDirectory() as tmp:
        # 28. chains over a mesh and across processes, sharded checkpoints, autotune,
        # the reference format
        t_mesh = time.perf_counter()
        log(f"[28] run_chain(mesh=) on the headline (2 shards on cuda:0), two processes (gloo), "
            f"sharded checkpoints, tile_rows=0 / exchange_steps=0, the reference format [{card}]:")
        with CardSampler("[28]"):
            mesh_launches, mesh_t = phase_chain_mesh(torch, mods, Path(tmp), card)
        t.update(mesh_t)
        for k, v in mesh_launches.items():
            launches[k] = launches.get(k, 0) + v
        log(f"  phase [28] took {time.perf_counter() - t_mesh:.1f} s; its launches {mesh_launches}")

    from stochquant_tpu_torch import physics_gates

    with tempfile.TemporaryDirectory() as tmp:
        # 29. the physics gates at full width
        t_phys = time.perf_counter()
        log(f"[29] physics at full width on the card: the JAX package's statistical gates through "
            f"kernels 1-7 and 10 against exact answers [{card}]:")
        with CardSampler("[29]"):
            checks, phys_launches = physics_gates.run_gates(device, Path(tmp), log=log)
        log(f"  phase [29] took {time.perf_counter() - t_phys:.1f} s: {len(checks)} checks; its "
            f"launches {phys_launches}")
        failed = [c.line() for c in checks if not c.passed]
        if failed:
            raise SystemExit("[29] physics gates failed:\n" + "\n".join(failed))
        idle = [k for k in PHYSICS_KERNELS if not phys_launches.get(k)]
        if idle:
            raise SystemExit(f"[29]: kernels {idle} did not launch")
        for k, v in phys_launches.items():
            launches[k] = launches.get(k, 0) + v

    with tempfile.TemporaryDirectory() as tmp:
        # 30. lattices split across processes on the card
        t_across = time.perf_counter()
        log(f"[30] lattices split across processes on cuda:0 (gloo for the handles, CUDA IPC and "
            f"stream counters for the data), bitwise the one-process runs [{card}]:")
        with CardSampler("[30]"):
            across_launches, across_t = phase_across_processes(torch, mods, Path(tmp), card)
        for k, v in across_launches.items():
            launches[k] = launches.get(k, 0) + v
        log(f"  phase [30] took {time.perf_counter() - t_across:.1f} s; its launches "
            f"{across_launches}")

    # max_abs_err: the comparisons at the main paths' shapes (chain: headline
    # K=1, main-path state K=2, config 2 K=16; field: 256^2 x 16 K=1 and K=10,
    # main-path states K=2 and one tiled pair, 1024^2 x 16 tiled; gauge: the
    # three full-width cells K=1, the main-path states K=1 and K=2 and the
    # multiframe cells K=8)
    err = {"chain_frame": t["chain_frame_err"],
           "chain_frames_multi": max(main_k2_err, t["chain_frames_multi_err"]),
           "field_frame": t["field_frame_err"],
           "field_frames_multi": max(field_err["field_frames_multi"],
                                     t["field_frames_multi_err"]),
           "field_pair": max(field_err["field_pair"], t["field_pair_err"]),
           "field_pair_nd": max(nd_main_err["field_pair_nd"], t["field_pair_nd_err"],
                                rdma_err["field_step_nd"]),
           "field_chunk_nd": max(nd_main_err["field_chunk_nd"], t["field_chunk_nd_err"]),
           "field_chunk_rdma_nd": max(rdma_err["field_chunk_rdma_nd"],
                                      t["field_chunk_rdma_nd_err"]),
           "field_halo_step": max(split_err["field_halo_step"], t["field_halo_step_err"]),
           "gauge_chunk": max(split_err["gauge_chunk"], t["gauge_chunk_err"]),
           "gauge_frame": max(gauge_main_err["gauge_frame"], t["gauge_frame_err"]),
           "gauge_frames_multi": max(gauge_main_err["gauge_frames_multi"],
                                     t["gauge_frames_multi_err"]),
           "chain_frame_hw": t["chain_frame_hw_err"],
           "chain_frames_multi_hw": max(hw_err["chain_frames_multi_hw"],
                                        t["chain_frames_multi_hw_err"]),
           "field_frame_hw": t["field_frame_hw_err"],
           "field_frames_multi_hw": max(hw_err["field_frames_multi_hw"],
                                        t["field_frames_multi_hw_err"])}
    # library_ms: no single PyTorch call computes a fused frame, pair or chunk
    # of Langevin micro-steps with its noise, detector and observables
    bounds = kernel_bounds()
    kernels = [
        {"name": kname, "route": "cuda", "source": CSRC + src, "replaces": replaces,
         "launches": launches[kname], "max_abs_err": err[kname],
         "ms": t[kname + "_ms"], "plain_ms": t[kname + "_plain_ms"],
         "bound_ms": bounds[kname][0], "bound_by": bounds[kname][1], "library_ms": None}
        for kname, (src, replaces) in KERNELS.items()
    ]
    # kernels 3, 4, 10 and 11: the cluster geometry of the timed launch (10: u1;
    # 11: u1 at 256 chains)
    for kname, key in (("field_frame", "field_frame"), ("field_frames_multi", "field_frames_multi"),
                       ("field_frame_hw", "field_frame_hw"),
                       ("field_frames_multi_hw", "field_frames_multi_hw"),
                       ("gauge_frame", "gauge_u1"), ("gauge_frames_multi", "gauge_u1_multi")):
        k = next(k for k in kernels if k["name"] == kname)
        g = t[key + "_geometry"]
        k["cluster_B"], k["placement"] = g.B, g.placement
    # kernel 6's launches include the one-step tails of odd loops (its own code)
    pair_k = next(k for k in kernels if k["name"] == "field_pair_nd")
    pair_k["launches"] += launches["field_step_nd"]
    pair_k["tail_launches"] = launches["field_step_nd"]
    pair_k["tail_ms"] = t["field_step_nd_ms"]
    # kernel 5 at the main path's 256^2 x 16 ([7]): the strip rule's height and --tile-rows 64
    strip_k = next(k for k in kernels if k["name"] == "field_pair")
    strip_k["ms_256_by_tile_rows"] = {str(t0): v for t0, v in pair_256_ms.items()}
    # kernels 8, 9 and 12 also carry the profiler's device time per launch ("ms"
    # is CUDA events around the wrapper, as for every other kernel); 12 its
    # cluster geometry at the u1 shard
    halo_k = next(k for k in kernels if k["name"] == "field_halo_step")
    halo_k["device_us"] = t["field_halo_step_device_us"]
    chunk_k = next(k for k in kernels if k["name"] == "gauge_chunk")
    chunk_k["device_us"] = t["gauge_chunk_device_us"]
    chunk_k["cluster_B"] = t["gauge_chunk_geometry"].B
    chunk_k["placement"] = t["gauge_chunk_geometry"].placement
    rdma_k = next(k for k in kernels if k["name"] == "field_chunk_rdma_nd")
    rdma_k["device_us"] = t["rdma_field_x=2_cuda_rdma"].get("kernel_us")
    # [30]: launches in processes that read their neighbours' slabs through CUDA IPC
    rdma_k["launches_across_processes"] = across_launches.get("field_chunk_rdma_nd", 0)
    log(f"  field_halo_step: bound {halo_k['bound_ms'] * 1e3 / halo_k['device_us']:.2%} of the "
        f"kernel's device time of {halo_k['device_us']:.2f} µs (profiler) [{card}]")
    for k in kernels:
        log(f"  {k['name']:21s} {k['ms']:10.3f} ms/launch, bound {k['bound_ms']:.4f} ms by "
            f"{k['bound_by']}: {k['bound_ms'] / k['ms']:.2%} of the bound's rate [{card}]")
    for kname, key in (("gauge_frame", "gauge_{}_ms"), ("gauge_frames_multi", "gauge_{}_multi_ms"),
                       ("gauge_chunk", "gauge_chunk_{}_ms")):
        for group in ("su2", "su3"):
            if key.format(group) in t:
                b, by = bounds[f"{kname}_{group}"]
                ms = t[key.format(group)]
                log(f"  {kname + ' ' + group:19s} {ms:10.3f} ms/launch, bound {b:.4f} ms by {by}: "
                    f"{b / ms:.2%} of the bound's rate [{card}]")
    log(json.dumps({"kernels": kernels, "mlups": {
        k: v["mlups"] for k, v in t.items() if isinstance(v, dict)},
        "across_processes": across_t}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

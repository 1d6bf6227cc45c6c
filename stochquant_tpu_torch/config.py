"""Typed run configuration — a field-for-field copy of
``stochquant_tpu.config`` (enums, ``ChainConfig``, ``FieldConfig``,
``PRESETS``), so a config serializes to byte-identical JSON in both packages
and checkpoints interchange.  Only the dtype accessor differs:
``torch_dtype`` in place of the JAX package's ``jdtype``.

Field comments that name the Pallas backend describe the JAX package; in this
package the CUDA backend reads ``frames_per_launch`` (chain kernel 2 and
field kernel 4, K frames per launch), ``FieldConfig.tile_rows`` (the dim-0
rows one block of field kernels 5, 6 and 7 owns) and, for D >= 3 lattices,
``FieldConfig.exchange_steps`` (W > 2 runs frames through the W-step chunk
kernel 7 instead of the pair kernel 6), and ignores ``block_chains``, which
stays for checkpoint compatibility: one launch covers every chain (see
``kernels.chain_kernel.run_frames_kernel``; 0 records that layout).
``FieldConfig.mesh_axes`` / ``mesh_chain_axis`` split a field run over the
mesh given to ``runtime.run_field(mesh=)`` (``parallel.halo``), where
``exchange_steps`` is the chunk kernel's W; ``ChainConfig.mesh_chain_axis``
splits the chains over the mesh given to ``runtime.run_chain(mesh=)``.  The
value 0 of ``tile_rows`` (D >= 3) and ``exchange_steps`` is timed on the card
(``kernels.autotune``).  ``rng_impl="hardware"`` (the TPU's on-core generator
in the JAX package) selects the Philox-4x32-10 variants of chain kernels 1, 2
and field kernels 3, 4; every other path ignores it and draws Threefry-20, as
the JAX package's XLA paths do.
"""

from __future__ import annotations

import dataclasses
import enum
import json
from typing import Optional, Tuple

import torch


class BoundaryCondition(enum.IntEnum):
    """Lattice boundary condition for the Euclidean-time direction.

    The reference hardcodes mode 1 (``tau_kernel.cl:59``); mode 0 there has a
    sign bug at the right edge (flaw F3, ``tau_kernel.cl:96``) which is *not*
    reproduced here.
    """

    PERIODIC = 0
    FIXED_BG = 1   # ghost sites pinned to the background's asymptotic value
    DIRICHLET = 2  # field fixed to 0 at the edges


class Scheme(enum.IntEnum):
    """Langevin time-integration scheme."""

    EM = 0    # Euler–Maruyama (the reference's scheme): O(Δτ) stationary bias
    HEUN = 1  # stochastic Heun (predictor-corrector): O(Δτ²) bias — larger
              # steps at equal accuracy, ~2x drift evaluations per step
    LM = 2    # Leimkuhler–Matthews: noise = (ξ_k + ξ_{k+1})/2, one drift eval
              # per step, O(Δτ²) sampling bias — and *exact* stationary
              # covariance for Gaussian actions at any stable Δτ
    EXACT = 3  # exact Ornstein–Uhlenbeck propagator for the linearized
               # (BACKGROUND, frozen-ω) drift: f' = μ + e^{−BΔτ}(f−μ) + ζ
               # with ζ drawn at the exact transition covariance — zero
               # integration bias at ANY Δτ, unconditionally stable, and
               # the dense batched matmuls ride the MXU.  XLA path only;
               # Δτ stays fixed (nothing to adapt — the step is exact).


class Formulation(enum.IntEnum):
    """What the state variable represents."""

    DIRECT = 0       # evolve the full field x(t) with drift −δS/δx
    BACKGROUND = 1   # evolve fluctuations f(t) around x_cl(t, ω) with the
                     # linearized drift −V''(x_cl)·f and a Langevin-updated
                     # collective coordinate ω (the reference's formulation,
                     # tau_kernel.cl:111-117 + 103-110)


@dataclasses.dataclass(frozen=True)
class ChainConfig:
    """1-D Euclidean-time quantum mechanics run (the reference's domain)."""

    action: str = "harmonic"           # registry name, see actions/
    n_sites: int = 100                 # N — lattice sites in Euclidean time
    dt: float = 0.1                    # Δt — lattice spacing
    dtau: float = 0.3                  # Δτ — initial Langevin step
    n_chains: int = 1                  # batched independent chains (DP axis)
    noise_amp: float = 1.0             # c — noise amplitude (1 = physical)
    bc: BoundaryCondition = BoundaryCondition.FIXED_BG
    formulation: Formulation = Formulation.BACKGROUND
    scheme: "Scheme" = Scheme.EM
    accumulate_spectrum: bool = False  # per-step |rfft(x)|² running mean →
                                       # translation-averaged correlator
                                       # (XLA path only; no FFT in Pallas)
    rng_impl: str = "threefry"
    # "threefry": counter-based (20 rounds), layout-invariant,
    #   bit-reproducible across any sharding/blocking (the default contract).
    # "threefry13": the Random123 reduced-round variant (13 rounds — the
    #   library's documented BigCrush-passing minimum): same counter keying
    #   and layout invariance, ~35% fewer key-schedule ops on the noise
    #   path; a *different* stream than the 20-round default.
    # "hardware": pltpu.prng_random_bits in the fused kernel — faster, still
    #   deterministic for a fixed (seed, chain blocking), but trajectories
    #   differ from the threefry path and are not layout-invariant.
    # Rejection semantics are identical on BOTH paths: the step counter
    #   advances by `loops` whether a frame is accepted or rejected, so the
    #   retry frame always draws fresh noise (threefry: new counters;
    #   hardware: per-frame reseed keyed by the advanced step) — and a
    #   checkpoint-resumed replay of any frame is exact on either path.
    parisi: bool = True
    # BACKGROUND formulation: update the collective coordinate ω every
    # micro-step (the "Parisi trick", tau_kernel.cl:103-110).  False freezes
    # ω at its initial value — the reference's Windows launcher exposed
    # exactly this toggle (`parisi=0`, taumain_windows.py:145), and the
    # frozen-ω chain is an exactly solvable Gaussian, giving the BACKGROUND
    # moment oracle gates (observables/exact.py:background_gaussian_moments).
    ghost_override: Optional[Tuple[float, float]] = None
    # FIXED_BG ghost values (left, right) for the *full field*; overrides the
    # action's asymptotes.  The reference's BC mode 1 pins ±η for every
    # potential — including the harmonic oscillator (tau_kernel.cl:247-256,
    # boundary() ignores `pot`) — so set (−0.8, 0.8) for exact parity there.
    loops: int = 1000                  # micro-steps per frame (kernel launch)
    frames: int = 5000                 # macro-steps
    frames_per_launch: int = 1         # Pallas backend: frames batched per
                                       # kernel launch with the accept/reject
                                       # + Δτ epilogue in-kernel (>1 removes
                                       # the per-frame launch/epilogue
                                       # round-trip — the win at small chain
                                       # counts; per-frame semantics
                                       # unchanged)
    block_chains: Optional[int] = None  # Pallas backend chain-block size:
                                        # None = heuristic (min(C, 256));
                                        # 0 = autotune on device at first
                                        # use (kernels/autotune.py — one
                                        # compile per candidate, worth it
                                        # for long runs); >0 = explicit
    fps: int = 1                       # stream observables every `fps` frames
    seed: int = 0
    dtype: str = "float32"             # TPU-native; fp64 only for CPU checks
    clamp: float = 1000.0              # |f| clamp (tau_kernel.cl:61)
    shrink: float = 0.95               # Δτ ← shrink·Δτ on divergence
    grow_after: int = 10               # grow Δτ after this many stable frames
    dtau_max: Optional[float] = None   # cap for adaptive growth (None = initial)
    mesh_chain_axis: Optional[str] = None  # shard chains over this mesh axis

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "ChainConfig":
        d = json.loads(s)
        d["bc"] = BoundaryCondition(d["bc"])
        d["formulation"] = Formulation(d["formulation"])
        d["scheme"] = Scheme(d.get("scheme", 0))
        if d.get("ghost_override") is not None:
            d["ghost_override"] = tuple(d["ghost_override"])
        return cls(**d)


class Sweep(enum.IntEnum):
    """Site-update ordering for field lattices."""

    SYNC = 0          # synchronous full-lattice update (reference semantics)
    CHECKERBOARD = 1  # even/odd half-sweeps; odd sites see fresh even values


@dataclasses.dataclass(frozen=True)
class FieldConfig:
    """D-dimensional scalar field theory run (2-D / 4-D φ⁴)."""

    action: str = "phi4"
    shape: Tuple[int, ...] = (256, 256)    # lattice sites per dimension
    spacing: float = 1.0                   # lattice spacing a (isotropic)
    sweep: "Sweep" = Sweep.SYNC
    scheme: "Scheme" = Scheme.EM
    # EM (default) or EXACT — the exact OU propagator for the FREE (Gaussian)
    # field sector, applied per Fourier mode (rfftn diagonalizes the periodic
    # Laplacian): zero integration bias at ANY Δτ, unconditionally stable
    # (r4 — the field-theory extension of ChainConfig's Scheme.EXACT).
    # XLA path, SYNC sweep, action='free_field' only; Δτ stays fixed.
    rng_impl: str = "threefry"
    # "threefry": counter-based (20 rounds), layout-invariant (the default
    #   contract).
    # "threefry13": reduced-round counter variant (see ChainConfig) — still
    #   layout-invariant, a different stream.
    # "hardware": pltpu.prng_random_bits in the fused field kernels —
    #   faster, deterministic for a fixed (seed, chain) assignment, but
    #   trajectories differ from the threefry path and are not
    #   layout-invariant; ignored by the XLA/halo paths.
    dtau: float = 0.01
    n_chains: int = 1
    noise_amp: float = 1.0
    loops: int = 100
    frames: int = 100
    frames_per_launch: int = 1         # whole-lattice Pallas backend: frames
                                       # batched per kernel launch with the
                                       # accept/reject + Δτ epilogue in-kernel
                                       # (per-frame semantics unchanged)
    fps: int = 1
    seed: int = 0
    dtype: str = "float32"
    clamp: float = 1000.0
    shrink: float = 0.95
    grow_after: int = 10
    dtau_max: Optional[float] = None
    mesh_axes: Optional[Tuple[Optional[str], ...]] = None  # per-lattice-dim
    mesh_chain_axis: Optional[str] = None
    #: Pallas backend: rows per lattice tile for the HBM-resident tiled
    #: kernel (lattices too large for one VMEM-resident program).  None =
    #: whole-lattice-in-VMEM kernel (2-D) / budget heuristic (D >= 3);
    #: 0 = autotune on device at first use (D >= 3 only,
    #: kernels/autotune.best_tile_rows — one compile per candidate).
    tile_rows: Optional[int] = None
    #: Composed halo kernels (dim-0-split lattices): micro-steps advanced
    #: per halo exchange (the wide-halo / communication-avoiding knob, W).
    #: The kernel recomputes an H = W-deep (2W checkerboard; 8-aligned for
    #: 2-D) halo trapezoidally, so larger W trades redundant edge compute
    #: for W x fewer exchanges and launches with NO semantics change
    #: (per-step detector stats still come out of the kernel).  None =
    #: 2 for D >= 3, 8 for 2-D; 0 = autotune on device at first use
    #: (kernels/autotune.best_exchange_steps — one compile per candidate).
    #: Must be even when set explicitly.
    exchange_steps: Optional[int] = None
    #: Split runs on 'auto': take kernel 8 (backend='cuda_rdma', the chunk
    #: kernel that reads its dim-0 halo rows from the neighbour shards'
    #: slabs itself) where its rules admit the split: a dim-0-only split
    #: with the ring axis named, even loops and W, counter-based noise,
    #: float32, one hop, and every shard of a ring on one card.  Elsewhere
    #: 'cuda' (kernel 7 or 9) runs and run_field records why.  Off by
    #: default, as in the JAX package; ignored by every other route.
    prefer_rdma: bool = False

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "FieldConfig":
        d = json.loads(s)
        d["shape"] = tuple(d["shape"])
        d["sweep"] = Sweep(d.get("sweep", 0))
        d["scheme"] = Scheme(d.get("scheme", 0))
        if d.get("mesh_axes") is not None:
            d["mesh_axes"] = tuple(d["mesh_axes"])
        return cls(**d)


# Presets mirroring the reference launchers.  Linux launcher values:
# taumain.py:91-128 (harmosc, double_well, entw=5000, loops=1000); Windows
# launcher adds poeschl_teller / quartic presets (taumain_windows.py:101-139)
# whose potentials the reference kernel never implemented (SURVEY.md K8) —
# here they are real actions.
PRESETS = {
    "harmosc": ChainConfig(
        action="harmonic",
        n_sites=100,
        dt=0.1,
        dtau=0.3,
        frames=5000,
        loops=1000,
        formulation=Formulation.BACKGROUND,
        bc=BoundaryCondition.FIXED_BG,
    ),
    "double_well": ChainConfig(
        action="double_well",
        n_sites=200,
        dt=0.02,
        dtau=0.002,
        frames=5000,
        loops=1000,
        formulation=Formulation.BACKGROUND,
        bc=BoundaryCondition.FIXED_BG,
    ),
    "poeschl_teller": ChainConfig(
        action="poeschl_teller",
        n_sites=100,
        dt=1.0,
        dtau=0.1,
        frames=100,
        loops=10000,
        formulation=Formulation.DIRECT,
        bc=BoundaryCondition.PERIODIC,
    ),
    "quartic": ChainConfig(
        action="anharmonic",
        n_sites=50,
        dt=1.0,
        dtau=0.01,
        frames=100,
        loops=10000,
        formulation=Formulation.DIRECT,
        bc=BoundaryCondition.PERIODIC,
    ),
    # BASELINE.json config 2 at its stated scale: λφ⁴ chain, N=1024, 256
    # batched chains; ⟨x²⟩, ⟨x⁴⟩ and the gap gated against the fp64
    # transfer-matrix oracle (this package's observables/exact.py): on the
    # plain path by tests/test_torch_physics.py, through kernel 2 at this
    # width by physics_gates.gate_e (chip_smoke.py [29](e))
    "quartic_large": ChainConfig(
        action="anharmonic",
        n_sites=1024,
        dt=0.25,
        dtau=0.01,
        n_chains=256,
        frames=200,
        loops=1000,
        formulation=Formulation.DIRECT,
        bc=BoundaryCondition.PERIODIC,
        accumulate_spectrum=True,
    ),
    "phi4_2d": FieldConfig(
        action="phi4",
        shape=(256, 256),
        dtau=0.01,
        frames=100,
        loops=100,
    ),
    "phi4_4d": FieldConfig(
        action="phi4",
        shape=(32, 32, 32, 32),
        dtau=0.005,
        frames=100,
        loops=100,
    ),
}

"""Langevin frames for compact lattice gauge fields (U(1) / SU(2) / SU(3)
Wilson) in plain PyTorch: the twin of ``stochquant_tpu.integrators.gauge``.

Update per micro-step (generators T_a, ⟨η_aη_b⟩ = 2δ_ab):

    U(1):        θ ← wrap( θ + Δτ_eff·F(θ) + √(2Δτ_eff)·η )
    SU(2)/SU(3): U ← exp(i Σ_a ω_a T_a) U,  ω_a = Δτ_eff·f_a + √(2Δτ_eff)·η_a

with Δτ_eff = Δτ·min(1, drift_cap / max‖F‖), the max taken over the chain's
whole lattice every micro-step.  A frame is ``cfg.loops`` micro-steps
(:func:`gauge_frame_sums`, the plain version of CUDA kernel 10) and the
accept/reject, running-plaquette merge and adaptive-Δτ epilogue
(:func:`gauge_frame_epilogue`, which kernel 11 runs in-kernel).  Compact
links cannot run away, so a frame is rejected only for non-finite links.
The noise is the JAX package's counter-based Threefry stream keyed by the
C-order index over the group's noise shape, one Box–Muller pair per counter
for two micro-steps.

The complexified groups (and the gauge cooling that acts on them) are not
ported yet and raise.
State lives on one device, given explicitly (links split over a device mesh
are a list of such states: ``parallel.gauge_halo``), except ``step``: a 0-d int64
tensor on the host holding a uint32 value.
"""

from __future__ import annotations

import dataclasses
import json
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from stochquant_tpu_torch import rng
from stochquant_tpu_torch.actions import gauge as gauge_mod
from stochquant_tpu_torch.actions.base import true_divide
from stochquant_tpu_torch.integrators import accum
from stochquant_tpu_torch.integrators.langevin import host_step, stack_metrics

__all__ = [
    "GaugeConfig",
    "GaugeState",
    "GaugeFrameSums",
    "resolve_gauge_action",
    "init_gauge_state",
    "gauge_frame_sums",
    "gauge_frame_epilogue",
    "make_gauge_frame_fn",
    "run_gauge_frames",
    "reset_gauge_means",
    "exact_plaquette_2d",
]


@dataclasses.dataclass(frozen=True)
class GaugeConfig:
    """Wilson-action gauge run on a periodic D-dim lattice — a field-for-field
    copy of the JAX package's ``GaugeConfig``, so its JSON is byte-equal.

    Fields of features not ported yet (``beta_im`` and the complexified
    groups) raise where the run starts.  ``mesh_axes`` / ``mesh_chain_axis``
    split the links over the mesh given to ``runtime.run_gauge(mesh=)``
    (``parallel.gauge_halo``), where ``exchange_steps`` is the chunk runner's
    W (0: chosen from the slab); all three are unused without a mesh.
    ``cooling_rate`` acts on
    the complexified groups only, as in the JAX package: the compact
    actions have no cooling step."""

    group: str = "u1"
    beta: float = 1.0
    beta_im: float = 0.0
    cooling_rate: float = 0.0
    cooling_steps: int = 1
    shape: Tuple[int, ...] = (16, 16)
    n_chains: int = 64
    dtau: float = 2e-3
    loops: int = 100
    frames: int = 100
    seed: int = 0
    drift_cap: float = 20.0
    shrink: float = 0.95
    grow_after: int = 10
    dtau_max: Optional[float] = None
    hot_start: bool = False
    measure_loops: bool = False        # per-frame Polyakov loop + final Wilson-loop table
    frames_per_launch: int = 1         # CUDA backend: frames per kernel-11 launch
    mesh_axes: Optional[Tuple[Optional[str], ...]] = None
    mesh_chain_axis: Optional[str] = None
    exchange_steps: int = 0

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "GaugeConfig":
        d = json.loads(s)
        d["shape"] = tuple(d["shape"])
        if d.get("mesh_axes") is not None:
            d["mesh_axes"] = tuple(d["mesh_axes"])
        return cls(**d)


class GaugeState(NamedTuple):
    """Full resumable state (the JAX package's ``GaugeState``, leaf for leaf)."""

    links: torch.Tensor      # u1 (C,D,*L) f32 | su2 (C,4,D,*L) f32 | su3 (C,D,*L,3,3) c64
    plaq_mean: torch.Tensor  # (C,) running ⟨(1/N)ReTr U_p⟩
    drift_max: torch.Tensor  # (C,) max drift norm seen
    runs: torch.Tensor       # (C, 2) int64 (lo, hi) uint32 words of the sample count
    dtau: torch.Tensor       # (C,)
    stab_cnt: torch.Tensor   # (C,) int32
    step: torch.Tensor       # () int64 on the host: uint32 micro-step counter


class GaugeFrameSums(NamedTuple):
    """What one frame of micro-steps returns (CUDA kernel 10's outputs)."""

    links: torch.Tensor     # links at the end of the frame (a tripped chain: as it froze)
    ps: torch.Tensor        # (C,) frame Σ of the per-step mean plaquette
    dmax: torch.Tensor      # (C,) max(state.drift_max, every step's drift norm)
    unstable: torch.Tensor  # (C,) bool


def check_gauge_supported(cfg: GaugeConfig) -> None:
    """Raise for the gauge features that are not ported yet."""
    if cfg.group not in ("u1", "su2", "su3") or cfg.beta_im:
        raise ValueError(
            f"gauge group {cfg.group!r} (beta_im={cfg.beta_im}): the complexified groups "
            "cu1/csu2/csu3 (and their gauge cooling) are not ported yet; u1, su2 and su3 are"
        )


def resolve_gauge_action(cfg: GaugeConfig) -> gauge_mod.GaugeAction:
    check_gauge_supported(cfg)
    return gauge_mod.get_gauge(cfg.group, beta=cfg.beta)


def init_gauge_state(cfg: GaugeConfig, action=None, *, device) -> GaugeState:
    """Cold start at the identity, or with ``hot_start`` the links
    randomized by one INIT-stream draw at step 0; ``step = 1``."""
    action = action or resolve_gauge_action(cfg)
    C = cfg.n_chains
    links = action.init_links(action.state_shape(C, cfg.ndim, cfg.shape), device=device)
    if cfg.hot_start:
        eta = rng.normal_for_shape(cfg.seed, rng.Stream.INIT, 0,
                                   action.noise_shape(C, cfg.ndim, cfg.shape), device=device)
        links = action.hot_start(links, eta)
    zeros = torch.zeros((C,), dtype=torch.float32, device=device)
    return GaugeState(
        links=links,
        plaq_mean=zeros,
        drift_max=zeros.clone(),
        runs=accum.init_runs(C, device=device),
        dtau=torch.full((C,), cfg.dtau, dtype=torch.float32, device=device),
        stab_cnt=torch.zeros((C,), dtype=torch.int32, device=device),
        step=host_step(1),
    )


def gauge_frame_sums(state: GaugeState, action, cfg: GaugeConfig) -> GaugeFrameSums:
    """One frame of ``cfg.loops`` micro-steps from ``state``, in pairs that
    share one Threefry draw.  The plaquette samples the pre-update links; a
    chain whose update turns non-finite keeps those links and is frozen for
    the rest of the frame."""
    C, ndim = cfg.n_chains, cfg.ndim
    dev = state.links.device
    cap = float(np.float32(cfg.drift_cap))
    one = torch.ones((), dtype=torch.float32, device=dev)
    tiny = torch.full((), 1e-30, dtype=torch.float32, device=dev)
    noise_shape = action.noise_shape(C, ndim, cfg.shape)

    def substep(vals, eta):
        links, ps, dmax, unstable = vals
        f = action.drift(links, ndim)
        dnorm = action.drift_norm(f)
        scale = torch.minimum(one, true_divide(cap, torch.maximum(dnorm, tiny)))
        new_links = action.apply_update(links, action.omega(f, eta, state.dtau * scale))
        bad = ~torch.all(torch.isfinite(new_links).reshape(C, -1), dim=1)
        plaq = action.mean_plaquette(links, ndim)
        u = unstable.reshape((C,) + (1,) * (links.dim() - 1))
        return (
            torch.where(u, links, new_links),
            torch.where(unstable, ps, ps + plaq),
            torch.where(unstable, dmax, torch.maximum(dmax, dnorm)),
            unstable | bad,
        )

    vals = (state.links, torch.zeros_like(state.plaq_mean), state.drift_max,
            torch.zeros((C,), dtype=torch.bool, device=dev))
    step0 = int(state.step)
    for p in range(cfg.loops // 2):
        e0, e1 = rng.normal_pair_for_shape(cfg.seed, rng.Stream.FIELD, step0 + 2 * p,
                                           noise_shape, device=dev)
        vals = substep(substep(vals, e0), e1)
    if cfg.loops % 2:
        e0, _ = rng.normal_pair_for_shape(cfg.seed, rng.Stream.FIELD, step0 + cfg.loops - 1,
                                          noise_shape, device=dev)
        vals = substep(vals, e0)
    return GaugeFrameSums(*vals)


def gauge_frame_epilogue(state: GaugeState, sums: GaugeFrameSums, cfg: GaugeConfig):
    """Accept/reject, running-plaquette merge and adaptive Δτ for one frame —
    the expressions of the JAX frame and of kernel 11's in-kernel epilogue.
    Rejected frames still advance ``step``.  Returns (new_state, metrics)."""
    accept = ~sums.unstable
    n_new = accum.runs_after(state.runs, cfg.loops)
    pm = accum.merge_frame_sum(state.plaq_mean, sums.ps, cfg.loops, n_new)
    grow = accept & (state.stab_cnt >= cfg.grow_after)
    dtau = torch.where(
        grow,
        true_divide(state.dtau, cfg.shrink),
        torch.where(accept, state.dtau, state.dtau * cfg.shrink),
    )
    if cfg.dtau_max is not None:
        dtau = torch.clamp(dtau, max=float(np.float32(cfg.dtau_max)))
    au = accept.reshape((-1,) + (1,) * (state.links.dim() - 1))
    new_state = GaugeState(
        links=torch.where(au, sums.links, state.links),
        plaq_mean=torch.where(accept, pm, state.plaq_mean),
        drift_max=torch.where(accept, sums.dmax, state.drift_max),
        runs=accum.bump_runs(state.runs, cfg.loops, accept),
        dtau=dtau,
        stab_cnt=torch.where(accept, torch.where(state.stab_cnt >= cfg.grow_after, 0,
                                                 state.stab_cnt + 1), 0).to(torch.int32),
        step=host_step(int(state.step) + cfg.loops),
    )
    metrics = {
        "stable": accept,
        "dtau": dtau,
        "drift_max": sums.dmax,
        "unitarity_norm": torch.zeros_like(dtau),  # compact groups stay unitary
    }
    return new_state, metrics


def make_gauge_frame_fn(action, cfg: GaugeConfig):
    """The frame function state → (state, metrics) of the plain path."""
    check_gauge_supported(cfg)

    def frame(state: GaugeState):
        return gauge_frame_epilogue(state, gauge_frame_sums(state, action, cfg), cfg)

    return frame


def run_gauge_frames(state: GaugeState, action, cfg: GaugeConfig, n_frames: int):
    """``n_frames`` frames in plain PyTorch on the state's device, any D.
    Returns (final_state, metrics) with metrics stacked over frames (n_frames, C)."""
    frame = make_gauge_frame_fn(action, cfg)
    per_frame = []
    for _ in range(n_frames):
        state, m = frame(state)
        per_frame.append(m)
    return state, stack_metrics(per_frame)


def reset_gauge_means(state: GaugeState) -> GaugeState:
    return state._replace(plaq_mean=torch.zeros_like(state.plaq_mean),
                          runs=torch.zeros_like(state.runs))


def exact_plaquette_2d(group: str, beta: float) -> float:
    """Exact 2-D mean plaquette ⟨(1/N)ReTr U_p⟩ of the compact groups:
    I₁(β)/I₀(β) for U(1), I₂(β)/I₁(β) for SU(2) (character expansion), and
    for SU(3) the Weyl-measure eigenvalue integral on a 512² periodic
    trapezoid grid (``stochquant_tpu.integrators.gauge._weyl_plaquette_sun``)."""
    if group in ("u1", "su2"):
        from scipy.special import iv

        n = 1 if group == "u1" else 2
        return float(iv(n, beta) / iv(n - 1, beta))
    if group != "su3":
        raise KeyError(group)
    t = np.linspace(0.0, 2.0 * np.pi, 512, endpoint=False)
    t1, t2 = t[:, None], t[None, :]
    t3 = -(t1 + t2)
    tr = np.cos(t1) + np.cos(t2) + np.cos(t3)
    d = (np.sin((t1 - t2) / 2.0) ** 2 * np.sin((t1 - t3) / 2.0) ** 2
         * np.sin((t2 - t3) / 2.0) ** 2)
    w = d * np.exp((beta / 3.0) * (tr - 3.0))
    return float(np.sum(tr / 3.0 * w) / np.sum(w))

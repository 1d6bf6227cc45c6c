"""Host loop for chain runs (port of ``stochquant_tpu.runtime.run_chain``).

State stays on the device; the loop launches ``fps`` frames at a time,
streams the small per-frame metrics and the connected correlator, and writes
full-state checkpoints that resume bitwise (in this package or the JAX one).
"""

from __future__ import annotations

import dataclasses
import signal
from typing import Optional

import numpy as np
import torch

from stochquant_tpu_torch import actions as actions_mod
from stochquant_tpu_torch import metrics as metrics_mod
from stochquant_tpu_torch.config import ChainConfig
from stochquant_tpu_torch.integrators import langevin
from stochquant_tpu_torch.io import checkpoint as ckpt_mod
from stochquant_tpu_torch.kernels import chain_kernel

BACKENDS = ("auto", "cuda", "torch")


@dataclasses.dataclass
class RunResult:
    state: object
    cfg: object
    summary: dict


class PreemptionGuard:
    """SIGTERM/SIGINT set a flag instead of killing the process; the run
    loop polls it (``stop=guard``), writes a final checkpoint and returns."""

    def __init__(self, signums=(signal.SIGTERM, signal.SIGINT)):
        self._signums = signums
        self._old = {}
        self.tripped = False

    def _handler(self, signum, frame):
        self.tripped = True

    def __enter__(self):
        for s in self._signums:
            self._old[s] = signal.signal(s, self._handler)
        return self

    def __exit__(self, *exc):
        for s, h in self._old.items():
            signal.signal(s, h)
        return False

    def __call__(self) -> bool:
        return self.tripped


def resolve_device(device) -> torch.device:
    """The run's device; a CUDA device without a usable GPU raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but no CUDA device is available")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}; use 'cuda' or 'cpu'")
    return device


def select_backend(backend: str, device: torch.device) -> str:
    """'auto' → 'cuda' (the hand-written kernels) on a CUDA device, 'torch'
    (the plain PyTorch integrator) on the CPU.  'cuda' on the CPU raises."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown chain backend {backend!r}; known: {BACKENDS}")
    if backend == "auto":
        return "cuda" if device.type == "cuda" else "torch"
    if backend == "cuda" and device.type != "cuda":
        raise ValueError(f"backend='cuda' runs the CUDA kernels and needs a CUDA device, not {device}")
    return backend


def _frames_already_done(state, cfg, checkpoint_in=None) -> int:
    if checkpoint_in:
        meta = ckpt_mod.read_meta(checkpoint_in)
        if "frames_done" in meta:
            return min(cfg.frames, int(meta["frames_done"]))
    return min(cfg.frames, int(state.step) // max(cfg.loops, 1))


def _check_resume_compat(loaded_cfg, cfg, checkpoint_in, fields) -> None:
    bad = {
        f: (getattr(loaded_cfg, f), getattr(cfg, f))
        for f in fields
        if getattr(loaded_cfg, f) != getattr(cfg, f)
    }
    if bad:
        raise ValueError(
            f"checkpoint {checkpoint_in} was produced by an incompatible "
            f"config: " + ", ".join(f"{k}={a!r} vs {b!r}" for k, (a, b) in bad.items())
        )


def _stop_requested(stop, sink, state, cfg, checkpoint_out, frames_done) -> bool:
    if stop is None or not stop():
        return False
    if checkpoint_out:
        ckpt_mod.save(checkpoint_out, state, cfg, frames_done=frames_done)
    sink.emit({"type": "preempted", "frames_done": frames_done, "checkpoint": checkpoint_out})
    return True


def run_chain(
    cfg: ChainConfig,
    *,
    device,
    backend: str = "auto",
    burn_frames: int = 0,
    sink: Optional[metrics_mod.MetricsSink] = None,
    checkpoint_out: Optional[str] = None,
    checkpoint_in: Optional[str] = None,
    checkpoint_every: int = 0,
    stream_correlator: bool = True,
    stop=None,
    resume_progress: bool = False,
) -> RunResult:
    """Run a 1-D chain ensemble per the config on ``device``; returns the
    final state.

    backend: 'cuda' (the hand-written kernels), 'torch' (the plain PyTorch
    integrator, on any device) or 'auto' (cuda on a CUDA device, torch on
    the CPU).  stop: optional callable polled between frame groups (e.g. a
    PreemptionGuard); when true the loop checkpoints and returns early.
    resume_progress: with checkpoint_in, count the checkpoint's completed
    frames toward cfg.frames instead of running cfg.frames more.
    """
    device = resolve_device(device)
    backend = select_backend(backend, device)
    langevin.check_supported(cfg)
    if cfg.mesh_chain_axis is not None:
        raise ValueError("mesh_chain_axis (chains sharded over a device mesh) is not ported yet")
    if cfg.block_chains == 0:
        raise ValueError("block_chains=0 (autotune) is not ported yet")
    act = actions_mod.get(cfg.action)
    sink = sink or metrics_mod.MetricsSink()

    if checkpoint_in:
        state, loaded_cfg = ckpt_mod.load(checkpoint_in, device)
        _check_resume_compat(loaded_cfg, cfg, checkpoint_in, ("action", "n_sites", "n_chains"))
    else:
        state = langevin.init_chain_state(cfg, act, device=device)

    def run_n(state, n):
        if backend == "cuda":
            return chain_kernel.run_frames_kernel(
                state, act, cfg, n,
                frames_per_launch=min(cfg.frames_per_launch, n),
            )
        return langevin.run_frames(state, act, cfg, n)

    frames_done = (
        _frames_already_done(state, cfg, checkpoint_in)
        if (resume_progress and checkpoint_in)
        else 0
    )
    if burn_frames and frames_done == 0:
        state, _ = run_n(state, burn_frames)
        state = langevin.reset_means(state)

    updates_per_frame = cfg.n_chains * cfg.n_sites * cfg.loops
    fps = max(cfg.fps, 1)
    while frames_done < cfg.frames:
        n = min(fps, cfg.frames - frames_done)
        state, m = run_n(state, n)
        frames_done += n
        obs = {}
        if stream_correlator:
            corr = langevin.connected_correlator(state).mean(dim=0).double().cpu().numpy()
            obs["log_abs_corr"] = np.log(np.abs(corr) + 1e-300)
        sink.frame(
            frames_done - 1,
            cfg.frames,
            updates_per_frame * n,
            m["dtau"][-1].cpu().numpy(),
            float(m["stable"][-n:].float().mean()),
            observables=obs,
        )
        if checkpoint_out and checkpoint_every and frames_done % checkpoint_every == 0:
            ckpt_mod.save(checkpoint_out, state, cfg, frames_done=frames_done)
        if _stop_requested(stop, sink, state, cfg, checkpoint_out, frames_done):
            break

    if checkpoint_out:
        ckpt_mod.save(checkpoint_out, state, cfg, frames_done=frames_done)
    summary = sink.summary()
    sink.emit(summary)
    return RunResult(state=state, cfg=cfg, summary=summary)

"""Host loops for chain, field, complex-Langevin and gauge runs (port of
``stochquant_tpu.runtime``'s ``run_chain``, ``select_field_backend``,
``run_field``, ``run_complex`` and ``run_gauge``).

State stays on the device; a loop launches ``fps`` frames at a time (gauge
runs: ``frames_per_launch``), streams the small per-frame metrics (chains:
the connected correlator; fields: magnetization, ⟨φ²⟩, susceptibility,
Binder cumulant; complex Langevin: Re/Im ⟨z²⟩ and the drift max; gauge: the
mean plaquette beside its exact 2-D value, the drift max, for the
complexified groups the imaginary parts and the unitarity norm, and with
``measure_loops`` the Polyakov loop) and writes full-state checkpoints that
resume bitwise (in this package or the JAX one).

``run_field`` and ``run_gauge`` take ``mesh=`` (``parallel.make_mesh``): with
``cfg.mesh_axes`` set the lattice is split over the mesh and the halo runners
of ``parallel.halo`` / ``parallel.gauge_halo`` run the frames.  The state is
then a list of per-shard states inside the loop; checkpoints are of the
whole-state kind (gathered first), and the result carries the whole state.
On a mesh across processes (``parallel.distributed.global_mesh``) every
process runs the same loop on its own shards, as the JAX package's SPMD
program does: a fresh start builds the whole state from the seed in every
process and keeps its shards, checkpoints are sharded (``io.checkpoint.
save_sharded``, one file a process), every process writes the same records
(the per-chain scalars and metrics reach each of them), and the result
carries this process's per-shard states.
"""

from __future__ import annotations

import dataclasses
import math
import signal
from typing import Optional

import numpy as np
import torch

from stochquant_tpu_torch import actions as actions_mod
from stochquant_tpu_torch import metrics as metrics_mod
from stochquant_tpu_torch import tracing
from stochquant_tpu_torch.actions import complex_actions
from stochquant_tpu_torch.config import ChainConfig, FieldConfig, Scheme
from stochquant_tpu_torch.integrators import complex_field as cfield
from stochquant_tpu_torch.integrators import complex_langevin as cl
from stochquant_tpu_torch.integrators import field as field_mod
from stochquant_tpu_torch.integrators import gauge as gauge_mod
from stochquant_tpu_torch.integrators import langevin
from stochquant_tpu_torch.io import checkpoint as ckpt_mod
from stochquant_tpu_torch.kernels import (
    autotune, chain_kernel, field_kernel, field_kernel_nd, field_kernel_tiled, gauge_kernel,
)
from stochquant_tpu_torch.observables import gauge_loops
from stochquant_tpu_torch.parallel import gauge_halo as gauge_halo_mod
from stochquant_tpu_torch.parallel import halo as halo_mod
from stochquant_tpu_torch.parallel import mesh as mesh_mod

BACKENDS = ("auto", "cuda", "torch")
#: field backends under a mesh: 'auto', then ``parallel.halo.HALO_BACKENDS``
HALO_FIELD_BACKENDS = ("auto",) + halo_mod.HALO_BACKENDS


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


def select_backend(backend: str, device: torch.device, cfg: Optional[ChainConfig] = None):
    """Resolve a chain run's path: ('cuda', None) for kernels 1 and 2, or
    ('torch', reason) for the plain PyTorch integrator, with ``reason`` set
    when 'auto' on a CUDA device gives way (the caller records it).

    'auto' is 'cuda' on a CUDA device and 'torch' on the CPU.  The LM and
    exact-OU schemes and the power-spectrum channel have no kernel in either
    package: there 'auto' runs the plain integrator on the device and says
    why, and 'cuda' raises, as the JAX package's 'pallas' does.  'cuda' on the
    CPU raises.  ``rng_impl='hardware'`` runs the kernels' Philox variants on
    'cuda' and is ignored by 'torch' (Threefry-20), as in the JAX package."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown chain backend {backend!r}; known: {BACKENDS}")
    plain_only = langevin.plain_path_only(cfg) if cfg is not None else None
    if backend == "auto":
        if device.type != "cuda":
            return "torch", None
        if plain_only:
            return "torch", f"{plain_only}; the plain PyTorch integrator runs on the device"
        return "cuda", None
    if backend == "cuda":
        if device.type != "cuda":
            raise ValueError("backend='cuda' runs the CUDA kernels and needs a CUDA device, "
                             f"not {device}")
        if plain_only:
            raise ValueError(f"backend='cuda' cannot run this config: {plain_only}; "
                             "use backend='torch'")
    return backend, None


def _frames_already_done(state, cfg, checkpoint_in=None) -> int:
    if checkpoint_in:
        meta = ckpt_mod.read_meta_any(checkpoint_in)
        if "frames_done" in meta:
            return min(cfg.frames, int(meta["frames_done"]))
    return min(cfg.frames, int(state.step) // max(cfg.loops, 1))


def _check_resume_compat(loaded_cfg, cfg, checkpoint_in, fields) -> None:
    if type(loaded_cfg) is not type(cfg):
        raise ValueError(f"checkpoint {checkpoint_in} holds a {type(loaded_cfg).__name__} "
                         f"run, not {type(cfg).__name__}")
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


def _load_whole(checkpoint_in, device, cfg, fields):
    """A whole-state checkpoint on ``device``; a sharded one needs the mesh
    it was split over and raises here, as the JAX ``run_field`` does."""
    if ckpt_mod.is_sharded_checkpoint(checkpoint_in):
        raise ValueError(f"{checkpoint_in} is a sharded checkpoint; resume it under a mesh "
                         "(mesh= with the config's mesh axes) whose shards align with it")
    state, loaded_cfg = ckpt_mod.load(checkpoint_in, device)
    _check_resume_compat(loaded_cfg, cfg, checkpoint_in, fields)
    return state


def _stop_requested(stop, sink, state, cfg, checkpoint_out, frames_done, mesh=None) -> bool:
    """Poll ``stop``; when set, checkpoint (a split state of ``mesh`` as
    ``io.checkpoint.save_auto`` writes it) and record the preemption."""
    if stop is None or not stop():
        return False
    _preempt(sink, state, cfg, checkpoint_out, frames_done, mesh)
    return True


def _preempt(sink, state, cfg, checkpoint_out, frames_done, mesh=None) -> None:
    """Checkpoint ``state`` where a stop ends a run, and record the preemption."""
    if checkpoint_out:
        ckpt_mod.save_auto(checkpoint_out, state, cfg, mesh=mesh, frames_done=frames_done)
    sink.emit({"type": "preempted", "frames_done": frames_done, "checkpoint": checkpoint_out})


def _mesh_device(mesh, device) -> torch.device:
    """Where a mesh run assembles whole states (checkpoints, the result):
    ``device``, or the mesh's first device."""
    return mesh.devices[0] if device is None else resolve_device(device)


def _mesh_on_cuda(mesh) -> bool:
    kinds = {d.type for d in mesh.devices}
    if len(kinds) != 1:
        raise ValueError(f"a mesh mixes device types {sorted(kinds)}; use CUDA devices or the CPU")
    return kinds == {"cuda"}


def _check_mesh_cfg(cfg, mesh) -> bool:
    """True for a split run (``mesh`` and ``cfg.mesh_axes``); a config that
    names mesh axes without a mesh, or a mesh without ``cfg.mesh_axes``, raises."""
    if mesh is None:
        for name in ("mesh_axes", "mesh_chain_axis"):
            if getattr(cfg, name, None) is not None:
                raise ValueError(f"cfg.{name}={getattr(cfg, name)!r} names mesh axes but no mesh "
                                 "was given: pass mesh=parallel.make_mesh(...)")
        return False
    if cfg.mesh_axes is None:
        raise ValueError("a mesh needs cfg.mesh_axes: one mesh axis name per lattice dim "
                         "(None = that dim stays whole)")
    return True


class _SplitState:
    """A run loop's view of a state that is a list of per-shard states, of
    class ``cls`` split over ``mesh`` as ``cfg`` says.  A mesh across
    processes gathers its per-chain scalars in every process and never its
    lattice; chain runs refuse it."""

    def __init__(self, cls, cfg, mesh, device, scalars):
        if mesh.process_count > 1 and cls is langevin.ChainState:
            raise ValueError(
                "a chain run's shards run in one process (as the JAX package's run_chain): "
                "across processes each runs chain_kernel.run_frames_kernel(..., chain_offset=) "
                "on its part of the chains (parallel.distributed.process_local_chains) and saves "
                "with io.checkpoint.save_sharded")
        self.across = mesh.process_count > 1
        self.spec = mesh_mod.state_spec(cls, cfg)
        self.mesh, self.device, self._scalars = mesh, device, scalars

    def shard(self, whole) -> list:
        return mesh_mod.shard_state(whole, self.spec, self.mesh)

    def load(self, checkpoint_in, cfg, fields):
        """The per-shard states of a checkpoint: a sharded one restored onto
        the mesh block by block, a whole-state one loaded and split."""
        if ckpt_mod.is_sharded_checkpoint(checkpoint_in):
            shards, loaded_cfg = ckpt_mod.load_sharded(checkpoint_in, self.mesh)
        else:
            return self.shard(_load_whole(checkpoint_in, self.device, cfg, fields))
        _check_resume_compat(loaded_cfg, cfg, checkpoint_in, fields)
        return shards

    def whole(self, shards):
        return mesh_mod.gather_state(shards, self.spec, self.mesh, self.device)

    def scalars(self, shards):
        """The per-chain leaves a frame record reads, in every process; the
        lattice is ``None``."""
        return mesh_mod.gather_scalars(shards, self.spec, self.mesh, self._scalars, self.device)

    def finish(self, shards, cfg, checkpoint_out, frames_done):
        """The result's state, checkpointed to ``checkpoint_out``: the whole
        state in one process; across processes this process's shards, each
        process writing its sharded file."""
        if self.across:
            if checkpoint_out:
                ckpt_mod.save_sharded(checkpoint_out, shards, cfg, self.mesh,
                                      frames_done=frames_done)
            return shards
        state = self.whole(shards)
        if checkpoint_out:
            ckpt_mod.save(checkpoint_out, state, cfg, frames_done=frames_done)
        return state


class _ChainRecords:
    """The frame records of a chain run, read on the host one frame group
    late.  ``push`` enqueues a group's record on the device right after the
    group: the correlator's mean over chains in float64, the last frame's Δτ
    row and the stable share of the group's frames, each copied into a host
    slot, then an event.  There are two slots, taken by the group's parity
    and allocated at the first record; on a CUDA device they are page-locked
    and the copies ``non_blocking``.  ``deliver`` waits on the event of the
    oldest group not yet read and hands its record to the sink.  On the CPU,
    and with ``sync`` (a mesh run: its correlator is gathered onto the run's
    device, which may be another card than its Δτ's), the slots are plain
    tensors, each copy is done at once and no event is kept."""

    def __init__(self, sink, n_frames: int, updates_per_frame: int, correlator: bool,
                 sync: bool):
        self.sink, self.n_frames, self.updates_per_frame = sink, n_frames, updates_per_frame
        self.correlator, self.sync = correlator, sync
        self.slots = None
        self.pushed = self.read = 0

    def push(self, view, m, n: int, frames_done: int) -> None:
        """Enqueue the record of a group of ``n`` frames that ends at frame
        ``frames_done``: ``m`` its metrics, ``view`` the state its correlator
        is read from."""
        values = {"dtau": m["dtau"][-1], "stable": m["stable"][-n:].float().mean()}
        if self.correlator:
            values["corr"] = langevin.connected_correlator(view).mean(dim=0).double()
        dev = values["dtau"].device
        if self.slots is None:
            pin = dev.type == "cuda" and not self.sync
            self.slots = [
                {"host": {k: torch.empty(v.shape, dtype=v.dtype, pin_memory=pin)
                          for k, v in values.items()},
                 "event": torch.cuda.Event() if pin else None}
                for _ in range(2)
            ]
        slot = self.slots[self.pushed % 2]
        for k, v in values.items():
            slot["host"][k].copy_(v, non_blocking=slot["event"] is not None)
        if slot["event"] is not None:
            slot["event"].record(torch.cuda.current_stream(dev))
        slot["group"] = (n, frames_done)
        self.pushed += 1

    def deliver(self) -> None:
        """Wait for the oldest record not yet read and stream it."""
        with tracing.span(tracing.RECORD):
            slot = self.slots[self.read % 2]
            self.read += 1
            if slot["event"] is not None:
                slot["event"].synchronize()
            host, (n, frames_done) = slot["host"], slot["group"]
            obs = {}
            if self.correlator:
                obs["log_abs_corr"] = np.log(np.abs(host["corr"].numpy()) + 1e-300)
            self.sink.frame(
                frames_done - 1,
                self.n_frames,
                self.updates_per_frame * n,
                host["dtau"].numpy(),
                float(host["stable"]),
                observables=obs,
            )


class _FieldRecords:
    """The frame records of a field run, read on the host one frame group
    late, as :class:`_ChainRecords` reads a chain run's.  ``push`` enqueues a
    group's record on the device right after the group: the five per-chain
    observables, the last frame's Δτ row and the stable share of the group's
    frames, each copied into a host slot (seven copies, counted in
    ``run_field.readbacks``), then an event.  There are two slots, taken by
    the group's parity and allocated at the first record; on a CUDA device
    they are page-locked and the copies ``non_blocking``.  ``deliver`` waits
    on the event of the oldest group not yet read, takes the observables'
    means over chains on the host and hands the record to the sink.  On the
    CPU, and with ``sync`` (a mesh run: its observables are gathered onto
    the run's device), the slots are plain tensors, each copy is done at
    once and no event is kept."""

    #: the record's observables, each a mean over chains taken on the host
    OBSERVABLES = ("mag", "abs_mag", "phi2", "susceptibility", "binder")

    def __init__(self, sink, n_frames: int, updates_per_frame: int, volume: int, sync: bool):
        self.sink, self.n_frames, self.updates_per_frame = sink, n_frames, updates_per_frame
        self.volume, self.sync = volume, sync
        self.slots = None
        self.pushed = self.read = 0

    def push(self, view, m, n: int, frames_done: int) -> None:
        """Enqueue the record of a group of ``n`` frames that ends at frame
        ``frames_done``: ``m`` its metrics, ``view`` the state its
        observables are read from."""
        values = {
            "mag": view.mag_mean,
            "abs_mag": view.absmag_mean,
            "phi2": view.phi2_mean,
            "susceptibility": field_mod.susceptibility(view, self.volume),
            "binder": field_mod.binder_cumulant(view),
            "dtau": m["dtau"][-1],
            "stable": m["stable"][-n:].float().mean(),
        }
        dev = values["dtau"].device
        if self.slots is None:
            pin = dev.type == "cuda" and not self.sync
            self.slots = [
                {"host": {k: torch.empty(v.shape, dtype=v.dtype, pin_memory=pin)
                          for k, v in values.items()},
                 "event": torch.cuda.Event() if pin else None}
                for _ in range(2)
            ]
        slot = self.slots[self.pushed % 2]
        for k, v in values.items():
            slot["host"][k].copy_(v, non_blocking=slot["event"] is not None)
        run_field.readbacks += len(values)
        if slot["event"] is not None:
            slot["event"].record(torch.cuda.current_stream(dev))
        slot["group"] = (n, frames_done)
        self.pushed += 1

    def deliver(self) -> None:
        """Wait for the oldest record not yet read and stream it."""
        with tracing.span(tracing.RECORD):
            slot = self.slots[self.read % 2]
            self.read += 1
            if slot["event"] is not None:
                slot["event"].synchronize()
            host, (n, frames_done) = slot["host"], slot["group"]
            obs = {k: float(host[k].numpy().mean()) for k in self.OBSERVABLES}
            self.sink.frame(
                frames_done - 1,
                self.n_frames,
                self.updates_per_frame * n,
                host["dtau"].numpy(),
                float(host["stable"].numpy()),
                observables=obs,
            )
        run_field.records += 1


def _check_chain_mesh(cfg: ChainConfig, mesh) -> bool:
    """True for a chain run over a mesh (``mesh`` and ``cfg.mesh_chain_axis``,
    the one mesh field of ``ChainConfig``); a chain axis without a mesh or a
    mesh without a chain axis raises."""
    if mesh is None:
        _check_mesh_cfg(cfg, None)
        return False
    if cfg.mesh_chain_axis is None:
        raise ValueError("a mesh needs cfg.mesh_chain_axis: the mesh axis the chains split over")
    return True


def run_chain(
    cfg: ChainConfig,
    *,
    device=None,
    backend: str = "auto",
    burn_frames: int = 0,
    sink: Optional[metrics_mod.MetricsSink] = None,
    checkpoint_out: Optional[str] = None,
    checkpoint_in: Optional[str] = None,
    checkpoint_every: int = 0,
    stream_correlator: bool = True,
    mesh=None,
    stop=None,
    resume_progress: bool = False,
) -> RunResult:
    """Run a 1-D chain ensemble per the config on ``device``, or with
    ``mesh`` and ``cfg.mesh_chain_axis`` split over the mesh's chain axis
    (``device`` then only says where whole states are assembled: default the
    mesh's first device); returns the final whole state.

    backend: 'cuda' (the hand-written kernels), 'torch' (the plain PyTorch
    integrator, on any device) or 'auto' (cuda on a CUDA device, torch on
    the CPU), resolved by :func:`select_backend`.  Under a mesh every shard
    runs its chains (kernels 1 / 2 on the card) with its global chain offset,
    so state, metrics and records are bit for bit the unsplit run's; the
    records gather the per-chain metrics and correlators in mesh order, a
    checkpoint the whole state (``io.checkpoint.save_auto``), and a sharded
    checkpoint resumes block by block.  ``block_chains=0`` records the
    launch's layout (``kernels.autotune.best_block_chains``).  stop: optional
    callable polled once a frame group (e.g. a PreemptionGuard), after the
    group is enqueued and before the next one is; when true the loop streams
    the group's record, checkpoints and returns early.  A stop that reads no
    record ends the run after the groups a loop that reads each record at
    once would run; one that depends on the records (a window closed by a
    record's time) sees, polled for group k, only record k - 1, so it runs
    and streams one group more, drained.
    resume_progress: with checkpoint_in, count the checkpoint's completed
    frames toward cfg.frames instead of running cfg.frames more.

    Records are read one group late: group k's record (correlator, Δτ row,
    stable share) is enqueued on the device right after the group, and read
    on the host only once group k+1 is enqueued too, so the device runs k+1
    while the host reads, streams and launches.  Nothing of a group depends
    on a record's host values, so the records and states are those of a
    loop that reads each record at once.  A group is not followed before a
    checkpoint, at a stop or at the last frame: its record is read with
    nothing enqueued behind it (drained), so a checkpoint, a stop and the
    result hold the state the last record describes.  Under a mesh every
    record is drained and copied to the host at once (the correlator's
    gather is synchronous, and may land on another card than the Δτ row).
    Two plain counters, 0 at import and set to 0 by their reader
    (``tools/span_check.py records``), as the kernel wrappers' ``launches``
    are: ``run_chain.records_ahead`` (records read with the next group
    already enqueued) and ``run_chain.records_drained`` (records read with
    nothing enqueued behind them).
    """
    split = None
    if _check_chain_mesh(cfg, mesh):
        device = _mesh_device(mesh, device)
        split = _SplitState(langevin.ChainState, cfg, mesh, device, ("x_mean", "xx0_mean"))
        _mesh_on_cuda(mesh)  # one device type
        backend, reason = select_backend(backend, mesh.devices[0], cfg)
        c_local, offsets = mesh_mod.chain_split(cfg.n_chains, mesh, cfg.mesh_chain_axis)
        run_cfg = dataclasses.replace(cfg, n_chains=c_local, mesh_chain_axis=None)
    else:
        device = resolve_device(device)
        backend, reason = select_backend(backend, device, cfg)
        offsets, run_cfg = [0], cfg
    act = actions_mod.get(cfg.action)
    langevin.check_supported(cfg, act)
    sink = sink or metrics_mod.MetricsSink()
    if reason:
        sink.emit({"type": "backend_fallback", "backend": "torch", "reason": reason})
    if cfg.block_chains == 0:
        sink.emit(dict(autotune.best_block_chains(act, run_cfg, device=device)))

    fields = ("action", "n_sites", "n_chains")
    if split:
        state = (split.load(checkpoint_in, cfg, fields) if checkpoint_in else
                 split.shard(langevin.init_chain_state(cfg, act, device=device)))
    elif checkpoint_in:
        state = _load_whole(checkpoint_in, device, cfg, fields)
    else:
        state = langevin.init_chain_state(cfg, act, device=device)

    def run_one(s, n, offset):
        if backend == "cuda":
            return chain_kernel.run_frames_kernel(
                s, act, run_cfg, n, frames_per_launch=min(cfg.frames_per_launch, n),
                chain_offset=offset)
        return langevin.run_frames(s, act, run_cfg, n, offset)

    def run_n(state, n):
        if not split:
            return run_one(state, n, 0)
        out = [run_one(s, n, off) for s, off in zip(state, offsets)]
        return ([o[0] for o in out],
                mesh_mod.gather_metrics([o[1] for o in out], mesh, cfg.mesh_chain_axis))

    frames_done = (
        _frames_already_done(state[0] if split else state, cfg, checkpoint_in)
        if (resume_progress and checkpoint_in)
        else 0
    )
    if burn_frames and frames_done == 0:
        state, _ = run_n(state, burn_frames)
        state = [langevin.reset_means(s) for s in state] if split else langevin.reset_means(state)

    fps = max(cfg.fps, 1)
    records = _ChainRecords(sink, cfg.frames, cfg.n_chains * cfg.n_sites * cfg.loops,
                            stream_correlator, sync=bool(split))

    def enqueue():
        # rebinds the run's own state, so the group's input is freed before its record's work
        nonlocal state, frames_done
        n = min(fps, cfg.frames - frames_done)
        state, m = run_n(state, n)
        frames_done += n
        view = (split.scalars(state) if split else state) if stream_correlator else None
        records.push(view, m, n, frames_done)

    ahead = False  # a group is enqueued behind the one whose record is read next
    while ahead or frames_done < cfg.frames:
        if not ahead:
            enqueue()
        stopping = stop is not None and stop()
        due = bool(checkpoint_out and checkpoint_every and frames_done % checkpoint_every == 0)
        ahead = not (split or stopping or due) and frames_done < cfg.frames
        if ahead:
            enqueue()
        records.deliver()
        run_chain.records_ahead += ahead
        run_chain.records_drained += not ahead
        if due:
            ckpt_mod.save_auto(checkpoint_out, state, cfg, mesh=mesh, frames_done=frames_done)
        if stopping:
            _preempt(sink, state, cfg, checkpoint_out, frames_done, mesh)
            break

    if split:
        state = split.finish(state, cfg, checkpoint_out, frames_done)
    elif checkpoint_out:
        ckpt_mod.save(checkpoint_out, state, cfg, frames_done=frames_done)
    summary = sink.summary()
    sink.emit(summary)
    return RunResult(state=state, cfg=cfg, summary=summary)


run_chain.records_ahead = 0
run_chain.records_drained = 0


#: The JAX package's routing rule (``stochquant_tpu.runtime._FIELD_VMEM_FIELD_BYTES``):
#: a 2-D float32 lattice of up to 1 MiB per chain runs whole-lattice frames
#: (kernels 3 and 4); larger ones, or any run with ``tile_rows`` set, run
#: the strip-tiled pair kernel (kernel 5).  D >= 3 lattices run kernels 6 and 7.
WHOLE_LATTICE_MAX_BYTES = 1 << 20


def _select_halo_backend(cfg: FieldConfig, backend: str, mesh) -> str:
    """The halo runner's backend for a split run (see :func:`select_field_backend`)."""
    if backend not in HALO_FIELD_BACKENDS:
        raise ValueError(f"field backend {backend!r} is not available under the halo runner "
                         f"(mesh + cfg.mesh_axes); known: {HALO_FIELD_BACKENDS}")
    on_cuda = _mesh_on_cuda(mesh)
    if backend == "auto":
        backend = "cuda" if on_cuda else "torch"
        if on_cuda and cfg.prefer_rdma and halo_mod.rdma_backend_available(
                actions_mod.get_field(cfg.action), cfg, mesh):
            backend = "cuda_rdma"
    if backend == "torch":
        return "torch"
    if not on_cuda:
        raise ValueError(f"backend={backend!r} runs the CUDA kernels and needs a mesh of CUDA "
                         f"devices, not {sorted({str(d) for d in mesh.devices})}")
    if cfg.dtype != "float32":
        raise ValueError(f"the field kernels are float32-only, not {cfg.dtype}; use backend='torch'")
    # raises where no kernel covers this (cfg, mesh): nothing gives way to 'torch' unasked
    halo_mod.resolve_backend(actions_mod.get_field(cfg.action), cfg, mesh, backend)
    return backend


def _check_threefry(cfg: FieldConfig, what: str) -> None:
    if cfg.rng_impl == "hardware":
        raise ValueError(
            f"{what} draws Threefry noise only (it recomputes halo sites, which a generator "
            "keyed per launch could not replay), not rng_impl='hardware': use 'threefry' / "
            "'threefry13', the whole-lattice kernels, or backend='torch' (the plain "
            "integrator, which draws Threefry-20 under 'hardware')")


def field_fallback_reason(cfg: FieldConfig, backend: str, device) -> Optional[str]:
    """Why 'auto' on a CUDA device runs an unsplit field config on the plain
    integrator (``run_field`` records it), or None: ``Scheme.EXACT`` has no
    kernel in either package."""
    if backend == "auto" and torch.device(device).type == "cuda" and cfg.scheme == Scheme.EXACT:
        return ("no field kernel implements Scheme.EXACT (the rfftn-mode propagator); the "
                "plain PyTorch integrator runs on the device")
    return None


def split_fallback_reason(cfg: FieldConfig, backend: str, mesh) -> Optional[str]:
    """Why 'auto' on a CUDA mesh does not take kernel 8 although
    ``cfg.prefer_rdma`` asks for it (``run_field`` records it), or None: its
    rules do not admit the split, so ``backend='cuda'`` (kernel 7 or 9) runs
    it, as the JAX package gives way to its chunk composition."""
    if backend != "auto" or not cfg.prefer_rdma or not _mesh_on_cuda(mesh):
        return None
    reason = halo_mod.rdma_refusal(actions_mod.get_field(cfg.action), cfg, mesh)
    if reason is None:
        return None
    return (f"prefer_rdma is set but kernel 8 (cuda_rdma) does not admit this split: {reason}; "
            "backend 'cuda' (kernel 7 or 9) runs it")


def select_field_backend(cfg: FieldConfig, backend: str, device, mesh=None) -> str:
    """Resolve a field run's path: 'cuda' (kernels 3 and 4), 'cuda_tiled'
    (kernel 5), 'cuda_nd' (kernels 6 and 7, D >= 3) or 'torch' (the plain
    PyTorch integrator, any dimension).

    'auto' takes the CUDA kernels on a CUDA device and 'torch' on the CPU.
    On the CUDA route every case the kernels do not cover raises, naming it
    (a dtype other than float32); ``backend='torch'``
    is the explicit way to run the plain integrator there.  An odd ``loops``
    on the paths of pair launches (the tiled 2-D kernel and the D >= 3
    kernels) ends each frame in one launch of kernel 6's code at one step.
    ``Scheme.EXACT`` has no kernel in either package: 'auto' runs the plain
    integrator on the device (``run_field`` records why); 'cuda' raises.
    ``rng_impl='hardware'`` runs the Philox variants of kernels 3 and 4 and
    is ignored by 'torch'
    (Threefry-20); the strip-tiled and D >= 3 kernels are Threefry-only and
    raise for it, naming ``backend='torch'``.

    With ``mesh`` (and ``cfg.mesh_axes``) the result is a backend of
    ``parallel.halo.make_halo_runner``: 'torch', 'cuda' (kernels 3 / 6 per
    shard on a chain-only mesh, the chunk kernel 7 on a cut lattice it
    admits, else in 2-D the per-step kernel 9), or an explicit 'cuda_step' /
    'cuda_pair' / 'cuda_rdma' (kernel 8); ``device`` is then ignored (the mesh
    names the devices).  'auto' on a CUDA mesh is 'cuda_rdma' with
    ``cfg.prefer_rdma`` where kernel 8 admits the split, else 'cuda' (where
    ``prefer_rdma`` was set, ``run_field`` records why:
    :func:`split_fallback_reason`), and as on the unsplit route every case
    the kernels do not cover raises (a D >= 3 split the chunk kernel does not
    admit, a dtype other than float32); ``WHOLE_LATTICE_MAX_BYTES`` plays no
    part under a mesh.  ``tile_rows=0`` takes the strip-tiled route in 2-D,
    as the JAX package does; ``run_field`` resolves it (D >= 3) and
    ``exchange_steps=0`` on the card (``kernels.autotune``)."""
    field_mod.check_field_supported(cfg, actions_mod.get_field(cfg.action))
    if _check_mesh_cfg(cfg, mesh):
        return _select_halo_backend(cfg, backend, mesh)
    device = torch.device(device)
    if backend not in BACKENDS:
        raise ValueError(f"unknown field backend {backend!r}; known: {BACKENDS}")
    exact = cfg.scheme == Scheme.EXACT
    if exact and backend == "cuda":
        raise ValueError("Scheme.EXACT is a plain-path scheme by design (the rfftn-mode "
                         "propagator): use backend='auto' or 'torch'")
    if backend == "auto":
        backend = "cuda" if device.type == "cuda" and not exact else "torch"
    if backend == "torch":
        return "torch"
    if device.type != "cuda":
        raise ValueError(f"backend='cuda' runs the CUDA kernels and needs a CUDA device, not {device}")
    if cfg.dtype != "float32":
        raise ValueError(f"the field kernels are float32-only, not {cfg.dtype}; use backend='torch'")
    if cfg.ndim >= 3:
        _check_threefry(cfg, "the D >= 3 field kernels")
        field_kernel_nd.check_nd_config(cfg)
        return "cuda_nd"
    lattice_bytes = math.prod(cfg.shape) * 4
    if cfg.tile_rows is None and lattice_bytes <= WHOLE_LATTICE_MAX_BYTES:
        return "cuda"
    _check_threefry(cfg, "the strip-tiled field kernel")
    return "cuda_tiled"


def _resolve_tile_rows(act, cfg: FieldConfig, route: str, device, sink) -> Optional[int]:
    """``tile_rows=0`` of an unsplit run, resolved and recorded: timed on the
    card for the D >= 3 kernels; in 2-D the strip-tiled kernel's default
    height (the JAX package's tiled path takes its default too); on the
    plain path the tile rule's default, unused."""
    if route == "cuda_nd":
        record = autotune.best_tile_rows(act, cfg, device=device)
    elif route == "cuda_tiled":
        record = {"type": "autotune", "tile_rows": field_kernel_tiled.resolve_tile_rows(cfg),
                  "reason": "2-D: the strip-tiled kernel's default height, as the JAX "
                            "package's tiled path takes its default"}
    else:
        record = {"type": "autotune",
                  "tile_rows": field_kernel_nd.default_tile_rows(cfg) if cfg.ndim >= 3 else None,
                  "reason": "the plain PyTorch integrator runs: no tile to choose"}
    sink.emit(dict(record))
    return record["tile_rows"]


def run_field(
    cfg: FieldConfig,
    *,
    device=None,
    backend: str = "auto",
    burn_frames: int = 0,
    sink: Optional[metrics_mod.MetricsSink] = None,
    checkpoint_out: Optional[str] = None,
    checkpoint_in: Optional[str] = None,
    checkpoint_every: int = 0,
    mesh=None,
    stop=None,
    resume_progress: bool = False,
) -> RunResult:
    """Run a D-dimensional field ensemble per the config on ``device``, or
    with ``mesh`` and ``cfg.mesh_axes`` split over the mesh's devices by the
    halo runner (``device`` then only says where whole states are assembled:
    default the mesh's first device); returns the final whole state.

    backend: 'auto', 'cuda' or 'torch' (under a mesh also 'cuda_step',
    'cuda_pair' and 'cuda_rdma'), resolved by :func:`select_field_backend`.
    ``tile_rows=0`` (D >= 3) and, under a mesh, ``exchange_steps=0`` are
    timed on the card (``kernels.autotune``) and recorded; on the plain path
    they resolve to the kernels' defaults, recorded with why.  A sharded
    checkpoint resumes under a mesh, block by block; without one it raises.
    On a mesh across processes (``parallel.distributed.global_mesh``) every
    process calls this with the same arguments: each runs its shards, writes
    the same records and its own sharded checkpoint, and gets its per-shard
    states back (``exchange_steps=0`` takes process 0's timed pick in every
    process: ``kernels.autotune.best_exchange_steps``).
    stop and resume_progress as in :func:`run_chain`: stop is polled once a
    frame group, after the group is enqueued and before the next one is; a
    stop that depends on the records sees, polled for group k, only record
    k - 1, so it runs and streams one group more, drained.

    Records are read one group late, as :func:`run_chain` reads them: group
    k's record (the five observables per chain, the last frame's Δτ row, the
    stable share) is enqueued on the device right after the group and
    copied into a host slot (:class:`_FieldRecords`), and read on the host
    only once group k+1 is enqueued too, so the device runs k+1 while the
    host waits on k's event, takes its means, streams it and calls the
    wrapper for k+2.  The records and states are those of a loop that reads
    each record at once.  A group is not followed before a checkpoint, at a
    stop or at the last frame: its record is read with nothing enqueued
    behind it (drained), so a checkpoint, a stop and the result hold the
    state the last record describes.  Under a mesh every record is drained
    and copied to the host at once (the halo runner's gather is
    synchronous).  The ``tracing.RECORD`` span covers the wait, the
    host-side numpy and the sink.  Four plain counters, 0 at import and set
    to 0 by their reader (``tools/span_check.py records``), as the kernel
    wrappers' ``launches`` are: ``run_field.records`` (records streamed),
    ``run_field.readbacks`` (the records' device-to-host copies, seven a
    record), ``run_field.records_ahead`` (records read with the next group
    already enqueued) and ``run_field.records_drained`` (records read with
    nothing enqueued behind them)."""
    sink = sink or metrics_mod.MetricsSink()
    act = actions_mod.get_field(cfg.action)
    split = None
    tile_rows = cfg.tile_rows
    if mesh is None:
        if device is None:
            raise ValueError("run_field needs device= (or mesh= with cfg.mesh_axes)")
        device = resolve_device(device)
        route = select_field_backend(cfg, backend, device)
        reason = field_fallback_reason(cfg, backend, device)
        if cfg.tile_rows == 0:
            tile_rows = _resolve_tile_rows(act, cfg, route, device, sink)
    else:
        split = _SplitState(
            field_mod.FieldState, cfg, mesh, _mesh_device(mesh, device),
            ("mag_mean", "mag2_mean", "mag4_mean", "absmag_mean", "phi2_mean"))
        route = select_field_backend(cfg, backend, device, mesh)
        device = split.device
        runner_cfg = cfg
        if cfg.exchange_steps == 0:
            record = (autotune.best_exchange_steps(act, cfg, mesh) if route != "torch" else
                      {"type": "autotune",
                       "exchange_steps": field_kernel_nd.default_exchange_steps(cfg),
                       "reason": "the plain PyTorch halo runner runs: the per-dimension default"})
            sink.emit(dict(record))
            runner_cfg = dataclasses.replace(cfg, exchange_steps=record["exchange_steps"])
            route = select_field_backend(runner_cfg, backend, device, mesh)
        reason = split_fallback_reason(runner_cfg, backend, mesh)  # at the W that runs
        runner = halo_mod.make_halo_runner(act, runner_cfg, mesh, backend=route)
        split.mesh = runner.mesh  # the records' gathers go through the runner's transport
    if reason:
        sink.emit({"type": "backend_fallback", "backend": route, "reason": reason})

    fields = ("action", "shape", "n_chains")
    if split:
        state = (split.load(checkpoint_in, cfg, fields) if checkpoint_in else
                 split.shard(field_mod.init_field_state(cfg, device=device)))
    elif checkpoint_in:
        state = _load_whole(checkpoint_in, device, cfg, fields)
    else:
        state = field_mod.init_field_state(cfg, device=device)

    def run_n(state, n):
        if split:
            return runner(state, n)
        if route == "cuda":
            return field_kernel.run_field_frames_kernel(
                state, act, cfg, n, frames_per_launch=min(cfg.frames_per_launch, n)
            )
        if route == "cuda_tiled":
            return field_kernel_tiled.run_field_frames_tiled(state, act, cfg, n, tile_rows=tile_rows)
        if route == "cuda_nd":
            return field_kernel_nd.run_field_frames_nd(state, act, cfg, n, tile_rows=tile_rows)
        return field_mod.run_field_frames(state, act, cfg, n)

    frames_done = (
        _frames_already_done(state[0] if split else state, cfg, checkpoint_in)
        if (resume_progress and checkpoint_in)
        else 0
    )
    if burn_frames and frames_done == 0:
        state, _ = run_n(state, burn_frames)
        state = ([field_mod.reset_field_means(s) for s in state] if split
                 else field_mod.reset_field_means(state))

    volume = math.prod(cfg.shape)
    fps = max(cfg.fps, 1)
    records = _FieldRecords(sink, cfg.frames, cfg.n_chains * volume * cfg.loops, volume,
                            sync=bool(split))

    def enqueue():
        # rebinds the run's own state, so the group's input is freed before its record's work
        nonlocal state, frames_done
        n = min(fps, cfg.frames - frames_done)
        state, m = run_n(state, n)
        frames_done += n
        records.push(split.scalars(state) if split else state, m, n, frames_done)

    ahead = False  # a group is enqueued behind the one whose record is read next
    while ahead or frames_done < cfg.frames:
        if not ahead:
            enqueue()
        stopping = stop is not None and stop()
        due = bool(checkpoint_out and checkpoint_every and frames_done % checkpoint_every == 0)
        ahead = not (split or stopping or due) and frames_done < cfg.frames
        if ahead:
            enqueue()
        records.deliver()
        run_field.records_ahead += ahead
        run_field.records_drained += not ahead
        if due:
            ckpt_mod.save_auto(checkpoint_out, state, cfg, mesh=mesh, frames_done=frames_done)
        if stopping:
            _preempt(sink, state, cfg, checkpoint_out, frames_done, mesh)
            break

    if split:
        runner.close()
        state = split.finish(state, cfg, checkpoint_out, frames_done)
    elif checkpoint_out:
        ckpt_mod.save(checkpoint_out, state, cfg, frames_done=frames_done)
    summary = sink.summary()
    sink.emit(summary)
    return RunResult(state=state, cfg=cfg, summary=summary)


run_field.records = 0
run_field.readbacks = 0
run_field.records_ahead = 0
run_field.records_drained = 0


def run_complex(
    cfg,
    *,
    device,
    burn_frames: int = 0,
    sink: Optional[metrics_mod.MetricsSink] = None,
    checkpoint_out: Optional[str] = None,
    checkpoint_in: Optional[str] = None,
    checkpoint_every: int = 0,
    stop=None,
    resume_progress: bool = False,
) -> RunResult:
    """Run a complex-Langevin ensemble on ``device``: 0-D
    (``ComplexLangevinConfig``), a 1-D chain (``ComplexChainConfig``) or a
    D-dim field (``ComplexFieldConfig``).  No kernel implements complex
    Langevin in either package, so there is no backend to choose: the plain
    PyTorch integrator runs on the device, the state never leaves it, and
    only the per-frame scalars come to the host.  A burn-in resets the means
    after it; stop and resume_progress as in :func:`run_chain`."""
    device = resolve_device(device)
    if isinstance(cfg, cfield.ComplexFieldConfig):
        init, run_n = cfield.init_cfield_state, cfield.run_cfield_frames
        reset, sites, geometry = cfield.reset_cfield_means, math.prod(cfg.shape), ("shape",)
    elif isinstance(cfg, cl.ComplexChainConfig):
        init, run_n = cl.init_ccl_state, cl.run_ccl_frames
        reset, sites, geometry = cl.reset_ccl_means, cfg.n_sites, ("n_sites",)
    elif isinstance(cfg, cl.ComplexLangevinConfig):
        init, run_n = cl.init_cl_state, cl.run_cl_frames
        reset, sites, geometry = cl.reset_cl_means, 1, ()
    else:
        raise TypeError(f"run_complex takes a complex-Langevin config, not {type(cfg).__name__}")
    act = complex_actions.get_complex(cfg.action, **dict(getattr(cfg, "action_params", ())))
    sink = sink or metrics_mod.MetricsSink()
    if checkpoint_in:
        state, loaded_cfg = ckpt_mod.load(checkpoint_in, device)
        _check_resume_compat(loaded_cfg, cfg, checkpoint_in, ("action", "n_chains") + geometry)
    else:
        state = init(cfg, device=device)
    frames_done = (
        _frames_already_done(state, cfg, checkpoint_in)
        if (resume_progress and checkpoint_in)
        else 0
    )
    if burn_frames and frames_done == 0:
        state, _ = run_n(state, act, cfg, burn_frames)
        state = reset(state)

    updates_per_frame = cfg.n_chains * sites * cfg.loops
    while frames_done < cfg.frames:
        state, m = run_n(state, act, cfg, 1)
        frames_done += 1
        obs = {
            "re_z2": float(state.z2r_mean.mean()),
            "im_z2": float(state.z2i_mean.mean()),
            "drift_max": float(m["drift_max"].max()),
        }
        sink.frame(
            frames_done - 1,
            cfg.frames,
            updates_per_frame,
            m["dtau"][-1].cpu().numpy(),
            float(m["stable"].float().mean()),
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


def select_gauge_backend(cfg: gauge_mod.GaugeConfig, backend: str, device, mesh=None):
    """Resolve a gauge run's path: ('cuda', None) for kernels 10 and 11, or
    ('torch', reason) for the plain PyTorch integrator, with ``reason`` set
    when 'auto' on a CUDA device falls back (the caller records it).

    'auto' takes the kernels on a CUDA device wherever they apply (2-D u1,
    su2, su3 without cooling: the JAX package's ``supports``); the other
    configurations (``su2_4d``, ``su3_4d``, the complexified groups ``cu1``,
    ``csu2``, ``csu3`` and gauge cooling) have no kernel in the JAX package
    either and run the plain path on the device.  'cuda' raises for a case
    the kernels do not cover, naming it; 'torch' is the plain path on any
    device.

    With ``mesh`` (and ``cfg.mesh_axes``) the links are split over the mesh
    and ``device`` is ignored: 'torch' is the per-step halo runner
    (``parallel.gauge_halo.make_gauge_halo_runner``, exact drift-cap rescale),
    'cuda' the chunk runner (kernel 12: a cap event rejects the frame).  The
    two differ in what a cap event does, so 'auto' keeps the per-step runner,
    as the JAX package does, and where kernel 12 would apply says so in
    ``reason``; 'cuda' opts into the chunk runner and raises for what it does
    not cover (the complexified groups, cooling, D != 2), naming it."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown gauge backend {backend!r}; known: {BACKENDS}")
    act = gauge_mod.resolve_gauge_action(cfg)
    if _check_mesh_cfg(cfg, mesh):
        on_cuda = _mesh_on_cuda(mesh)
        if backend == "cuda":
            if not on_cuda:
                raise ValueError("backend='cuda' runs the CUDA kernels and needs a mesh of CUDA "
                                 f"devices, not {sorted({str(d) for d in mesh.devices})}")
            gauge_kernel.check_kernel_config(act, cfg)  # the chunk runner's groups
            return "cuda", None
        if backend == "auto" and on_cuda and gauge_kernel.supports(act, cfg):
            return "torch", ("a split gauge run on 'auto' keeps the per-step halo runner (exact "
                             "drift-cap rescale); backend='cuda' opts into the chunk runner "
                             "(kernel 12), where a cap event rejects the frame")
        return "torch", None
    device = torch.device(device)
    if backend == "torch" or (backend == "auto" and device.type != "cuda"):
        return "torch", None
    if device.type != "cuda":
        raise ValueError(f"backend='cuda' runs the CUDA kernels and needs a CUDA device, not {device}")
    if backend == "cuda":
        gauge_kernel.check_kernel_config(act, cfg)
        return "cuda", None
    reason = gauge_kernel.unsupported_reason(act, cfg)
    if reason is None:
        return "cuda", None
    return "torch", (
        f"no gauge kernel for group {cfg.group} on shape {cfg.shape}: {reason}; the kernels "
        "cover 2-D u1/su2/su3 without cooling, so the plain PyTorch integrator runs on the device"
    )


def run_gauge(
    cfg: gauge_mod.GaugeConfig,
    *,
    device=None,
    backend: str = "auto",
    burn_frames: int = 0,
    sink: Optional[metrics_mod.MetricsSink] = None,
    checkpoint_out: Optional[str] = None,
    checkpoint_in: Optional[str] = None,
    checkpoint_every: int = 0,
    mesh=None,
    stop=None,
    resume_progress: bool = False,
) -> RunResult:
    """Run a lattice-gauge Langevin ensemble (``GaugeConfig``, compact or
    complexified group) on
    ``device``, or with ``mesh`` and ``cfg.mesh_axes`` split over the mesh's
    devices (``device`` then only says where whole states are assembled);
    returns the final whole state.

    backend: 'auto', 'cuda' or 'torch', resolved by
    :func:`select_gauge_backend`.  One metrics record per frame, as in the
    JAX package's runner, so ``frames_per_launch`` batches only the burn-in
    (kernel 11 there, kernel 10 + the PyTorch epilogue per recorded frame).
    Across processes as :func:`run_field`.  ``measure_loops`` adds the
    Polyakov loop along dim 0 to every record and a final ``wilson_loops``
    record; on a mesh both are computed shard-local
    (``observables.gauge_loops.split_polyakov_loop`` /
    ``split_wilson_loop_table``), never on a gathered lattice, and are the
    same in one process and across processes.
    stop and resume_progress as in :func:`run_chain`."""
    sink = sink or metrics_mod.MetricsSink()
    split = None
    if mesh is None:
        if device is None:
            raise ValueError("run_gauge needs device= (or mesh= with cfg.mesh_axes)")
        device = resolve_device(device)
        route, reason = select_gauge_backend(cfg, backend, device)
    else:
        split = _SplitState(gauge_mod.GaugeState, cfg, mesh, _mesh_device(mesh, device),
                            ("plaq_mean",))
        route, reason = select_gauge_backend(cfg, backend, device, mesh)
        device = split.device
    if reason:
        sink.emit({"type": "backend_fallback", "backend": "torch", "reason": reason})
    act = gauge_mod.resolve_gauge_action(cfg)
    if mesh is not None:
        make = (gauge_halo_mod.make_gauge_chunk_runner if route == "cuda"
                else gauge_halo_mod.make_gauge_halo_runner)
        runner = make(act, cfg, mesh)
        split.mesh = runner.mesh  # the records' gathers go through the runner's transport

    fields = ("group", "shape", "n_chains")
    if split:
        state = (split.load(checkpoint_in, cfg, fields) if checkpoint_in else
                 split.shard(gauge_mod.init_gauge_state(cfg, act, device=device)))
    elif checkpoint_in:
        state = _load_whole(checkpoint_in, device, cfg, fields)
    else:
        state = gauge_mod.init_gauge_state(cfg, act, device=device)

    def run_n(state, n):
        if split:
            return runner(state, n)
        if route == "cuda":
            return gauge_kernel.run_gauge_frames_kernel(
                state, act, cfg, n, frames_per_launch=min(cfg.frames_per_launch, n))
        return gauge_mod.run_gauge_frames(state, act, cfg, n)

    frames_done = (
        _frames_already_done(state[0] if split else state, cfg, checkpoint_in)
        if (resume_progress and checkpoint_in)
        else 0
    )
    if burn_frames and frames_done == 0:
        state, _ = run_n(state, burn_frames)
        state = ([gauge_mod.reset_gauge_means(s) for s in state] if split
                 else gauge_mod.reset_gauge_means(state))

    beta = complex(cfg.beta, cfg.beta_im) if cfg.beta_im else cfg.beta
    exact2d = gauge_mod.exact_plaquette_2d(cfg.group, beta) if cfg.ndim == 2 else None
    updates_per_frame = cfg.n_chains * cfg.ndim * math.prod(cfg.shape) * cfg.loops
    while frames_done < cfg.frames:
        state, m = run_n(state, 1)
        frames_done += 1
        view = split.scalars(state) if split else state
        plaq = complex(view.plaq_mean.mean())
        obs = {
            "plaquette": plaq.real,
            "plaquette_exact_2d": None if exact2d is None else float(np.real(exact2d)),
            "drift_max": float(m["drift_max"].max()),
        }
        if view.plaq_mean.is_complex():
            obs["plaquette_im"] = plaq.imag
            if exact2d is not None:
                obs["plaquette_exact_2d_im"] = float(np.imag(exact2d))
            obs["unitarity_norm"] = float(m["unitarity_norm"].max())
        if cfg.measure_loops:
            p = (gauge_loops.split_polyakov_loop(act, [s.links for s in state], cfg, split.mesh)
                 if split else gauge_loops.polyakov_loop(act, state.links, 0)).mean(dim=0)
            obs["polyakov_re"], obs["polyakov_im"] = float(p[0]), float(p[1])
        sink.frame(
            frames_done - 1,
            cfg.frames,
            updates_per_frame,
            m["dtau"][-1].cpu().numpy(),
            float(m["stable"].float().mean()),
            observables=obs,
        )
        if checkpoint_out and checkpoint_every and frames_done % checkpoint_every == 0:
            ckpt_mod.save_auto(checkpoint_out, state, cfg, mesh=mesh, frames_done=frames_done)
        if _stop_requested(stop, sink, state, cfg, checkpoint_out, frames_done, mesh):
            break

    if cfg.measure_loops:  # on a mesh before the runner's transport closes
        rmax = max(1, min(4, min(cfg.shape) // 2))
        table = (gauge_loops.split_wilson_loop_table(act, [s.links for s in state], cfg,
                                                     split.mesh, 0, 1, rmax, rmax) if split
                 else gauge_loops.wilson_loop_table(act, state.links, 0, 1, rmax, rmax))
    if split:
        runner.close()
        state = split.finish(state, cfg, checkpoint_out, frames_done)
    elif checkpoint_out:
        ckpt_mod.save(checkpoint_out, state, cfg, frames_done=frames_done)
    if cfg.measure_loops:
        sink.emit({"type": "wilson_loops", "mu": 0, "nu": 1,
                   "w": table.mean(dim=0).double().cpu().numpy().tolist()})
    summary = sink.summary()
    sink.emit(summary)
    return RunResult(state=state, cfg=cfg, summary=summary)

"""Device mesh, state placement and collectives (port of
``stochquant_tpu.parallel.mesh``).

The JAX package runs one ``shard_map`` program per device and lets XLA move
the data.  PyTorch has no twin of that, so the port's mesh is a
**single-process mesh of** ``torch.device`` **s**: one host thread drives every
shard in turn, each shard's tensors live on its own device, and kernels are
launched on that device's current stream.  A sharded state is a plain list of
per-shard local states, one per mesh position in C order of the mesh
coordinates.

A device may appear in the mesh more than once.  That is what lets one GPU
(or the CPU, in the tests) run a lattice that is really cut: with non-zero
global offsets, edge slices that need their neighbours, and reductions that
have to be completed across shards.  The JAX package gets the same from its
virtual CPU devices.  With one device repeated, all shards share a stream and
run one after the other.

The collectives are plain functions over the list of shards:

* :func:`ppermute` gives every shard its ring neighbour's tensor
  (``.to(device)`` when the devices differ; a copy between two streams of
  different devices is ordered after the producer's kernel by PyTorch);
* :func:`psum`, :func:`pmax` and :func:`pany` reduce the shards' partials in
  ascending mesh index, **once**, and hand the same tensor to every shard, so
  the replicas of a per-chain scalar can never part.  ``pmax`` propagates NaN
  (``torch.maximum``).

A mesh that spans processes (``parallel.distributed.global_mesh``) names
the *global* axis sizes and holds only this process's positions, a
contiguous run of the global positions in C order (so the first axis spans
the processes).  A shard has two indices: its place ``i`` in this process's
list, and its **global** mesh position (:meth:`DeviceMesh.global_index`);
coordinates, neighbours and groups are global, and a collective reads the
shards of other processes where its groups or rings reach them:

* CPU tensors through gloo (one all-gather, ``distributed.all_gather``):
  what the tests run;
* CUDA tensors through the runner's transport (``parallel.ipc``: this
  process's shards copied into device memory that the others map, ordered
  on the streams by counters).  A CUDA tensor never goes through gloo or the
  host; without a transport such a collective raises.

Every process then reduces the gathered partials in ascending global index,
once, as one process does, so the replicas cannot part and the run is the
one-process run on the same mesh shape bit for bit.  ``gather_state``
stays in one process (across processes a state is saved, not gathered:
``io.checkpoint.save_sharded``); the metrics and the per-chain scalars of a
record (:func:`gather_metrics`, :func:`gather_scalars`) reach every process.

Because the noise is keyed by global (chain, site, step) coordinates, any
placement produces the same field trajectory.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import Optional, Sequence, Tuple

import torch

from stochquant_tpu_torch.integrators.field import FieldState
from stochquant_tpu_torch.integrators.gauge import GaugeState, resolve_gauge_action
from stochquant_tpu_torch.integrators.langevin import ChainState, stack_metrics

__all__ = [
    "DeviceMesh",
    "make_mesh",
    "ppermute",
    "psum",
    "pmax",
    "pany",
    "pcat",
    "pfrom",
    "field_state_spec",
    "gauge_state_spec",
    "chain_state_spec",
    "state_spec",
    "shard_state",
    "gather_state",
    "shard_field_state",
    "gather_field_state",
    "shard_gauge_state",
    "gather_gauge_state",
    "shard_chain_state",
    "gather_chain_state",
    "shard_state_from_numpy",
    "gather_metrics",
    "gather_scalars",
    "split_geometry",
    "chain_split",
    "frame_loop",
]


@dataclasses.dataclass(frozen=True)
class DeviceMesh:
    """Named axes over a flat tuple of devices (C order of the coordinates).

    Across processes (``process_count`` > 1) ``shape`` is the global mesh and
    ``devices`` are this process's positions, the global ones
    ``process_index · size …`` in C order; coordinates are global.
    ``transport`` is the runner's cross-process transport of CUDA tensors
    (``parallel.ipc.attach``), ``None`` elsewhere."""

    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]
    devices: Tuple[torch.device, ...]
    process_index: int = 0
    process_count: int = 1
    transport: object = dataclasses.field(default=None, compare=False, repr=False)

    @property
    def size(self) -> int:
        """Positions this process holds (every position in one process)."""
        return len(self.devices)

    @property
    def n_positions(self) -> int:
        """Positions of the global mesh."""
        return self.size * self.process_count

    def axis_size(self, name: Optional[str]) -> int:
        """Shards along axis ``name``; 1 for ``None`` and for a name the mesh
        does not have (that dim then stays whole)."""
        if name not in self.axis_names:
            return 1
        return self.shape[self.axis_names.index(name)]

    def global_index(self, i: int) -> int:
        """The global mesh position of this process's shard ``i``."""
        return i + self.process_index * self.size

    def owner(self, g: int) -> int:
        """The process that holds global position ``g``."""
        return g // self.size

    def local(self, g: int) -> Optional[int]:
        """This process's list index of global position ``g``, or ``None``."""
        i = g - self.process_index * self.size
        return i if 0 <= i < self.size else None

    def global_coords(self, g: int) -> Tuple[int, ...]:
        return tuple(int(c) for c in _unravel(g, self.shape))

    def coords(self, i: int) -> Tuple[int, ...]:
        """Global coordinates of this process's position ``i``."""
        return self.global_coords(self.global_index(i))

    def coord(self, i: int, name: Optional[str]) -> int:
        """Shard ``i``'s coordinate along axis ``name``; 0 where
        :meth:`axis_size` is 1."""
        if name not in self.axis_names:
            return 0
        return self.coords(i)[self.axis_names.index(name)]

    def index(self, coords: Sequence[int]) -> int:
        """The global position of ``coords`` (periodic)."""
        i = 0
        for c, n in zip(coords, self.shape):
            i = i * n + c % n
        return i

    def shift(self, g: int, name: str, delta: int) -> int:
        """The global position ``delta`` steps from ``g`` along the ring of
        axis ``name``."""
        c = list(self.global_coords(g))
        c[self.axis_names.index(name)] += delta
        return self.index(c)

    def neighbor(self, i: int, name: str, delta: int) -> int:
        """The global position ``delta`` steps along the ring of axis ``name``
        from this process's shard ``i``."""
        return self.shift(self.global_index(i), name, delta)

    def groups(self, names: Sequence[str]) -> tuple:
        """The sets of global positions that differ only in their coordinates
        along ``names``, each in ascending order (in one process the list
        indices)."""
        return _groups(self.axis_names, self.shape, tuple(names))


@functools.lru_cache(maxsize=None)
def _groups(axis_names: tuple, shape: tuple, names: tuple) -> tuple:
    reduce_axes = {axis_names.index(n) for n in names}
    keyed: dict = {}
    for g in range(math.prod(shape)):
        key = tuple(v for a, v in enumerate(_unravel(g, shape)) if a not in reduce_axes)
        keyed.setdefault(key, []).append(g)
    return tuple(tuple(grp) for grp in keyed.values())


def _unravel(i: int, shape) -> list:
    out = []
    for n in reversed(shape):
        out.append(i % n)
        i //= n
    return out[::-1]


def _resolve(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"mesh device {device} requested but no CUDA device is available")
        index = torch.cuda.current_device() if device.index is None else device.index
        if index >= torch.cuda.device_count():
            raise RuntimeError(f"mesh device cuda:{index} requested but this machine has "
                               f"{torch.cuda.device_count()} CUDA device(s)")
        return torch.device("cuda", index)
    if device.type != "cpu":
        raise ValueError(f"unsupported mesh device {device}; use 'cuda' or 'cpu' devices")
    return device


def make_mesh(axes: Sequence[Tuple[str, int]], devices=None) -> DeviceMesh:
    """Build a mesh from (name, size) pairs, e.g. ``[("chain", 2), ("x", 4)]``.

    ``devices``: a list with at least one device per mesh position (a device
    may repeat), or a single device that every shard then shares, or ``None``
    for the machine's CUDA devices, one per position.  A CUDA device the
    machine lacks raises, as does a list that is too short."""
    names = tuple(n for n, _ in axes)
    sizes = tuple(int(s) for _, s in axes)
    if len(set(names)) != len(names) or any(s < 1 for s in sizes):
        raise ValueError(f"mesh axes need distinct names and sizes >= 1, got {list(axes)}")
    n = math.prod(sizes)
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n > have:
            raise ValueError(
                f"mesh needs {n} devices, this machine has {have} CUDA device(s): pass "
                "devices= (a device may repeat, e.g. devices='cuda:0' or 'cpu')")
        devices = [torch.device("cuda", i) for i in range(n)]
    elif isinstance(devices, (str, torch.device)):
        devices = [devices] * n
    devices = list(devices)
    if n > len(devices):
        raise ValueError(f"mesh needs {n} devices, have {len(devices)}")
    return DeviceMesh(names, sizes, tuple(_resolve(d) for d in devices[:n]))


# ---------------------------------------------------------------------------
# collectives over the list of shards
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _exchanged(xs: list, mesh: DeviceMesh, crosses: bool):
    """Yields ``get(g)``: the tensor of global position ``g`` for this call of
    a collective, whose groups reach other processes where ``crosses``.
    This process's shards are its own tensors; another process's come through
    gloo (CPU tensors) or the mesh's transport (CUDA tensors), as fresh
    tensors on this process's device."""
    if mesh.process_count == 1 or not crosses:
        yield lambda g: xs[mesh.local(g)]
        return
    if xs[0].device.type == "cpu":
        from stochquant_tpu_torch.parallel import distributed

        rows = [t for part in distributed.all_gather(torch.stack(list(xs)))
                for t in part.unbind(0)]
        yield lambda g: xs[mesh.local(g)] if mesh.local(g) is not None else rows[g]
        return
    if mesh.transport is None:
        raise ValueError(
            f"a collective over CUDA tensors reaches the shards of {mesh.process_count} processes "
            "but the mesh has no transport: CUDA tensors cross processes only through device "
            "memory the processes share (parallel.ipc.attach, which the runners call), never "
            "through gloo or the host")
    call = mesh.transport.publish(xs)
    try:
        yield lambda g: (xs[mesh.local(g)] if mesh.local(g) is not None
                         else call.fetch(mesh.owner(g), g % mesh.size))
    finally:
        call.done()


def _owners_differ(mesh: DeviceMesh, groups) -> bool:
    return mesh.process_count > 1 and any(
        len({mesh.owner(g) for g in grp}) > 1 for grp in groups)


def pfrom(xs: list, mesh: DeviceMesh, src) -> list:
    """``out[i]`` = the tensor of global position ``src(g)`` for this
    process's shard ``i`` at global position ``g``, on shard ``i``'s device.
    ``src`` maps every global position (those of other processes too) to
    the one it reads."""
    crosses = mesh.process_count > 1 and any(
        mesh.owner(src(g)) != mesh.owner(g) for g in range(mesh.n_positions))
    with _exchanged(xs, mesh, crosses) as get:
        return [get(src(mesh.global_index(i))).to(mesh.devices[i]) for i in range(mesh.size)]


def ppermute(xs: list, mesh: DeviceMesh, axis: str, delta: int) -> list:
    """``out[i]`` = the tensor of the shard ``delta`` steps along ``axis``
    from shard ``i`` (periodic), on shard ``i``'s device."""
    return pfrom(xs, mesh, lambda g: mesh.shift(g, axis, delta))


def _preduce(xs: list, mesh: DeviceMesh, axes: Sequence[str], op) -> list:
    axes = [a for a in axes if a]
    if not axes:
        return list(xs)
    groups = mesh.groups(axes)
    out = [None] * mesh.size
    with _exchanged(xs, mesh, _owners_differ(mesh, groups)) as get:
        for group in groups:
            mine = [mesh.local(g) for g in group if mesh.local(g) is not None]
            if not mine:
                continue
            acc = get(group[0])
            for g in group[1:]:
                acc = op(acc, get(g).to(acc.device))
            for i in mine:
                out[i] = acc.to(mesh.devices[i])
    return out


def psum(xs: list, mesh: DeviceMesh, axes: Sequence[str]) -> list:
    """Sum over the shards along ``axes``, in ascending mesh index."""
    return _preduce(xs, mesh, axes, torch.add)


def pmax(xs: list, mesh: DeviceMesh, axes: Sequence[str]) -> list:
    """Max over the shards along ``axes``; NaN propagates."""
    return _preduce(xs, mesh, axes, torch.maximum)


def pany(xs: list, mesh: DeviceMesh, axes: Sequence[str]) -> list:
    """Logical or over the shards along ``axes``."""
    return _preduce(xs, mesh, axes, torch.logical_or)


def pcat(xs: list, mesh: DeviceMesh, axes: Sequence[str], dim: int) -> list:
    """The tensors of the shards along ``axes`` joined along ``dim`` in
    ascending mesh index, once, and handed to each of them: the partials of a
    reduction that the receiver completes itself."""
    axes = [a for a in axes if a]
    if not axes:
        return list(xs)
    groups = mesh.groups(axes)
    out = [None] * mesh.size
    with _exchanged(xs, mesh, _owners_differ(mesh, groups)) as get:
        for group in groups:
            mine = [mesh.local(g) for g in group if mesh.local(g) is not None]
            if not mine:
                continue
            lead = mesh.devices[mine[0]]
            joined = torch.cat([get(g).to(lead) for g in group], dim=dim)
            for i in mine:
                out[i] = joined.to(mesh.devices[i])
    return out


# ---------------------------------------------------------------------------
# state placement: a spec names the mesh axis of every tensor dim
# ---------------------------------------------------------------------------


def field_state_spec(cfg) -> FieldState:
    """Per leaf, the mesh axis of each dim: phi over (chain, *mesh_axes); the
    per-chain scalars over chain; the time-slice correlator over (chain,
    axis of lattice dim 0); ``step`` whole on the host."""
    ca = cfg.mesh_chain_axis
    lat = tuple(cfg.mesh_axes or (None,) * cfg.ndim)
    row = (ca,)
    return FieldState(
        phi=(ca, *lat), mag_mean=row, mag2_mean=row, mag4_mean=row, absmag_mean=row,
        phi2_mean=row, act_mean=row, corr_mean=(ca, lat[0]),
        runs=(ca, None), dtau=row, stab_cnt=row, lrg_vl=row, step=None,
    )


def gauge_state_spec(action, cfg) -> GaugeState:
    """Per leaf, the mesh axis of each dim: links over chain and, on the
    action's lattice axes, ``cfg.mesh_axes``; the rest over chain."""
    ca = cfg.mesh_chain_axis
    lat = tuple(cfg.mesh_axes or (None,) * cfg.ndim)
    links = [None] * len(action.state_shape(cfg.n_chains, cfg.ndim, cfg.shape))
    links[0] = ca
    for d, axis in enumerate(action.lattice_axes(cfg.ndim)):
        links[axis] = lat[d]
    row = (ca,)
    return GaugeState(links=tuple(links), plaq_mean=row, drift_max=row, runs=(ca, None),
                      dtau=row, stab_cnt=row, step=None)


def chain_state_spec(chain_axis: Optional[str]) -> ChainState:
    """Chains sharded, sites local."""
    row, mat = (chain_axis,), (chain_axis, None)
    return ChainState(
        f=mat, omega=row, x_mean=mat, xx0_mean=mat, x2_mean=mat, x4_mean=mat,
        runs=mat, dtau=row, stab_cnt=row, lrg_vl=row, spec_mean=mat, step=None,
    )


def state_spec(cls, cfg):
    """The spec of a state of class ``cls`` split as ``cfg`` says: the one
    layout of the runners' shards and of a sharded checkpoint."""
    if cls is ChainState:
        return chain_state_spec(cfg.mesh_chain_axis)
    if cls is FieldState:
        return field_state_spec(cfg)
    if cls is GaugeState:
        return gauge_state_spec(resolve_gauge_action(cfg), cfg)
    raise ValueError(f"no sharded layout for a {cls.__name__}: chain, field and gauge states "
                     "split over a mesh")


def _block_at(spec, mesh: DeviceMesh, g: int, shape) -> tuple:
    """The index of global position ``g``'s block of a whole tensor of ``shape``."""
    coords = mesh.global_coords(g)
    index = []
    for d, name in enumerate(spec):
        n = mesh.axis_size(name)
        if shape[d] % n:
            raise ValueError(f"dim {d} of extent {shape[d]} is not divisible by mesh axis "
                             f"{name!r} of size {n}")
        loc = shape[d] // n
        c = coords[mesh.axis_names.index(name)] if name in mesh.axis_names else 0
        index.append(slice(c * loc, (c + 1) * loc))
    return tuple(index)


def _block(spec, mesh: DeviceMesh, i: int, shape) -> tuple:
    """The index of this process's shard ``i``'s block of a whole tensor."""
    return _block_at(spec, mesh, mesh.global_index(i), shape)


def shard_state(state, spec, mesh: DeviceMesh) -> list:
    """A whole state → the list of per-shard local states (each leaf a
    contiguous copy on its shard's device; ``step`` shared, on the host)."""
    shards = []
    for i, dev in enumerate(mesh.devices):
        leaves = []
        for leaf, sp in zip(state, spec):
            if sp is None:
                leaves.append(leaf)
            else:
                leaves.append(leaf[_block(sp, mesh, i, leaf.shape)].to(dev).clone(
                    memory_format=torch.contiguous_format))
        shards.append(type(state)(*leaves))
    return shards


def _one_process(mesh: DeviceMesh, what: str) -> None:
    if mesh.process_count > 1:
        raise ValueError(f"{what} needs every shard in this process; a mesh across "
                         f"{mesh.process_count} processes saves and loads its shards "
                         "(io.checkpoint.save_sharded / load_sharded)")


def gather_state(shards: list, spec, mesh: DeviceMesh, device=None):
    """The inverse of :func:`shard_state`: the whole state on ``device``
    (default: the mesh's first device), in one process (a run loop reads the
    per-chain scalars of every record through :func:`gather_scalars`)."""
    _one_process(mesh, "gather_state")
    device = mesh.devices[0] if device is None else torch.device(device)
    leaves = []
    for k, sp in enumerate(spec):
        first = shards[0][k]
        if sp is None:
            leaves.append(first)
            continue
        shape = [n * mesh.axis_size(ax) for n, ax in zip(first.shape, sp)]
        whole = torch.empty(shape, dtype=first.dtype, device=device)
        for i in range(mesh.size):
            whole[_block(sp, mesh, i, shape)] = shards[i][k].to(device)
        leaves.append(whole)
    return type(shards[0])(*leaves)


def shard_field_state(state: FieldState, mesh: DeviceMesh, cfg) -> list:
    return shard_state(state, field_state_spec(cfg), mesh)


def gather_field_state(shards: list, mesh: DeviceMesh, cfg, device=None) -> FieldState:
    return gather_state(shards, field_state_spec(cfg), mesh, device)


def shard_gauge_state(state: GaugeState, action, mesh: DeviceMesh, cfg) -> list:
    return shard_state(state, gauge_state_spec(action, cfg), mesh)


def gather_gauge_state(shards: list, action, mesh: DeviceMesh, cfg, device=None) -> GaugeState:
    return gather_state(shards, gauge_state_spec(action, cfg), mesh, device)


def shard_chain_state(state: ChainState, mesh: DeviceMesh, chain_axis: str = "chain") -> list:
    return shard_state(state, chain_state_spec(chain_axis), mesh)


def gather_chain_state(shards: list, mesh: DeviceMesh, chain_axis: str = "chain",
                       device=None) -> ChainState:
    return gather_state(shards, chain_state_spec(chain_axis), mesh, device)


def shard_state_from_numpy(arrays: dict, mesh: DeviceMesh, cfg, action=None) -> list:
    """The JAX package's state as numpy arrays (a sharded ``jax.Array``
    gathers with ``np.asarray``) → this package's per-shard states for
    ``mesh`` and ``cfg``: both packages then start a split run from the same
    bits.  ``action`` is needed for a gauge state."""
    from stochquant_tpu_torch.io import checkpoint

    state = checkpoint.state_from_numpy(arrays, "cpu")
    if isinstance(state, FieldState):
        return shard_field_state(state, mesh, cfg)
    if isinstance(state, GaugeState):
        return shard_gauge_state(state, action, mesh, cfg)
    return shard_chain_state(state, mesh, cfg.mesh_chain_axis)


def _gather_whole(parts: list, spec, mesh: DeviceMesh, device) -> torch.Tensor:
    """The whole tensor of the per-shard blocks ``parts`` (laid out by
    ``spec``), in every process: each block read once, from this process's
    first shard that holds it, else from the first global position that does
    (the others hold bitwise replicas); nothing moves between processes that
    each hold every block."""
    shape = [n * mesh.axis_size(ax) for n, ax in zip(parts[0].shape, spec)]
    whole = torch.empty(shape, dtype=parts[0].dtype, device=device)
    holders = {}
    for g in range(mesh.n_positions):
        holders.setdefault(_block_at(spec, mesh, g, shape), []).append(g)
    crosses = any(len({mesh.owner(g) for g in gs}) < mesh.process_count
                  for gs in holders.values())
    with _exchanged(parts, mesh, crosses) as get:
        for block, gs in holders.items():
            mine = [g for g in gs if mesh.local(g) is not None]
            whole[block] = get(mine[0] if mine else gs[0]).to(device)
    return whole


def gather_metrics(per_shard: list, mesh: DeviceMesh, chain_axis: Optional[str]) -> dict:
    """Per-shard metrics of (frames, C_local) leaves → (frames, C) in global
    chain order on the mesh's first device, in every process (the shards
    along the lattice axes hold replicas)."""
    return {key: _gather_whole([m[key] for m in per_shard], (None, chain_axis), mesh,
                               mesh.devices[0]) for key in per_shard[0]}


def gather_scalars(shards: list, spec, mesh: DeviceMesh, names, device=None):
    """The per-chain leaves ``names`` of a split state whole on ``device``
    (default: the mesh's first device), in every process; the other leaves
    come back as ``None``.  A leaf split over a lattice axis raises: the
    lattice is gathered in one process only (:func:`gather_state`)."""
    device = mesh.devices[0] if device is None else torch.device(device)
    leaves = []
    for k, (name, sp) in enumerate(zip(spec._fields, spec)):
        if name not in names:
            leaves.append(None)
        elif sp is None:
            leaves.append(shards[0][k])
        else:
            if any(ax is not None and ax != sp[0] for ax in sp[1:]):
                raise ValueError(f"gather_scalars gathers per-chain leaves, not {name!r} "
                                 f"split over {sp}")
            leaves.append(_gather_whole([s[k] for s in shards], sp, mesh, device))
    return type(shards[0])(*leaves)


# ---------------------------------------------------------------------------
# what the field and gauge runners share
# ---------------------------------------------------------------------------


def split_geometry(cfg, mesh: DeviceMesh):
    """How ``cfg.mesh_axes`` / ``cfg.mesh_chain_axis`` cut a run over ``mesh``:
    (shards per lattice dim, the local lattice shape, chains per shard, and per
    shard its global chain offset and its global lattice offsets).  Raises
    where an extent does not divide."""
    lat_spec = tuple(cfg.mesh_axes)
    if len(lat_spec) != cfg.ndim:
        raise ValueError(f"mesh_axes {lat_spec} must name one entry per lattice dim of {cfg.shape}")
    sizes = tuple(mesh.axis_size(ax) for ax in lat_spec)
    local_shape = tuple(s // n for s, n in zip(cfg.shape, sizes))
    for s, ls, n, ax in zip(cfg.shape, local_shape, sizes, lat_spec):
        if ls * n != s:
            raise ValueError(f"lattice dim {s} not divisible by mesh axis {ax}")
    c_local = cfg.n_chains // mesh.axis_size(cfg.mesh_chain_axis)
    if c_local * mesh.axis_size(cfg.mesh_chain_axis) != cfg.n_chains:
        raise ValueError(f"n_chains {cfg.n_chains} not divisible by mesh axis "
                         f"{cfg.mesh_chain_axis}")
    ch_offs = [mesh.coord(i, cfg.mesh_chain_axis) * c_local for i in range(mesh.size)]
    lat_offs = [tuple(mesh.coord(i, ax) * ls for ax, ls in zip(lat_spec, local_shape))
                for i in range(mesh.size)]
    return sizes, local_shape, c_local, ch_offs, lat_offs


def chain_split(n_chains: int, mesh: DeviceMesh, chain_axis: Optional[str]):
    """(chains per shard, each shard's global chain offset) for ``n_chains``
    chains split over ``chain_axis``; raises where they do not divide."""
    n = mesh.axis_size(chain_axis)
    if n_chains % n:
        raise ValueError(f"n_chains {n_chains} not divisible by mesh axis {chain_axis!r} "
                         f"of size {n}")
    c_local = n_chains // n
    return c_local, [mesh.coord(i, chain_axis) * c_local for i in range(mesh.size)]


def frame_loop(frame, mesh: DeviceMesh, chain_axis: Optional[str]):
    """``run(shards, n_frames) -> (shards, metrics)`` around a runner's
    ``frame(shards) -> (shards, per-shard metrics)``; the metrics come back as
    (n_frames, C) tensors on the mesh's first device, in every process.
    Across processes on the card the run ends when this process's stream
    has done its frames (``ipc.Transport.settle``: a peer that stops raises
    past the transport's time limit); ``run.close()`` closes the transport."""
    def run(states, n_frames: int):
        if len(states) != mesh.size:
            raise ValueError(f"expected {mesh.size} per-shard states, got {len(states)}")
        per_frame = []
        for _ in range(n_frames):
            states, m = frame(states)
            per_frame.append(m)
        per_shard = [stack_metrics([m[i] for m in per_frame]) for i in range(mesh.size)]
        metrics = gather_metrics(per_shard, mesh, chain_axis)
        if mesh.transport is not None:
            mesh.transport.settle()
        return states, metrics

    run.mesh = mesh  # with its transport: what the caller's own collectives go through
    run.close = lambda: mesh.transport.close() if mesh.transport is not None else None
    return run

"""Chain and field checkpoints in the JAX package's ``.npz`` format.

A checkpoint is one ``.npz`` with an entry ``state_<leaf>`` per state leaf
plus a ``meta`` record (``kind``, the config's JSON, ``version`` and, when
given, ``frames_done``) — the layout of
``stochquant_tpu.io.checkpoint.save``, so a checkpoint written by either
package resumes in the other.  On disk ``runs`` is a ``(C, 2)`` uint32
(lo, hi) pair and ``step`` a uint32 scalar; in memory they are int64
tensors holding the same words.  Every kind of the JAX package's
single-file format is ported:

* ``"chain"`` (``ChainState``) and ``"field"`` (``FieldState``);
* ``"gauge"`` (``GaugeState``): SU(3) links complex64 ``(C, D, *L, 3, 3)``;
  the complexified groups' links complex64, ``cu1`` ``(C, D, *L)`` and
  ``csu2`` / ``csu3`` ``(C, D, *L, N, N)``, with a complex64 ``plaq_mean``;
* ``"complex0d"`` (``CLState``), ``"complex_chain"`` (``ComplexChainState``)
  and ``"complex_field"`` (``ComplexFieldState``): real and imaginary parts
  as float32 leaves.

The leaves of ``ComplexChainState`` are a subset of those of the other two
complex kinds, so a state class is told by its kind tag or by the exact set
of its leaf names, never by a subset.

Sharded checkpoints (:func:`save_sharded`, :func:`load_sharded`) keep the
JAX package's per-process format: ``{path}.proc{i}-of-{n}.npz``, each block
of a leaf under ``shard_{leaf}__{a:b,c:d,...}`` (its global index), and a
``meta`` record of ``version`` 2 with ``sharded``, ``process_index``,
``process_count``, the per-leaf mesh axes (``specs``) and global ``shapes``.
A process writes the blocks its shards hold and reads the blocks its mesh
needs, so a sharded checkpoint written by either package resumes in the
other.  :func:`export_reference` / :func:`import_reference` convert one
chain to and from the reference's "%a" text format (``reference_fmt``).
"""

from __future__ import annotations

import glob as glob_mod
import json
import os
import re
import warnings

import numpy as np
import torch

from stochquant_tpu_torch.config import ChainConfig, FieldConfig
from stochquant_tpu_torch.integrators import accum
from stochquant_tpu_torch.integrators.complex_field import ComplexFieldConfig, ComplexFieldState
from stochquant_tpu_torch.integrators.complex_langevin import (
    CLState,
    ComplexChainConfig,
    ComplexChainState,
    ComplexLangevinConfig,
)
from stochquant_tpu_torch.integrators.field import FieldState
from stochquant_tpu_torch.integrators.gauge import GaugeConfig, GaugeState
from stochquant_tpu_torch.integrators.langevin import ChainState, connected_correlator
from stochquant_tpu_torch.io import reference_fmt

# kind tag -> (state class, config class); the JAX package's on-disk tags
_KIND = {
    "chain": (ChainState, ChainConfig),
    "field": (FieldState, FieldConfig),
    "complex0d": (CLState, ComplexLangevinConfig),
    "complex_chain": (ComplexChainState, ComplexChainConfig),
    "complex_field": (ComplexFieldState, ComplexFieldConfig),
    "gauge": (GaugeState, GaugeConfig),
}
_STATE_KIND = {cls: kind for kind, (cls, _) in _KIND.items()}
_U32_LEAVES = ("runs", "step")
# moment channels older checkpoints lack, with the second moment they are
# shaped like (backfilled with zeros, as the JAX package does)
_MOMENT_BACKFILL = {"x4_mean": "x2_mean", "mag4_mean": "mag2_mean"}


def state_to_numpy(state) -> dict:
    """Host numpy arrays, leaf for leaf, in the JAX package's dtypes."""
    out = {}
    for name, leaf in zip(state._fields, state):
        a = leaf.detach().cpu().numpy()
        out[name] = a.astype(np.uint32) if name in _U32_LEAVES else a
    return out


def state_from_numpy(arrays: dict, device, kind=None):
    """The state of ``kind`` (a tag of the on-disk format) on ``device`` from
    numpy arrays, e.g. the leaves of the JAX package's state; without
    ``kind``, the state class whose leaf names are exactly the keys of
    ``arrays``.  ``step`` stays on the host."""
    if kind is not None:
        cls = _KIND[kind][0]
    else:
        found = [c for c in _STATE_KIND if set(c._fields) == set(arrays)]
        if len(found) != 1:
            raise ValueError(f"leaves {sorted(arrays)} match no single state class: {found}")
        cls = found[0]
    leaves = []
    for name in cls._fields:
        a = np.asarray(arrays[name])
        if name in _U32_LEAVES:
            a = a.astype(np.int64)
        t = torch.from_numpy(np.array(a))  # a writable copy the tensor owns
        leaves.append(t if name == "step" else t.to(device))
    return cls(*leaves)


def _prune_stale_shards(path, keep_count=None) -> None:
    """Delete ``{path}.proc*-of-*.npz`` files of an earlier generation, except
    those of a ``keep_count``-process save: a stale shard would shadow a fresh
    save in the loader, or make a sharded state win over a fresh single file.
    Several processes may prune at once; a file already gone is fine."""
    for f in glob_mod.glob(f"{glob_mod.escape(str(path))}.proc*-of-*.npz"):
        m = re.search(r"\.proc\d+-of-(\d+)\.npz$", f)
        if m and keep_count is not None and int(m.group(1)) == keep_count:
            continue
        try:
            os.remove(f)
        except FileNotFoundError:
            pass  # another process pruned it first


def _write(path, payload: dict, meta: dict) -> None:
    payload["meta"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    with open(path, "wb") as fh:
        np.savez(fh, **payload)


def save(path, state, cfg, *, frames_done=None) -> None:
    """Write the full state + config (and the completed-frame count); a
    sharded checkpoint of an earlier save at ``path`` is removed.  A list of
    per-shard states raises: across processes no process holds the whole
    state (the JAX package's ``save`` cannot gather such an array either)."""
    if isinstance(state, (list, tuple)) and not hasattr(state, "_fields"):
        raise ValueError("save writes a whole state, not a list of per-shard states: the shards "
                         "of a mesh across processes are written by save_sharded (one file a "
                         "process, io.checkpoint.save_sharded / load_sharded)")
    payload = {f"state_{name}": a for name, a in state_to_numpy(state).items()}
    meta = {"kind": _STATE_KIND[type(state)], "config": cfg.to_json(), "version": 1}
    if frames_done is not None:
        meta["frames_done"] = int(frames_done)
    _write(path, payload, meta)
    _prune_stale_shards(path, keep_count=None)


def read_meta(path) -> dict:
    """The metadata record of a checkpoint, without the arrays."""
    with np.load(path) as z:
        return json.loads(bytes(z["meta"].tobytes()).decode())


def load(path, device):
    """Returns (state on ``device``, cfg).

    Older layouts load as the JAX package loads them: a (C,) ``runs`` gains
    a zero high word, and a missing ``x4_mean`` / ``mag4_mean`` is
    backfilled with zeros (warned: its estimate is unbiased only after the
    next reset of the means).
    """
    with np.load(path) as z:
        meta = json.loads(bytes(z["meta"].tobytes()).decode())
        if meta["kind"] not in _KIND:
            raise ValueError(f"checkpoint {path} holds a {meta['kind']!r} run; the known "
                             f"kinds are {sorted(_KIND)}")
        cls, cfg_cls = _KIND[meta["kind"]]
        arrays = {}
        for name in cls._fields:
            key = f"state_{name}"
            if key in z:
                arrays[name] = z[key]
            elif name in _MOMENT_BACKFILL:
                arrays[name] = np.zeros_like(z[f"state_{_MOMENT_BACKFILL[name]}"])
                warnings.warn(
                    f"checkpoint {path} predates the {name} channel; backfilled "
                    "with zeros — the fourth-moment estimate is only unbiased "
                    "after the next reset of the running means",
                    stacklevel=2,
                )
            else:
                raise KeyError(f"checkpoint {path} is missing leaf {name!r}")
    if arrays["runs"].ndim == 1:
        arrays["runs"] = np.stack([arrays["runs"], np.zeros_like(arrays["runs"])], axis=-1)
    return state_from_numpy(arrays, device, meta["kind"]), cfg_cls.from_json(meta["config"])


# ---------------------------------------------------------------------------
# sharded checkpoints: one file per process, each holding its shards' blocks
# ---------------------------------------------------------------------------


def shard_path(path, process_index: int, process_count: int) -> str:
    return f"{path}.proc{process_index}-of-{process_count}.npz"


def is_sharded_checkpoint(path) -> bool:
    """True if ``path`` names a sharded checkpoint (per-process files)."""
    return bool(glob_mod.glob(f"{glob_mod.escape(str(path))}.proc*-of-*.npz"))


def read_meta_any(path) -> dict:
    """:func:`read_meta` for either flavour (single file or sharded)."""
    if is_sharded_checkpoint(path):
        return read_meta(sorted(glob_mod.glob(f"{glob_mod.escape(str(path))}.proc*-of-*.npz"))[0])
    return read_meta(path)


def _shard_key(index, shape) -> str:
    """A block's global position, 'a:b,c:d,...' (the JAX package's key)."""
    parts = []
    for sl, dim in zip(index, shape):
        start = 0 if sl.start is None else int(sl.start)
        stop = dim if sl.stop is None else int(sl.stop)
        parts.append(f"{start}:{stop}")
    return ",".join(parts) if parts else ":"


def _spec_to_json(name: str, sp) -> list:
    """A leaf's mesh axes as the JAX package writes its PartitionSpec:
    ``[]`` for a replicated leaf, ``runs`` by its chain axis alone."""
    if sp is None:
        return []
    return [sp[0]] if name == "runs" else list(sp)


def _spec_from_json(entries, ndim: int) -> tuple:
    if any(isinstance(e, list) for e in entries):
        raise ValueError(f"a dim split over several mesh axes ({entries}) has no counterpart "
                         "in this package's mesh")
    return tuple(entries) + (None,) * (ndim - len(entries))


def _host(name: str, t) -> np.ndarray:
    a = t.detach().cpu().numpy()
    return a.astype(np.uint32) if name in _U32_LEAVES else a


def save_sharded(path, shards: list, cfg, mesh, *, frames_done=None) -> str:
    """Write the blocks that this process's ``shards`` (the per-shard states
    of ``mesh``, as ``parallel.mesh.shard_state`` makes them) hold, each once,
    to ``{path}.proc{i}-of-{n}.npz`` with the mesh's process index and count.
    Every process of a mesh across processes calls it.  Returns the file."""
    from stochquant_tpu_torch.parallel import mesh as mesh_mod

    cls = type(shards[0])
    spec = mesh_mod.state_spec(cls, cfg)
    payload, specs, shapes = {}, {}, {}
    for k, name in enumerate(cls._fields):
        sp, first = spec[k], shards[0][k]
        specs[name] = _spec_to_json(name, sp)
        if sp is None:
            shapes[name] = list(first.shape)
            key = _shard_key((slice(None),) * first.dim(), first.shape)
            payload[f"shard_{name}__{key}"] = _host(name, first)
            continue
        shape = [n * mesh.axis_size(ax) for n, ax in zip(first.shape, sp)]
        if shape[0] != cfg.n_chains:
            raise ValueError(f"leaf {name!r} holds {shape[0]} chains over the mesh, not "
                             f"cfg.n_chains={cfg.n_chains}: cfg.mesh_chain_axis must name the "
                             "mesh axis the chains are split over")
        shapes[name] = shape
        for i in range(mesh.size):
            key = _shard_key(mesh_mod._block(sp, mesh, i, shape), shape)
            if f"shard_{name}__{key}" not in payload:  # replicas hold one block once
                payload[f"shard_{name}__{key}"] = _host(name, shards[i][k])
    meta = {
        "kind": _STATE_KIND[cls], "config": cfg.to_json(), "version": 2, "sharded": True,
        "process_index": mesh.process_index, "process_count": mesh.process_count,
        "specs": specs, "shapes": shapes,
    }
    if frames_done is not None:
        meta["frames_done"] = int(frames_done)
    out = shard_path(path, mesh.process_index, mesh.process_count)
    _write(out, payload, meta)
    _prune_stale_shards(path, keep_count=mesh.process_count)
    return out


def load_sharded(path, mesh):
    """Restore a sharded checkpoint onto ``mesh``: the per-shard states (each
    leaf on its shard's device, ``step`` on the host) and the config.

    Reads every per-process file it finds and takes the blocks its own
    shards need, matched by global index; the mesh's shard boundaries must
    align with the saved ones (the device count per axis may differ).  Files
    of different save generations raise."""
    from stochquant_tpu_torch.parallel import mesh as mesh_mod

    files = sorted(glob_mod.glob(f"{glob_mod.escape(str(path))}.proc*-of-*.npz"))
    if not files:
        raise FileNotFoundError(f"no sharded checkpoint files at {path}.proc*")
    metas, blocks = [], {}
    for f in files:
        with np.load(f) as z:
            metas.append(json.loads(bytes(z["meta"].tobytes()).decode()))
            for k in z.files:
                if k.startswith("shard_"):
                    name, key = k[len("shard_"):].rsplit("__", 1)
                    blocks.setdefault(name, {})[key] = z[k]
    gens = {(m.get("version"), m.get("process_count")) for m in metas}
    if len(gens) > 1:
        raise ValueError(f"checkpoint {path}: mixed shard generations {sorted(gens)} — files "
                         "from different saves (version, process_count) found; delete the "
                         "stale ones")
    meta = metas[0]
    cls, cfg_cls = _KIND[meta["kind"]]
    cfg = cfg_cls.from_json(meta["config"])
    if "runs" in blocks and len(meta["shapes"].get("runs", ())) == 1:  # a (C,) runs of old
        blocks["runs"] = {f"{k},0:2": np.stack([v, np.zeros_like(v)], axis=-1)
                          for k, v in blocks["runs"].items()}
        meta["shapes"]["runs"] = list(meta["shapes"]["runs"]) + [2]
    per_shard = [{} for _ in range(mesh.size)]
    for name in cls._fields:
        shape = tuple(meta["shapes"][name])
        sp = _spec_from_json(meta["specs"][name], len(shape))
        available = blocks.get(name, {})
        for i in range(mesh.size):
            key = _shard_key(mesh_mod._block(sp, mesh, i, shape), shape)
            if key not in available:
                raise ValueError(
                    f"checkpoint {path}: leaf {name!r} is missing shard {key} (files visible: "
                    f"{len(files)}/{meta['process_count']}; restore mesh shard boundaries must "
                    "align with the saved ones)")
            per_shard[i][name] = available[key]
    return [state_from_numpy(a, dev, meta["kind"]) for a, dev in zip(per_shard, mesh.devices)], cfg


def save_auto(path, state, cfg, *, mesh=None, frames_done=None) -> None:
    """:func:`save` of a whole state, or of the per-shard states of ``mesh``
    gathered, where one process holds every shard; :func:`save_sharded`
    where the mesh spans processes (no process can gather the state)."""
    if mesh is None:
        save(path, state, cfg, frames_done=frames_done)
    elif mesh.process_count > 1:
        save_sharded(path, state, cfg, mesh, frames_done=frames_done)
    else:
        from stochquant_tpu_torch.parallel import mesh as mesh_mod

        whole = mesh_mod.gather_state(state, mesh_mod.state_spec(type(state[0]), cfg), mesh)
        save(path, whole, cfg, frames_done=frames_done)


# ---------------------------------------------------------------------------
# the reference's "%a" format
# ---------------------------------------------------------------------------


def export_reference(path, state: ChainState, chain: int = 0) -> None:
    """Write one chain of a ChainState in the reference's "%a" schema so the
    original tauhost can resume from it (its reader re-randomizes ω and the
    RNG anyway — flaw F4)."""
    host = lambda t: t.detach().cpu().numpy()  # noqa: E731
    reference_fmt.write(
        path,
        xavg=host(connected_correlator(state))[chain],
        xx0=host(state.xx0_mean)[chain],
        x=host(state.x_mean)[chain],
        f=host(state.f)[chain],
        omega=float(host(state.omega)[chain]),
        runs=int(accum.runs_total(state.runs)[chain]),
        dtau=float(host(state.dtau)[chain]),
    )


def import_reference(path, cfg: ChainConfig, device) -> ChainState:
    """A reference-format checkpoint as a ChainState on ``device``, every
    chain a copy of the file's.  Reference files carry no RNG state (flaw
    F4): the state starts a fresh counter stream at ``step = 0``; Δτ is
    clamped to ``cfg.dtau`` as tauhost.c:131-137 does."""
    from stochquant_tpu_torch.integrators.langevin import host_step

    d = reference_fmt.read(path, cfg.n_sites)
    C, N, dtype = cfg.n_chains, cfg.n_sites, cfg.torch_dtype
    rep = lambda a: torch.as_tensor(np.asarray(a)).to(dtype)[None, :].expand(C, N).to(  # noqa: E731
        device).contiguous()
    full = lambda v, dt: torch.full((C,), v, dtype=dt, device=device)  # noqa: E731
    f = rep(d["f"])
    return ChainState(
        f=f,
        omega=full(d["omega"], dtype),
        x_mean=rep(d["x"]),
        xx0_mean=rep(d["xx0"]),
        x2_mean=torch.zeros((C, N), dtype=dtype, device=device),
        x4_mean=torch.zeros((C, N), dtype=dtype, device=device),
        runs=torch.stack([full(d["runs"] & 0xFFFFFFFF, torch.int64),
                          full(d["runs"] >> 32, torch.int64)], dim=-1),
        dtau=full(min(d["dtau"], cfg.dtau), dtype),
        stab_cnt=torch.zeros((C,), dtype=torch.int32, device=device),
        lrg_vl=torch.amax(torch.abs(f), dim=-1),
        spec_mean=torch.zeros((C, N // 2 + 1), dtype=dtype, device=device),
        step=host_step(0),
    )

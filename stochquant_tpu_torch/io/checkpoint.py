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
"""

from __future__ import annotations

import json
import warnings

import numpy as np
import torch

from stochquant_tpu_torch.config import ChainConfig, FieldConfig
from stochquant_tpu_torch.integrators.complex_field import ComplexFieldConfig, ComplexFieldState
from stochquant_tpu_torch.integrators.complex_langevin import (
    CLState,
    ComplexChainConfig,
    ComplexChainState,
    ComplexLangevinConfig,
)
from stochquant_tpu_torch.integrators.field import FieldState
from stochquant_tpu_torch.integrators.gauge import GaugeConfig, GaugeState
from stochquant_tpu_torch.integrators.langevin import ChainState

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


def save(path, state, cfg, *, frames_done=None) -> None:
    """Write the full state + config (and the completed-frame count)."""
    payload = {f"state_{name}": a for name, a in state_to_numpy(state).items()}
    meta = {"kind": _STATE_KIND[type(state)], "config": cfg.to_json(), "version": 1}
    if frames_done is not None:
        meta["frames_done"] = int(frames_done)
    payload["meta"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    with open(path, "wb") as fh:
        np.savez(fh, **payload)


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

"""Chain checkpoints in the JAX package's ``.npz`` format.

A checkpoint is one ``.npz`` with an entry ``state_<leaf>`` per
``ChainState`` leaf plus a ``meta`` record (``kind``, the config's JSON,
``version`` and, when given, ``frames_done``) — the layout of
``stochquant_tpu.io.checkpoint.save``, so a checkpoint written by either
package resumes in the other.  On disk ``runs`` is a ``(C, 2)`` uint32
(lo, hi) pair and ``step`` a uint32 scalar; in memory they are int64
tensors holding the same words.  Only the ``"chain"`` kind is ported.
"""

from __future__ import annotations

import json
import warnings

import numpy as np
import torch

from stochquant_tpu_torch.config import ChainConfig
from stochquant_tpu_torch.integrators.langevin import ChainState

_KIND = "chain"
_U32_LEAVES = ("runs", "step")


def state_to_numpy(state: ChainState) -> dict:
    """Host numpy arrays, leaf for leaf, in the JAX package's dtypes."""
    out = {}
    for name, leaf in zip(ChainState._fields, state):
        a = leaf.detach().cpu().numpy()
        out[name] = a.astype(np.uint32) if name in _U32_LEAVES else a
    return out


def state_from_numpy(arrays: dict, device) -> ChainState:
    """ChainState on ``device`` from numpy arrays (e.g. the leaves of a JAX
    ``ChainState``); ``step`` stays on the host."""
    leaves = []
    for name in ChainState._fields:
        a = np.asarray(arrays[name])
        if name in _U32_LEAVES:
            a = a.astype(np.int64)
        t = torch.from_numpy(np.array(a))  # a writable copy the tensor owns
        leaves.append(t if name == "step" else t.to(device))
    return ChainState(*leaves)


def save(path, state: ChainState, cfg: ChainConfig, *, frames_done=None) -> None:
    """Write the full state + config (and the completed-frame count)."""
    payload = {f"state_{name}": a for name, a in state_to_numpy(state).items()}
    meta = {"kind": _KIND, "config": cfg.to_json(), "version": 1}
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
    a zero high word, and a missing ``x4_mean`` is backfilled with zeros
    (warned: its estimate is unbiased only after the next reset of the means).
    """
    with np.load(path) as z:
        meta = json.loads(bytes(z["meta"].tobytes()).decode())
        if meta["kind"] != _KIND:
            raise ValueError(
                f"checkpoint {path} holds a {meta['kind']!r} run; only chain "
                "checkpoints are ported"
            )
        arrays = {}
        for name in ChainState._fields:
            key = f"state_{name}"
            if key in z:
                arrays[name] = z[key]
            elif name == "x4_mean":
                arrays[name] = np.zeros_like(z["state_x2_mean"])
                warnings.warn(
                    f"checkpoint {path} predates the x4_mean channel; backfilled "
                    "with zeros — the fourth-moment estimate is only unbiased "
                    "after the next reset of the running means",
                    stacklevel=2,
                )
            else:
                raise KeyError(f"checkpoint {path} is missing leaf {name!r}")
    if arrays["runs"].ndim == 1:
        arrays["runs"] = np.stack([arrays["runs"], np.zeros_like(arrays["runs"])], axis=-1)
    return state_from_numpy(arrays, device), ChainConfig.from_json(meta["config"])

"""Two-level observable accumulation (port of
``stochquant_tpu.integrators.accum``).

Each frame accumulates plain float32 sample sums; the cross-frame merge
folds one frame's mean into the running mean with weight loops/n:

    m ← m + (S/loops − m) · (loops / n_new),      n_new = runs + loops

one rounding per frame instead of per sample.  The accepted-sample count is
a 64-bit value held as a ``(C, 2)`` (lo, hi) pair of 32-bit words — the JAX
package's checkpoint layout — stored here in an ``int64`` tensor whose
entries stay in ``[0, 2**32)`` (PyTorch lacks unsigned 32-bit arithmetic).
"""

from __future__ import annotations

import numpy as np
import torch

from stochquant_tpu_torch.actions.base import true_divide
from stochquant_tpu_torch.rng import u32

__all__ = ["merge_frame_sum", "init_runs", "runs_after", "bump_runs", "runs_total"]


def init_runs(n_chains: int, device=None) -> torch.Tensor:
    """Zeroed (n_chains, 2) (lo, hi) counter."""
    return torch.zeros((n_chains, 2), dtype=torch.int64, device=device)


def _add_wide(runs: torch.Tensor, loops: int):
    """(lo, hi) + loops with carry; loops is a static int < 2**32."""
    lo = u32(runs[..., 0] + loops)
    carry = (lo < runs[..., 0]).to(torch.int64)
    return lo, u32(runs[..., 1] + carry)


def runs_after(runs: torch.Tensor, loops: int) -> torch.Tensor:
    """Total count including this frame's ``loops``, as float32:
    ``float(hi)·2³² + float(lo)``, each word rounded to nearest once."""
    lo, hi = _add_wide(runs, loops)
    return hi.to(torch.float32) * 4294967296.0 + lo.to(torch.float32)


def bump_runs(runs: torch.Tensor, loops: int, accept: torch.Tensor) -> torch.Tensor:
    """Advance the (lo, hi) counter by ``loops`` where ``accept``."""
    lo, hi = _add_wide(runs, loops)
    return torch.where(accept[..., None], torch.stack([lo, hi], dim=-1), runs)


def runs_total(runs) -> np.ndarray:
    """Host-side exact total (numpy uint64) — for metrics/export."""
    a = np.asarray(runs.cpu() if isinstance(runs, torch.Tensor) else runs).astype(np.uint64)
    return (a[..., 1] << np.uint64(32)) | a[..., 0]


def merge_frame_sum(mean, frame_sum, loops: int, n_new):
    """Fold a frame's sample sum into the running mean — the expression of
    ``stochquant_tpu.integrators.accum.merge_frame_sum`` and of kernel 2's
    in-kernel epilogue, so every path merges bit-identically.

    ``n_new`` is the total count including this frame (``runs_after``).
    The weight is an IEEE division (``true_divide``), as in the JAX package.
    """
    w = true_divide(float(loops), n_new)
    return mean + (frame_sum * (1.0 / float(loops)) - mean) * w

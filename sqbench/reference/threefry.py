"""Counter-based Threefry-2x32 noise in plain PyTorch: the benchmark's frozen
copy of the generator the port's chain kernels draw (key ``(seed, stream ^
chain << 8)``, counter ``(global site, micro-step)``), kept here so that the
reference depends on nothing of the program.

Words are uint32 values held in int64 tensors and masked after each
operation; a Box-Muller pair turns one evaluation into two N(0, 1) float32
draws.  Rounds: 20 (``rng_impl="threefry"``) or 13 (``"threefry13"``).
"""

from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
FIELD, COLLECTIVE, INIT = 0, 1, 2          # the streams folded into the key
ROUNDS = {"threefry": 20, "threefry13": 13}
_ROTATIONS = (13, 15, 26, 6, 17, 29, 16, 24)
_PARITY = 0x1BD11BDA
_TWO_PI = 6.283185307179586


def u32(x):
    return x & MASK


def _word(x, device):
    if isinstance(x, torch.Tensor):
        return u32(x.to(torch.int64))
    return torch.tensor(int(x) & MASK, dtype=torch.int64, device=device)


def threefry2x32(k0, k1, c0, c1, rounds: int):
    """Two uint32 output words (int64 tensors) per broadcast (key, counter)."""
    dev = next(t.device for t in (c0, c1, k0, k1) if isinstance(t, torch.Tensor))
    k0, k1, c0, c1 = (_word(v, dev) for v in (k0, k1, c0, c1))
    ks = (k0, k1, (k0 ^ k1) ^ _PARITY)
    x0 = u32(c0 + ks[0])
    x1 = u32(c1 + ks[1])
    for i in range(rounds):
        x0 = u32(x0 + x1)
        r = _ROTATIONS[i % 8]
        x1 = (u32(x1 << r) | (x1 >> (32 - r))) ^ x0
        if (i + 1) % 4 == 0:
            j = (i + 1) // 4
            x0 = u32(x0 + ks[j % 3])
            x1 = u32(x1 + ks[(j + 1) % 3] + j)
    return x0, x1


def _uniform(bits):
    """uint32 -> float32 in (0, 1]: the top 24 bits times 2^-24, plus 2^-25."""
    return (bits >> 8).to(torch.float32) * 2.0**-24 + 2.0**-25


def normal_pair(seed, k1, site, step, rounds: int):
    """Both Box-Muller outputs (float32) of one evaluation."""
    b0, b1 = threefry2x32(seed, k1, site, step, rounds)
    r = torch.sqrt(-2.0 * torch.log(_uniform(b0)))
    theta = _TWO_PI * _uniform(b1)
    return r * torch.cos(theta), r * torch.sin(theta)


def chain_key(stream: int, chain_ids: torch.Tensor) -> torch.Tensor:
    return u32(chain_ids.to(torch.int64) << 8) ^ int(stream)

"""Counter-based random numbers: the PyTorch port of ``stochquant_tpu.rng``.

Noise is a pure function of ``(seed, stream, chain, global site, step)`` via
Threefry-2x32, with the same key/counter layout as the JAX package:

    k0 = seed
    k1 = stream ^ (chain_index << 8)      (wraps in 32 bits)
    c0 = global site linear index
    c1 = micro-step index

so both packages draw bit-identical uniforms, and trajectories can be
compared between them (and between the CUDA kernels and their plain
versions) up to float32 rounding of the transcendentals.

PyTorch has no unsigned 32-bit arithmetic on the CPU (no ``add`` or shifts
for ``uint32``), so every word is held in an ``int64`` tensor with values in
``[0, 2**32)`` and reduced after each operation by :func:`u32`, the one
masking helper used on every device.
"""

from __future__ import annotations

import enum
import math

import torch

__all__ = [
    "Stream",
    "u32",
    "rounds_of",
    "counter_based",
    "threefry2x32",
    "uniform_from_bits",
    "normal_pair",
    "normal",
    "philox4x32",
    "philox_normal_quad",
    "philox_normal_quad_for_shape",
    "PHILOX_STEPS",
    "global_site_index",
    "normal_for_shape",
    "normal_pair_for_shape",
]

_MASK = 0xFFFFFFFF


class Stream(enum.IntEnum):
    """Independent noise streams (folded into the Threefry key)."""

    FIELD = 0
    COLLECTIVE = 1
    INIT = 2
    COMPLEX = 3


_ROTATIONS = (13, 15, 26, 6, 17, 29, 16, 24)
_PARITY = 0x1BD11BDA
_DEFAULT_ROUNDS = 20
_TWO_PI = 6.283185307179586


def rounds_of(rng_impl: str) -> int:
    """Threefry round count for a config's ``rng_impl`` string.  'hardware'
    gives the default 20: only the kernel wrappers and their plain versions
    draw its Philox stream (:func:`philox_normal_quad`); every other path
    (cold starts, the plain runners, the halo runners) draws Threefry-20
    under it, as the JAX package's XLA paths do."""
    return 13 if rng_impl == "threefry13" else _DEFAULT_ROUNDS


def counter_based(rng_impl: str) -> bool:
    """True for the layout-invariant counter RNG variants (any round count);
    False for the sequential hardware PRNG."""
    return rng_impl in ("threefry", "threefry13")


def u32(x):
    """Reduce an int64 tensor (or Python int) to its low 32 bits."""
    return x & _MASK


def _as_word(x, device=None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return u32(x.to(torch.int64))
    return torch.tensor(int(x) & _MASK, dtype=torch.int64, device=device)


def _rotl(x, r: int):
    return u32(x << r) | (x >> (32 - r))


def threefry2x32(k0, k1, c0, c1, rounds: int = _DEFAULT_ROUNDS):
    """Threefry-2x32 on int64 tensors holding uint32 words (broadcastable).

    Returns two int64 tensors with values in ``[0, 2**32)``, bit-equal to
    ``stochquant_tpu.rng.threefry2x32`` at 20 and 13 rounds."""
    dev = next((t.device for t in (c0, c1, k0, k1) if isinstance(t, torch.Tensor)), None)
    k0, k1, c0, c1 = (_as_word(v, dev) for v in (k0, k1, c0, c1))
    ks = (k0, k1, (k0 ^ k1) ^ _PARITY)
    x0 = u32(c0 + ks[0])
    x1 = u32(c1 + ks[1])
    for i in range(rounds):
        x0 = u32(x0 + x1)
        x1 = _rotl(x1, _ROTATIONS[i % 8]) ^ x0
        if (i + 1) % 4 == 0:
            j = (i + 1) // 4
            x0 = u32(x0 + ks[j % 3])
            x1 = u32(x1 + ks[(j + 1) % 3] + j)
    return x0, x1


def uniform_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """uint32 word → float32 uniform in (0, 1]: the top 24 bits scaled by
    2⁻²⁴ plus a half-ulp 2⁻²⁵, never 0 (safe under ``log``); the all-ones
    top word rounds to exactly 1.0, as it does in the JAX package."""
    top = (bits >> 8).to(torch.float32)  # exact: top < 2**24
    return top * 2.0**-24 + 2.0**-25


def _box_muller(b0, b1):
    """Both Box–Muller outputs of two uint32 words."""
    u1 = uniform_from_bits(b0)
    u2 = uniform_from_bits(b1)
    r = torch.sqrt(-2.0 * torch.log(u1))
    theta = _TWO_PI * u2  # the scalar rounds to float32, as jnp.float32(_TWO_PI)
    return r * torch.cos(theta), r * torch.sin(theta)


def normal_pair(k0, k1, c0, c1, rounds: int = _DEFAULT_ROUNDS):
    """Two independent N(0,1) float32 draws per counter (full Box–Muller)."""
    return _box_muller(*threefry2x32(k0, k1, c0, c1, rounds))


# ---------------------------------------------------------------------------
# Philox-4x32-10: the fast-noise generator of rng_impl='hardware'
# ---------------------------------------------------------------------------

#: micro-steps served by one Philox evaluation (four words, two Box–Muller pairs)
PHILOX_STEPS = 4
_PHILOX_M0, _PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
_PHILOX_W0, _PHILOX_W1 = 0x9E3779B9, 0xBB67AE85


def _mulhilo(m: int, b):
    """(high, low) 32-bit words of the 64-bit product ``m * b`` of a uint32
    constant and a uint32 word held in int64.  The product can exceed 2⁶³
    (0xD2511F53 × 0xFFFFFFFF does), so ``b`` is split into 16-bit halves:
    no intermediate leaves [0, 2⁴⁹), nothing wraps and no shift sign-extends."""
    t_lo = m * (b & 0xFFFF)   # < 2**48
    t_hi = m * (b >> 16)      # < 2**48; m*b = t_hi * 2**16 + t_lo
    hi = (t_hi + (t_lo >> 16)) >> 16
    lo = u32((u32(t_hi) << 16) + t_lo)
    return hi, lo


def philox4x32(k0, k1, c0, c1, c2, c3, rounds: int = 10):
    """Philox-4x32 on int64 tensors holding uint32 words (broadcastable):
    four output words per (key, counter), bit-equal to Random123's
    ``philox4x32`` at its default 10 rounds and to ``philox4x32`` in
    ``kernels/csrc/sq_rng.cuh`` (which takes the high words with ``__umulhi``)."""
    dev = next((t.device for t in (c0, c1, c2, c3, k0, k1)
                if isinstance(t, torch.Tensor)), None)
    k0, k1, c0, c1, c2, c3 = (_as_word(v, dev) for v in (k0, k1, c0, c1, c2, c3))
    for i in range(rounds):
        if i:
            k0 = u32(k0 + _PHILOX_W0)
            k1 = u32(k1 + _PHILOX_W1)
        hi0, lo0 = _mulhilo(_PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(_PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def philox_normal_quad(seed, k1, site, step):
    """Four independent N(0,1) float32 draws from one Philox evaluation at
    key ``(seed, k1)`` and counter ``(site, step, 0, 0)``: words 0 and 1 give
    the Box–Muller pair of micro-steps ``step`` and ``step + 1``, words 2 and
    3 that of ``step + 2`` and ``step + 3``."""
    w0, w1, w2, w3 = philox4x32(seed, k1, site, step, 0, 0)
    z0, z1 = _box_muller(w0, w1)
    z2, z3 = _box_muller(w2, w3)
    return z0, z1, z2, z3


def chain_key(stream, chain_ids: torch.Tensor) -> torch.Tensor:
    """``k1 = stream ^ (chain << 8)`` as a uint32 word."""
    return u32(chain_ids.to(torch.int64) << 8) ^ int(stream)


def normal(seed, stream, chain, site, step, rounds: int = _DEFAULT_ROUNDS):
    """One N(0,1) float32 per (chain, site) element (the first Box–Muller
    output); ``chain`` and ``site`` are integer tensors of global indices."""
    z0, _ = normal_pair(seed, chain_key(stream, chain), site, step, rounds)
    return z0


def global_site_index(local_shape, global_shape, offsets=None, *, device=None):
    """int64 tensor of shape ``local_shape`` holding *global* linear site ids
    (C order over ``global_shape``), offset by the block origin ``offsets``."""
    if offsets is None:
        offsets = (0,) * len(local_shape)
    strides = [math.prod(global_shape[a + 1:]) for a in range(len(global_shape))]
    ids = torch.zeros(local_shape, dtype=torch.int64, device=device)
    for axis, (n, off, s) in enumerate(zip(local_shape, offsets, strides)):
        view = [1] * len(local_shape)
        view[axis] = n
        coord = torch.arange(n, dtype=torch.int64, device=device).view(view) + off
        ids = u32(ids + coord * s)
    return ids


def _ids_for_shape(shape, global_lattice_shape, chain_offset, lattice_offsets, device):
    chains, local_lattice = shape[0], tuple(shape[1:])
    if global_lattice_shape is None:
        global_lattice_shape = local_lattice
    site_ids = global_site_index(
        local_lattice, global_lattice_shape, lattice_offsets, device=device
    )[None]
    chain_ids = torch.arange(chains, dtype=torch.int64, device=device) + chain_offset
    chain_ids = u32(chain_ids).view((chains,) + (1,) * len(local_lattice))
    return chain_ids, site_ids


def normal_for_shape(
    seed, stream, step, shape, global_lattice_shape=None, chain_offset=0,
    lattice_offsets=None, rounds: int = _DEFAULT_ROUNDS, *, device=None,
):
    """N(0,1) field of ``shape = (chains, *lattice)`` from global coordinates
    (layout-invariant: any block reproduces its slice of the global field)."""
    chain_ids, site_ids = _ids_for_shape(
        shape, global_lattice_shape, chain_offset, lattice_offsets, device
    )
    return normal(seed, stream, chain_ids, site_ids, _as_word(step, device), rounds)


def normal_pair_for_shape(
    seed, stream, step, shape, global_lattice_shape=None, chain_offset=0,
    lattice_offsets=None, rounds: int = _DEFAULT_ROUNDS, *, device=None,
):
    """Both Box–Muller outputs per counter (site, ``step``): the noise fields
    of micro-steps ``step`` and ``step + 1`` from one Threefry evaluation."""
    chain_ids, site_ids = _ids_for_shape(
        shape, global_lattice_shape, chain_offset, lattice_offsets, device
    )
    return normal_pair(
        seed, chain_key(stream, chain_ids), site_ids, _as_word(step, device), rounds
    )


def philox_normal_quad_for_shape(seed, stream, step, shape, chain_offset=0, *, device=None):
    """The four Philox noise fields of micro-steps ``step … step + 3`` for
    ``shape = (chains, *lattice)`` (see :func:`philox_normal_quad`); rows are
    global chains ``chain_offset …``, sites the lattice's C-order indices."""
    chain_ids, site_ids = _ids_for_shape(shape, None, chain_offset, None, device)
    return philox_normal_quad(seed, chain_key(stream, chain_ids), site_ids,
                              _as_word(step, device))

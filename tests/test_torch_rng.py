"""The port's Threefry noise is bit-equal to the JAX package's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stochquant_tpu import rng as jrng
from stochquant_tpu_torch import rng as trng

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.uint32).astype(np.int64))


def _u32(t):
    return t.numpy().astype(np.uint32)


def test_threefry_known_answer_vectors():
    # Random123 v1.09 kat_vectors for threefry2x32, 20 rounds.
    cases = [
        ((0x00000000, 0x00000000), (0x00000000, 0x00000000), (0x6B200159, 0x99BA4EFE)),
        ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF), (0x1CB996FC, 0xBB002BE7)),
        ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3), (0xC4923A9C, 0x483DF7A0)),
    ]
    for (k0, k1), (c0, c1), (e0, e1) in cases:
        r0, r1 = trng.threefry2x32(k0, k1, _t(c0), _t(c1))
        assert (int(r0), int(r1)) == (e0, e1)


@pytest.mark.parametrize("rounds", [20, 13])
def test_threefry_bits_equal_jax(rounds):
    rs = np.random.RandomState(rounds)
    k0, k1, c0, c1 = (rs.randint(0, 2**32, size=4096, dtype=np.uint64).astype(np.uint32)
                      for _ in range(4))
    want = jrng.threefry2x32(jnp.asarray(k0), jnp.asarray(k1), jnp.asarray(c0),
                             jnp.asarray(c1), rounds)
    got = trng.threefry2x32(_t(k0), _t(k1), _t(c0), _t(c1), rounds)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), _u32(g))
        assert int(g.min()) >= 0 and int(g.max()) < 2**32


@pytest.mark.parametrize("rounds", [20, 13])
def test_chain_key_and_step_wrap(rounds):
    """k1 = stream ^ (chain << 8) wraps in 32 bits; step counters near 2³²."""
    chains = np.array([0, 1, 2**24 - 1, 2**24, 2**24 + 5, 2**31 + 7, 2**32 - 1], np.uint32)
    steps = np.array([0, 2, 2**32 - 2, 2**32 - 1, 12345, 2**31, 7], np.uint32)
    sites = np.arange(len(chains), dtype=np.uint32)
    stream = jrng.Stream.COLLECTIVE
    jk1 = jnp.uint32(stream) ^ (jnp.asarray(chains) << jnp.uint32(8))
    tk1 = trng.chain_key(stream, _t(chains))
    np.testing.assert_array_equal(np.asarray(jk1), _u32(tk1))
    want = jrng.normal_pair(jnp.uint32(5), jk1, jnp.asarray(sites), jnp.asarray(steps), rounds)
    got = trng.normal_pair(5, tk1, _t(sites), _t(steps), rounds)
    for w, g in zip(want, got):
        np.testing.assert_allclose(np.asarray(w), g.numpy(), rtol=0, atol=1e-6)


def test_uniforms_bit_equal_and_normals_close():
    rs = np.random.RandomState(3)
    bits = rs.randint(0, 2**32, size=1 << 16, dtype=np.uint64).astype(np.uint32)
    bits[:4] = [0, 255, 2**32 - 1, 2**31]
    u_j = np.asarray(jrng.uniform_from_bits(jnp.asarray(bits)))
    u_t = trng.uniform_from_bits(_t(bits)).numpy()
    assert u_t.dtype == np.float32
    np.testing.assert_array_equal(u_j, u_t)
    # never 0 (safe under log); the all-ones word rounds to 1.0 in both packages
    assert u_t.min() > 0.0 and u_t.max() <= 1.0

    for rounds in (20, 13):
        a = jrng.normal_pair_for_shape(7, jrng.Stream.FIELD, 11, (8, 200), rounds=rounds)
        b = trng.normal_pair_for_shape(7, trng.Stream.FIELD, 11, (8, 200), rounds=rounds)
        for x, y in zip(a, b):
            np.testing.assert_allclose(np.asarray(x), y.numpy(), rtol=0, atol=1e-6)


def test_normal_for_shape_offsets_match_jax_and_global_slice():
    kw = dict(global_lattice_shape=(16, 24), chain_offset=2, lattice_offsets=(8, 12))
    a = jrng.normal_for_shape(11, jrng.Stream.FIELD, 5, (2, 8, 12), **kw)
    b = trng.normal_for_shape(11, trng.Stream.FIELD, 5, (2, 8, 12), **kw)
    np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=0, atol=1e-6)
    full = trng.normal_for_shape(11, trng.Stream.FIELD, 5, (4, 16, 24))
    torch.testing.assert_close(full[2:4, 8:16, 12:24], b, rtol=0, atol=0)

    ids_j = jrng.global_site_index((2, 3), (8, 10), offsets=(4, 7))
    ids_t = trng.global_site_index((2, 3), (8, 10), offsets=(4, 7))
    np.testing.assert_array_equal(np.asarray(ids_j), _u32(ids_t))


def test_rounds_of_and_hardware_rng_raises():
    assert trng.rounds_of("threefry") == 20
    assert trng.rounds_of("threefry13") == 13
    with pytest.raises(ValueError, match="hardware"):
        trng.rounds_of("hardware")

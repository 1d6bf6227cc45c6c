"""The port's Threefry noise is bit-equal to the JAX package's; its Philox
generator (rng_impl='hardware' on the kernel routes) gives Random123's known
answers."""

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
    # the name dates from when 'hardware' raised: it now gives 20, as in the JAX
    # package, and stays off the counter-based list (the routing reads that)
    for impl in ("threefry", "threefry13", "hardware"):
        assert trng.rounds_of(impl) == jrng.rounds_of(impl)
        assert trng.counter_based(impl) == jrng.counter_based(impl)
    assert trng.rounds_of("hardware") == 20 and not trng.counter_based("hardware")


def test_philox_known_answer_vectors():
    # Random123's kat_vectors for philox4x32, 10 rounds
    f = 0xFFFFFFFF
    cases = [
        ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
        ((f, f, f, f), (f, f), (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
        ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
         (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
    ]
    for ctr, key, want in cases:
        got = trng.philox4x32(*key, *(_t(c) for c in ctr))
        assert tuple(int(w) for w in got) == want


def test_philox_bits_match_a_numpy_uint64_version_and_broadcast():
    rs = np.random.RandomState(7)
    k0, k1, c0, c1, c2, c3 = (rs.randint(0, 2**32, size=2048, dtype=np.uint64)
                              for _ in range(6))
    # force the corners where a signed 64-bit product would wrap
    c0[:4] = c2[:4] = 0xFFFFFFFF
    got = trng.philox4x32(_t(k0), _t(k1), _t(c0), _t(c1), _t(c2), _t(c3))
    m32 = np.uint64(0xFFFFFFFF)
    a, b, c, d, ka, kb = c0.copy(), c1.copy(), c2.copy(), c3.copy(), k0.copy(), k1.copy()
    for i in range(10):
        if i:
            ka, kb = (ka + np.uint64(0x9E3779B9)) & m32, (kb + np.uint64(0xBB67AE85)) & m32
        p0, p1 = np.uint64(0xD2511F53) * a, np.uint64(0xCD9E8D57) * c
        a, b, c, d = (p1 >> np.uint64(32)) ^ b ^ ka, p1 & m32, (p0 >> np.uint64(32)) ^ d ^ kb, p0 & m32
    for g, w in zip(got, (a, b, c, d)):
        np.testing.assert_array_equal(g.numpy().astype(np.uint64), w)
    again = trng.philox4x32(_t(k0), _t(k1), _t(c0), _t(c1), _t(c2), _t(c3))
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    row = trng.philox4x32(3, _t(k1[:5])[:, None], _t(c0[:7])[None, :], 9, 0, 0)
    assert row[0].shape == (5, 7)
    one = trng.philox4x32(3, int(k1[2]), int(c0[4]), 9, 0, 0)
    assert all(int(r[2, 4]) == int(o) for r, o in zip(row, one))


def test_philox_normals_are_standard_and_uniforms_stay_in_range():
    z = torch.stack(trng.philox_normal_quad_for_shape(5, trng.Stream.FIELD, 11, (8, 4096)))
    assert torch.isfinite(z).all() and z.dtype == torch.float32
    assert abs(float(z.mean())) < 0.01 and abs(float(z.var()) - 1.0) < 0.02
    flat = z.reshape(4, -1).double()
    corr = torch.corrcoef(flat)
    assert float((corr - torch.eye(4, dtype=corr.dtype)).abs().max()) < 0.02
    words = torch.stack(trng.philox4x32(5, 1, torch.arange(1 << 14), 0, 0, 0))
    u = trng.uniform_from_bits(words)
    assert float(u.min()) > 0.0 and float(u.max()) <= 1.0
    assert float(trng.uniform_from_bits(torch.tensor([0, 0xFFFFFFFF]))[0]) == 2.0**-25
    # rows are global chains, columns the chain's sites: any block is a slice
    full = trng.philox_normal_quad_for_shape(5, trng.Stream.FIELD, 11, (6, 10))
    part = trng.philox_normal_quad_for_shape(5, trng.Stream.FIELD, 11, (2, 10), chain_offset=3)
    assert all(torch.equal(f[3:5], p) for f, p in zip(full, part))

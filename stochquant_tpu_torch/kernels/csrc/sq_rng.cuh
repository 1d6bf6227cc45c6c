// Counter-based noise shared by every kernel of the port: Threefry-2x32 and
// the Box-Muller pair of stochquant_tpu/rng.py, expression for expression, so
// the kernels draw the bits and normals of the JAX package and of the plain
// PyTorch versions (stochquant_tpu_torch/rng.py); and Philox-4x32-10, the
// fast-noise generator of rng_impl='hardware' (kernels 1-4), the counterpart
// of the TPU kernels' on-core generator.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// Noise streams folded into the Threefry key: k1 = stream ^ (chain << 8).
enum { STREAM_FIELD = 0, STREAM_COLLECTIVE = 1 };

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
    return (x << r) | (x >> (32 - r));
}

// Threefry-2x32 (stochquant_tpu/rng.py:threefry2x32): key schedule with the
// Skein parity constant, injection after every fourth round.
template <int ROUNDS>
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1, uint32_t c0,
                                             uint32_t c1, uint32_t& o0, uint32_t& o1) {
    const uint32_t ks[3] = {k0, k1, 0x1BD11BDAu ^ k0 ^ k1};
    const int rot[8] = {13, 15, 26, 6, 17, 29, 16, 24};
    uint32_t x0 = c0 + ks[0];
    uint32_t x1 = c1 + ks[1];
#pragma unroll
    for (int i = 0; i < ROUNDS; ++i) {
        x0 += x1;
        x1 = rotl32(x1, rot[i % 8]);
        x1 ^= x0;
        if ((i + 1) % 4 == 0) {
            const int j = (i + 1) / 4;
            x0 += ks[j % 3];
            x1 += ks[(j + 1) % 3] + (uint32_t)j;
        }
    }
    o0 = x0;
    o1 = x1;
}

// Top 24 bits * 2^-24 + 2^-25: uniform in (0, 1], never 0 (safe under logf).
__device__ __forceinline__ float uniform_from_bits(uint32_t bits) {
    return (float)(bits >> 8) * 5.9604644775390625e-08f + 2.98023223876953125e-08f;
}

// Both Box-Muller outputs of two uint32 words.
__device__ __forceinline__ void box_muller(uint32_t b0, uint32_t b1, float& z0, float& z1) {
    const float u1 = uniform_from_bits(b0);
    const float u2 = uniform_from_bits(b1);
    const float r = sqrtf(-2.0f * logf(u1));
    const float theta = (float)6.283185307179586 * u2;
    z0 = r * cosf(theta);
    z1 = r * sinf(theta);
}

// Both Box-Muller outputs of one Threefry evaluation at counter (c0, step).
template <int ROUNDS>
__device__ __forceinline__ void normal_pair(uint32_t seed, uint32_t k1, uint32_t c0,
                                            uint32_t step, float& z0, float& z1) {
    uint32_t b0, b1;
    threefry2x32<ROUNDS>(seed, k1, c0, step, b0, b1);
    box_muller(b0, b1, z0, z1);
}

// Philox-4x32-10 (Salmon et al., SC'11; Random123's philox4x32 at its default
// rounds): per round two 32x32 -> 64-bit products, the high words crossed
// into the other lane with the key, the key bumped by the Weyl constants
// between rounds.  Bit-equal to philox4x32 in stochquant_tpu_torch/rng.py.
__device__ __forceinline__ void philox4x32(uint32_t k0, uint32_t k1, uint32_t c0, uint32_t c1,
                                           uint32_t c2, uint32_t c3, uint32_t (&out)[4]) {
#pragma unroll
    for (int i = 0; i < 10; ++i) {
        if (i) {
            k0 += 0x9E3779B9u;
            k1 += 0xBB67AE85u;
        }
        const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
        const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
        c0 = hi1 ^ c1 ^ k0;
        c1 = lo1;
        c2 = hi0 ^ c3 ^ k1;
        c3 = lo0;
    }
    out[0] = c0;
    out[1] = c1;
    out[2] = c2;
    out[3] = c3;
}

// The noise generators of kernels 1-4 as template parameters.  A generator
// serves STEPS consecutive micro-steps of one site from one evaluation at
// counter (site, step of the first), under key (seed, k1).
template <int ROUNDS>
struct ThreefryNoise {
    static constexpr int STEPS = 2;
    static constexpr bool PHILOX = false;
    static constexpr int N_ROUNDS = ROUNDS;
    static __device__ __forceinline__ void draw(uint32_t seed, uint32_t k1, uint32_t site,
                                                uint32_t step, float (&z)[2]) {
        normal_pair<ROUNDS>(seed, k1, site, step, z[0], z[1]);
    }
};

typedef ThreefryNoise<20> Threefry20;
typedef ThreefryNoise<13> Threefry13;

// rng_impl='hardware': counter (site, step, 0, 0); words 0, 1 give the
// Box-Muller pair of steps step, step + 1, words 2, 3 that of step + 2, + 3.
struct PhiloxNoise {
    static constexpr int STEPS = 4;
    static constexpr bool PHILOX = true;
    static __device__ __forceinline__ void draw(uint32_t seed, uint32_t k1, uint32_t site,
                                                uint32_t step, float (&z)[4]) {
        uint32_t w[4];
        philox4x32(seed, k1, site, step, 0u, 0u, w);
        box_muller(w[0], w[1], z[0], z[1]);
        box_muller(w[2], w[3], z[2], z[3]);
    }
};

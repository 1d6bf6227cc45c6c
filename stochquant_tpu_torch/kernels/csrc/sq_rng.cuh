// Counter-based noise shared by every kernel of the port: Threefry-2x32 and
// the Box-Muller pair of stochquant_tpu/rng.py, expression for expression, so
// the kernels draw the bits and normals of the JAX package and of the plain
// PyTorch versions (stochquant_tpu_torch/rng.py).
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

// Both Box-Muller outputs of one Threefry evaluation at counter (c0, step).
template <int ROUNDS>
__device__ __forceinline__ void normal_pair(uint32_t seed, uint32_t k1, uint32_t c0,
                                            uint32_t step, float& z0, float& z1) {
    uint32_t b0, b1;
    threefry2x32<ROUNDS>(seed, k1, c0, step, b0, b1);
    const float u1 = uniform_from_bits(b0);
    const float u2 = uniform_from_bits(b1);
    const float r = sqrtf(-2.0f * logf(u1));
    const float theta = (float)6.283185307179586 * u2;
    z0 = r * cosf(theta);
    z1 = r * sinf(theta);
}

// What the scalar-field kernels share (field_kernel.cu: kernels 3 and 4;
// field_kernel_tiled.cu: kernel 5; field_kernel_nd.cu: kernels 6, 7 and 8 and
// the one-step tail; field_halo_kernel.cu: kernel 9): the launch parameters,
// the phi^4 / free field potential, the Euler-Maruyama site update and, for
// the 2-D kernels, the stencil and a deterministic block reduction (the D-dim
// kernels have their own of both).
//
// Numerics: every expression keeps the operand order of the JAX integrator
// (stochquant_tpu/integrators/field.py, actions/phi4.py) and of the plain
// PyTorch version (stochquant_tpu_torch/integrators/field.py); the sources
// build with --fmad=false and without fast math, so each product rounds on
// its own and divisions are IEEE, as in the plain version's tensor ops.
#pragma once

#include "sq_rng.cuh"

// Mirrors FieldParams in stochquant_tpu_torch/kernels/_build.py: every field
// is 4 bytes, so the two layouts agree without padding rules.
struct FieldParams {
    int32_t n_chains;     // chains in this launch
    int32_t L0;           // lattice rows (slice axis of the correlator)
    int32_t L1;           // lattice columns
    int32_t rounds;       // Threefry rounds: 20 or 13
    int32_t philox;       // 1: Philox-4x32-10 (rng_impl='hardware'; kernels 3 and 4 only)
    int32_t loops;        // micro-steps per frame (kernels 3, 4)
    int32_t n_frames;     // K (kernel 4)
    int32_t checkerboard; // 1: even half-sweep, then odd sites on fresh even values
    int32_t action;       // 0 phi4, 1 free_field
    int32_t grow_after;
    int32_t has_dtau_max;
    int32_t tile_rows;    // T0, rows owned by one block of kernel 5
    int32_t halo;         // H, recomputed rows above and below (2 sync, 4 checkerboard)
    int32_t n_tiles;      // L0 / T0
    uint32_t seed;
    uint32_t step0;       // micro-step counter at the first frame (kernel 5: of the pair)
    uint32_t chain0;      // global id of this launch's first chain
    float m2, hm2, l6, l24;  // m^2, float32(0.5 m^2), float32(lam/6), float32(lam/24)
    float inv_a2, measure, c_amp, clamp;
    float shrink, dtau_max, inv_loops, loops_f;
    float inv_l1;         // float32(1 / L1): kernel 5's slice means multiply by it
    // kernels 3 and 4 (cluster.cuh): the geometry of field_kernel.cluster_geometry
    int32_t cl_B;         // blocks of the thread-block cluster a chain runs on (1: one block)
    int32_t cl_rows;      // rows of the largest strip, ceil(L0 / cl_B)
    int32_t cl_scratch;   // 1: the kept noise in shared memory; 0: in global memory
    int32_t cl_empty;     // 1: barriers, halos' publication and reductions only (timing)
};

enum { ACTION_PHI4 = 0, ACTION_FREE = 1 };

__device__ __forceinline__ float field_V(const FieldParams& p, float f) {
    if (p.action == ACTION_PHI4) {
        const float p2 = f * f;
        return p.hm2 * p2 + p.l24 * p2 * p2;   // 0.5 m2 p2 + (lam/24) p2 p2
    }
    return p.hm2 * f * f;                      // 0.5 m2 f f
}

__device__ __forceinline__ float field_dV(const FieldParams& p, float f) {
    if (p.action == ACTION_PHI4) return p.m2 * f + p.l6 * f * f * f;
    return p.m2 * f;
}

// Periodic Laplacian: (down + up - 2 phi) per axis, summed from zero in axis
// order, times 1/a^2 (actions/phi4.py:periodic_laplacian).
__device__ __forceinline__ float laplacian(const FieldParams& p, float f, float dn0, float up0,
                                           float dn1, float up1) {
    float lap = 0.0f + (dn0 + up0 - 2.0f * f);
    lap = lap + (dn1 + up1 - 2.0f * f);
    return lap * p.inv_a2;
}

// Action density: forward-difference kinetic term + V (FieldAction.action_density).
__device__ __forceinline__ float action_density(const FieldParams& p, float f, float up0,
                                                float up1) {
    const float d0 = up0 - f, d1 = up1 - f;
    float kin = 0.0f + 0.5f * d0 * d0 * p.inv_a2;
    kin = kin + 0.5f * d1 * d1 * p.inv_a2;
    return kin + field_V(p, f);
}

// Euler-Maruyama update of one site with the clamp and the non-finite rule;
// |det| comes back as +inf where the update is not finite.
__device__ __forceinline__ float em_update(const FieldParams& p, float f, float lap, float noise,
                                           float dtau, float& absdet, bool& finite) {
    const float det = (lap - field_dV(p, f)) * dtau;
    const float new_raw = f + det + noise;
    finite = isfinite(new_raw);
    float newf = fminf(fmaxf(new_raw, -p.clamp), p.clamp);
    if (!finite) newf = p.clamp;
    absdet = finite ? fabsf(det) : INFINITY;
    return newf;
}

// torch.maximum / jnp.maximum of two floats: NaN when either is NaN (a chain
// whose lrg_vl is NaN keeps it, as in the plain version); fmaxf would drop it.
__device__ __forceinline__ float max_keep_nan(float a, float b) {
    return (a > b || isnan(a)) ? a : b;
}

__device__ __forceinline__ float warp_sum(float v) {
    #pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}

// A thread's partial statistics of one micro-step: three sums (phi, phi^2,
// action density), two maxima (|det|, |phi_new|) and the non-finite flag.
struct Acc {
    float s0, s1, s2, mdet, mnew;
    int bad;
};

__device__ __forceinline__ Acc acc_zero() {
    Acc a;
    a.s0 = a.s1 = a.s2 = a.mdet = a.mnew = 0.0f;
    a.bad = 0;
    return a;
}

// First half of a block reduction in a fixed order: xor-shuffle within each
// warp, lane 0 writes the warp's partials to red[6 * warp ...], then a
// barrier.  acc_total then sums the partials in warp order, so every thread
// holds the same totals and the result does not vary between runs.
__device__ __forceinline__ void acc_publish(Acc a, float* red) {
    #pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        a.s0 += __shfl_xor_sync(0xffffffffu, a.s0, off);
        a.s1 += __shfl_xor_sync(0xffffffffu, a.s1, off);
        a.s2 += __shfl_xor_sync(0xffffffffu, a.s2, off);
        a.mdet = fmaxf(a.mdet, __shfl_xor_sync(0xffffffffu, a.mdet, off));
        a.mnew = fmaxf(a.mnew, __shfl_xor_sync(0xffffffffu, a.mnew, off));
        a.bad |= __shfl_xor_sync(0xffffffffu, a.bad, off);
    }
    if ((threadIdx.x & 31) == 0) {
        float* w = red + 6 * (threadIdx.x >> 5);
        w[0] = a.s0;
        w[1] = a.s1;
        w[2] = a.s2;
        w[3] = a.mdet;
        w[4] = a.mnew;
        w[5] = (float)a.bad;
    }
    __syncthreads();
}

__device__ __forceinline__ Acc acc_total(const float* red) {
    Acc t = acc_zero();
    const int nw = blockDim.x >> 5;
    for (int w = 0; w < nw; ++w) {
        const float* v = red + 6 * w;
        t.s0 = w ? t.s0 + v[0] : v[0];
        t.s1 = w ? t.s1 + v[1] : v[1];
        t.s2 = w ? t.s2 + v[2] : v[2];
        t.mdet = fmaxf(t.mdet, v[3]);
        t.mnew = fmaxf(t.mnew, v[4]);
        t.bad |= v[5] != 0.0f;
    }
    return t;
}

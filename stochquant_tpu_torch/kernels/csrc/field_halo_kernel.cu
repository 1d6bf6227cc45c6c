// One Euler-Maruyama micro-step of a shard's local 2-D block for NVIDIA Hopper
// (sm_90a): the update of the lattice-split per-step halo runner.
//
// Replaces the Pallas TPU kernel of stochquant_tpu/kernels/field_halo_kernel.py:
//   kernel 9  sq_field_halo_step  <- _build_kernel / _step_call / make_local_step
//
// One launch is one micro-step (or one checkerboard half-sweep) of every chain
// of the local block (C, L0, L1).  Two modes (FieldHaloParams.halos):
//
//   halos = 0, the JAX kernel's: no halo inputs, the stencil wraps inside the
//   block, so the first and last slice of a split dim come out wrong; the
//   action sum takes the local wrap and the detector the interior sites only
//   (not on the first or last slice of a split dim).
//
//   halos = 1, the runner's: the halo slices of every split dim are inputs (a
//   row below and above, (C, 1, L1), for a dim-0 split; a column left and
//   right, (C, L0, 1), for a dim-1 split: the neighbours' edge slices), so the
//   stencil is the true one on every site, in the bulk's operand order, the
//   action sum takes the true forward difference at the last slice, and the
//   detector counts every site.  The split run is then bit for bit the
//   unsplit one, with no fixup on the host.
//
// The noise is the Threefry draw at the site's *global* counter
// (chain0 + c, (row_off + r) * gL1 + (col_off + col), pair base); `parity`
// picks the Box-Muller output, as two micro-steps share one draw.  Outputs:
// the new field; per chain sum(phi), sum(phi^2) and sum(action density) of the
// pre-update field over all sites; the row sums of the pre-update field; and
// over the detector's sites max|det|, the count of non-finite updates and
// max|phi_new|.  The maxima propagate NaN, as torch.amax does.
//
// What bounds it on the card: per site one Threefry evaluation and Box-Muller
// (~135 operations) plus ~50 of stencil, update and sums against 8 bytes of
// traffic: arithmetic.  But a launch is a single step of a block that is small
// (a 128 x 256 x 16 shard is 2 MiB), so the launch's latency exceeds its work
// and the path is bound by the host: the halo inputs take the edge fixup (its
// noise, stencil, splice and action correction, ~300 small PyTorch ops a step
// and shard) off it.  Design: nothing carries from step to step inside a
// launch, so no block waits on another: a chain's block is cut into strips of
// whole rows over many thread blocks (grid: strips x chains) and the card is
// filled.  Warp w of a block takes rows w, w + nw, ... of its strip, lane l
// columns l, l + 32, ...; a row's sum is one warp reduction, written once.
// Per-block partials are reduced in a fixed order (warp xor-shuffle, then
// warps in order) and written to part[c, strip, 0..5] (sums and the count in
// 0..3, maxima in 4..5); the wrapper reduces them with one torch.sum and one
// torch.amax.  No float atomics: the result is the same on every run.

#include "field_common.cuh"

#define FH_THREADS 256

// Mirrors FieldHaloParams in stochquant_tpu_torch/kernels/_build.py (4-byte
// fields only).  f.L0 / f.L1 are the local block, f.step0 the pair base,
// f.chain0 the global id of the block's first chain.
struct FieldHaloParams {
    FieldParams f;
    int32_t gL1;             // global lattice columns
    int32_t row_off;         // global row of local row 0
    int32_t col_off;         // global column of local column 0
    int32_t parity;          // 0: first Box-Muller output, 1: second
    int32_t half;            // checkerboard: 0 even half-sweep, 1 odd
    int32_t sh0, sh1;        // 1 where the lattice dim is split over shards
    int32_t rows_per_block;  // rows of one strip
    int32_t n_strips;        // ceil(L0 / rows_per_block)
    int32_t halos;           // 1: the halo slices of every split dim are inputs
};

// max that returns NaN when either operand is NaN (torch.maximum)
__device__ __forceinline__ float fh_nan_max(float a, float b) {
    return (a > b || isnan(a)) ? a : b;
}

template <int ROUNDS>
__global__ void __launch_bounds__(FH_THREADS)
field_halo_step_kernel(FieldHaloParams q, const float* __restrict__ phi_in,
                       const float* __restrict__ dtau_in, const float* __restrict__ below,
                       const float* __restrict__ above, const float* __restrict__ left,
                       const float* __restrict__ right, float* __restrict__ phi_out,
                       float* __restrict__ slice, float* __restrict__ part) {
    __shared__ float red[6 * (FH_THREADS / 32)];
    const FieldParams& p = q.f;
    const int L0 = p.L0, L1 = p.L1;
    const int strip = blockIdx.x, ch = blockIdx.y;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nw = FH_THREADS / 32;
    const size_t vol = (size_t)L0 * (size_t)L1;
    const float* phi = phi_in + ch * vol;
    float* out = phi_out + ch * vol;
    const float dtau = dtau_in[ch];
    const float namp = p.c_amp * sqrtf(2.0f * dtau / p.measure);
    const uint32_t k1 = (uint32_t)STREAM_FIELD ^ ((p.chain0 + (uint32_t)ch) << 8);
    const int r_begin = strip * q.rows_per_block;
    const int r_end = min(L0, r_begin + q.rows_per_block);
    // the halo slices of this chain: rows (C, 1, L1) below row 0 and above row
    // L0 - 1, columns (C, L0, 1) left of column 0 and right of column L1 - 1
    const bool h0 = q.halos && q.sh0, h1 = q.halos && q.sh1;
    const float* h_below = below + (size_t)ch * L1;
    const float* h_above = above + (size_t)ch * L1;
    const float* h_left = left + (size_t)ch * L0;
    const float* h_right = right + (size_t)ch * L0;

    float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, mdet = 0.0f, nbad = 0.0f, mnew = 0.0f;
    for (int r = r_begin + warp; r < r_end; r += nw) {
        const int rdn = (r == 0 ? L0 : r) - 1, rup = r + 1 == L0 ? 0 : r + 1;
        const bool row_inner = q.halos || !q.sh0 || (r > 0 && r < L0 - 1);
        const uint32_t grow = (uint32_t)(q.row_off + r);
        float row = 0.0f;
        for (int c = lane; c < L1; c += 32) {
            const int cdn = (c == 0 ? L1 : c) - 1, cup = c + 1 == L1 ? 0 : c + 1;
            const float f = phi[(size_t)r * L1 + c];
            const float up0 = h0 && r + 1 == L0 ? h_above[c] : phi[(size_t)rup * L1 + c];
            const float dn0 = h0 && r == 0 ? h_below[c] : phi[(size_t)rdn * L1 + c];
            const float up1 = h1 && c + 1 == L1 ? h_right[r] : phi[(size_t)r * L1 + cup];
            const float dn1 = h1 && c == 0 ? h_left[r] : phi[(size_t)r * L1 + cdn];
            const uint32_t gcol = (uint32_t)(q.col_off + c);
            const bool active = !p.checkerboard || (int)((grow + gcol) & 1u) == q.half;
            float newf = f, absdet = 0.0f;
            bool fin = true;
            if (active) {
                float z0, z1;
                normal_pair<ROUNDS>(p.seed, k1, grow * (uint32_t)q.gL1 + gcol, p.step0, z0, z1);
                const float noise = namp * (q.parity ? z1 : z0);
                const float lap = laplacian(p, f, dn0, up0, dn1, up1);
                const float det = (lap - field_dV(p, f)) * dtau;
                const float new_raw = f + det + noise;
                fin = isfinite(new_raw);
                newf = fin ? fminf(fmaxf(new_raw, -p.clamp), p.clamp) : p.clamp;
                absdet = fabsf(det);
            }
            out[(size_t)r * L1 + c] = newf;
            s0 += f;
            s1 += f * f;
            s2 += action_density(p, f, up0, up1);
            row += f;
            if (row_inner && (q.halos || !q.sh1 || (c > 0 && c < L1 - 1))) {
                mdet = fh_nan_max(mdet, absdet);
                mnew = fh_nan_max(mnew, fabsf(newf));
                if (!fin) nbad += 1.0f;
            }
        }
        row = warp_sum(row);
        if (lane == 0) slice[(size_t)ch * L0 + r] = row;
    }

#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        s0 += __shfl_xor_sync(0xffffffffu, s0, off);
        s1 += __shfl_xor_sync(0xffffffffu, s1, off);
        s2 += __shfl_xor_sync(0xffffffffu, s2, off);
        nbad += __shfl_xor_sync(0xffffffffu, nbad, off);
        mdet = fh_nan_max(mdet, __shfl_xor_sync(0xffffffffu, mdet, off));
        mnew = fh_nan_max(mnew, __shfl_xor_sync(0xffffffffu, mnew, off));
    }
    if (lane == 0) {
        float* w = red + 6 * warp;
        w[0] = s0;
        w[1] = s1;
        w[2] = s2;
        w[3] = mdet;
        w[4] = nbad;
        w[5] = mnew;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        float t0 = red[0], t1 = red[1], t2 = red[2], t3 = red[3], t4 = red[4], t5 = red[5];
        for (int w = 1; w < nw; ++w) {
            const float* v = red + 6 * w;
            t0 = t0 + v[0];
            t1 = t1 + v[1];
            t2 = t2 + v[2];
            t3 = fh_nan_max(t3, v[3]);
            t4 = t4 + v[4];
            t5 = fh_nan_max(t5, v[5]);
        }
        float* o = part + ((size_t)ch * q.n_strips + strip) * 6;
        o[0] = t0;  // the three sums and the count, then the two maxima
        o[1] = t1;
        o[2] = t2;
        o[3] = t4;
        o[4] = t3;
        o[5] = t5;
    }
}

// ---- C entry point (loaded with ctypes) -----------------------------------

// below / above ((C, 1, L1)) are read where halos and sh0, left / right ((C, L0,
// 1)) where halos and sh1; otherwise they may be any pointer.
extern "C" int sq_field_halo_step(const FieldHaloParams* q, const float* phi_in,
                                  const float* dtau_in, const float* below, const float* above,
                                  const float* left, const float* right, float* phi_out,
                                  float* slice, float* part, void* stream) {
    const FieldParams& p = q->f;
    const bool ok = p.n_chains > 0 && p.n_chains <= 65535 && p.L0 >= 1 && p.L1 >= 1 &&
                    q->gL1 >= p.L1 && q->rows_per_block >= 1 &&
                    q->n_strips == (p.L0 + q->rows_per_block - 1) / q->rows_per_block &&
                    (p.rounds == 20 || p.rounds == 13) &&
                    (p.action == ACTION_PHI4 || p.action == ACTION_FREE) &&
                    (q->parity == 0 || q->parity == 1) && (q->half == 0 || q->half == 1) &&
                    (q->halos == 0 || q->halos == 1);
    if (!ok) return (int)cudaErrorInvalidValue;
    const dim3 grid(q->n_strips, p.n_chains);
    cudaStream_t st = (cudaStream_t)stream;
    if (p.rounds == 20)
        field_halo_step_kernel<20><<<grid, FH_THREADS, 0, st>>>(
            *q, phi_in, dtau_in, below, above, left, right, phi_out, slice, part);
    else
        field_halo_step_kernel<13><<<grid, FH_THREADS, 0, st>>>(
            *q, phi_in, dtau_in, below, above, left, right, phi_out, slice, part);
    return (int)cudaGetLastError();
}

// Strip-tiled 2-D scalar-field micro-step pairs for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of stochquant_tpu/kernels/field_kernel_tiled.py:
//   kernel 5  sq_field_pair  <- _build_pair_kernel / _pair_call
//             (one pair of micro-steps, the two Box-Muller outputs of one
//             Threefry draw, on every chain; per-strip statistics out, the
//             frame's accept/reject and observable sums run in PyTorch)
//
// For lattices too large for one block, the field stays in device memory
// and one block works on a strip of T0 owned rows plus an H-row halo above
// and below (H = 2 for synchronous sweeps, 4 for checkerboard half-sweep
// pairs), wrapping around the lattice.  The halo rows are recomputed rather
// than exchanged (trapezoidal temporal blocking): the edge rows of the
// extended strip compute garbage that moves one row inward per stencil
// application and never reaches the owned rows.  Like the TPU kernel it does
// not freeze a tripped chain mid-frame; the frame rollback discards those
// values.
//
// What bounds it on the card: per site and pair one Threefry evaluation and
// Box-Muller (~150 integer and float operations) plus two updates of ~40, on
// (T0 + 2H) / T0 times the lattice, against one read and one write of the
// strip in device memory: arithmetic, not bandwidth, for T0 >= 8.  Design:
// one block of 1024 threads per (strip, chain); the extended strip is
// ping-ponged between two shared-memory buffers of (T0 + 2H) * L1 floats
// (the wrapper picks T0 so that both fit the 227 KB a block may use), so a
// micro-step reads its neighbours from shared memory; the second noise output
// waits between the two micro-steps in a per-site scratch buffer in device
// memory.  Warp w owns extended rows w, w + 32, ..., lane l columns l, l + 32,
// ...; each statistic is a fixed-order block reduction, written to the
// block's lanes of `stats`: [sum phi, sum phi^2, sum s, max|det|, max|phi_new|]
// for the first micro-step in lanes 0-4 and for the second in 5-9, all over
// the owned rows only, with the slice means (row sums times 1/L1) of the
// pre-update field of each micro-step.

#include "field_common.cuh"

#define FT_THREADS 1024

enum { NOISE_DRAW_KEEP = 0, NOISE_KEPT = 1 };

// Geometry of one block's extended strip.
struct Strip {
    int E;        // T0 + 2H rows
    int row0;     // global row of extended row 0 is (row0 + rl) mod L0
    int own0;     // first global row this block owns (= row0 + H)
};

__device__ __forceinline__ int global_row(const FieldParams& p, const Strip& s, int rl) {
    return ((s.row0 + rl) % p.L0 + p.L0) % p.L0;
}

// One sweep of the extended strip: sites of parity `par` (global row + col;
// every site when par < 0) take the EM update from `src`, the others copy
// it, into `dst`.  Statistics come from the owned rows only.
template <int ROUNDS>
__device__ void tile_sweep(const FieldParams& p, const Strip& s, const float* __restrict__ src,
                           float* __restrict__ dst, float* __restrict__ zk, int par, int noise,
                           uint32_t k1, float namp, float dtau, bool observe, bool last,
                           Acc& acc, float* __restrict__ slice) {
    const int L1 = p.L1, E = s.E, H = p.halo, T0 = p.tile_rows;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nw = blockDim.x >> 5;
    for (int rl = warp; rl < E; rl += nw) {
        const int g = global_row(p, s, rl);
        const bool owned = rl >= H && rl < H + T0;
        const int rdn = (rl == 0 ? E : rl) - 1, rup = rl + 1 == E ? 0 : rl + 1;
        float row = 0.0f;
        for (int c = lane; c < L1; c += 32) {
            const int cdn = (c == 0 ? L1 : c) - 1, cup = c + 1 == L1 ? 0 : c + 1;
            const int i = rl * L1 + c;
            const float f = src[i];
            const float up0 = src[rup * L1 + c], up1 = src[rl * L1 + cup];
            float newf = f;
            if (par < 0 || ((g + c) & 1) == par) {
                float eta;
                if (noise == NOISE_KEPT) {
                    eta = zk[i];
                } else {
                    float z1;
                    normal_pair<ROUNDS>(p.seed, k1, (uint32_t)g * (uint32_t)L1 + (uint32_t)c,
                                        p.step0, eta, z1);
                    zk[i] = z1;
                }
                const float lap = laplacian(p, f, src[rdn * L1 + c], up0, src[rl * L1 + cdn], up1);
                float absdet;
                bool finite;
                newf = em_update(p, f, lap, namp * eta, dtau, absdet, finite);
                if (owned) acc.mdet = fmaxf(acc.mdet, absdet);
            }
            dst[i] = newf;
            if (owned) {
                if (observe) {
                    acc.s0 += f;
                    acc.s1 += f * f;
                    acc.s2 += action_density(p, f, up0, up1);
                    row += f;
                }
                if (last) acc.mnew = fmaxf(acc.mnew, fabsf(newf));
            }
        }
        if (observe && owned) {  // warp-uniform
            row = warp_sum(row);
            if (lane == 0) slice[g] = row * p.inv_l1;
        }
    }
}

// One micro-step of the extended strip; the field goes from `cur` to the
// returned buffer.  Writes the step's statistics to stats[base .. base + 4].
template <int ROUNDS>
__device__ float* tile_micro(const FieldParams& p, const Strip& s, float* cur, float* oth,
                             float* zk, int noise, uint32_t k1, float namp, float dtau,
                             float* __restrict__ stats, float* __restrict__ slice, float* red) {
    Acc acc = acc_zero();
    float* out;
    if (p.checkerboard) {
        tile_sweep<ROUNDS>(p, s, cur, oth, zk, 0, noise, k1, namp, dtau, true, false, acc, slice);
        __syncthreads();
        tile_sweep<ROUNDS>(p, s, oth, cur, zk, 1, noise, k1, namp, dtau, false, true, acc, slice);
        out = cur;
    } else {
        tile_sweep<ROUNDS>(p, s, cur, oth, zk, -1, noise, k1, namp, dtau, true, true, acc, slice);
        out = oth;
    }
    acc_publish(acc, red);  // its barrier also publishes the new strip
    if (threadIdx.x == 0) {
        const Acc t = acc_total(red);
        stats[0] = t.s0;
        stats[1] = t.s1;
        stats[2] = t.s2;
        stats[3] = t.mdet;
        stats[4] = t.mnew;
    }
    __syncthreads();  // red is free again
    return out;
}

template <int ROUNDS>
__global__ void __launch_bounds__(FT_THREADS)
field_pair_kernel(FieldParams p, const float* __restrict__ phi_in,
                  const float* __restrict__ dtau_in, float* __restrict__ phi_out,
                  float* __restrict__ sl0, float* __restrict__ sl1,
                  float* __restrict__ stats, float* __restrict__ zk_all) {
    extern __shared__ float smem[];
    __shared__ float red[6 * (FT_THREADS / 32)];
    const int tile = blockIdx.x, ch = blockIdx.y;
    const int L0 = p.L0, L1 = p.L1, H = p.halo, T0 = p.tile_rows;
    Strip s;
    s.E = T0 + 2 * H;
    s.own0 = tile * T0;
    s.row0 = s.own0 - H;
    float* X = smem;
    float* Y = smem + (size_t)s.E * L1;
    const size_t vol = (size_t)L0 * (size_t)L1;
    const float* phi = phi_in + ch * vol;
    float* zk = zk_all + ((size_t)ch * p.n_tiles + tile) * (size_t)s.E * L1;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nw = blockDim.x >> 5;
    for (int rl = warp; rl < s.E; rl += nw) {
        const int g = global_row(p, s, rl);
        for (int c = lane; c < L1; c += 32) X[rl * L1 + c] = phi[(size_t)g * L1 + c];
    }
    __syncthreads();
    const float dtau = dtau_in[ch];
    const float namp = p.c_amp * sqrtf(2.0f * dtau / p.measure);
    const uint32_t k1 = (uint32_t)STREAM_FIELD ^ ((p.chain0 + (uint32_t)ch) << 8);
    float* st = stats + ((size_t)ch * p.n_tiles + tile) * 10;
    float* a = tile_micro<ROUNDS>(p, s, X, Y, zk, NOISE_DRAW_KEEP, k1, namp, dtau, st,
                                  sl0 + (size_t)ch * L0, red);
    float* b = a == X ? Y : X;
    float* out = tile_micro<ROUNDS>(p, s, a, b, zk, NOISE_KEPT, k1, namp, dtau, st + 5,
                                    sl1 + (size_t)ch * L0, red);
    for (int rl = H + warp; rl < H + T0; rl += nw) {
        const size_t g = (size_t)(s.own0 + rl - H);
        for (int c = lane; c < L1; c += 32) phi_out[ch * vol + g * L1 + c] = out[rl * L1 + c];
    }
}

// ---- C entry point (loaded with ctypes) -----------------------------------

extern "C" int sq_field_pair(const FieldParams* p, const float* phi_in, const float* dtau_in,
                             float* phi_out, float* sl0, float* sl1, float* stats, float* zk,
                             void* stream) {
    const bool ok = p->n_chains > 0 && p->n_chains <= 65535 && p->L0 >= 1 && p->L1 >= 1 &&
                    (long long)p->L0 * p->L1 <= (1LL << 32) && p->tile_rows >= 1 &&
                    p->L0 % p->tile_rows == 0 && p->n_tiles == p->L0 / p->tile_rows &&
                    (p->halo == 2 || p->halo == 4) && (p->rounds == 20 || p->rounds == 13) &&
                    (p->action == ACTION_PHI4 || p->action == ACTION_FREE);
    if (!ok) return (int)cudaErrorInvalidValue;
    const size_t smem = 2 * (size_t)(p->tile_rows + 2 * p->halo) * p->L1 * sizeof(float);
    const dim3 grid(p->n_tiles, p->n_chains);
    cudaStream_t st = (cudaStream_t)stream;
    cudaError_t err;
    if (p->rounds == 20) {
        err = cudaFuncSetAttribute(field_pair_kernel<20>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
        field_pair_kernel<20><<<grid, FT_THREADS, smem, st>>>(*p, phi_in, dtau_in, phi_out, sl0,
                                                              sl1, stats, zk);
    } else {
        err = cudaFuncSetAttribute(field_pair_kernel<13>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
        field_pair_kernel<13><<<grid, FT_THREADS, smem, st>>>(*p, phi_in, dtau_in, phi_out, sl0,
                                                              sl1, stats, zk);
    }
    return (int)cudaGetLastError();
}

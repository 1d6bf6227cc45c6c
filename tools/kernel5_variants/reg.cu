// Kernel 5 with the kept noise in registers: a variant of
// stochquant_tpu_torch/kernels/csrc/field_kernel_tiled.cu timed by
// tools/kernel5_variants.py, not built into the package.  Build with
// -I stochquant_tpu_torch/kernels/csrc and FT_THREADS / FT_KEPT / FT_UNROLL.
//
// Every pass cuts the extended strip into 32-column segments; the work rows
// 1 .. E - 2 (the first application's) give N = (E - 2) * nseg segments, and
// warp w takes segments w, w + NW, w + 2 NW, ... in every application, lane l
// column 32 j + l of segment j.  So a thread's sites are the same in all the
// applications of the pair, an application masks the rows it does not update,
// and the second Box-Muller output waits in a register array of FT_KEPT
// floats, rotated by two per iteration (static indices).

#include "field_common.cuh"

#ifndef FT_THREADS
#define FT_THREADS 512
#endif
#ifndef FT_KEPT
#define FT_KEPT 48
#endif
#ifndef FT_UNROLL
#define FT_UNROLL 4
#endif
#define FT_WARPS (FT_THREADS / 32)
constexpr int kUnroll = FT_UNROLL;

__device__ __forceinline__ float max_nan(float a, float b) {
    return (a != a || b != b) ? NAN : fmaxf(a, b);
}

struct Strip {
    int E, nseg, row0, own0, N;
};

__device__ __forceinline__ Strip make_strip(const FieldParams& p, int tile) {
    Strip s;
    s.E = p.tile_rows + 2 * p.halo;
    s.nseg = (p.L1 + 31) / 32;
    s.own0 = tile * p.tile_rows;
    s.row0 = s.own0 - p.halo;
    while (s.row0 < 0) s.row0 += p.L0;
    s.N = (s.E - 2) * s.nseg;
    return s;
}

__device__ __forceinline__ int global_row(const FieldParams& p, const Strip& s, int rl) {
    int g = s.row0 + rl;
    while (g >= p.L0) g -= p.L0;
    return g;
}

// (row, segment) of the segment FT_WARPS after (rl, j).
__device__ __forceinline__ void next_seg(int& rl, int& j, int nseg) {
    j += FT_WARPS;
    while (j >= nseg) {
        j -= nseg;
        ++rl;
    }
}

// One site, without branches on the data.  Returns its pre-update value where
// it counts for the slice means (observe, owned, valid), else 0.
template <int ROUNDS, bool KEPT>
__device__ __forceinline__ float reg_site(const FieldParams& p, const float* __restrict__ src,
                                          float* __restrict__ dst, int rl, int c, int g,
                                          bool valid, bool owned, int par, uint32_t k1,
                                          float namp, float dtau, bool observe, bool last,
                                          Acc& acc, float& kz) {
    const int L1 = p.L1;
    const int cdn = (c == 0 ? L1 : c) - 1, cup = c + 1 == L1 ? 0 : c + 1;
    const int i = rl * L1 + c;
    const float f = src[i];
    const float up0 = src[i + L1], up1 = src[rl * L1 + cup];
    const float lap = laplacian(p, f, src[i - L1], up0, src[rl * L1 + cdn], up1);
    const bool upd = valid && (par < 0 || ((g + c) & 1) == par);
    float eta, z1 = 0.0f;
    if (KEPT)
        eta = kz;
    else
        normal_pair<ROUNDS>(p.seed, k1, (uint32_t)g * (uint32_t)L1 + (uint32_t)c, p.step0, eta,
                            z1);
    float absdet;
    bool finite;
    const float moved = em_update(p, f, lap, namp * eta, dtau, absdet, finite);
    const float newf = upd ? moved : f;
    if (valid) dst[i] = newf;
    if (!KEPT) kz = upd ? z1 : kz;
    float pre = 0.0f;
    if (owned) {  // warp-uniform
        if (upd) acc.mdet = max_nan(acc.mdet, absdet);
        if (observe && valid) {
            acc.s0 += f;
            acc.s1 += f * f;
            acc.s2 += action_density(p, f, up0, up1);
            pre = f;
        }
        if (last && valid) acc.mnew = max_nan(acc.mnew, fabsf(newf));
    }
    return pre;
}

// Stencil application `app` over the thread's fixed sites: rows app .. E -
// app - 1 take the update at sites of parity `par` (every site when par < 0)
// and a copy elsewhere; the other rows are left alone.  The kept noise
// rotates by two per iteration whether or not the warp has work, so every
// application sees a site's value at the same index.
template <int ROUNDS, bool KEPT>
__device__ __forceinline__ void reg_sweep(const FieldParams& p, const Strip& s, int app,
                                          const float* __restrict__ src, float* __restrict__ dst,
                                          float (&kept)[FT_KEPT], int par, uint32_t k1,
                                          float namp, float dtau, bool observe, bool last,
                                          Acc& acc, float* __restrict__ part) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int H = p.halo, T0 = p.tile_rows, L1 = p.L1;
    int q = warp, rl = 1 + warp / s.nseg, j = warp % s.nseg;
#pragma unroll kUnroll
    for (int k = 0; k < FT_KEPT; k += 2) {
        float a = kept[0], b = kept[1];
        if (q < s.N) {  // warp-uniform
            int rl2 = rl, j2 = j;
            next_seg(rl2, j2, s.nseg);
            const bool has2 = q + FT_WARPS < s.N;
            const int r2 = has2 ? rl2 : rl, s2 = has2 ? j2 : j;
            const int c = 32 * j + lane, c2 = 32 * s2 + lane;
            const bool v1 = rl >= app && rl < s.E - app && c < L1;
            const bool v2 = has2 && r2 >= app && r2 < s.E - app && c2 < L1;
            const bool o1 = rl >= H && rl < H + T0, o2 = has2 && r2 >= H && r2 < H + T0;
            float p1 = reg_site<ROUNDS, KEPT>(p, src, dst, rl, c < L1 ? c : 0,
                                              global_row(p, s, rl), v1, o1, par, k1, namp, dtau,
                                              observe, last, acc, a);
            float p2 = reg_site<ROUNDS, KEPT>(p, src, dst, r2, c2 < L1 ? c2 : 0,
                                              global_row(p, s, r2), v2, o2, par, k1, namp, dtau,
                                              observe, last, acc, b);
            if (observe) {
                if (o1) {
                    p1 = warp_sum(p1);
                    if (lane == 0) part[(rl - H) * s.nseg + j] = p1;
                }
                if (o2) {
                    p2 = warp_sum(p2);
                    if (lane == 0) part[(r2 - H) * s.nseg + s2] = p2;
                }
            }
            rl = rl2;
            j = j2;
            next_seg(rl, j, s.nseg);
        }
#pragma unroll
        for (int m = 0; m + 2 < FT_KEPT; ++m) kept[m] = kept[m + 2];
        kept[FT_KEPT - 2] = a;
        kept[FT_KEPT - 1] = b;
        q += 2 * FT_WARPS;
    }
}

// Fixed-order block totals (xor-shuffle in each warp, then warp 0 shuffles
// the warp partials).  Valid in thread 0.
__device__ __forceinline__ Acc tile_reduce(Acc a, float* red) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        a.s0 += __shfl_xor_sync(0xffffffffu, a.s0, off);
        a.s1 += __shfl_xor_sync(0xffffffffu, a.s1, off);
        a.s2 += __shfl_xor_sync(0xffffffffu, a.s2, off);
        a.mdet = max_nan(a.mdet, __shfl_xor_sync(0xffffffffu, a.mdet, off));
        a.mnew = max_nan(a.mnew, __shfl_xor_sync(0xffffffffu, a.mnew, off));
    }
    if (lane == 0) {
        float* v = red + 5 * warp;
        v[0] = a.s0;
        v[1] = a.s1;
        v[2] = a.s2;
        v[3] = a.mdet;
        v[4] = a.mnew;
    }
    __syncthreads();
    Acc t = acc_zero();
    if (warp == 0) {
        if (lane < FT_WARPS) {
            const float* v = red + 5 * lane;
            t.s0 = v[0];
            t.s1 = v[1];
            t.s2 = v[2];
            t.mdet = v[3];
            t.mnew = v[4];
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
            t.s0 += __shfl_xor_sync(0xffffffffu, t.s0, off);
            t.s1 += __shfl_xor_sync(0xffffffffu, t.s1, off);
            t.s2 += __shfl_xor_sync(0xffffffffu, t.s2, off);
            t.mdet = max_nan(t.mdet, __shfl_xor_sync(0xffffffffu, t.mdet, off));
            t.mnew = max_nan(t.mnew, __shfl_xor_sync(0xffffffffu, t.mnew, off));
        }
    }
    return t;
}

// A micro-step's statistics and slice means, from its accumulators and the
// segment partials in `part`; ends with the block free to reuse red / part.
__device__ __forceinline__ void micro_out(const FieldParams& p, const Strip& s, Acc acc,
                                          float* __restrict__ stats, float* __restrict__ slice,
                                          const float* part, float* red) {
    const Acc t = tile_reduce(acc, red);  // its barrier also publishes the strip and part
    if (threadIdx.x == 0) {
        stats[0] = t.s0;
        stats[1] = t.s1;
        stats[2] = t.s2;
        stats[3] = t.mdet;
        stats[4] = t.mnew;
    }
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int r = warp; r < p.tile_rows; r += FT_WARPS) {
        const float* pr = part + r * s.nseg;
        float sum = 0.0f;
        for (int k = lane; k < s.nseg; k += 32) sum += pr[k];
        sum = warp_sum(sum);
        if (lane == 0) slice[s.own0 + r] = sum * p.inv_l1;
    }
    __syncthreads();
}

template <int ROUNDS, bool CB>
__global__ void __launch_bounds__(FT_THREADS)
field_pair_kernel(FieldParams p, const float* __restrict__ phi_in,
                  const float* __restrict__ dtau_in, float* __restrict__ phi_out,
                  float* __restrict__ sl0, float* __restrict__ sl1, float* __restrict__ stats) {
    extern __shared__ float smem[];
    __shared__ float red[5 * FT_WARPS];
    const int tile = blockIdx.x, ch = blockIdx.y;
    const int L0 = p.L0, L1 = p.L1, H = p.halo, T0 = p.tile_rows;
    const Strip s = make_strip(p, tile);
    float* X = smem;
    float* Y = smem + (size_t)s.E * L1;
    float* part = Y + (size_t)s.E * L1;
    const size_t vol = (size_t)L0 * (size_t)L1;
    const float* phi = phi_in + ch * vol;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int q = warp; q < s.E * s.nseg; q += FT_WARPS) {  // load the extended strip
        const int rl = q / s.nseg, c = 32 * (q - rl * s.nseg) + lane;
        if (c < L1) X[rl * L1 + c] = phi[(size_t)global_row(p, s, rl) * L1 + c];
    }
    __syncthreads();
    const float dtau = dtau_in[ch];
    const float namp = p.c_amp * sqrtf(2.0f * dtau / p.measure);
    const uint32_t k1 = (uint32_t)STREAM_FIELD ^ ((p.chain0 + (uint32_t)ch) << 8);
    float* st = stats + ((size_t)ch * p.n_tiles + tile) * 10;
    float kept[FT_KEPT];
#pragma unroll
    for (int m = 0; m < FT_KEPT; ++m) kept[m] = 0.0f;
    Acc acc = acc_zero();
    if (CB) {
        reg_sweep<ROUNDS, false>(p, s, 1, X, Y, kept, 0, k1, namp, dtau, true, false, acc, part);
        __syncthreads();
        reg_sweep<ROUNDS, false>(p, s, 2, Y, X, kept, 1, k1, namp, dtau, false, true, acc, part);
    } else {
        reg_sweep<ROUNDS, false>(p, s, 1, X, Y, kept, -1, k1, namp, dtau, true, true, acc, part);
    }
    micro_out(p, s, acc, st, sl0 + (size_t)ch * L0, part, red);
    acc = acc_zero();
    if (CB) {
        reg_sweep<ROUNDS, true>(p, s, 3, X, Y, kept, 0, k1, namp, dtau, true, false, acc, part);
        __syncthreads();
        reg_sweep<ROUNDS, true>(p, s, 4, Y, X, kept, 1, k1, namp, dtau, false, true, acc, part);
    } else {
        reg_sweep<ROUNDS, true>(p, s, 2, Y, X, kept, -1, k1, namp, dtau, true, true, acc, part);
    }
    micro_out(p, s, acc, st + 5, sl1 + (size_t)ch * L0, part, red);
    for (int q = warp; q < T0 * s.nseg; q += FT_WARPS) {  // store the owned rows (in X)
        const int r = q / s.nseg, c = 32 * (q - r * s.nseg) + lane;
        if (c < L1) phi_out[ch * vol + (size_t)(s.own0 + r) * L1 + c] = X[(r + H) * L1 + c];
    }
}

template <int ROUNDS, bool CB>
static int reg_launch(const FieldParams* p, const float* phi_in, const float* dtau_in,
                      float* phi_out, float* sl0, float* sl1, float* stats, size_t smem,
                      cudaStream_t st) {
    cudaError_t err = cudaFuncSetAttribute(field_pair_kernel<ROUNDS, CB>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    field_pair_kernel<ROUNDS, CB><<<dim3(p->n_tiles, p->n_chains), FT_THREADS, smem, st>>>(
        *p, phi_in, dtau_in, phi_out, sl0, sl1, stats);
    return (int)cudaGetLastError();
}

extern "C" int sq_field_pair(const FieldParams* p, const float* phi_in, const float* dtau_in,
                             float* phi_out, float* sl0, float* sl1, float* stats, float* zk,
                             void* stream) {
    (void)zk;
    const long long nseg = (p->L1 + 31) / 32, E = p->tile_rows + 2 * p->halo;
    const bool ok = p->n_chains > 0 && p->n_chains <= 65535 && p->L0 >= 1 && p->L1 >= 1 &&
                    (long long)p->L0 * p->L1 <= (1LL << 32) && p->tile_rows >= 1 &&
                    p->L0 % p->tile_rows == 0 && p->n_tiles == p->L0 / p->tile_rows &&
                    (p->halo == 2 || p->halo == 4) && (p->rounds == 20 || p->rounds == 13) &&
                    (p->action == ACTION_PHI4 || p->action == ACTION_FREE) &&
                    (E - 2) * nseg <= (long long)FT_KEPT * FT_WARPS;
    if (!ok) return (int)cudaErrorInvalidValue;
    const size_t smem = (2 * E * p->L1 + (size_t)p->tile_rows * nseg) * sizeof(float);
    cudaStream_t st = (cudaStream_t)stream;
    if (p->rounds == 20)
        return p->checkerboard
                   ? reg_launch<20, true>(p, phi_in, dtau_in, phi_out, sl0, sl1, stats, smem, st)
                   : reg_launch<20, false>(p, phi_in, dtau_in, phi_out, sl0, sl1, stats, smem, st);
    return p->checkerboard
               ? reg_launch<13, true>(p, phi_in, dtau_in, phi_out, sl0, sl1, stats, smem, st)
               : reg_launch<13, false>(p, phi_in, dtau_in, phi_out, sl0, sl1, stats, smem, st);
}

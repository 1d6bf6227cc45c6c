// Kernel 5 with the second micro-step's rows of the kept noise in shared
// memory: a variant of stochquant_tpu_torch/kernels/csrc/field_kernel_tiled.cu
// timed by tools/kernel5_variants.py, not built into the package.  The first
// micro-step stores the second Box-Muller output only for the rows the second
// micro-step updates (kr0 ... E - kr0 - 1, kr0 = 1 + the stencil applications
// a micro-step), in a buffer after the slice partials; everything else is the
// package's kernel.  Build with -I stochquant_tpu_torch/kernels/csrc.

#include "field_common.cuh"

#define FT_THREADS 1024
#define FT_WARPS (FT_THREADS / 32)

// torch.amax / torch.maximum keep a NaN; fmaxf drops it.
__device__ __forceinline__ float max_nan(float a, float b) {
    return (a != a || b != b) ? NAN : fmaxf(a, b);
}

// Geometry of one block's extended strip.
struct Strip {
    int E;        // T0 + 2H rows
    int nseg;     // 32-column segments of a row
    int row0;     // global row of extended row 0 (own0 - H, wrapped)
    int own0;     // first global row this block owns
};

__device__ __forceinline__ Strip make_strip(const FieldParams& p, int tile) {
    Strip s;
    s.E = p.tile_rows + 2 * p.halo;
    s.nseg = (p.L1 + 31) / 32;
    s.own0 = tile * p.tile_rows;
    s.row0 = s.own0 - p.halo;
    while (s.row0 < 0) s.row0 += p.L0;
    return s;
}

// The units of `rows` rows: each row cut into the fewest chunks that give
// every warp a unit, nch = ceil(32 / rows) (at most one per 64 columns), of
// cw columns, a multiple of 64 (a lane's two sites per iteration), so that
// every warp works and the warps' shares differ by at most one unit.
struct Units {
    int nch, cw;
};

__device__ __forceinline__ Units make_units(int rows, int nseg) {
    const int npair = (nseg + 1) / 2;
    Units u;
    u.nch = min((FT_WARPS + rows - 1) / rows, npair);
    u.cw = 64 * ((npair + u.nch - 1) / u.nch);
    return u;
}

__device__ __forceinline__ int global_row(const FieldParams& p, const Strip& s, int rl) {
    int g = s.row0 + rl;
    while (g >= p.L0) g -= p.L0;  // once, unless the strip is taller than the lattice
    return g;
}

// One site of a sweep, without branches on the data: the stencil, the noise
// and the update are computed for every site, and `upd` / `valid` select what
// is stored and counted, so that the two sites a lane takes per iteration
// interleave (a lane's sites of one warp alternate in parity under the
// checkerboard, so its warp runs the update of every site in any case).
// OWNED (the row is owned) and KEPT (the noise comes from the second
// micro-step's store) are compile-time, so a halo row issues no statistics.
template <int ROUNDS, bool OWNED, bool KEPT>
__device__ __forceinline__ void tile_site(const FieldParams& p, const float* __restrict__ src,
                                          float* __restrict__ dst, float* __restrict__ zk,
                                          int rl, int c, int g, bool valid, int par, uint32_t k1,
                                          float namp, float dtau, bool observe, bool last,
                                          Acc& acc, float& row, bool krow) {
    const int L1 = p.L1;
    const int cdn = (c == 0 ? L1 : c) - 1, cup = c + 1 == L1 ? 0 : c + 1;
    const int i = rl * L1 + c;
    const float f = src[i];
    const float up0 = src[i + L1], up1 = src[rl * L1 + cup];
    const float lap = laplacian(p, f, src[i - L1], up0, src[rl * L1 + cdn], up1);
    const bool upd = valid && (par < 0 || ((g + c) & 1) == par);
    float eta, z1 = 0.0f;
    if (KEPT)
        eta = zk[i];
    else
        normal_pair<ROUNDS>(p.seed, k1, (uint32_t)g * (uint32_t)L1 + (uint32_t)c, p.step0, eta,
                            z1);
    float absdet;
    bool finite;
    const float moved = em_update(p, f, lap, namp * eta, dtau, absdet, finite);
    const float newf = upd ? moved : f;
    if (valid) dst[i] = newf;
    if (!KEPT && upd && krow) zk[i] = z1;
    if (OWNED) {
        if (upd) acc.mdet = max_nan(acc.mdet, absdet);
        if (observe && valid) {
            acc.s0 += f;
            acc.s1 += f * f;
            acc.s2 += action_density(p, f, up0, up1);
            row += f;
        }
        if (last && valid) acc.mnew = max_nan(acc.mnew, fabsf(newf));
    }
}

// The columns c0 ... c1 - 1 of extended row `rl`, a lane two sites 32 apart
// per iteration; returns the lane's sum of the pre-update field (observe).
template <int ROUNDS, bool OWNED, bool KEPT>
__device__ __forceinline__ float tile_unit(const FieldParams& p, const float* __restrict__ src,
                                           float* __restrict__ dst, float* __restrict__ zk,
                                           int rl, int c0, int c1, int g, int par, uint32_t k1,
                                           float namp, float dtau, bool observe, bool last,
                                           Acc& acc, bool krow) {
    const int lane = threadIdx.x & 31;
    float row = 0.0f;
    for (int c = c0 + lane; c < c1; c += 64) {
        const bool two = c + 32 < c1;
        tile_site<ROUNDS, OWNED, KEPT>(p, src, dst, zk, rl, c, g, true, par, k1, namp, dtau,
                                       observe, last, acc, row, krow);
        tile_site<ROUNDS, OWNED, KEPT>(p, src, dst, zk, rl, two ? c + 32 : c, g, two, par, k1,
                                       namp, dtau, observe, last, acc, row, krow);
    }
    return row;
}

// Stencil application `app` (1 ... 2H over the pair) of the extended strip:
// rows app ... E - app - 1, the rows the owned ones still depend on (the
// strip shrinks a row a side per application, as the TPU kernel's strip
// does), take from `src` the EM update at sites of parity `par` (global row +
// col; every site when par < 0) and a copy elsewhere, into `dst`.  Warp w
// takes units w, w + 32, ... (unit u: row app + u / nch, the columns of chunk
// u mod nch).  Statistics come from the owned rows only; with `observe` each
// unit's sum of the pre-update field goes to part[owned row][chunk].
// Returns the units' nch.
template <int ROUNDS, bool KEPT>
__device__ __forceinline__ int tile_sweep(const FieldParams& p, const Strip& s, int app,
                                          const float* __restrict__ src, float* __restrict__ dst,
                                          float* __restrict__ zk, int par, uint32_t k1,
                                          float namp, float dtau, bool observe, bool last,
                                          Acc& acc, float* __restrict__ part) {
    const int L1 = p.L1, H = p.halo, T0 = p.tile_rows;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int rows = s.E - 2 * app;
    const Units un = make_units(rows, s.nseg);
    for (int u = warp; u < rows * un.nch; u += FT_WARPS) {
        const int r = u / un.nch, chunk = u - r * un.nch, rl = app + r;
        const int g = global_row(p, s, rl);
        const int c0 = chunk * un.cw, c1 = min(L1, c0 + un.cw);
        const int kr0 = 1 + (p.checkerboard ? 2 : 1);
        const bool krow = rl >= kr0 && rl < s.E - kr0;
        if (rl >= H && rl < H + T0) {  // warp-uniform
            float row = tile_unit<ROUNDS, true, KEPT>(p, src, dst, zk, rl, c0, c1, g, par, k1,
                                                      namp, dtau, observe, last, acc, krow);
            if (observe) {
                row = warp_sum(row);
                if (lane == 0) part[(rl - H) * un.nch + chunk] = row;
            }
        } else {
            tile_unit<ROUNDS, false, KEPT>(p, src, dst, zk, rl, c0, c1, g, par, k1, namp, dtau,
                                           observe, last, acc, krow);
        }
    }
    return un.nch;
}

// Fixed-order block totals: xor-shuffle in each warp, then warp 0 shuffles
// the 32 warp partials.  Valid in thread 0.
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
        const float* v = red + 5 * lane;
        t.s0 = v[0];
        t.s1 = v[1];
        t.s2 = v[2];
        t.mdet = v[3];
        t.mnew = v[4];
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

// One micro-step of the extended strip, from stencil application `app`; the
// field goes from `cur` to the returned buffer.  Writes the step's statistics
// to stats[0 .. 4] and the slice means of its pre-update field to
// slice[global row].
template <int ROUNDS, bool KEPT>
__device__ __forceinline__ float* tile_micro(const FieldParams& p, const Strip& s, int app,
                                             float* cur, float* oth, float* zk, uint32_t k1,
                                             float namp, float dtau, float* __restrict__ stats,
                                             float* __restrict__ slice, float* part, float* red) {
    Acc acc = acc_zero();
    float* out;
    int nch;
    if (p.checkerboard) {
        nch = tile_sweep<ROUNDS, KEPT>(p, s, app, cur, oth, zk, 0, k1, namp, dtau, true, false,
                                       acc, part);
        __syncthreads();
        tile_sweep<ROUNDS, KEPT>(p, s, app + 1, oth, cur, zk, 1, k1, namp, dtau, false, true, acc,
                                 part);
        out = cur;
    } else {
        nch = tile_sweep<ROUNDS, KEPT>(p, s, app, cur, oth, zk, -1, k1, namp, dtau, true, true,
                                       acc, part);
        out = oth;
    }
    const Acc t = tile_reduce(acc, red);  // its barrier also publishes the new strip and part
    if (threadIdx.x == 0) {
        stats[0] = t.s0;
        stats[1] = t.s1;
        stats[2] = t.s2;
        stats[3] = t.mdet;
        stats[4] = t.mnew;
    }
    // a warp a row: lane l adds chunks l, l + 32, ... in order, then a shuffle
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int r = warp; r < p.tile_rows; r += FT_WARPS) {
        const float* pr = part + r * nch;
        float sum = 0.0f;
        for (int k = lane; k < nch; k += 32) sum += pr[k];
        sum = warp_sum(sum);
        if (lane == 0) slice[s.own0 + r] = sum * p.inv_l1;
    }
    __syncthreads();  // red and part are free again
    return out;
}

template <int ROUNDS>
__global__ void __launch_bounds__(FT_THREADS)
field_pair_kernel(FieldParams p, const float* __restrict__ phi_in,
                  const float* __restrict__ dtau_in, float* __restrict__ phi_out,
                  float* __restrict__ sl0, float* __restrict__ sl1, float* __restrict__ stats,
                  float* __restrict__ zk_all) {
    extern __shared__ float smem[];
    __shared__ float red[5 * FT_WARPS];
    const int tile = blockIdx.x, ch = blockIdx.y;
    const int L0 = p.L0, L1 = p.L1, H = p.halo, T0 = p.tile_rows;
    const Strip s = make_strip(p, tile);
    const size_t strip = (size_t)s.E * L1;
    float* X = smem;
    float* Y = smem + strip;
    float* part = Y + strip;  // T0 * nseg at most
    const int kr0 = 1 + (p.checkerboard ? 2 : 1);  // the kept noise, rows kr0 .. E - kr0 - 1
    float* zk = part + (size_t)T0 * s.nseg - (size_t)kr0 * L1;
    const size_t vol = (size_t)L0 * (size_t)L1;
    const float* phi = phi_in + ch * vol;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    {  // load the extended strip, in units of all E rows
        const Units un = make_units(s.E, s.nseg);
        for (int u = warp; u < s.E * un.nch; u += FT_WARPS) {
            const int rl = u / un.nch, chunk = u - rl * un.nch;
            const size_t g = (size_t)global_row(p, s, rl);
            const int c1 = min(L1, (chunk + 1) * un.cw);
            for (int c = chunk * un.cw + lane; c < c1; c += 32) X[rl * L1 + c] = phi[g * L1 + c];
        }
    }
    __syncthreads();
    const float dtau = dtau_in[ch];
    const float namp = p.c_amp * sqrtf(2.0f * dtau / p.measure);
    const uint32_t k1 = (uint32_t)STREAM_FIELD ^ ((p.chain0 + (uint32_t)ch) << 8);
    const int per_step = p.checkerboard ? 2 : 1;
    float* st = stats + ((size_t)ch * p.n_tiles + tile) * 10;
    float* a = tile_micro<ROUNDS, false>(p, s, 1, X, Y, zk, k1, namp, dtau, st,
                                         sl0 + (size_t)ch * L0, part, red);
    float* b = a == X ? Y : X;
    float* out = tile_micro<ROUNDS, true>(p, s, 1 + per_step, a, b, zk, k1, namp, dtau, st + 5,
                                          sl1 + (size_t)ch * L0, part, red);
    {  // store the owned rows, in units of T0 rows
        const Units un = make_units(T0, s.nseg);
        for (int u = warp; u < T0 * un.nch; u += FT_WARPS) {
            const int r = u / un.nch, chunk = u - r * un.nch;
            const size_t g = (size_t)(s.own0 + r);
            const int c1 = min(L1, (chunk + 1) * un.cw);
            for (int c = chunk * un.cw + lane; c < c1; c += 32)
                phi_out[ch * vol + g * L1 + c] = out[(r + H) * L1 + c];
        }
    }
}

// ---- C entry point (loaded with ctypes) -----------------------------------

// zk: unused (the kept noise is in shared memory).
extern "C" int sq_field_pair(const FieldParams* p, const float* phi_in, const float* dtau_in,
                             float* phi_out, float* sl0, float* sl1, float* stats, float* zk,
                             void* stream) {
    const bool ok = p->n_chains > 0 && p->n_chains <= 65535 && p->L0 >= 1 && p->L1 >= 1 &&
                    (long long)p->L0 * p->L1 <= (1LL << 32) && p->tile_rows >= 1 &&
                    p->L0 % p->tile_rows == 0 && p->n_tiles == p->L0 / p->tile_rows &&
                    (p->halo == 2 || p->halo == 4) && (p->rounds == 20 || p->rounds == 13) &&
                    (p->action == ACTION_PHI4 || p->action == ACTION_FREE);
    if (!ok) return (int)cudaErrorInvalidValue;
    const size_t E = (size_t)(p->tile_rows + 2 * p->halo), nseg = (p->L1 + 31) / 32;
    const size_t kr0 = 1 + (p->checkerboard ? 2 : 1);
    const size_t smem = ((3 * E - 2 * kr0) * p->L1 + (size_t)p->tile_rows * nseg) * sizeof(float);
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

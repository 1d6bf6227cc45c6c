// D-dimensional (2 <= D <= 5) scalar-field micro-steps for NVIDIA Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernels of stochquant_tpu/kernels/field_kernel_nd.py:
//   kernel 6  sq_field_pair_nd   <- _build_pair_kernel / _pair_call
//             (one pair of micro-steps, the two Box-Muller outputs of one
//             Threefry draw, of every chain of a periodic D >= 3 lattice;
//             per-block statistics and dim-0 slice sums out, the frame's
//             observable sums and accept/reject run in PyTorch)
//   kernel 7  sq_field_chunk_nd  <- _build_sharded_chunk_kernel(rdma=False) /
//             _sharded_chunk_call / make_sharded_chunk_step_md
//             (W micro-steps, W even, on a block that carries a halo in every
//             split dim; noise and parity from global coordinates; statistics
//             over the owned sites of every step)
//   kernel 8  sq_field_chunk_rdma_nd  <- _build_sharded_chunk_kernel(rdma=True) /
//             _sharded_chunk_call / make_rdma_chunk_step
//             (kernel 7's W steps on a dim-0 split, reading the H halo rows
//             on each side straight from the dim-0 neighbours' unextended
//             slabs instead of from a block the runner assembled)
//   sq_field_step_nd  one launch of kernel 6's code at n_steps = 1: the last
//             micro-step of an odd loops count (the first Box-Muller output
//             of the pair drawn at that step's counter), D = 2 ... 5
//
// The TPU kernels hold a dim-0 strip of the lattice, several MiB, on chip.
// Here one dim-0 slab of 32^4 is 128 KiB, so with its halo not even a one-row
// strip fits the 227 KB of shared memory a block may use, and a strip per
// block would leave most multiprocessors idle at a few chains.  So a block
// owns a TILE, cut in as many dims as the wrapper chooses (dims 0 and 1
// today), and recomputes a halo of `depth` sites around it in every dim the
// tile does not span (trapezoidal temporal blocking: stencil application s
// updates the tile extended by depth - s sites, so the last one updates the
// owned sites, and nothing is exchanged between blocks).  In a dim the tile
// spans and the lattice does not split, the tile wraps periodically and has
// no halo.  A checkerboard launch needs depth 2 W (8 at W = 4), where a
// shared-memory tile with its halo would shrink to a few sites per dim; so
// for both sweeps the extended tile is staged in a per-block scratch in
// device memory (two buffers, ping-ponged per stencil application, and the
// kept second Box-Muller output), which stays in L1 / L2 while the block
// works on it.  One design for kernels 6, 7 and 8, both sweeps and any D: the
// kernels differ in where the extended tile is loaded from and in nothing
// else.
//
// Kernel 8.  The TPU kernel copies its halo rows from the ring neighbours
// with remote DMAs into stage and receive buffers, under DMA and barrier
// semaphores and in a rotated strip order, so that no chip overwrites rows a
// neighbour has not read yet.  Here the shards of a dim-0 ring all lie on one
// card (a mesh whose device repeats): they share one address space and one
// stream, so the kernel takes three plain pointers (own slab, left and right
// neighbour) and none of that machinery is needed: the runner launches every
// shard's chunk on the same stream before any shard's phi is replaced, each
// launch writes a fresh output tensor (the double buffering), and the stream
// order does the barrier's job.  Shards on several cards would need peer
// access and an event per shard; that variant is not written.  What bounds
// it: kernel 7's operations at the same geometry; what it saves is the
// runner's copy of the extended block (two slices, two shifts and a concat
// per shard and chunk).
//
// What bounds it on the card: per site and pair one Threefry evaluation and
// Box-Muller (135 integer and float operations at 20 rounds, a transcendental
// counted as one) and two updates with their statistics of 9 D + 30 each,
// against one read and one write of the field: operations, not bytes (at
// 32^4 267 operations per site and pair against 8 bytes).  The halo
// recompute multiplies the arithmetic by the mean over the applications s of
// the product over the cut dims of (T + 2 (depth - s)) / T; the wrapper
// halves the tile only until the launch fills the card.
//
// Threads: warp w takes the rows (all dims but the last) w, w + 16, ... of
// the region, lane l the sites l, l + 32, ... of the last dim.  Statistics
// are reduced in a fixed order (lanes by xor-shuffle, warps in order), the
// maxima NaN-propagating as torch.amax, and written per block: [sum phi,
// sum phi^2, sum s, max|det|, max|phi_new|] for each micro-step over the
// block's owned sites; the dim-0 slice sums of the pre-update field go to
// slp[chain, step, row, tile index over dims >= 1], summed over the last
// axis by the wrapper.  Like the TPU kernels, a tripped chain is not frozen
// mid-frame; the frame rollback discards it.

#include "field_common.cuh"

#define SQ_ND_MAXD 5
#define ND_THREADS 512
#define ND_WARPS (ND_THREADS / 32)

// Mirrors FieldNdParams in stochquant_tpu_torch/kernels/_build.py (all 4-byte
// fields).  f.L0, f.L1 and the tile fields of f are not read here.
struct FieldNdParams {
    FieldParams f;
    int32_t nd;         // lattice dims D
    int32_t n_steps;    // micro-steps per launch: 2 (kernel 6), 1 (its odd tail) or W (7, 8)
    int32_t depth;      // stencil applications per launch
    int32_t n_blocks;   // tiles per chain
    int32_t ext_sites;  // sites of one extended tile
    int32_t n_inner;    // tiles per chain that share one dim-0 tile index
    int32_t G[SQ_ND_MAXD];    // global lattice extents
    int32_t A[SQ_ND_MAXD];    // extents of the input array (owned + 2 array halos; for
                              // kernel 8 the array its three slabs stand for)
    int32_t loc[SQ_ND_MAXD];  // extents of the owned block (the output)
    int32_t ab[SQ_ND_MAXD];   // input index of extended-tile site e of a tile at o: (ab + o + e) mod A
    int32_t gb[SQ_ND_MAXD];   // its global coordinate: (gb + o + e) mod G
    int32_t T[SQ_ND_MAXD];    // tile extents
    int32_t th[SQ_ND_MAXD];   // tile halo per side: 0 (the tile wraps) or depth
    int32_t nt[SQ_ND_MAXD];   // tiles per dim
};

enum { ND_DRAW_KEEP = 0, ND_KEPT = 1 };

// torch.amax / torch.maximum keep a NaN; fmaxf drops it.
__device__ __forceinline__ float max_nan(float a, float b) {
    return (a != a || b != b) ? NAN : fmaxf(a, b);
}

struct NdAcc {
    float s0, s1, s2, mdet, mnew;
};

// One block's tile: where it sits and the strides of its extended box.
struct NdTile {
    int o[SQ_ND_MAXD];    // origin of the owned tile in the owned block
    int ext[SQ_ND_MAXD];  // T + 2 th
    int es[SQ_ND_MAXD];   // C-order strides of the extended tile
    int inner;            // tile index over dims >= 1
};

// Row `r` of the box [lo_d, ext_d - lo_d) over dims 0 .. D-2, C order:
// its coordinates in the extended tile.
__device__ __forceinline__ void nd_row(const FieldNdParams& p, const NdTile& t, int shrink, int r,
                                       int (&e)[SQ_ND_MAXD]) {
#pragma unroll
    for (int d = SQ_ND_MAXD - 2; d >= 0; --d) {
        if (d < p.nd - 1) {
            const int lo = p.th[d] ? shrink : 0;
            const int n = t.ext[d] - 2 * lo;
            e[d] = lo + r % n;
            r /= n;
        }
    }
}

__device__ __forceinline__ int nd_rows(const FieldNdParams& p, const NdTile& t, int shrink) {
    int n = 1;
#pragma unroll
    for (int d = 0; d < SQ_ND_MAXD - 1; ++d)
        if (d < p.nd - 1) n *= t.ext[d] - 2 * (p.th[d] ? shrink : 0);
    return n;
}

// One stencil application on the extended tile shrunk by `app` sites per side
// in every dim with a halo: sites of parity `par` (sum of global coordinates;
// every site when par < 0) take the EM update from `src`, the others copy it,
// into `dst`.  Statistics come from the owned sites only.
template <int ROUNDS>
__device__ void nd_sweep(const FieldNdParams& p, const NdTile& t, const float* src, float* dst,
                         float* zk, int app, int par, int noise, uint32_t k1, uint32_t step,
                         float namp, float dtau, bool observe, bool last, NdAcc& acc,
                         float* part) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int D = p.nd, L = D - 1;
    const int n_rows = nd_rows(p, t, app);
    const int xlo = p.th[L] ? app : 0, xhi = t.ext[L] - xlo;
    int cur = -1;       // dim-0 owned row whose slice sum this warp is adding up
    float racc = 0.0f;
    for (int r = warp; r < n_rows; r += ND_WARPS) {
        int e[SQ_ND_MAXD];
        nd_row(p, t, app, r, e);
        int base = 0, dn[SQ_ND_MAXD - 1], up[SQ_ND_MAXD - 1];
        uint32_t site = 0, gsum = 0;
        bool row_owned = true;
#pragma unroll
        for (int d = 0; d < SQ_ND_MAXD - 1; ++d) {
            if (d < L) {
                base += e[d] * t.es[d];
                const bool wrap = p.th[d] == 0;
                dn[d] = (wrap && e[d] == 0) ? (t.ext[d] - 1) * t.es[d] : -t.es[d];
                up[d] = (wrap && e[d] == t.ext[d] - 1) ? -(t.ext[d] - 1) * t.es[d] : t.es[d];
                const uint32_t g = (uint32_t)(p.gb[d] + t.o[d] + e[d]) % (uint32_t)p.G[d];
                site = site * (uint32_t)p.G[d] + g;
                gsum += g;
                row_owned = row_owned && e[d] >= p.th[d] && e[d] < p.th[d] + p.T[d];
            }
        }
        if (observe) {  // warp-uniform
            const int row0 = (e[0] >= p.th[0] && e[0] < p.th[0] + p.T[0]) ? e[0] - p.th[0] : -1;
            if (row0 != cur) {
                if (cur >= 0) {
                    const float s = warp_sum(racc);
                    if (lane == 0) part[cur * ND_WARPS + warp] = s;
                }
                cur = row0;
                racc = 0.0f;
            }
        }
        for (int x = xlo + lane; x < xhi; x += 32) {
            const int i = base + x;
            const bool wrap = p.th[L] == 0;
            const int xdn = (wrap && x == 0) ? t.ext[L] - 1 : x - 1;
            const int xup = (wrap && x == t.ext[L] - 1) ? 0 : x + 1;
            const uint32_t g = (uint32_t)(p.gb[L] + t.o[L] + x) % (uint32_t)p.G[L];
            const bool owned = row_owned && x >= p.th[L] && x < p.th[L] + p.T[L];
            const bool update = par < 0 || (int)((gsum + g) & 1u) == par;
            const bool obs = observe && owned;
            const float f = src[i];
            float newf = f;
            if (update || obs) {
                float lap = 0.0f, kin = 0.0f;
#pragma unroll
                for (int d = 0; d < SQ_ND_MAXD - 1; ++d) {
                    if (d < L) {
                        const float fdn = src[i + dn[d]], fup = src[i + up[d]];
                        lap = lap + (fdn + fup - 2.0f * f);
                        const float diff = fup - f;
                        kin = kin + 0.5f * diff * diff * p.f.inv_a2;
                    }
                }
                {
                    const float fdn = src[base + xdn], fup = src[base + xup];
                    lap = lap + (fdn + fup - 2.0f * f);
                    const float diff = fup - f;
                    kin = kin + 0.5f * diff * diff * p.f.inv_a2;
                }
                lap = lap * p.f.inv_a2;
                if (obs) {
                    acc.s0 += f;
                    acc.s1 += f * f;
                    acc.s2 += kin + field_V(p.f, f);
                    racc += f;
                }
                if (update) {
                    float eta;
                    if (noise == ND_KEPT) {
                        eta = zk[i];
                    } else {
                        float z1;
                        normal_pair<ROUNDS>(p.f.seed, k1, site * (uint32_t)p.G[L] + g, step, eta,
                                            z1);
                        zk[i] = z1;
                    }
                    float absdet;
                    bool finite;
                    newf = em_update(p.f, f, lap, namp * eta, dtau, absdet, finite);
                    if (owned) acc.mdet = max_nan(acc.mdet, absdet);
                }
            }
            dst[i] = newf;
            if (last && owned) acc.mnew = max_nan(acc.mnew, fabsf(newf));
        }
    }
    if (observe && cur >= 0) {
        const float s = warp_sum(racc);
        if (lane == 0) part[cur * ND_WARPS + warp] = s;
    }
}

// Block totals of a micro-step's statistics in a fixed order, written by
// thread 0; the barrier inside also publishes the sweep's field and `part`.
__device__ void nd_publish(NdAcc a, float* red, float* __restrict__ stats) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        a.s0 += __shfl_xor_sync(0xffffffffu, a.s0, off);
        a.s1 += __shfl_xor_sync(0xffffffffu, a.s1, off);
        a.s2 += __shfl_xor_sync(0xffffffffu, a.s2, off);
        a.mdet = max_nan(a.mdet, __shfl_xor_sync(0xffffffffu, a.mdet, off));
        a.mnew = max_nan(a.mnew, __shfl_xor_sync(0xffffffffu, a.mnew, off));
    }
    if ((threadIdx.x & 31) == 0) {
        float* w = red + 5 * (threadIdx.x >> 5);
        w[0] = a.s0;
        w[1] = a.s1;
        w[2] = a.s2;
        w[3] = a.mdet;
        w[4] = a.mnew;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        NdAcc t = {red[0], red[1], red[2], red[3], red[4]};
        for (int w = 1; w < ND_WARPS; ++w) {
            const float* v = red + 5 * w;
            t.s0 = t.s0 + v[0];
            t.s1 = t.s1 + v[1];
            t.s2 = t.s2 + v[2];
            t.mdet = max_nan(t.mdet, v[3]);
            t.mnew = max_nan(t.mnew, v[4]);
        }
        stats[0] = t.s0;
        stats[1] = t.s1;
        stats[2] = t.s2;
        stats[3] = t.mdet;
        stats[4] = t.mnew;
    }
}

// Kernel 8's load of the extended tile: the input array of kernel 7 (owned
// rows plus H = (A[0] - loc[0]) / 2 halo rows a side in dim 0, dims >= 1
// whole) stands for three unextended slabs of loc[0] rows: array rows 0 .. H-1
// are the left slab's last H rows, rows H + loc[0] .. the right slab's first
// H, the others the own slab's.  H <= loc[0] (one hop).
__device__ void nd_load_slabs(const FieldNdParams& p, const NdTile& t, int ch,
                              const float* __restrict__ own, const float* __restrict__ left,
                              const float* __restrict__ right, float* X) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int D = p.nd, L = D - 1;
    const int H = (p.A[0] - p.loc[0]) / 2;
    size_t svol = (size_t)p.loc[0];
#pragma unroll
    for (int d = 1; d < SQ_ND_MAXD; ++d)
        if (d < D) svol *= (size_t)p.A[d];
    const int n_rows = nd_rows(p, t, 0);
    for (int r = warp; r < n_rows; r += ND_WARPS) {
        int e[SQ_ND_MAXD];
        nd_row(p, t, 0, r, e);
        const int q = (p.ab[0] + t.o[0] + e[0]) % p.A[0] - H;  // own-slab row, -H <= q < loc + H
        const float* src = q < 0 ? left : (q >= p.loc[0] ? right : own);
        size_t a = (size_t)(q < 0 ? q + p.loc[0] : (q >= p.loc[0] ? q - p.loc[0] : q));
        int base = e[0] * t.es[0];
#pragma unroll
        for (int d = 1; d < SQ_ND_MAXD - 1; ++d) {
            if (d < L) {
                base += e[d] * t.es[d];
                a = a * (size_t)p.A[d] + (size_t)((p.ab[d] + t.o[d] + e[d]) % p.A[d]);
            }
        }
        src += (size_t)ch * svol;
        for (int x = lane; x < t.ext[L]; x += 32)
            X[base + x] = src[a * (size_t)p.A[L] + (size_t)((p.ab[L] + t.o[L] + x) % p.A[L])];
    }
}

// The whole launch of one block: load the extended tile (from one array, or
// with SLABS from kernel 8's three slabs), n_steps micro-steps, store the
// owned tile.
template <int ROUNDS, bool SLABS = false>
__device__ void nd_block(const FieldNdParams& p, const float* __restrict__ in,
                         const float* __restrict__ dtau_in, float* __restrict__ out,
                         float* __restrict__ slp, float* __restrict__ stats_all, float* xbuf,
                         float* ybuf, float* zbuf, const float* __restrict__ left = nullptr,
                         const float* __restrict__ right = nullptr) {
    extern __shared__ float smem[];
    float* red = smem;                 // 5 * ND_WARPS
    float* part = smem + 5 * ND_WARPS;  // T[0] * ND_WARPS
    const int ch = blockIdx.y, tile = blockIdx.x;
    const int D = p.nd, L = D - 1;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

    NdTile t;
    {
        int rest = tile, stride = 1;
#pragma unroll
        for (int d = SQ_ND_MAXD - 1; d >= 0; --d) {
            if (d < D) {
                t.o[d] = (rest % p.nt[d]) * p.T[d];
                rest /= p.nt[d];
                t.ext[d] = p.T[d] + 2 * p.th[d];
                t.es[d] = stride;
                stride *= t.ext[d];
            }
        }
        t.inner = tile % p.n_inner;
    }
    const size_t blk = (size_t)ch * p.n_blocks + tile;
    float* X = xbuf + blk * (size_t)p.ext_sites;
    float* Y = ybuf + blk * (size_t)p.ext_sites;
    float* zk = zbuf + blk * (size_t)p.ext_sites;

    // load the extended tile, wrapping around the input array
    if constexpr (SLABS)
        nd_load_slabs(p, t, ch, in, left, right, X);
    else
    {
        size_t avol = 1;
#pragma unroll
        for (int d = 0; d < SQ_ND_MAXD; ++d)
            if (d < D) avol *= (size_t)p.A[d];
        const float* src = in + (size_t)ch * avol;
        const int n_rows = nd_rows(p, t, 0);
        for (int r = warp; r < n_rows; r += ND_WARPS) {
            int e[SQ_ND_MAXD];
            nd_row(p, t, 0, r, e);
            int base = 0;
            size_t a = 0;
#pragma unroll
            for (int d = 0; d < SQ_ND_MAXD - 1; ++d) {
                if (d < L) {
                    base += e[d] * t.es[d];
                    a = a * (size_t)p.A[d] + (size_t)((p.ab[d] + t.o[d] + e[d]) % p.A[d]);
                }
            }
            for (int x = lane; x < t.ext[L]; x += 32)
                X[base + x] = src[a * (size_t)p.A[L] + (size_t)((p.ab[L] + t.o[L] + x) % p.A[L])];
        }
    }

    const float dtau = dtau_in[ch];
    const float namp = p.f.c_amp * sqrtf(2.0f * dtau / p.f.measure);
    const uint32_t k1 = (uint32_t)STREAM_FIELD ^ ((p.f.chain0 + (uint32_t)ch) << 8);
    float* stats = stats_all + blk * (size_t)(5 * p.n_steps);
    float* cur = X;
    float* oth = Y;
    int app = 0;
    for (int w = 0; w < p.n_steps; ++w) {
        const uint32_t step = p.f.step0 + (uint32_t)(w & ~1);
        const int noise = (w & 1) ? ND_KEPT : ND_DRAW_KEEP;
        NdAcc acc = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
        for (int i = threadIdx.x; i < p.T[0] * ND_WARPS; i += ND_THREADS) part[i] = 0.0f;
        __syncthreads();  // the field of the step before (or the load) and the cleared sums
        if (p.f.checkerboard) {
            nd_sweep<ROUNDS>(p, t, cur, oth, zk, ++app, 0, noise, k1, step, namp, dtau, true,
                             false, acc, part);
            __syncthreads();
            nd_sweep<ROUNDS>(p, t, oth, cur, zk, ++app, 1, noise, k1, step, namp, dtau, false,
                             true, acc, part);
        } else {
            nd_sweep<ROUNDS>(p, t, cur, oth, zk, ++app, -1, noise, k1, step, namp, dtau, true,
                             true, acc, part);
            float* s = cur;
            cur = oth;
            oth = s;
        }
        nd_publish(acc, red, stats + 5 * w);
        for (int r0 = threadIdx.x; r0 < p.T[0]; r0 += ND_THREADS) {
            float s = part[r0 * ND_WARPS];
            for (int k = 1; k < ND_WARPS; ++k) s = s + part[r0 * ND_WARPS + k];
            const size_t row = (size_t)(t.o[0] + r0);
            slp[(((size_t)ch * p.n_steps + w) * p.loc[0] + row) * p.n_inner + t.inner] = s;
        }
        __syncthreads();  // red and part are free again
    }

    // store the owned tile
    {
        size_t lvol = 1;
#pragma unroll
        for (int d = 0; d < SQ_ND_MAXD; ++d)
            if (d < D) lvol *= (size_t)p.loc[d];
        float* dst = out + (size_t)ch * lvol;
        int n_rows = 1;
#pragma unroll
        for (int d = 0; d < SQ_ND_MAXD - 1; ++d)
            if (d < L) n_rows *= p.T[d];
        for (int r = warp; r < n_rows; r += ND_WARPS) {
            int rest = r, base = 0;
            size_t a = 0, astride = (size_t)p.loc[L];
#pragma unroll
            for (int d = SQ_ND_MAXD - 2; d >= 0; --d) {
                if (d < L) {
                    const int c = rest % p.T[d];
                    rest /= p.T[d];
                    base += (c + p.th[d]) * t.es[d];
                    a += (size_t)(t.o[d] + c) * astride;
                    astride *= (size_t)p.loc[d];
                }
            }
            for (int x = lane; x < p.T[L]; x += 32)
                dst[a + (size_t)(t.o[L] + x)] = cur[base + p.th[L] + x];
        }
    }
}

// Kernel 6: the input is the periodic lattice itself (A = G, no array halo).
template <int ROUNDS>
__global__ void __launch_bounds__(ND_THREADS)
field_pair_nd_kernel(FieldNdParams p, const float* __restrict__ phi_in,
                     const float* __restrict__ dtau_in, float* __restrict__ phi_out,
                     float* __restrict__ slp, float* __restrict__ stats, float* xbuf, float* ybuf,
                     float* zbuf) {
    nd_block<ROUNDS>(p, phi_in, dtau_in, phi_out, slp, stats, xbuf, ybuf, zbuf);
}

// Kernel 7: the input is the owned block extended by its array halos.
template <int ROUNDS>
__global__ void __launch_bounds__(ND_THREADS)
field_chunk_nd_kernel(FieldNdParams p, const float* __restrict__ ext_in,
                      const float* __restrict__ dtau_in, float* __restrict__ phi_out,
                      float* __restrict__ slp, float* __restrict__ stats, float* xbuf, float* ybuf,
                      float* zbuf) {
    nd_block<ROUNDS>(p, ext_in, dtau_in, phi_out, slp, stats, xbuf, ybuf, zbuf);
}

// Kernel 8: the input is three unextended dim-0 slabs, the block's own and
// its dim-0 ring neighbours' (all three the same slab on a ring of one).
template <int ROUNDS>
__global__ void __launch_bounds__(ND_THREADS)
field_chunk_rdma_nd_kernel(FieldNdParams p, const float* __restrict__ phi_in,
                           const float* __restrict__ left, const float* __restrict__ right,
                           const float* __restrict__ dtau_in, float* __restrict__ phi_out,
                           float* __restrict__ slp, float* __restrict__ stats, float* xbuf,
                           float* ybuf, float* zbuf) {
    nd_block<ROUNDS, true>(p, phi_in, dtau_in, phi_out, slp, stats, xbuf, ybuf, zbuf, left, right);
}

// ---- C entry points (loaded with ctypes) -----------------------------------

// What each entry takes: kernel 6's pair (D >= 3) and its one-step tail (D >= 2)
// on the periodic lattice, kernel 7's W steps on an extended array, kernel
// 8's on three slabs (one hop: 1 <= H <= loc[0], dims >= 1 whole).
enum NdEntry { ND_PAIR, ND_STEP, ND_CHUNK, ND_SLABS };

static bool nd_params_ok(const FieldNdParams* p, NdEntry entry) {
    const FieldParams& f = p->f;
    const bool lattice = entry == ND_PAIR || entry == ND_STEP;
    const bool steps_ok = entry == ND_PAIR   ? p->n_steps == 2 && p->nd >= 3
                          : entry == ND_STEP ? p->n_steps == 1
                                             : p->n_steps >= 2 && p->n_steps % 2 == 0;
    bool ok = f.n_chains > 0 && f.n_chains <= 65535 && p->nd >= 2 && p->nd <= SQ_ND_MAXD &&
              (f.rounds == 20 || f.rounds == 13) &&
              (f.action == ACTION_PHI4 || f.action == ACTION_FREE) && steps_ok &&
              p->depth == p->n_steps * (f.checkerboard ? 2 : 1) && p->n_blocks >= 1 &&
              p->n_inner >= 1;
    long long blocks = 1, ext = 1, sites = 1;
    for (int d = 0; ok && d < p->nd; ++d) {
        ok = p->G[d] >= 1 && p->loc[d] >= 1 && p->loc[d] <= p->G[d] && p->A[d] >= p->loc[d] &&
             p->T[d] >= 1 && p->loc[d] % p->T[d] == 0 && p->nt[d] == p->loc[d] / p->T[d] &&
             (p->th[d] == p->depth || (p->th[d] == 0 && p->T[d] == p->G[d] && p->A[d] == p->G[d])) &&
             p->ab[d] >= 0 && p->ab[d] < p->A[d] && p->gb[d] >= 0 && p->gb[d] < p->G[d] &&
             (!lattice || p->A[d] == p->G[d]) &&
             (entry != ND_SLABS || d == 0 || (p->A[d] == p->loc[d] && p->loc[d] == p->G[d]));
        blocks *= p->nt[d];
        ext *= p->T[d] + 2 * p->th[d];
        sites *= p->G[d];
    }
    if (ok && entry == ND_SLABS) {
        const int H = (p->A[0] - p->loc[0]) / 2;
        ok = p->A[0] == p->loc[0] + 2 * H && H >= 1 && H <= p->loc[0] && p->th[0] == H &&
             p->ab[0] == 0;
    }
    return ok && blocks == p->n_blocks && ext == p->ext_sites && ext < (1LL << 31) &&
           sites <= (1LL << 32) && p->n_blocks % p->nt[0] == 0 &&
           p->n_inner == p->n_blocks / p->nt[0];
}

template <typename K, typename... In>
static int nd_launch(K kernel, const FieldNdParams* p, void* stream, In... in) {
    const size_t smem = (size_t)(5 + p->T[0]) * ND_WARPS * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(p->n_blocks, p->f.n_chains);
    kernel<<<grid, ND_THREADS, smem, (cudaStream_t)stream>>>(*p, in...);
    return (int)cudaGetLastError();
}

extern "C" int sq_field_pair_nd(const FieldNdParams* p, const float* phi_in, const float* dtau_in,
                                float* phi_out, float* slp, float* stats, float* xbuf,
                                float* ybuf, float* zbuf, void* stream) {
    if (!nd_params_ok(p, ND_PAIR)) return (int)cudaErrorInvalidValue;
    if (p->f.rounds == 20)
        return nd_launch(field_pair_nd_kernel<20>, p, stream, phi_in, dtau_in, phi_out, slp, stats,
                         xbuf, ybuf, zbuf);
    return nd_launch(field_pair_nd_kernel<13>, p, stream, phi_in, dtau_in, phi_out, slp, stats,
                     xbuf, ybuf, zbuf);
}

// The one-step tail: kernel 6's own code (the same __global__) at n_steps = 1.
extern "C" int sq_field_step_nd(const FieldNdParams* p, const float* phi_in, const float* dtau_in,
                                float* phi_out, float* slp, float* stats, float* xbuf,
                                float* ybuf, float* zbuf, void* stream) {
    if (!nd_params_ok(p, ND_STEP)) return (int)cudaErrorInvalidValue;
    if (p->f.rounds == 20)
        return nd_launch(field_pair_nd_kernel<20>, p, stream, phi_in, dtau_in, phi_out, slp, stats,
                         xbuf, ybuf, zbuf);
    return nd_launch(field_pair_nd_kernel<13>, p, stream, phi_in, dtau_in, phi_out, slp, stats,
                     xbuf, ybuf, zbuf);
}

extern "C" int sq_field_chunk_nd(const FieldNdParams* p, const float* ext_in,
                                 const float* dtau_in, float* phi_out, float* slp, float* stats,
                                 float* xbuf, float* ybuf, float* zbuf, void* stream) {
    if (!nd_params_ok(p, ND_CHUNK)) return (int)cudaErrorInvalidValue;
    if (p->f.rounds == 20)
        return nd_launch(field_chunk_nd_kernel<20>, p, stream, ext_in, dtau_in, phi_out, slp,
                         stats, xbuf, ybuf, zbuf);
    return nd_launch(field_chunk_nd_kernel<13>, p, stream, ext_in, dtau_in, phi_out, slp, stats,
                     xbuf, ybuf, zbuf);
}

extern "C" int sq_field_chunk_rdma_nd(const FieldNdParams* p, const float* phi_in,
                                      const float* left, const float* right,
                                      const float* dtau_in, float* phi_out, float* slp,
                                      float* stats, float* xbuf, float* ybuf, float* zbuf,
                                      void* stream) {
    if (!nd_params_ok(p, ND_SLABS)) return (int)cudaErrorInvalidValue;
    if (p->f.rounds == 20)
        return nd_launch(field_chunk_rdma_nd_kernel<20>, p, stream, phi_in, left, right, dtau_in,
                         phi_out, slp, stats, xbuf, ybuf, zbuf);
    return nd_launch(field_chunk_rdma_nd_kernel<13>, p, stream, phi_in, left, right, dtau_in,
                     phi_out, slp, stats, xbuf, ybuf, zbuf);
}

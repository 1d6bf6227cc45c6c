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
// What bounds it on the card: per site and pair one Threefry evaluation and
// Box-Muller (135 integer and float operations at 20 rounds, a transcendental
// counted as one) and two updates with their statistics of 9 D + 30 each,
// against one read and one write of the field: operations, not bytes (at
// 32^4 267 operations per site and pair against 8 bytes).  A micro-step is a
// chain of dependent latency per site (the Threefry rounds, logf / sincosf),
// so what the card reaches depends on how many warps hide it.
//
// Design: one body for all four entries, one persistent cooperative launch.
// The launch's DOMAIN is the array it reads: the periodic lattice (kernel 6
// and the tail), the owned block extended by its array halos (kernel 7:
// geo.array), or that array made of three slabs (kernel 8).  The domain is
// cut into disjoint tiles aligned to the owned block's origin, so a tile lies
// wholly inside the owned block (a statistics block: geo.blocks) or wholly
// inside a halo; a work item is one (chain, tile).  Stencil application s
// (1 ... depth: one per synchronous sweep, two per checkerboard step)
// updates the domain shrunk by s sites in every dim that carries an array
// halo, as the TPU kernel does at strip level, so the only sites computed
// twice on the card are the shard's exchange halo; with no array halo (kernel
// 6) nothing is.  Between two applications stands cooperative_groups'
// grid.sync(): the grid is sized from cudaOccupancyMaxActiveBlocksPerMultiprocessor
// times the SMs (never more blocks than items), launched through
// cudaLaunchKernelEx with cudaLaunchAttributeCooperative, and its blocks
// stride over the items; a refused launch returns its error, there is no
// other body.  grid.sync() needs no relocatable device code (-rdc) since
// CUDA 11: this source builds with the common flags of _build.py.
//
// Why the per-tile trapezoid went: before, a block recomputed a depth-deep
// halo around its tile in every dim the tile cut (15x the lattice at the
// first application at 32^4 x 1, W = 4, tiles 2 x 4) and kept its extended
// tile in a per-block scratch of C * n_blocks * ext_sites floats (180 MiB
// there), far beyond the 50 MB L2.  Now the field lives in two ping-pong
// buffers of the domain and the kept second Box-Muller output in a third
// (C * prod(domain) floats each, 15 MiB at 32^4 x 1, W = 4): application s
// reads buffer (s - 1) & 1 (the input at s = 1) and writes buffer s & 1, the
// last one the owned block of the output.  Each item of an application is
// staged with a one-site neighbour layer (none in a dim the tile spans
// periodically: the box wraps) in shared memory, so the stencil reads come
// from shared memory.  The kept noise stays in device memory: a thread's
// sites change with the item it strides to, and at 32^4 x 8 a thread owns
// ~40 sites of a pair, more than registers hold.
//
// Indexing: D is a template parameter (2 ... 5), so every dim loop unrolls;
// strides, tile counts and wraps come from the host.  At D >= 3 a thread
// walks an item's sites in C order with a mixed-radix counter that adds the
// thread count (one compare-and-select carry per dim, no % or / per site); at
// D = 2 the rule keeps a tile's rows whole (the rows of 256^2 shards) and the
// warps take rows, their lanes along them, a row's offsets computed once.
// Either way a thread takes two sites per iteration and computes both without
// branches on the data (the update selected, not branched to), with the noise
// step (draw or read the kept one) a template parameter, so that the two
// sites' Threefry chains interleave: a site's micro-step is a chain of
// dependent latency, and what is left is bound by instructions issued.
// Global coordinates wrap by compare-and-select; offsets are 32-bit within a
// chain.

// Statistics: per item and micro-step over its owned sites, [sum phi, sum
// phi^2, sum s, max|det|, max|phi_new|] into stats[chain, block, 5 w ...] (a
// statistics block is one owned item); lanes by xor-shuffle, then warp 0
// shuffles the warps' partials: a fixed order, the maxima NaN-propagating as
// torch.amax.  The dim-0 slice sums of the pre-update field come from the
// staged box, a warp a row (lanes in order, then a shuffle), into
// slp[chain, step, row, tile index over dims >= 1], summed over the last axis
// by the wrapper.  Like the TPU kernels, a tripped chain is not frozen
// mid-frame; the frame rollback discards it.

#include <cooperative_groups.h>

#include <mutex>

#include "field_common.cuh"

namespace cg = cooperative_groups;

#define SQ_ND_MAXD 5
#define ND_THREADS 256
#define ND_WARPS (ND_THREADS / 32)

// Mirrors FieldNdParams in stochquant_tpu_torch/kernels/_build.py (all 4-byte
// fields).  f.L0, f.L1 and the tile fields of f are not read here.
struct FieldNdParams {
    FieldParams f;
    int32_t nd;         // lattice dims D
    int32_t n_steps;    // micro-steps per launch: 2 (kernel 6), 1 (its odd tail) or W (7, 8)
    int32_t depth;      // stencil applications per launch
    int32_t n_blocks;   // owned tiles per chain: the statistics blocks
    int32_t n_inner;    // owned tiles per chain that share one dim-0 tile index
    int32_t n_items;    // domain tiles per chain: the work items
    int32_t box;        // floats of the largest staged box (a tile and its layer)
    int32_t avol;       // sites of the domain, per chain
    int32_t lvol;       // sites of the owned block, per chain
    int32_t G[SQ_ND_MAXD];     // global lattice extents
    int32_t A[SQ_ND_MAXD];     // domain extents: owned + 2 h
    int32_t loc[SQ_ND_MAXD];   // owned extents (the output)
    int32_t h[SQ_ND_MAXD];     // array halo per side (0: the dim is whole and periodic)
    int32_t gb[SQ_ND_MAXD];    // global coordinate of domain coordinate 0
    int32_t T[SQ_ND_MAXD];     // tile extents
    int32_t nl[SQ_ND_MAXD];    // domain tiles before the owned block: ceil(h / T)
    int32_t ndt[SQ_ND_MAXD];   // domain tiles: loc / T + 2 nl
    int32_t wrap[SQ_ND_MAXD];  // 1: a tile spans the periodic dim, its box wraps (no layer)
    int32_t as[SQ_ND_MAXD];    // C-order strides of the domain
    int32_t ls[SQ_ND_MAXD];    // of the owned block
    uint32_t gs[SQ_ND_MAXD];   // of the global lattice (site ids)
};

// torch.amax / torch.maximum keep a NaN; fmaxf drops it.
__device__ __forceinline__ float max_nan(float a, float b) {
    return (a != a || b != b) ? NAN : fmaxf(a, b);
}

struct NdAcc {
    float s0, s1, s2, mdet, mnew;
};

// A thread's place in a box walked STEP sites at a time, C order: a
// mixed-radix counter that adds STEP with one carry per dim.
template <int D, int STEP = ND_THREADS>
struct NdWalk {
    int c[D], inc[D];
    __device__ __forceinline__ void start(int first, const int (&ext)[D]) {
        int a = first, b = STEP;
#pragma unroll
        for (int d = D - 1; d > 0; --d) {
            c[d] = a % ext[d];
            a /= ext[d];
            inc[d] = b % ext[d];
            b /= ext[d];
        }
        c[0] = a;
        inc[0] = b;
    }
    __device__ __forceinline__ void next(const int (&ext)[D]) {
        int carry = 0;
#pragma unroll
        for (int d = D - 1; d > 0; --d) {
            const int v = c[d] + inc[d] + carry;
            carry = v >= ext[d];
            c[d] = carry ? v - ext[d] : v;
        }
        c[0] += inc[0] + carry;
    }
};

// One item of application s: where its sites lie in the domain (clipped to
// the domain shrunk by s in every dim with an array halo) and in the staged box.
template <int D>
struct NdItem {
    int chain;
    int lo[D], E[D];    // first domain coordinate and extent of the updated sites
    int lay[D];         // neighbour layer per side in the box: 0 (wraps) or 1
    int bx[D], bs[D];   // box extents and C-order strides
    int g0[D];          // global coordinate of lo
    int nbox, nsites;
    bool owned;         // inside the owned block (a statistics block)
    int blk, inner, row0;
};

template <int D>
__device__ __forceinline__ bool nd_item(const FieldNdParams& p, int item, int s, NdItem<D>& it) {
    it.chain = item / p.n_items;
    int rest = item - it.chain * p.n_items;
    int j[D];
#pragma unroll
    for (int d = D - 1; d >= 0; --d) {
        j[d] = rest % p.ndt[d];
        rest /= p.ndt[d];
    }
    it.owned = true;
    it.blk = 0;
    it.inner = 0;
    bool live = true;
#pragma unroll
    for (int d = 0; d < D; ++d) {
        const int k = j[d] - p.nl[d], nt = p.loc[d] / p.T[d];
        const int shr = p.h[d] ? s : 0;
        const int lo = max(p.h[d] + k * p.T[d], shr);
        const int hi = min(p.h[d] + (k + 1) * p.T[d], p.A[d] - shr);
        live = live && hi > lo;
        it.lo[d] = lo;
        it.E[d] = hi - lo;
        it.lay[d] = p.wrap[d] ? 0 : 1;
        it.bx[d] = it.E[d] + 2 * it.lay[d];
        int g = p.gb[d] + lo;  // < 4 G: the domain is shorter than 3 G
        g = g >= p.G[d] ? g - p.G[d] : g;
        g = g >= p.G[d] ? g - p.G[d] : g;
        it.g0[d] = g >= p.G[d] ? g - p.G[d] : g;
        it.owned = it.owned && k >= 0 && k < nt;
        it.blk = it.blk * nt + k;
        if (d > 0) it.inner = it.inner * nt + k;
    }
    if (!live) return false;
    it.row0 = it.lo[0] - p.h[0];
    int sb = 1, se = 1;
#pragma unroll
    for (int d = D - 1; d >= 0; --d) {
        it.bs[d] = sb;
        sb *= it.bx[d];
        se *= it.E[d];
    }
    it.nbox = sb;
    it.nsites = se;
    return true;
}

// The rows of a box (every dim but the last), walked ND_WARPS at a time: a
// warp a row, its lanes along the last dim.
template <int D>
__device__ __forceinline__ int nd_rows(const int (&ext)[D], int (&rext)[D > 1 ? D - 1 : 1]) {
    int n = 1;
#pragma unroll
    for (int d = 0; d < D - 1; ++d) {
        rext[d] = ext[d];
        n *= ext[d];
    }
    return n;
}

// Stage the item's box: its sites and their neighbour layer, from the domain
// array `src` or, with SLABS at the first application, from kernel 8's three
// slabs (domain rows 0 .. H-1 are the left slab's last H rows, rows H +
// loc[0] .. the right slab's first H, the others the own slab's).
template <int D, bool SLABS>
__device__ __forceinline__ void nd_stage(const FieldNdParams& p, const NdItem<D>& it,
                                         const float* __restrict__ src,
                                         const float* __restrict__ left,
                                         const float* __restrict__ right, float* box) {
    constexpr int L = D - 1;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int H = p.h[0], L0 = p.loc[0];
    if constexpr (D == 2) {  // a warp a row of the box, its lanes along the row
        int rext[1];
        const int rows = nd_rows<D>(it.bx, rext);
        for (int r = warp; r < rows; r += ND_WARPS) {
            int v = it.lo[0] + r - it.lay[0];
            v = v < 0 ? v + p.A[0] : (v >= p.A[0] ? v - p.A[0] : v);
            const float* from = src;
            int a = v * p.as[0];
            if (SLABS) {
                const int q = v - H;
                from = q < 0 ? left : (q >= L0 ? right : src);
                a = (q < 0 ? q + L0 : (q >= L0 ? q - L0 : q)) * p.ls[0];
            }
            from += (size_t)it.chain * (SLABS ? p.lvol : p.avol) + a;
            for (int j = lane; j < it.bx[L]; j += 32) {
                int u = it.lo[L] + j - it.lay[L];
                u = u < 0 ? u + p.A[L] : (u >= p.A[L] ? u - p.A[L] : u);
                box[r * it.bs[0] + j] = from[u];
            }
        }
    } else {  // the box in C order, a thread every ND_THREADS-th site
        NdWalk<D> w;
        w.start(threadIdx.x, it.bx);
        for (int f = threadIdx.x; f < it.nbox; f += ND_THREADS) {
            int x[D];
#pragma unroll
            for (int d = 0; d < D; ++d) {
                int v = it.lo[d] + w.c[d] - it.lay[d];
                v = v < 0 ? v + p.A[d] : (v >= p.A[d] ? v - p.A[d] : v);
                x[d] = v;
            }
            if constexpr (SLABS) {
                const int q = x[0] - H;
                const float* slab = q < 0 ? left : (q >= L0 ? right : src);
                int a = (q < 0 ? q + L0 : (q >= L0 ? q - L0 : q)) * p.ls[0];
#pragma unroll
                for (int d = 1; d < D; ++d) a += x[d] * p.ls[d];
                box[f] = slab[(size_t)it.chain * p.lvol + a];
            } else {
                int a = 0;
#pragma unroll
                for (int d = 0; d < D; ++d) a += x[d] * p.as[d];
                box[f] = src[(size_t)it.chain * p.avol + a];
            }
            w.next(it.bx);
        }
    }
}

// Fixed-order block totals of the partials: xor-shuffle in each warp, then
// warp 0 shuffles the ND_WARPS warp partials.  Valid in thread 0.
__device__ __forceinline__ NdAcc nd_reduce(NdAcc a, float* red) {
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
    NdAcc t = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    if (warp == 0) {
        if (lane < ND_WARPS) {
            const float* v = red + 5 * lane;
            t = {v[0], v[1], v[2], v[3], v[4]};
        }
#pragma unroll
        for (int off = ND_WARPS / 2; off > 0; off >>= 1) {
            t.s0 += __shfl_xor_sync(0xffffffffu, t.s0, off);
            t.s1 += __shfl_xor_sync(0xffffffffu, t.s1, off);
            t.s2 += __shfl_xor_sync(0xffffffffu, t.s2, off);
            t.mdet = max_nan(t.mdet, __shfl_xor_sync(0xffffffffu, t.mdet, off));
            t.mnew = max_nan(t.mnew, __shfl_xor_sync(0xffffffffu, t.mnew, off));
        }
    }
    return t;
}

// The dim-0 slice sums of the staged (pre-update) sites of an owned item: a
// warp a row, lanes over the row's sites in order, then a shuffle.
template <int D>
__device__ __forceinline__ void nd_slices(const FieldNdParams& p, const NdItem<D>& it,
                                          const float* box, float* __restrict__ slp, int w) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int row_sites = it.nsites / it.E[0];
    int rext[D];
    rext[0] = 1;
#pragma unroll
    for (int d = 1; d < D; ++d) rext[d] = it.E[d];
    for (int r = warp; r < it.E[0]; r += ND_WARPS) {
        float sum = 0.0f;
        NdWalk<D, 32> wk;
        wk.start(lane, rext);
        for (int f = lane; f < row_sites; f += 32) {
            int bi = (r + it.lay[0]) * it.bs[0];
#pragma unroll
            for (int d = 1; d < D; ++d) bi += (wk.c[d] + it.lay[d]) * it.bs[d];
            sum += box[bi];
            wk.next(rext);
        }
        sum = warp_sum(sum);
        if (lane == 0)
            slp[(((size_t)it.chain * p.n_steps + w) * p.loc[0] + it.row0 + r) * p.n_inner +
                it.inner] = sum;
    }
}

// What a row of an item shares (every dim but the last): its offsets in the
// box, the domain and the owned block, its part of the site id and parity,
// and its neighbours' offsets in the box.
template <int D>
struct NdRow {
    int bi, di, oi;
    uint32_t site, gsum;
    int dn[D > 1 ? D - 1 : 1], up[D > 1 ? D - 1 : 1];
};

template <int D>
__device__ __forceinline__ NdRow<D> nd_row(const FieldNdParams& p, const NdItem<D>& it,
                                           const int* c) {
    NdRow<D> r;
    r.bi = it.lay[D - 1];
    r.di = it.lo[D - 1];
    r.oi = it.lo[D - 1] - p.h[D - 1];
    r.site = 0;
    r.gsum = 0;
#pragma unroll
    for (int d = 0; d < D - 1; ++d) {
        const int x = it.lo[d] + c[d];
        r.bi += (c[d] + it.lay[d]) * it.bs[d];
        r.di += x * p.as[d];
        r.oi += (x - p.h[d]) * p.ls[d];
        int g = it.g0[d] + c[d];
        g = g >= p.G[d] ? g - p.G[d] : g;
        r.site += (uint32_t)g * p.gs[d];
        r.gsum += (uint32_t)g;
        const int span = (it.E[d] - 1) * it.bs[d];
        r.dn[d] = (!it.lay[d] && c[d] == 0) ? span : -it.bs[d];
        r.up[d] = (!it.lay[d] && c[d] == it.E[d] - 1) ? -span : it.bs[d];
    }
    return r;
}

// One site, without branches on the data: the stencil, the noise and the
// update are computed for every site and `upd` / `valid` select what is
// stored and counted, so that the two sites a thread takes per iteration
// interleave (under the checkerboard the lanes of a warp alternate in
// parity, so the warp runs the update of every site in any case).  KEPT
// (the noise comes from the step before) is compile-time, so that the two
// sites' noise computations share one basic block.  The site sits at `bi` in the
// box, `di` in the domain, `oi` in the owned block, with global id `site`
// and coordinate sum `gsum`; its neighbours at bi + dn[d], bi + up[d].
template <int D, int ROUNDS, bool KEPT>
__device__ __forceinline__ void nd_apply(const FieldNdParams& p, const int (&dn)[D],
                                         const int (&up)[D], int bi, int di, int oi,
                                         uint32_t site, uint32_t gsum, bool valid, bool owned,
                                         const float* box, float* dst, bool to_out, size_t dbase,
                                         float* __restrict__ zk, size_t zbase, int par, bool keep,
                                         uint32_t k1, uint32_t step, float namp, float dtau,
                                         bool obs, bool last, NdAcc& acc) {
    const bool upd = valid && (par < 0 || (int)(gsum & 1u) == par);
    const float f0 = box[bi];
    float lap = 0.0f, kin = 0.0f;
#pragma unroll
    for (int d = 0; d < D; ++d) {
        const float fdn = box[bi + dn[d]], fup = box[bi + up[d]];
        lap = lap + (fdn + fup - 2.0f * f0);
        const float diff = fup - f0;
        kin = kin + 0.5f * diff * diff * p.f.inv_a2;
    }
    lap = lap * p.f.inv_a2;
    float eta, z1 = 0.0f;
    if (KEPT)
        eta = zk[zbase + di];
    else
        normal_pair<ROUNDS>(p.f.seed, k1, site, step, eta, z1);
    float absdet;
    bool finite;
    const float moved = em_update(p.f, f0, lap, namp * eta, dtau, absdet, finite);
    const float newf = upd ? moved : f0;
    if (valid) dst[dbase + (to_out ? oi : di)] = newf;
    if (!KEPT && upd && keep) zk[zbase + di] = z1;
    const bool own = valid && owned;
    if (own && obs) {
        acc.s0 += f0;
        acc.s1 += f0 * f0;
        acc.s2 += kin + field_V(p.f, f0);
    }
    if (own && upd) acc.mdet = max_nan(acc.mdet, absdet);
    if (own && last) acc.mnew = max_nan(acc.mnew, fabsf(newf));
}

// Site x of row `r` (the row's offsets computed once, the last dim's here).
template <int D, int ROUNDS, bool KEPT>
__device__ __forceinline__ void nd_site(const FieldNdParams& p, const NdItem<D>& it,
                                        const NdRow<D>& r, int x, bool valid, const float* box,
                                        float* dst, bool to_out, size_t dbase,
                                        float* __restrict__ zk, size_t zbase, int par, bool keep,
                                        uint32_t k1, uint32_t step, float namp, float dtau,
                                        bool obs, bool last, NdAcc& acc) {
    constexpr int L = D - 1;
    int g = it.g0[L] + x;
    g = g >= p.G[L] ? g - p.G[L] : g;
    int dn[D], up[D];
#pragma unroll
    for (int d = 0; d < L; ++d) {
        dn[d] = r.dn[d];
        up[d] = r.up[d];
    }
    const int span = it.E[L] - 1;
    dn[L] = (!it.lay[L] && x == 0) ? span : -1;
    up[L] = (!it.lay[L] && x == span) ? -span : 1;
    nd_apply<D, ROUNDS, KEPT>(p, dn, up, r.bi + x, r.di + x, r.oi + x,
                                     r.site + (uint32_t)g, r.gsum + (uint32_t)g, valid, it.owned,
                                     box, dst,
                                     to_out, dbase, zk, zbase, par, keep, k1, step, namp, dtau,
                                     obs, last, acc);
}

// The site at item coordinates c (every offset computed here).
template <int D, int ROUNDS, bool KEPT>
__device__ __forceinline__ void nd_point(const FieldNdParams& p, const NdItem<D>& it,
                                         const int (&c)[D], bool valid, const float* box,
                                         float* dst, bool to_out, size_t dbase,
                                         float* __restrict__ zk, size_t zbase, int par, bool keep,
                                         uint32_t k1, uint32_t step, float namp, float dtau,
                                         bool obs, bool last, NdAcc& acc) {
    int bi = 0, di = 0, oi = 0;
    uint32_t site = 0, gsum = 0;
    int dn[D], up[D];
#pragma unroll
    for (int d = 0; d < D; ++d) {
        const int x = it.lo[d] + c[d];
        bi += (c[d] + it.lay[d]) * it.bs[d];
        di += x * p.as[d];
        oi += (x - p.h[d]) * p.ls[d];
        int g = it.g0[d] + c[d];
        g = g >= p.G[d] ? g - p.G[d] : g;
        site += (uint32_t)g * p.gs[d];
        gsum += (uint32_t)g;
        const int span = (it.E[d] - 1) * it.bs[d];
        dn[d] = (!it.lay[d] && c[d] == 0) ? span : -it.bs[d];
        up[d] = (!it.lay[d] && c[d] == it.E[d] - 1) ? -span : it.bs[d];
    }
    nd_apply<D, ROUNDS, KEPT>(p, dn, up, bi, di, oi, site, gsum, valid, it.owned, box, dst, to_out,
                                     dbase, zk, zbase, par, keep, k1, step, namp, dtau, obs, last,
                                     acc);
}

// One stencil application on one item: sites of parity `par` (sum of global
// coordinates; every site when par < 0) take the EM update from the staged
// box, the others copy it, into `dst` (the next domain buffer, or the owned
// block of the output at the last application), two sites a thread per
// iteration.  At D = 2 the rows go to the warps, w, w + ND_WARPS, ..., a
// lane's two sites 32 apart along the row (a row's offsets computed once);
// at D >= 3 the sites are walked in C order, a thread's two sites ND_THREADS
// apart.  One mapping a D keeps the kernel's code, which inlines the noise
// for each of the two sites, small enough for the instruction cache.
template <int D, int ROUNDS, bool KEPT>
__device__ __forceinline__ void nd_sweep(const FieldNdParams& p, const NdItem<D>& it,
                                         const float* box, float* dst, bool to_out,
                                         float* __restrict__ zk, int par, bool keep, uint32_t k1,
                                         uint32_t step, float namp, float dtau, bool observe,
                                         bool last, NdAcc& acc) {
    constexpr int L = D - 1;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const size_t zbase = (size_t)it.chain * p.avol;
    const size_t dbase = (size_t)it.chain * (to_out ? p.lvol : p.avol);
    if constexpr (D == 2) {  // rows of the lattice's last dim: a lane's two sites 32 apart
        int rext[D > 1 ? D - 1 : 1];
        const int rows = nd_rows<D>(it.E, rext);
        NdWalk<L, ND_WARPS> w;
        w.start(warp, rext);
        for (int r = warp; r < rows; r += ND_WARPS) {
            const NdRow<D> a = nd_row<D>(p, it, w.c);
            w.next(rext);
            for (int x0 = 0; x0 < it.E[L]; x0 += 64) {
                const int x1 = x0 + lane, x2 = x1 + 32;
                const bool v1 = x1 < it.E[L], v2 = x2 < it.E[L];
                nd_site<D, ROUNDS, KEPT>(p, it, a, v1 ? x1 : 0, v1, box, dst, to_out, dbase, zk,
                                         zbase, par, keep, k1, step, namp, dtau, observe, last,
                                         acc);
                nd_site<D, ROUNDS, KEPT>(p, it, a, v2 ? x2 : 0, v2, box, dst, to_out, dbase, zk,
                                         zbase, par, keep, k1, step, namp, dtau, observe, last,
                                         acc);
            }
        }
    } else {  // the item's sites in C order, a thread's two ND_THREADS apart
        NdWalk<D> f;
        f.start(threadIdx.x, it.E);
        for (int i = threadIdx.x; i < it.nsites; i += 2 * ND_THREADS) {
            int first[D], second[D];
#pragma unroll
            for (int d = 0; d < D; ++d) first[d] = f.c[d];
            f.next(it.E);
            const bool two = i + ND_THREADS < it.nsites;
#pragma unroll
            for (int d = 0; d < D; ++d) second[d] = two ? f.c[d] : first[d];
            f.next(it.E);
            nd_point<D, ROUNDS, KEPT>(p, it, first, true, box, dst, to_out, dbase, zk, zbase,
                                      par, keep, k1, step, namp, dtau, observe, last, acc);
            nd_point<D, ROUNDS, KEPT>(p, it, second, two, box, dst, to_out, dbase, zk, zbase,
                                      par, keep, k1, step, namp, dtau, observe, last, acc);
        }
    }
}

// The whole launch: `depth` applications over every item, a grid barrier
// between two applications.
template <int D, int ROUNDS>
__global__ void __launch_bounds__(ND_THREADS)
field_nd_kernel(FieldNdParams p, const float* __restrict__ in, const float* __restrict__ left,
                const float* __restrict__ right, const float* __restrict__ dtau_in,
                float* __restrict__ out, float* __restrict__ slp, float* __restrict__ stats,
                float* buf0, float* buf1, float* __restrict__ zk) {
    extern __shared__ float box[];
    __shared__ float red[5 * ND_WARPS];
    cg::grid_group grid = cg::this_grid();
    const bool cb = p.f.checkerboard != 0;
    const int n_items = p.f.n_chains * p.n_items;
    for (int s = 1; s <= p.depth; ++s) {
        const int w = cb ? (s - 1) >> 1 : s - 1;
        const int half = cb ? (s - 1) & 1 : -1;
        const bool observe = half <= 0, last = half != 0;
        const bool kept = w & 1;  // the second micro-step of a pair
        const bool keep = w + 1 < p.n_steps;
        const uint32_t step = p.f.step0 + (uint32_t)(w & ~1);
        const float* src = s == 1 ? in : ((s - 1) & 1 ? buf1 : buf0);
        const bool to_out = s == p.depth;
        float* dst = to_out ? out : (s & 1 ? buf1 : buf0);
        for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
            NdItem<D> it;
            if (!nd_item<D>(p, item, s, it)) continue;  // block-uniform
            if (left && s == 1)  // kernel 8's first application reads its three slabs
                nd_stage<D, true>(p, it, in, left, right, box);
            else
                nd_stage<D, false>(p, it, src, nullptr, nullptr, box);
            __syncthreads();
            const float dtau = dtau_in[it.chain];
            const float namp = p.f.c_amp * sqrtf(2.0f * dtau / p.f.measure);
            const uint32_t k1 = (uint32_t)STREAM_FIELD ^ ((p.f.chain0 + (uint32_t)it.chain) << 8);
            NdAcc acc = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
            if (kept)  // block-uniform: the second micro-step of a pair reads its noise
                nd_sweep<D, ROUNDS, true>(p, it, box, dst, to_out, zk, half, keep, k1, step, namp,
                                          dtau, observe, last, acc);
            else
                nd_sweep<D, ROUNDS, false>(p, it, box, dst, to_out, zk, half, keep, k1, step,
                                           namp, dtau, observe, last, acc);
            if (it.owned) {  // block-uniform
                if (observe) nd_slices<D>(p, it, box, slp, w);
                const NdAcc t = nd_reduce(acc, red);
                if (threadIdx.x == 0) {
                    float* st = stats + ((size_t)it.chain * p.n_blocks + it.blk) * (5 * p.n_steps) +
                                5 * w;
                    if (observe) {
                        st[0] = t.s0;
                        st[1] = t.s1;
                        st[2] = t.s2;
                    }
                    st[3] = half == 1 ? max_nan(st[3], t.mdet) : t.mdet;
                    if (last) st[4] = t.mnew;
                }
            }
            __syncthreads();  // the box and red are free again
        }
        if (s < p.depth) grid.sync();
    }
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
    bool ok = f.n_chains > 0 && p->nd >= 2 && p->nd <= SQ_ND_MAXD &&
              (f.rounds == 20 || f.rounds == 13) &&
              (f.action == ACTION_PHI4 || f.action == ACTION_FREE) && steps_ok &&
              p->depth == p->n_steps * (f.checkerboard ? 2 : 1) && p->n_blocks >= 1 &&
              p->n_inner >= 1 && p->box >= 1;
    long long blocks = 1, items = 1, avol = 1, lvol = 1, sites = 1, box = 1;
    for (int d = p->nd - 1; ok && d >= 0; --d) {
        const int nt = p->T[d] >= 1 ? p->loc[d] / p->T[d] : 0;
        ok = p->G[d] >= 1 && p->loc[d] >= 1 && p->loc[d] <= p->G[d] && p->h[d] >= 0 &&
             p->h[d] < p->G[d] && p->A[d] == p->loc[d] + 2 * p->h[d] && p->T[d] >= 1 &&
             p->loc[d] % p->T[d] == 0 && p->nl[d] == (p->h[d] + p->T[d] - 1) / p->T[d] &&
             p->ndt[d] == nt + 2 * p->nl[d] &&
             p->wrap[d] == (p->h[d] == 0 && p->T[d] == p->G[d]) &&
             (p->h[d] > 0 || p->loc[d] == p->G[d]) && (p->h[d] == 0 || p->h[d] == p->depth) &&
             p->gb[d] >= 0 && p->gb[d] < p->G[d] && p->as[d] == avol && p->ls[d] == lvol &&
             (long long)p->gs[d] == sites && (!lattice || p->h[d] == 0) &&
             (entry != ND_SLABS || d == 0 || p->h[d] == 0);
        blocks *= nt;
        items *= p->ndt[d];
        avol *= p->A[d];
        lvol *= p->loc[d];
        sites *= p->G[d];
        box *= p->T[d] + (p->wrap[d] ? 0 : 2);
    }
    if (ok && entry == ND_SLABS) ok = p->h[0] >= 1 && p->h[0] <= p->loc[0];
    return ok && blocks == p->n_blocks && items == p->n_items && avol == p->avol &&
           lvol == p->lvol && box == p->box && avol < (1LL << 31) && sites <= (1LL << 32) &&
           (long long)f.n_chains * items < (1LL << 31) &&
           p->n_inner == p->n_blocks / (p->loc[0] / p->T[0]);
}

// Blocks of `kern` the current device holds at once at `smem` bytes of
// dynamic shared memory: the attribute is set on every call (the launch must
// see the state the count was taken in), the count asked once per (kernel,
// smem, device) and remembered.
template <typename K>
static cudaError_t nd_resident(K kern, size_t smem, int* blocks) {
    struct Entry {
        const void* kern;
        size_t smem;
        int dev, blocks;
    };
    static Entry cache[64];
    static int n_cache = 0;
    static std::mutex lock;
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
        e = cudaFuncSetAttribute((const void*)kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
    if (e != cudaSuccess) return e;
    std::lock_guard<std::mutex> guard(lock);
    for (int i = 0; i < n_cache; ++i) {
        if (cache[i].kern == (const void*)kern && cache[i].smem == smem && cache[i].dev == dev) {
            *blocks = cache[i].blocks;
            return cudaSuccess;
        }
    }
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, (const void*)kern, ND_THREADS,
                                                          smem);
    if (e != cudaSuccess) return e;
    *blocks = per_sm * sms;
    if (n_cache < 64) cache[n_cache++] = {(const void*)kern, smem, dev, *blocks};
    return cudaSuccess;
}

// One cooperative launch of `kern`: as many blocks as the card holds at once
// (never more than there are items).  A refused launch returns its error.
template <typename... KArgs>
static int nd_launch(void (*kern)(KArgs...), const FieldNdParams* p, void* stream,
                     const float* in, const float* left, const float* right, const float* dtau,
                     float* out, float* slp, float* stats, float* buf0, float* buf1, float* zk) {
    const size_t smem = (size_t)p->box * sizeof(float);
    int resident = 0;
    cudaError_t e = nd_resident(kern, smem, &resident);
    if (e != cudaSuccess) return (int)e;
    if (resident < 1) return (int)cudaErrorInvalidConfiguration;
    const long long items = (long long)p->f.n_chains * p->n_items;
    const int grid = (int)(items < resident ? items : resident);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)grid);
    cfg.blockDim = dim3(ND_THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = (cudaStream_t)stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeCooperative;
    attr[0].val.cooperative = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    e = cudaLaunchKernelEx(&cfg, kern, *p, in, left, right, dtau, out, slp, stats, buf0, buf1, zk);
    return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

static int nd_dispatch(const FieldNdParams* p, void* stream, const float* in, const float* left,
                       const float* right, const float* dtau, float* out, float* slp,
                       float* stats, float* buf0, float* buf1, float* zk) {
#define SQ_ND_CASE(DD)                                                                          \
    case DD:                                                                                    \
        return p->f.rounds == 20                                                                \
                   ? nd_launch(field_nd_kernel<DD, 20>, p, stream, in, left, right, dtau, out,  \
                               slp, stats, buf0, buf1, zk)                                      \
                   : nd_launch(field_nd_kernel<DD, 13>, p, stream, in, left, right, dtau, out,  \
                               slp, stats, buf0, buf1, zk);
    switch (p->nd) {
        SQ_ND_CASE(2)
        SQ_ND_CASE(3)
        SQ_ND_CASE(4)
        SQ_ND_CASE(5)
    }
#undef SQ_ND_CASE
    return (int)cudaErrorInvalidValue;
}

extern "C" int sq_field_pair_nd(const FieldNdParams* p, const float* phi_in, const float* dtau_in,
                                float* phi_out, float* slp, float* stats, float* buf0,
                                float* buf1, float* zk, void* stream) {
    if (!nd_params_ok(p, ND_PAIR)) return (int)cudaErrorInvalidValue;
    return nd_dispatch(p, stream, phi_in, nullptr, nullptr, dtau_in, phi_out, slp, stats,
                              buf0, buf1, zk);
}

// The one-step tail: kernel 6's own code at n_steps = 1.
extern "C" int sq_field_step_nd(const FieldNdParams* p, const float* phi_in, const float* dtau_in,
                                float* phi_out, float* slp, float* stats, float* buf0,
                                float* buf1, float* zk, void* stream) {
    if (!nd_params_ok(p, ND_STEP)) return (int)cudaErrorInvalidValue;
    return nd_dispatch(p, stream, phi_in, nullptr, nullptr, dtau_in, phi_out, slp, stats,
                              buf0, buf1, zk);
}

extern "C" int sq_field_chunk_nd(const FieldNdParams* p, const float* ext_in,
                                 const float* dtau_in, float* phi_out, float* slp, float* stats,
                                 float* buf0, float* buf1, float* zk, void* stream) {
    if (!nd_params_ok(p, ND_CHUNK)) return (int)cudaErrorInvalidValue;
    return nd_dispatch(p, stream, ext_in, nullptr, nullptr, dtau_in, phi_out, slp, stats,
                              buf0, buf1, zk);
}

extern "C" int sq_field_chunk_rdma_nd(const FieldNdParams* p, const float* phi_in,
                                      const float* left, const float* right,
                                      const float* dtau_in, float* phi_out, float* slp,
                                      float* stats, float* buf0, float* buf1, float* zk,
                                      void* stream) {
    if (!nd_params_ok(p, ND_SLABS)) return (int)cudaErrorInvalidValue;
    return nd_dispatch(p, stream, phi_in, left, right, dtau_in, phi_out, slp, stats, buf0,
                             buf1, zk);
}

// Whole-lattice 2-D scalar-field Langevin frames for NVIDIA Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of stochquant_tpu/kernels/field_kernel.py:
//   kernel 3  sq_field_frame  <- _build_kernel / _frame_call
//             (one frame of `loops` micro-steps per chain; returns the frame
//             sums, the accept/reject epilogue runs outside in PyTorch)
//   kernel 4  sq_field_frames <- _build_multiframe_kernel / _multiframe_call
//             (K frames per launch with the accept/reject, running-mean merge,
//             (lo, hi) sample-count carry and adaptive-dtau epilogue in-kernel)
//
// Per micro-step pair every site draws one Threefry pair keyed by (seed,
// FIELD ^ chain << 8, row * L1 + col, step) and takes both Box-Muller outputs
// (under rng_impl='hardware', the counterpart of the TPU kernels' on-core
// generator branch: one Philox-4x32-10 evaluation per site and four
// micro-steps, key (seed, FIELD ^ chain << 8), counter (row * L1 + col, s, 0,
// 0) with s the counter of the first of the four steps, counted in fours from
// the frame's first step; a short last group drops its unused normals, so the
// stream depends only on (seed, chain, site, step): the same in kernels 3 and
// 4 at any frames per launch, resumable at a frame boundary, fresh for a
// rejected frame's retry);
// each micro-step is the Euler-Maruyama update (synchronous, or an even then
// an odd half-sweep) with clamp and non-finite rule; the observables (M, M^2,
// M^4, |M|, phi^2, action density, slice correlator) sample the pre-update
// field; the detector trips on max|det| > lrg or a non-finite update and
// freezes the chain for the rest of the frame.
//
// What bounds it on the card: operations (the noise and ~40 float ops per
// site-update; PERF.md's kernel table has the bound) once the lattice stays on
// chip.  The TPU kernel keeps a chain's whole lattice in VMEM (up to 1 MiB), but
// one H100 block has at most 227 KB of shared memory, so the 256^2 lattice (256
// KiB, two buffers 512 KiB) does not fit one block.  Two geometries, chosen per
// launch by field_kernel.cluster_geometry (FieldParams.cl_B):
//
//   B > 1, a chain on a thread-block cluster of B blocks (cluster.cuh): block
//   rank b holds its strip of rows, with one halo row a side, in two ping-pong
//   shared-memory buffers for the whole frame, loaded once at the frame's start
//   and written back once at its end; the kept noise of its own sites lives in
//   shared memory too where the budget allows (cl_scratch), else in global
//   memory.  A site update writes its row into the other buffer and, on a strip's
//   edge row, into the neighbour block's halo row of that buffer through
//   distributed shared memory: step k writes only halos nobody reads in step k,
//   so one cluster barrier per micro-step (two under the checkerboard, one per
//   half-sweep) publishes the update, the halos and the reduction's slots.  The
//   reduction is in fixed order (warps, then ranks; no atomics), so every thread
//   of the cluster holds the same totals and the trajectory, every decision and
//   the slice means are bitwise those of B = 1; only the site sums (M, phi^2, s)
//   are taken in another order.  16 chains of 256^2 fill 128 SMs at B = 8.
//
//   B = 1, one block of 1024 threads per chain (the geometry at many chains):
//   the field ping-ponged between two global buffers that stay L2-resident (the
//   wrapper allocates them; 4 MiB at 256^2 x 16 chains), barriers between the
//   read and write phases of each micro-step, and a fixed-order block reduction
//   per micro-step for the detector and the observables.
//
// Site ownership (B = 1): warp w of the block owns rows w, w + 32, ...; lane l owns
// columns l, l + 32, ... of those rows.  A thread reads and writes only its
// own sites of the destination buffer, so the later noise outputs of a group
// (kept in per-site scratch planes between the group's micro-steps: one
// plane under Threefry, three under Philox), the own-
// site copies and the row sums (the slice means, kept per chain in a scratch
// row) need no barrier; lane 0 of the owning warp also owns the row's entry
// of the slice correlator.  At B > 1 the same holds inside a strip: warp w owns
// its owned rows w, w + 32, ..., so a row's slice mean is summed in the order
// of B = 1.

#include "cluster.cuh"
#include "field_common.cuh"

#define FK_THREADS 1024

enum { NOISE_DRAW = 0, NOISE_DRAW_KEEP = 1, NOISE_KEPT = 2 };

// Block-uniform per-chain values of the frame in flight.
struct Frame {
    float lrg, dtau, namp;
    float sums[6];   // frame sums of M, M^2, M^4, |M|, phi^2, s
    int unstable;
};

__device__ __forceinline__ void copy_own(const FieldParams& p, const float* __restrict__ src,
                                         float* __restrict__ dst) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nw = blockDim.x >> 5;
    for (int r = warp; r < p.L0; r += nw)
        for (int c = lane; c < p.L1; c += 32) dst[r * p.L1 + c] = src[r * p.L1 + c];
}

// One sweep over this thread's sites: sites of parity `par` (every site when
// par < 0) take the EM update from `src`, the others copy `src`; all go to
// `dst`.  With `observe` it also sums the pre-update observables and writes
// the slice means; with `last` it takes max |phi_new|.
// Noise: NOISE_DRAW evaluates the generator at (site, step) and takes its
// first output; NOISE_DRAW_KEEP also stores outputs 1 .. STEPS-1 in the planes
// zk[(g - 1) * zk_plane + site]; NOISE_KEPT reads output `slot` from its plane.
template <class GEN>
__device__ void sweep(const FieldParams& p, const float* __restrict__ src,
                      float* __restrict__ dst, float* __restrict__ zk, size_t zk_plane, int par,
                      int noise, int slot, uint32_t k1, uint32_t step, const Frame& fr,
                      bool observe, bool last, Acc& acc, float* __restrict__ slice) {
    const int L0 = p.L0, L1 = p.L1;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nw = blockDim.x >> 5;
    for (int r = warp; r < L0; r += nw) {
        const int rdn = (r == 0 ? L0 : r) - 1, rup = r + 1 == L0 ? 0 : r + 1;
        float row = 0.0f;
        for (int c = lane; c < L1; c += 32) {
            const int cdn = (c == 0 ? L1 : c) - 1, cup = c + 1 == L1 ? 0 : c + 1;
            const int i = r * L1 + c;
            const float f = src[i];
            const float up0 = src[rup * L1 + c], up1 = src[r * L1 + cup];
            float newf = f;
            if (par < 0 || ((r + c) & 1) == par) {
                float eta;
                if (noise == NOISE_KEPT) {
                    if constexpr (GEN::STEPS == 2) eta = zk[i];
                    else eta = zk[(size_t)(slot - 1) * zk_plane + i];
                } else {
                    float z[GEN::STEPS];
                    GEN::draw(p.seed, k1, (uint32_t)i, step, z);
                    eta = z[0];
                    if (noise == NOISE_DRAW_KEEP) {
                        #pragma unroll
                        for (int g = 1; g < GEN::STEPS; ++g)
                            zk[(size_t)(g - 1) * zk_plane + i] = z[g];
                    }
                }
                const float lap = laplacian(p, f, src[rdn * L1 + c], up0, src[r * L1 + cdn], up1);
                float absdet;
                bool finite;
                newf = em_update(p, f, lap, fr.namp * eta, fr.dtau, absdet, finite);
                acc.mdet = fmaxf(acc.mdet, absdet);
                acc.bad |= !finite;
            }
            dst[i] = newf;
            if (observe) {
                acc.s0 += f;
                acc.s1 += f * f;
                acc.s2 += action_density(p, f, up0, up1);
                row += f;
            }
            if (last) acc.mnew = fmaxf(acc.mnew, fabsf(newf));
        }
        if (observe) {
            row = warp_sum(row);
            if (lane == 0) slice[r] = row / (float)L1;
        }
    }
}

// One micro-step of a chain that is not frozen (the caller checks).  `cur`
// holds the field before and after; `oth` is the other work buffer.
template <class GEN>
__device__ void substep(const FieldParams& p, float*& cur, float*& oth, float* zk,
                        size_t zk_plane, int noise, int slot, uint32_t k1, uint32_t step,
                        Frame& fr, float* __restrict__ cs, float* __restrict__ slice,
                        float* red) {
    Acc acc = acc_zero();
    if (p.checkerboard) {
        sweep<GEN>(p, cur, oth, zk, zk_plane, 0, noise, slot, k1, step, fr, true, false, acc,
                   slice);
        __syncthreads();
        sweep<GEN>(p, oth, cur, zk, zk_plane, 1, noise, slot, k1, step, fr, false, true, acc,
                   slice);
    } else {
        sweep<GEN>(p, cur, oth, zk, zk_plane, -1, noise, slot, k1, step, fr, true, true, acc,
                   slice);
        float* t = cur;
        cur = oth;
        oth = t;
    }
    acc_publish(acc, red);  // its barrier also publishes the new field and slice means
    const Acc t = acc_total(red);
    const float vol = (float)(p.L0 * p.L1);
    const float mag = t.s0 / vol, phi2 = t.s1 / vol, act = t.s2 / vol;
    const float mag2 = mag * mag;
    const bool tripped = t.mdet > fr.lrg || t.bad;
    fr.sums[0] = fr.sums[0] + mag;
    fr.sums[1] = fr.sums[1] + mag2;
    fr.sums[2] = fr.sums[2] + mag2 * mag2;
    fr.sums[3] = fr.sums[3] + fabsf(mag);
    fr.sums[4] = fr.sums[4] + phi2;
    fr.sums[5] = fr.sums[5] + act;
    fr.lrg = max_keep_nan(fr.lrg, t.mnew);
    fr.unstable = tripped;
    if ((threadIdx.x & 31) == 0) {
        const float s_first = slice[0];
        for (int r = threadIdx.x >> 5; r < p.L0; r += blockDim.x >> 5)
            cs[r] = cs[r] + slice[r] * s_first;
    }
    __syncthreads();  // red and slice are free for the next micro-step
}

// `loops` micro-steps from P0 starting at counter step0, in noise groups of
// GEN::STEPS counted from step0 (a short last group drops the rest of its
// evaluation); the field ends in P0.  A tripped chain stays frozen for the
// rest of the frame.
template <class GEN>
__device__ void run_frame(const FieldParams& p, float* P0, float* P1, float* zk,
                          size_t zk_plane, float* cs, float* slice, float* red, Frame& fr,
                          uint32_t step0, uint32_t k1) {
    float* cur = P0;
    float* oth = P1;
    fr.namp = p.c_amp * sqrtf(2.0f * fr.dtau / p.measure);
    for (int k = 0; k < 6; ++k) fr.sums[k] = 0.0f;
    fr.unstable = 0;
    if constexpr (GEN::STEPS == 2) {
        const int pairs = p.loops / 2;
        for (int k = 0; k < pairs; ++k) {  // block-uniform control flow
            const uint32_t step = step0 + 2u * (uint32_t)k;
            substep<GEN>(p, cur, oth, zk, zk_plane, NOISE_DRAW_KEEP, 0, k1, step, fr, cs, slice,
                         red);
            if (fr.unstable) break;
            substep<GEN>(p, cur, oth, zk, zk_plane, NOISE_KEPT, 1, k1, step, fr, cs, slice, red);
            if (fr.unstable) break;
        }
        if ((p.loops & 1) && !fr.unstable)
            substep<GEN>(p, cur, oth, zk, zk_plane, NOISE_DRAW, 0, k1,
                         step0 + (uint32_t)(p.loops - 1), fr, cs, slice, red);
    } else {
        for (int s0 = 0; s0 < p.loops && !fr.unstable; s0 += GEN::STEPS) {  // block-uniform
            const uint32_t step = step0 + (uint32_t)s0;
            const int n = min(GEN::STEPS, p.loops - s0);
            for (int g = 0; g < n && !fr.unstable; ++g) {
                const int noise = g ? NOISE_KEPT : (n > 1 ? NOISE_DRAW_KEEP : NOISE_DRAW);
                substep<GEN>(p, cur, oth, zk, zk_plane, noise, g, k1, step, fr, cs, slice, red);
            }
        }
    }
    if (cur != P0) {
        copy_own(p, cur, P0);
        __syncthreads();
    }
}

__device__ __forceinline__ void zero_owned_rows(const FieldParams& p, float* row) {
    if ((threadIdx.x & 31) == 0)
        for (int r = threadIdx.x >> 5; r < p.L0; r += blockDim.x >> 5) row[r] = 0.0f;
}

// ---- kernel 3: one frame, frame sums out ----------------------------------

template <class GEN>
__global__ void __launch_bounds__(FK_THREADS)
field_frame_kernel(FieldParams p, const float* __restrict__ phi_in,
                   const float* __restrict__ lrg_in, const float* __restrict__ dtau_in,
                   float* __restrict__ phi_out, float* __restrict__ sums_out,
                   float* __restrict__ cs_out, float* __restrict__ lrg_out,
                   int32_t* __restrict__ unst_out, float* __restrict__ work,
                   float* __restrict__ zk, float* __restrict__ slice) {
    __shared__ float red[6 * (FK_THREADS / 32)];
    const int ch = blockIdx.x, C = p.n_chains;
    const size_t vol = (size_t)p.L0 * (size_t)p.L1;
    float* P0 = phi_out + ch * vol;
    float* cs = cs_out + (size_t)ch * p.L0;
    copy_own(p, phi_in + ch * vol, P0);
    zero_owned_rows(p, cs);
    __syncthreads();
    Frame fr;
    fr.lrg = lrg_in[ch];
    fr.dtau = dtau_in[ch];
    const uint32_t k1 = (uint32_t)STREAM_FIELD ^ ((p.chain0 + (uint32_t)ch) << 8);
    run_frame<GEN>(p, P0, work + ch * vol, zk + ch * vol, (size_t)C * vol, cs,
                   slice + (size_t)ch * p.L0, red, fr, p.step0, k1);
    if (threadIdx.x == 0) {
        for (int k = 0; k < 6; ++k) sums_out[(size_t)k * C + ch] = fr.sums[k];
        lrg_out[ch] = fr.lrg;
        unst_out[ch] = fr.unstable;
    }
}

// ---- kernel 4: K frames, epilogue in-kernel --------------------------------

template <class GEN>
__global__ void __launch_bounds__(FK_THREADS)
field_frames_kernel(FieldParams p, const float* __restrict__ phi_in,
                    const float* __restrict__ lrg_in, const float* __restrict__ dtau_in,
                    const float* __restrict__ means_in, const float* __restrict__ cm_in,
                    const int64_t* __restrict__ runs_in, const int32_t* __restrict__ stab_in,
                    float* __restrict__ phi_out, float* __restrict__ lrg_out,
                    float* __restrict__ dtau_out, float* __restrict__ means_out,
                    float* __restrict__ cm_out, int64_t* __restrict__ runs_out,
                    int32_t* __restrict__ stab_out, int32_t* __restrict__ hist_stable,
                    float* __restrict__ hist_dtau, float* __restrict__ hist_lrg,
                    float* __restrict__ work, float* __restrict__ zk,
                    float* __restrict__ slice, float* __restrict__ cs_all) {
    __shared__ float red[6 * (FK_THREADS / 32)];
    const int ch = blockIdx.x, C = p.n_chains;
    const size_t vol = (size_t)p.L0 * (size_t)p.L1;
    float* acc_phi = phi_out + ch * vol;          // the accepted field, also the snapshot
    float* W0 = work + ch * vol;
    float* W1 = work + ((size_t)C + ch) * vol;
    float* cm = cm_out + (size_t)ch * p.L0;
    float* cs = cs_all + (size_t)ch * p.L0;
    copy_own(p, phi_in + ch * vol, acc_phi);
    if ((threadIdx.x & 31) == 0)
        for (int r = threadIdx.x >> 5; r < p.L0; r += blockDim.x >> 5)
            cm[r] = cm_in[(size_t)ch * p.L0 + r];
    float means[6];
    for (int k = 0; k < 6; ++k) means[k] = means_in[(size_t)k * C + ch];
    Frame fr;
    fr.lrg = lrg_in[ch];
    float dtau = dtau_in[ch];
    uint32_t lo = (uint32_t)runs_in[2 * ch], hi = (uint32_t)runs_in[2 * ch + 1];
    int32_t stab = stab_in[ch];
    const uint32_t loops_u = (uint32_t)p.loops;
    const uint32_t k1 = (uint32_t)STREAM_FIELD ^ ((p.chain0 + (uint32_t)ch) << 8);

    for (int j = 0; j < p.n_frames; ++j) {
        copy_own(p, acc_phi, W0);
        zero_owned_rows(p, cs);
        __syncthreads();
        const float lrg_snap = fr.lrg;
        fr.dtau = dtau;
        run_frame<GEN>(p, W0, W1, zk + ch * vol, (size_t)C * vol, cs,
                       slice + (size_t)ch * p.L0, red, fr, p.step0 + (uint32_t)j * loops_u, k1);

        // epilogue: integrators/field.py frame epilogue and accum.merge_frame_sum,
        // expression for expression
        const bool accept = !fr.unstable;
        const uint32_t lo_n = lo + loops_u;
        const uint32_t hi_n = hi + (lo_n < lo ? 1u : 0u);
        const float n_new = __uint2float_rn(hi_n) * 4294967296.0f + __uint2float_rn(lo_n);
        const float w = p.loops_f / n_new;
        if (accept) {
            for (int k = 0; k < 6; ++k)
                means[k] = means[k] + (fr.sums[k] * p.inv_loops - means[k]) * w;
            if ((threadIdx.x & 31) == 0)
                for (int r = threadIdx.x >> 5; r < p.L0; r += blockDim.x >> 5)
                    cm[r] = cm[r] + (cs[r] * p.inv_loops - cm[r]) * w;
            copy_own(p, W0, acc_phi);
            lo = lo_n;
            hi = hi_n;
        } else {
            fr.lrg = lrg_snap;
        }
        const bool grow = accept && stab >= p.grow_after;
        float dt = grow ? dtau / p.shrink : (accept ? dtau : dtau * p.shrink);
        if (p.has_dtau_max) dt = fminf(dt, p.dtau_max);
        dtau = dt;
        stab = accept ? (grow ? 0 : stab + 1) : 0;
        if (threadIdx.x == 0) {
            hist_stable[(size_t)j * C + ch] = accept ? 1 : 0;
            hist_dtau[(size_t)j * C + ch] = dtau;
            hist_lrg[(size_t)j * C + ch] = fr.lrg;
        }
    }

    if (threadIdx.x == 0) {
        for (int k = 0; k < 6; ++k) means_out[(size_t)k * C + ch] = means[k];
        lrg_out[ch] = fr.lrg;
        dtau_out[ch] = dtau;
        runs_out[2 * ch] = (int64_t)lo;
        runs_out[2 * ch + 1] = (int64_t)hi;
        stab_out[ch] = stab;
    }
}

// ---- kernels 3 and 4 on a thread-block cluster (B > 1) ---------------------

// A block's share of a chain at B > 1: its strip and where its state lives.
struct ClField {
    Strip s;
    int L1, S;        // columns; rows of the largest strip
    float* buf[2];    // ping-pong strips, (S + 2) x L1 each, local row lr at buf + lr L1
    float* zk;        // kept noise of own sites: plane g at zk + g zk_plane, site (lr - 1) L1 + c
    size_t zk_plane;
    float* slice;     // slice means of own rows (local row lr at slice[lr - 1])
    float* red;       // 6 partials a warp
    float* slot;      // 2 x 8: this block's partials, by reduction parity
    float* gath;      // 8 a rank: the cluster's partials
    int parity;
};

// Shared memory of a cluster block, in floats (kernels/_cluster.py mirrors it).
__host__ __device__ __forceinline__ size_t field_cl_floats(const FieldParams& p) {
    const size_t strip = (size_t)(p.cl_rows + 2) * p.L1;
    const size_t noise = p.cl_scratch ? (size_t)(p.philox ? 3 : 1) * p.cl_rows * p.L1 : 0;
    return 2 * strip + noise + p.cl_rows + 6 * 32 + 2 * 8 + 8 * SQ_MAX_CLUSTER;
}

__device__ __forceinline__ ClField cl_field_layout(const FieldParams& p, int rank, int ch,
                                                   float* zk_glob) {
    extern __shared__ float sm[];
    ClField w;
    w.s = make_strip(rank, p.cl_B, p.L0);
    w.L1 = p.L1;
    w.S = p.cl_rows;
    const size_t strip = (size_t)(w.S + 2) * p.L1, vol = (size_t)p.L0 * p.L1;
    float* q = sm;
    w.buf[0] = q;
    w.buf[1] = q + strip;
    q += 2 * strip;
    if (p.cl_scratch) {
        w.zk = q;
        w.zk_plane = (size_t)w.S * p.L1;
        q += (size_t)(p.philox ? 3 : 1) * w.zk_plane;
    } else {  // the B = 1 kernels' planes (NP, C, L0, L1), at this strip's first row
        w.zk = zk_glob + (size_t)ch * vol + (size_t)w.s.r0 * p.L1;
        w.zk_plane = (size_t)p.n_chains * vol;
    }
    w.slice = q;
    q += w.S;
    w.red = q;
    q += 6 * 32;
    w.slot = q;
    w.gath = q + 2 * 8;
    w.parity = 0;
    return w;
}

// Local rows 0 .. n + 1 of the strip from a chain's (L0, L1) field.
__device__ __forceinline__ void cl_load(const FieldParams& p, const ClField& w,
                                        const float* __restrict__ src, float* __restrict__ dst) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nw = blockDim.x >> 5;
    for (int lr = warp; lr < w.s.n + 2; lr += nw) {
        const float* row = src + (size_t)strip_row(w.s, lr, p.L0) * p.L1;
        for (int c = lane; c < p.L1; c += 32) dst[lr * p.L1 + c] = row[c];
    }
}

// The strip's own rows into a chain's (L0, L1) field (each thread its own sites).
__device__ __forceinline__ void cl_store(const FieldParams& p, const ClField& w,
                                         const float* __restrict__ src, float* __restrict__ dst) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nw = blockDim.x >> 5;
    for (int k = warp; k < w.s.n; k += nw)
        for (int c = lane; c < p.L1; c += 32)
            dst[(size_t)(w.s.r0 + k) * p.L1 + c] = src[(k + 1) * p.L1 + c];
}

// sweep() on the strip: the same site arithmetic and noise counters (global
// site r L1 + c), neighbours from the strip's rows and halo rows; an edge row's
// new values also go into the neighbour block's halo row of `dst`.
template <class GEN>
__device__ void cl_sweep(const FieldParams& p, ClField& w, cg::cluster_group& cl,
                         const float* __restrict__ src, float* __restrict__ dst, int par,
                         int noise, int slot, uint32_t k1, uint32_t step, const Frame& fr,
                         bool observe, bool last, Acc& acc) {
    if (p.cl_empty) return;
    const int L1 = w.L1, n = w.s.n;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nw = blockDim.x >> 5;
    float* up_halo = cl.map_shared_rank(dst, w.s.up) + (size_t)(w.s.n_up + 1) * L1;
    float* dn_halo = cl.map_shared_rank(dst, w.s.dn);
    for (int k = warp; k < n; k += nw) {
        const int lr = k + 1, r = w.s.r0 + k;
        float row = 0.0f;
        for (int c = lane; c < L1; c += 32) {
            const int cdn = (c == 0 ? L1 : c) - 1, cup = c + 1 == L1 ? 0 : c + 1;
            const int li = lr * L1 + c;
            const size_t zi = (size_t)k * L1 + c;
            const float f = src[li];
            const float up0 = src[li + L1], up1 = src[lr * L1 + cup];
            float newf = f;
            if (par < 0 || ((r + c) & 1) == par) {
                float eta;
                if (noise == NOISE_KEPT) {
                    if constexpr (GEN::STEPS == 2) eta = w.zk[zi];
                    else eta = w.zk[(size_t)(slot - 1) * w.zk_plane + zi];
                } else {
                    float z[GEN::STEPS];
                    GEN::draw(p.seed, k1, (uint32_t)(r * L1 + c), step, z);
                    eta = z[0];
                    if (noise == NOISE_DRAW_KEEP) {
                        #pragma unroll
                        for (int g = 1; g < GEN::STEPS; ++g)
                            w.zk[(size_t)(g - 1) * w.zk_plane + zi] = z[g];
                    }
                }
                const float lap = laplacian(p, f, src[li - L1], up0, src[lr * L1 + cdn], up1);
                float absdet;
                bool finite;
                newf = em_update(p, f, lap, fr.namp * eta, fr.dtau, absdet, finite);
                acc.mdet = fmaxf(acc.mdet, absdet);
                acc.bad |= !finite;
            }
            dst[li] = newf;
            if (lr == 1) up_halo[c] = newf;
            if (lr == n) dn_halo[c] = newf;
            if (observe) {
                acc.s0 += f;
                acc.s1 += f * f;
                acc.s2 += action_density(p, f, up0, up1);
                row += f;
            }
            if (last) acc.mnew = fmaxf(acc.mnew, fabsf(newf));
        }
        if (observe) {
            row = warp_sum(row);
            if (lane == 0) w.slice[k] = row / (float)L1;
        }
    }
}

// The cluster's totals of one micro-step, in warp order within a block and
// rank order across blocks; s_first is rank 0's slice mean of row 0.  Its
// cluster barrier also publishes the new field and the halo rows.
__device__ __forceinline__ Acc cl_acc_total(Acc a, ClField& w, cg::cluster_group& cl,
                                            float& s_first) {
    acc_publish(a, w.red);
    float mine[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    if (threadIdx.x == 0) {
        const Acc b = acc_total(w.red);
        mine[0] = b.s0;
        mine[1] = b.s1;
        mine[2] = b.s2;
        mine[3] = b.mdet;
        mine[4] = b.mnew;
        mine[5] = (float)b.bad;
        mine[6] = w.slice[0];
    }
    cluster_gather<8>(cl, mine, w.slot + 8 * w.parity, w.gath, w.s.B);
    w.parity ^= 1;
    Acc t = acc_zero();
    for (int b = 0; b < w.s.B; ++b) {
        const float* v = w.gath + 8 * b;
        t.s0 = b ? t.s0 + v[0] : v[0];
        t.s1 = b ? t.s1 + v[1] : v[1];
        t.s2 = b ? t.s2 + v[2] : v[2];
        t.mdet = fmaxf(t.mdet, v[3]);
        t.mnew = fmaxf(t.mnew, v[4]);
        t.bad |= v[5] != 0.0f;
    }
    s_first = w.gath[6];
    return t;
}

// substep() on the cluster; `cs` is the chain's correlator row at this strip's
// first row.
template <class GEN>
__device__ void cl_substep(const FieldParams& p, ClField& w, cg::cluster_group& cl,
                           float*& cur, float*& oth, int noise, int slot, uint32_t k1,
                           uint32_t step, Frame& fr, float* __restrict__ cs) {
    Acc acc = acc_zero();
    if (p.checkerboard) {
        cl_sweep<GEN>(p, w, cl, cur, oth, 0, noise, slot, k1, step, fr, true, false, acc);
        cl.sync();  // the even half-sweep and its halo rows, published
        cl_sweep<GEN>(p, w, cl, oth, cur, 1, noise, slot, k1, step, fr, false, true, acc);
    } else {
        cl_sweep<GEN>(p, w, cl, cur, oth, -1, noise, slot, k1, step, fr, true, true, acc);
        float* t = cur;
        cur = oth;
        oth = t;
    }
    float s_first;
    const Acc t = cl_acc_total(acc, w, cl, s_first);
    const float vol = (float)(p.L0 * p.L1);
    const float mag = t.s0 / vol, phi2 = t.s1 / vol, act = t.s2 / vol;
    const float mag2 = mag * mag;
    const bool tripped = t.mdet > fr.lrg || t.bad;
    fr.sums[0] = fr.sums[0] + mag;
    fr.sums[1] = fr.sums[1] + mag2;
    fr.sums[2] = fr.sums[2] + mag2 * mag2;
    fr.sums[3] = fr.sums[3] + fabsf(mag);
    fr.sums[4] = fr.sums[4] + phi2;
    fr.sums[5] = fr.sums[5] + act;
    fr.lrg = max_keep_nan(fr.lrg, t.mnew);
    fr.unstable = tripped;
    if ((threadIdx.x & 31) == 0)
        for (int k = threadIdx.x >> 5; k < w.s.n; k += blockDim.x >> 5)
            cs[k] = cs[k] + w.slice[k] * s_first;
}

// run_frame() on the cluster, from the strip in buf[0]; returns the buffer
// that holds the field at the end.  Control flow is cluster-uniform.
template <class GEN>
__device__ float* cl_run_frame(const FieldParams& p, ClField& w, cg::cluster_group& cl,
                               Frame& fr, float* cs, uint32_t step0, uint32_t k1) {
    float* cur = w.buf[0];
    float* oth = w.buf[1];
    fr.namp = p.c_amp * sqrtf(2.0f * fr.dtau / p.measure);
    for (int k = 0; k < 6; ++k) fr.sums[k] = 0.0f;
    fr.unstable = 0;
    if constexpr (GEN::STEPS == 2) {
        const int pairs = p.loops / 2;
        for (int k = 0; k < pairs; ++k) {
            const uint32_t step = step0 + 2u * (uint32_t)k;
            cl_substep<GEN>(p, w, cl, cur, oth, NOISE_DRAW_KEEP, 0, k1, step, fr, cs);
            if (fr.unstable) break;
            cl_substep<GEN>(p, w, cl, cur, oth, NOISE_KEPT, 1, k1, step, fr, cs);
            if (fr.unstable) break;
        }
        if ((p.loops & 1) && !fr.unstable)
            cl_substep<GEN>(p, w, cl, cur, oth, NOISE_DRAW, 0, k1,
                            step0 + (uint32_t)(p.loops - 1), fr, cs);
    } else {
        for (int s0 = 0; s0 < p.loops && !fr.unstable; s0 += GEN::STEPS) {
            const uint32_t step = step0 + (uint32_t)s0;
            const int n = min(GEN::STEPS, p.loops - s0);
            for (int g = 0; g < n && !fr.unstable; ++g) {
                const int noise = g ? NOISE_KEPT : (n > 1 ? NOISE_DRAW_KEEP : NOISE_DRAW);
                cl_substep<GEN>(p, w, cl, cur, oth, noise, g, k1, step, fr, cs);
            }
        }
    }
    return cur;
}

__device__ __forceinline__ void cl_zero_rows(const ClField& w, float* row) {
    if ((threadIdx.x & 31) == 0)
        for (int k = threadIdx.x >> 5; k < w.s.n; k += blockDim.x >> 5) row[k] = 0.0f;
}

// Kernel 3 at B > 1: the arguments of field_frame_kernel but the work buffer
// and the slice scratch (shared memory holds both).
template <class GEN>
__global__ void __launch_bounds__(FK_THREADS)
field_frame_cl_kernel(FieldParams p, const float* __restrict__ phi_in,
                      const float* __restrict__ lrg_in, const float* __restrict__ dtau_in,
                      float* __restrict__ phi_out, float* __restrict__ sums_out,
                      float* __restrict__ cs_out, float* __restrict__ lrg_out,
                      int32_t* __restrict__ unst_out, float* __restrict__ zk) {
    cg::cluster_group cl = cg::this_cluster();
    const int ch = blockIdx.x / p.cl_B, C = p.n_chains;
    const size_t vol = (size_t)p.L0 * (size_t)p.L1;
    ClField w = cl_field_layout(p, (int)cl.block_rank(), ch, zk);
    float* cs = cs_out + (size_t)ch * p.L0 + w.s.r0;
    cl_load(p, w, phi_in + ch * vol, w.buf[0]);
    cl_zero_rows(w, cs);
    __syncthreads();
    Frame fr;
    fr.lrg = lrg_in[ch];
    fr.dtau = dtau_in[ch];
    const uint32_t k1 = (uint32_t)STREAM_FIELD ^ ((p.chain0 + (uint32_t)ch) << 8);
    const float* cur = cl_run_frame<GEN>(p, w, cl, fr, cs, p.step0, k1);
    cl_store(p, w, cur, phi_out + ch * vol);
    if (w.s.rank == 0 && threadIdx.x == 0) {
        for (int k = 0; k < 6; ++k) sums_out[(size_t)k * C + ch] = fr.sums[k];
        lrg_out[ch] = fr.lrg;
        unst_out[ch] = fr.unstable;
    }
    cl.sync();  // no block leaves while a peer may still read its slots
}

// Kernel 4 at B > 1: the accepted field stays in phi_out (global), each
// frame starts from it in buf[0]; the arguments of field_frames_kernel but the
// work buffers and the slice scratch.
template <class GEN>
__global__ void __launch_bounds__(FK_THREADS)
field_frames_cl_kernel(FieldParams p, const float* __restrict__ phi_in,
                       const float* __restrict__ lrg_in, const float* __restrict__ dtau_in,
                       const float* __restrict__ means_in, const float* __restrict__ cm_in,
                       const int64_t* __restrict__ runs_in, const int32_t* __restrict__ stab_in,
                       float* __restrict__ phi_out, float* __restrict__ lrg_out,
                       float* __restrict__ dtau_out, float* __restrict__ means_out,
                       float* __restrict__ cm_out, int64_t* __restrict__ runs_out,
                       int32_t* __restrict__ stab_out, int32_t* __restrict__ hist_stable,
                       float* __restrict__ hist_dtau, float* __restrict__ hist_lrg,
                       float* __restrict__ zk, float* __restrict__ cs_all) {
    cg::cluster_group cl = cg::this_cluster();
    const int ch = blockIdx.x / p.cl_B, C = p.n_chains;
    const size_t vol = (size_t)p.L0 * (size_t)p.L1;
    ClField w = cl_field_layout(p, (int)cl.block_rank(), ch, zk);
    const bool lead = w.s.rank == 0 && threadIdx.x == 0;
    float* acc_phi = phi_out + ch * vol;  // the accepted field
    float* cm = cm_out + (size_t)ch * p.L0 + w.s.r0;
    float* cs = cs_all + (size_t)ch * p.L0 + w.s.r0;
    {
        const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nw = blockDim.x >> 5;
        for (int k = warp; k < w.s.n; k += nw) {
            const size_t row = (size_t)(w.s.r0 + k) * p.L1;
            for (int c = lane; c < p.L1; c += 32) acc_phi[row + c] = phi_in[ch * vol + row + c];
            if (lane == 0) cm[k] = cm_in[(size_t)ch * p.L0 + w.s.r0 + k];
        }
    }
    float means[6];
    for (int k = 0; k < 6; ++k) means[k] = means_in[(size_t)k * C + ch];
    Frame fr;
    fr.lrg = lrg_in[ch];
    float dtau = dtau_in[ch];
    uint32_t lo = (uint32_t)runs_in[2 * ch], hi = (uint32_t)runs_in[2 * ch + 1];
    int32_t stab = stab_in[ch];
    const uint32_t loops_u = (uint32_t)p.loops;
    const uint32_t k1 = (uint32_t)STREAM_FIELD ^ ((p.chain0 + (uint32_t)ch) << 8);

    for (int j = 0; j < p.n_frames; ++j) {
        __threadfence();
        cl.sync();  // every rank's accepted rows are in phi_out; no peer reads our strips
        cl_load(p, w, acc_phi, w.buf[0]);
        cl_zero_rows(w, cs);
        __syncthreads();
        const float lrg_snap = fr.lrg;
        fr.dtau = dtau;
        const float* cur = cl_run_frame<GEN>(p, w, cl, fr, cs, p.step0 + (uint32_t)j * loops_u,
                                             k1);

        // epilogue: field_frames_kernel's, expression for expression
        const bool accept = !fr.unstable;
        const uint32_t lo_n = lo + loops_u;
        const uint32_t hi_n = hi + (lo_n < lo ? 1u : 0u);
        const float n_new = __uint2float_rn(hi_n) * 4294967296.0f + __uint2float_rn(lo_n);
        const float wgt = p.loops_f / n_new;
        if (accept) {
            for (int k = 0; k < 6; ++k)
                means[k] = means[k] + (fr.sums[k] * p.inv_loops - means[k]) * wgt;
            if ((threadIdx.x & 31) == 0)
                for (int k = threadIdx.x >> 5; k < w.s.n; k += blockDim.x >> 5)
                    cm[k] = cm[k] + (cs[k] * p.inv_loops - cm[k]) * wgt;
            cl_store(p, w, cur, acc_phi);
            lo = lo_n;
            hi = hi_n;
        } else {
            fr.lrg = lrg_snap;
        }
        const bool grow = accept && stab >= p.grow_after;
        float dt = grow ? dtau / p.shrink : (accept ? dtau : dtau * p.shrink);
        if (p.has_dtau_max) dt = fminf(dt, p.dtau_max);
        dtau = dt;
        stab = accept ? (grow ? 0 : stab + 1) : 0;
        if (lead) {
            hist_stable[(size_t)j * C + ch] = accept ? 1 : 0;
            hist_dtau[(size_t)j * C + ch] = dtau;
            hist_lrg[(size_t)j * C + ch] = fr.lrg;
        }
    }

    if (lead) {
        for (int k = 0; k < 6; ++k) means_out[(size_t)k * C + ch] = means[k];
        lrg_out[ch] = fr.lrg;
        dtau_out[ch] = dtau;
        runs_out[2 * ch] = (int64_t)lo;
        runs_out[2 * ch + 1] = (int64_t)hi;
        stab_out[ch] = stab;
    }
    cl.sync();  // no block leaves while a peer may still read its slots
}

// ---- C entry points (loaded with ctypes) ----------------------------------

static bool valid_field_launch(const FieldParams& p) {
    const int B = p.cl_B;
    const bool cluster = B == 1 || ((B == 2 || B == 4 || B == 8 || B == 16) && B <= p.L0 &&
                                    p.cl_rows == (p.L0 + B - 1) / B &&
                                    (p.cl_scratch == 0 || p.cl_scratch == 1));
    return p.n_chains > 0 && p.n_chains <= 65535 && p.L0 >= 1 && p.L1 >= 1 &&
           (long long)p.L0 * p.L1 <= (1LL << 24) && (p.rounds == 20 || p.rounds == 13) &&
           (p.philox == 0 || p.philox == 1) && p.loops >= 1 &&
           (p.action == ACTION_PHI4 || p.action == ACTION_FREE) && cluster;
}

#define SQ_FIELD_DISPATCH(KERNEL, ...)                                                    \
    do {                                                                                  \
        cudaStream_t st = (cudaStream_t)stream;                                           \
        if (p->philox)                                                                    \
            KERNEL<PhiloxNoise><<<p->n_chains, FK_THREADS, 0, st>>>(*p, __VA_ARGS__);     \
        else if (p->rounds == 20)                                                         \
            KERNEL<Threefry20><<<p->n_chains, FK_THREADS, 0, st>>>(*p, __VA_ARGS__);      \
        else                                                                              \
            KERNEL<Threefry13><<<p->n_chains, FK_THREADS, 0, st>>>(*p, __VA_ARGS__);      \
    } while (0)

// B > 1: n_chains clusters of B blocks; returns the launch's error.
#define SQ_FIELD_CL_DISPATCH(KERNEL, ...)                                                 \
    do {                                                                                  \
        cudaStream_t st = (cudaStream_t)stream;                                           \
        const size_t smem = field_cl_floats(*p) * sizeof(float);                          \
        if (p->philox)                                                                    \
            return (int)launch_cluster(KERNEL<PhiloxNoise>, p->n_chains, FK_THREADS, smem, \
                                       p->cl_B, st, *p, __VA_ARGS__);                     \
        if (p->rounds == 20)                                                              \
            return (int)launch_cluster(KERNEL<Threefry20>, p->n_chains, FK_THREADS, smem,  \
                                       p->cl_B, st, *p, __VA_ARGS__);                     \
        return (int)launch_cluster(KERNEL<Threefry13>, p->n_chains, FK_THREADS, smem,      \
                                   p->cl_B, st, *p, __VA_ARGS__);                         \
    } while (0)

extern "C" int sq_field_frame(const FieldParams* p, const float* phi_in, const float* lrg_in,
                              const float* dtau_in, float* phi_out, float* sums_out,
                              float* cs_out, float* lrg_out, int32_t* unst_out, float* work,
                              float* zk, float* slice, void* stream) {
    if (!valid_field_launch(*p)) return (int)cudaErrorInvalidValue;
    if (p->cl_B > 1)
        SQ_FIELD_CL_DISPATCH(field_frame_cl_kernel, phi_in, lrg_in, dtau_in, phi_out, sums_out,
                             cs_out, lrg_out, unst_out, zk);
    SQ_FIELD_DISPATCH(field_frame_kernel, phi_in, lrg_in, dtau_in, phi_out, sums_out, cs_out,
                      lrg_out, unst_out, work, zk, slice);
    return (int)cudaGetLastError();
}

extern "C" int sq_field_frames(const FieldParams* p, const float* phi_in, const float* lrg_in,
                               const float* dtau_in, const float* means_in, const float* cm_in,
                               const int64_t* runs_in, const int32_t* stab_in, float* phi_out,
                               float* lrg_out, float* dtau_out, float* means_out, float* cm_out,
                               int64_t* runs_out, int32_t* stab_out, int32_t* hist_stable,
                               float* hist_dtau, float* hist_lrg, float* work, float* zk,
                               float* slice, float* cs, void* stream) {
    if (!valid_field_launch(*p) || p->n_frames < 1) return (int)cudaErrorInvalidValue;
    if (p->cl_B > 1)
        SQ_FIELD_CL_DISPATCH(field_frames_cl_kernel, phi_in, lrg_in, dtau_in, means_in, cm_in,
                             runs_in, stab_in, phi_out, lrg_out, dtau_out, means_out, cm_out,
                             runs_out, stab_out, hist_stable, hist_dtau, hist_lrg, zk, cs);
    SQ_FIELD_DISPATCH(field_frames_kernel, phi_in, lrg_in, dtau_in, means_in, cm_in, runs_in,
                      stab_in, phi_out, lrg_out, dtau_out, means_out, cm_out, runs_out,
                      stab_out, hist_stable, hist_dtau, hist_lrg, work, zk, slice, cs);
    return (int)cudaGetLastError();
}

// Chains of kernel 3 (multi = 0) or 4 (multi = 1) the card runs at once in the
// geometry of p (cl_B, cl_rows, cl_scratch): resident clusters of cl_B blocks,
// or at cl_B = 1 resident blocks.  The geometry rule's occupancy answer.
template <class GEN>
static cudaError_t field_resident(const FieldParams& p, int multi, int* out) {
    if (p.cl_B == 1)
        return multi ? resident_blocks(field_frames_kernel<GEN>, FK_THREADS, out)
                     : resident_blocks(field_frame_kernel<GEN>, FK_THREADS, out);
    const size_t smem = field_cl_floats(p) * sizeof(float);
    return multi ? resident_clusters(field_frames_cl_kernel<GEN>, FK_THREADS, smem, p.cl_B, out)
                 : resident_clusters(field_frame_cl_kernel<GEN>, FK_THREADS, smem, p.cl_B, out);
}

extern "C" int sq_field_resident(const FieldParams* p, int multi, int* out) {
    *out = 0;
    if (!valid_field_launch(*p)) return (int)cudaErrorInvalidValue;
    if (p->philox) return (int)field_resident<PhiloxNoise>(*p, multi, out);
    if (p->rounds == 20) return (int)field_resident<Threefry20>(*p, multi, out);
    return (int)field_resident<Threefry13>(*p, multi, out);
}

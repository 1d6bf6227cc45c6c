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
// What bounds it on the card: the TPU kernel keeps a chain's whole lattice in
// VMEM (up to 1 MiB), but one H100 block has at most 227 KB of shared memory,
// so even the 256^2 lattice (256 KiB) does not fit one block.  The design here
// is the simple one: one block of 1024 threads per chain, the field
// ping-ponged between two global buffers that stay L2-resident (the wrapper
// allocates them; 4 MiB at 256^2 x 16 chains), barriers between the read and
// write phases of each micro-step, and a fixed-order block reduction per
// micro-step for the detector and the observables.  Per site-update that is
// half a Threefry evaluation and Box-Muller, ~40 float ops and five L1/L2
// loads.  With one block per chain only `n_chains` SMs work (16 of 132 at the
// bench shape); a thread-block cluster per chain holding row strips in
// distributed shared memory is the later, faster design.
//
// Site ownership: warp w of the block owns rows w, w + 32, ...; lane l owns
// columns l, l + 32, ... of those rows.  A thread reads and writes only its
// own sites of the destination buffer, so the later noise outputs of a group
// (kept in per-site scratch planes between the group's micro-steps: one
// plane under Threefry, three under Philox), the own-
// site copies and the row sums (the slice means, kept per chain in a scratch
// row) need no barrier; lane 0 of the owning warp also owns the row's entry
// of the slice correlator.

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
    fr.lrg = fmaxf(fr.lrg, t.mnew);
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

// ---- C entry points (loaded with ctypes) ----------------------------------

static bool valid_field_launch(const FieldParams& p) {
    return p.n_chains > 0 && p.n_chains <= 65535 && p.L0 >= 1 && p.L1 >= 1 &&
           (long long)p.L0 * p.L1 <= (1LL << 24) && (p.rounds == 20 || p.rounds == 13) &&
           (p.philox == 0 || p.philox == 1) && p.loops >= 1 &&
           (p.action == ACTION_PHI4 || p.action == ACTION_FREE);
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

extern "C" int sq_field_frame(const FieldParams* p, const float* phi_in, const float* lrg_in,
                              const float* dtau_in, float* phi_out, float* sums_out,
                              float* cs_out, float* lrg_out, int32_t* unst_out, float* work,
                              float* zk, float* slice, void* stream) {
    if (!valid_field_launch(*p)) return (int)cudaErrorInvalidValue;
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
    SQ_FIELD_DISPATCH(field_frames_kernel, phi_in, lrg_in, dtau_in, means_in, cm_in, runs_in,
                      stab_in, phi_out, lrg_out, dtau_out, means_out, cm_out, runs_out,
                      stab_out, hist_stable, hist_dtau, hist_lrg, work, zk, slice, cs);
    return (int)cudaGetLastError();
}

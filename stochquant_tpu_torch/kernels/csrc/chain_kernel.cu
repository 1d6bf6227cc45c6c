// Batched 1-D Langevin chain frames for NVIDIA Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of stochquant_tpu/kernels/chain_kernel.py:
//   kernel 1  sq_chain_frame  <- _build_frame_kernel / _frame_call
//             (one frame of `loops` micro-steps; returns the frame sums, the
//             accept/reject epilogue runs outside in PyTorch)
//   kernel 2  sq_chain_frames <- _build_multiframe_kernel / _multiframe_call
//             (K frames per launch with the accept/reject, running-mean merge,
//             (lo, hi) sample-count carry and adaptive-dtau epilogue in-kernel)
//
// What bounds it on the card: arithmetic, not memory.  The state is read
// once and written once per launch; in between every site-update spends about
// ten Threefry-2x32 rounds of 32-bit integer work (20 or 13 rounds per pair
// of micro-steps), half a Box-Muller (logf, sqrtf, sinf, cosf per pair), one
// tanhf for the kink background (BACKGROUND formulation) and ~30 float ops of
// drift, clamp, detector and observable sums, plus two block-wide barriers
// (three under Heun) for the neighbour exchange and the per-chain detector
// max.  At the headline shape (65536 chains x 200 sites x 1000 micro-steps)
// that is ~1e13 integer and float operations per frame against ~2e8 bytes.
//
// What the design does about it: one thread block per chain and one thread
// per site (a thread walks sites tid, tid+T, ... when N exceeds the block of
// T <= 512 threads), so the chain's field, its four frame sums and (kernel 2)
// its running means stay in registers for the whole launch; neighbours come
// through one float per site of shared memory; the detector's two maxima are
// a warp-shuffle plus shared-memory block reduction that every thread
// finishes itself, so omega, lrg, dtau and the freeze flag are block-uniform
// registers and a frozen chain leaves the loop without further work.  The
// collective coordinate's noise is drawn once per noise group by thread 0.
// The generator is a template parameter (sq_rng.cuh: Threefry-2x32 at 20 or
// 13 rounds, one evaluation per site and two micro-steps; or Philox-4x32-10
// for rng_impl='hardware', one per site and four micro-steps), so the rounds
// unroll into straight-line integer code.  Making it fast (several chains
// per warp, CUDA graphs over frames) is later work.
//
// The Philox stream (the counterpart of the TPU kernels' on-core generator,
// _build_frame_kernel's hardware-PRNG branch): key (seed, FIELD ^ chain << 8)
// with the global chain id, counter (site, s, 0, 0) where s is the micro-step
// counter of the first of the four steps the evaluation serves, counted in
// fours from the frame's first step; the collective coordinate takes site N
// of the same stream (the TPU branch's extra lane).  A frame whose `loops`
// is not a multiple of four drops the last evaluation's unused normals, so
// no word serves two steps and the stream depends only on (seed, chain,
// site, step): the same in kernel 1 and kernel 2, at any frames per launch,
// resumable at any frame boundary, and fresh for a rejected frame's retry
// (the counter advances by `loops` regardless).
//
// Numerics: every expression keeps the operand order of the JAX integrator
// (stochquant_tpu/integrators/langevin.py) and of the Pallas kernels.  Build
// flags: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC --fmad=false.  No --use_fast_math: the accurate tanhf,
// logf, sinf, cosf, sqrtf and IEEE division keep the kernel within 2e-6 of
// the plain PyTorch version, and fast math may drop the isfinite checks the
// clamp and the detector rely on.  --fmad=false keeps each product rounded
// on its own, as the plain version's separate tensor operations do; it is
// also what makes kernel 1 (+ the PyTorch epilogue) and kernel 2 bitwise
// equal.

#include "sq_rng.cuh"

// Mirrors ChainParams in stochquant_tpu_torch/kernels/chain_kernel.py: every
// field is 4 bytes, so the two layouts agree without padding rules.
struct ChainParams {
    int32_t n_chains;     // chains in this launch (one block each)
    int32_t n_sites;      // N
    int32_t threads;      // T, block size (multiple of 32, <= 512)
    int32_t sites_per_thread;  // ceil(N / T), one of 1, 2, 4, 8
    int32_t rounds;       // Threefry rounds: 20 or 13
    int32_t philox;       // 1: Philox-4x32-10 (rng_impl='hardware') instead of Threefry
    int32_t loops;        // micro-steps per frame
    int32_t n_frames;     // K (kernel 2)
    uint32_t seed;
    uint32_t step0;       // micro-step counter at the first frame
    uint32_t chain0;      // global id of this launch's first chain
    int32_t bc;           // 0 PERIODIC, 1 FIXED_BG, 2 DIRICHLET
    int32_t background;   // BACKGROUND formulation
    int32_t has_zm;       // collective coordinate updated (Parisi trick)
    int32_t heun;         // stochastic Heun instead of Euler-Maruyama
    int32_t action;       // 0 harmonic, 1 double_well, 2 anharmonic, 3 poeschl_teller
    int32_t grow_after;
    int32_t has_dtau_max;
    float p0, p1, p2, p3; // action constants (see _action_constants)
    float xcl_w, xcl_eta; // double-well kink: eta * tanh(w * (t - omega))
    float dt, inv_dt2, c_amp, zm_c, clamp, upper, asym_l, asym_r;
    float t_right;        // float32(N * dt), the right ghost's time
    float shrink, dtau_max, inv_loops, loops_f;
};

#define SQ_MAX_THREADS 512
// Register caps of the Philox variants (a group of four normals per site stays
// live where Threefry keeps two): uncapped, kernel 1 at one site per thread
// took 58 registers against Threefry's 40 and kernel 2 at two sites 101
// against 64, so fewer blocks stayed resident on an SM.  The Threefry
// variants stay uncapped: a minimum of 0 blocks reads as none given, whereas
// an explicit 1 made ptxas spend more registers on them (40 -> 59 in kernel 1).
#define SQ_K1_BOUNDS(SPT, GEN) \
    __launch_bounds__(SQ_MAX_THREADS, (GEN::PHILOX && (SPT) == 1) ? 3 : 0)
#define SQ_K2_BOUNDS(SPT, GEN) \
    __launch_bounds__(SQ_MAX_THREADS, (GEN::PHILOX && (SPT) <= 2) ? 2 : 0)

enum { BC_PERIODIC = 0, BC_FIXED_BG = 1, BC_DIRICHLET = 2 };

// ---- actions (stochquant_tpu/actions/quantum_mechanics.py) ----------------

__device__ __forceinline__ float x_cl(const ChainParams& p, float t, float om) {
    if (p.action == 1) return p.xcl_eta * tanhf(p.xcl_w * (t - om));
    return 0.0f;
}

__device__ __forceinline__ float dV(const ChainParams& p, float x) {
    switch (p.action) {
        case 0: return p.p0 * x;                                   // k*x
        case 1: return p.p0 * x * (x * x - p.p2) / p.p3;           // 4v0 x (x^2-e2)/e2^2
        case 2: return p.p0 * x + p.p1 * x * x * x;                // mu2 x + 4 lam x^3
        default: {                                                 // 2 v0 s / (a c^3)
            const float u = x / p.p1;
            const float c = coshf(u);
            return p.p2 * sinhf(u) / (c * c * c);
        }
    }
}

__device__ __forceinline__ float ddV(const ChainParams& p, float x) {
    switch (p.action) {
        case 0: return p.p0;                                       // k
        case 1: return (p.p1 * x * x / p.p2 - p.p0) / p.p2;        // (12v0 x^2/e2 - 4v0)/e2
        case 2: return p.p0 + p.p2 * x * x;                        // mu2 + 12 lam x^2
        default: {                                                 // 2v0/a^2 (1-2s^2)/c^4
            const float u = x / p.p1;
            const float c = coshf(u);
            const float s = sinhf(u);
            return p.p3 * (1.0f - 2.0f * s * s) / (c * c * c * c);
        }
    }
}

__device__ __forceinline__ float reflect(float om, float upper) {
    om = om > upper ? 2.0f * upper - om : om;
    return om < 0.0f ? -om : om;
}

// ---- one frame ------------------------------------------------------------

// Per-thread slice of one chain: sites tid + k*T for k < SPT.
template <int SPT>
struct Sites {
    float f[SPT];
    float xs[SPT], xxs[SPT], x2s[SPT], x4s[SPT];
};

// Block-uniform per-chain scalars.
struct ChainScalars {
    float om, lrg, dtau;
    int unstable;
};

struct Shared {
    float* f;       // [N] current field, for the neighbour reads
    float* fp;      // [N] Heun predictor
    float* red;     // [2 * 32] per-warp detector partials
    float* misc;    // [0] x_mid, [1..4] omega noise of the group in flight
};

__device__ __forceinline__ float block_max_pair(float& a, float& b, float* red) {
    // max over the block of a and b; every thread returns with both maxima.
    #pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, off));
        b = fmaxf(b, __shfl_xor_sync(0xffffffffu, b, off));
    }
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (lane == 0) {
        red[warp] = a;
        red[32 + warp] = b;
    }
    __syncthreads();
    const int nw = blockDim.x >> 5;
    a = red[0];
    b = red[32];
    for (int w = 1; w < nw; ++w) {
        a = fmaxf(a, red[w]);
        b = fmaxf(b, red[32 + w]);
    }
    return a;
}

// f_{i+1} + f_{i-1} with the boundary condition's partners at the edges.
__device__ __forceinline__ float neighbor_sum(const ChainParams& p, const float* sf, int i,
                                              float gl, float gr) {
    const int N = p.n_sites;
    float up, down;
    if (i == N - 1) up = p.bc == BC_PERIODIC ? sf[0] : gr;
    else up = sf[i + 1];
    if (i == 0) down = p.bc == BC_PERIODIC ? sf[N - 1] : gl;
    else down = sf[i - 1];
    return up + down;
}

// One micro-step of a chain that is not frozen (the caller checks).
template <int SPT>
__device__ void substep(const ChainParams& p, Sites<SPT>& s, ChainScalars& c,
                        const float (&eta)[SPT], int om_slot, float noise_amp,
                        float om_amp, const Shared& sh) {
    const int N = p.n_sites, T = blockDim.x, tid = threadIdx.x, mid = N / 2;
    float bg[SPT], ddv[SPT];
    float gl = 0.0f, gr = 0.0f;
    #pragma unroll
    for (int k = 0; k < SPT; ++k) {
        const int i = tid + k * T;
        bg[k] = 0.0f;
        ddv[k] = 0.0f;
        if (i < N) {
            if (p.background) {
                bg[k] = x_cl(p, (float)i * p.dt, c.om);
                ddv[k] = ddV(p, bg[k]);
            }
            sh.f[i] = s.f[k];
            if (i == mid) sh.misc[0] = s.f[k] + bg[k];
            if (p.bc == BC_FIXED_BG && (i == 0 || i == N - 1)) {
                if (p.background) {
                    gl = p.asym_l - x_cl(p, -p.dt, c.om);
                    gr = p.asym_r - x_cl(p, p.t_right, c.om);
                } else {
                    gl = p.asym_l;
                    gr = p.asym_r;
                }
            }
        }
    }
    __syncthreads();
    const float x_mid = sh.misc[0];
    const float eta_om = p.has_zm ? sh.misc[1 + om_slot] : 0.0f;

    float det[SPT];
    #pragma unroll
    for (int k = 0; k < SPT; ++k) {
        const int i = tid + k * T;
        det[k] = 0.0f;
        if (i < N) {
            const float f = s.f[k];
            const float lap = (neighbor_sum(p, sh.f, i, gl, gr) - 2.0f * f) * p.inv_dt2;
            det[k] = p.background ? lap - ddv[k] * f : lap - dV(p, f);
        }
    }
    if (p.heun) {
        #pragma unroll
        for (int k = 0; k < SPT; ++k) {
            const int i = tid + k * T;
            if (i < N) sh.fp[i] = s.f[k] + c.dtau * det[k] + noise_amp * eta[k];
        }
        __syncthreads();
        #pragma unroll
        for (int k = 0; k < SPT; ++k) {
            const int i = tid + k * T;
            if (i < N) {
                const float fp = sh.fp[i];
                const float lap = (neighbor_sum(p, sh.fp, i, gl, gr) - 2.0f * fp) * p.inv_dt2;
                const float f2 = p.background ? lap - ddv[k] * fp : lap - dV(p, fp);
                det[k] = 0.5f * c.dtau * (det[k] + f2);
            }
        }
    } else {
        #pragma unroll
        for (int k = 0; k < SPT; ++k) det[k] = det[k] * c.dtau;
    }

    float max_det = 0.0f, max_x = 0.0f;
    #pragma unroll
    for (int k = 0; k < SPT; ++k) {
        const int i = tid + k * T;
        if (i < N) {
            const float f = s.f[k];
            const float new_raw = f + det[k] + noise_amp * eta[k];
            const bool finite = isfinite(new_raw);
            float newf = fminf(fmaxf(new_raw, -p.clamp), p.clamp);
            if (!finite) newf = p.clamp;
            if (p.bc == BC_DIRICHLET && (i == 0 || i == N - 1)) newf = 0.0f;
            max_det = fmaxf(max_det, finite ? fabsf(det[k]) : INFINITY);
            max_x = fmaxf(max_x, fabsf(newf + bg[k]));
            // observables sample the pre-update field
            const float x = f + bg[k];
            const float x2 = x * x;
            s.xs[k] = s.xs[k] + x;
            s.xxs[k] = s.xxs[k] + x * x_mid;
            s.x2s[k] = s.x2s[k] + x2;
            s.x4s[k] = s.x4s[k] + x2 * x2;
            s.f[k] = newf;
        }
    }
    block_max_pair(max_det, max_x, sh.red);
    const bool tripped = max_det > c.lrg;
    c.lrg = fmaxf(c.lrg, max_x);
    if (p.has_zm) c.om = reflect(c.om + om_amp * eta_om, p.upper);
    c.unstable = tripped;
}

// `loops` micro-steps starting at counter step0; leaves a tripped chain frozen.
// Threefry: one evaluation per site and pair of micro-steps, an odd last step
// taking the first output of its own evaluation.
template <int SPT, class GEN>
__device__ void run_frame(const ChainParams& p, Sites<SPT>& s, ChainScalars& c,
                          uint32_t step0, const Shared& sh) {
    const int N = p.n_sites, T = blockDim.x, tid = threadIdx.x;
    const uint32_t chain = p.chain0 + blockIdx.x;
    const uint32_t k1_field = (uint32_t)STREAM_FIELD ^ (chain << 8);
    const float noise_amp = p.c_amp * sqrtf(2.0f * c.dtau / p.dt);
    const float om_amp = p.zm_c * sqrtf(2.0f * c.dtau);
    if constexpr (!GEN::PHILOX) {
        constexpr int ROUNDS = GEN::N_ROUNDS;
        const uint32_t k1_om = (uint32_t)STREAM_COLLECTIVE ^ (chain << 8);
        float e0[SPT], e1[SPT];
        const int pairs = p.loops / 2;
        for (int k = 0; k <= pairs; ++k) {
            const bool tail = k == pairs;
            if (c.unstable || (tail && p.loops % 2 == 0)) break;  // block-uniform
            const uint32_t step = tail ? step0 + (uint32_t)(p.loops - 1) : step0 + 2u * (uint32_t)k;
            if (p.has_zm && tid == 0) normal_pair<ROUNDS>(p.seed, k1_om, 0u, step, sh.misc[1], sh.misc[2]);
            #pragma unroll
            for (int j = 0; j < SPT; ++j) {
                const int i = tid + j * T;
                if (i < N) normal_pair<ROUNDS>(p.seed, k1_field, (uint32_t)i, step, e0[j], e1[j]);
                else e0[j] = e1[j] = 0.0f;
            }
            substep<SPT>(p, s, c, e0, 0, noise_amp, om_amp, sh);
            if (tail || c.unstable) continue;
            substep<SPT>(p, s, c, e1, 1, noise_amp, om_amp, sh);
        }
    } else {
        // Philox: groups of GEN::STEPS micro-steps from one evaluation per site,
        // counted from step0; a short last group drops the rest.  omega draws
        // site N of the chain's own stream.
        constexpr int G = GEN::STEPS;
        float e[G][SPT];
        for (int s0 = 0; s0 < p.loops; s0 += G) {
            if (c.unstable) break;  // block-uniform
            const uint32_t step = step0 + (uint32_t)s0;
            if (p.has_zm && tid == 0) {
                float z[G];
                GEN::draw(p.seed, k1_field, (uint32_t)N, step, z);
                #pragma unroll
                for (int g = 0; g < G; ++g) sh.misc[1 + g] = z[g];
            }
            #pragma unroll
            for (int j = 0; j < SPT; ++j) {
                const int i = tid + j * T;
                float z[G];
                #pragma unroll
                for (int g = 0; g < G; ++g) z[g] = 0.0f;
                if (i < N) GEN::draw(p.seed, k1_field, (uint32_t)i, step, z);
                #pragma unroll
                for (int g = 0; g < G; ++g) e[g][j] = z[g];
            }
            #pragma unroll
            for (int g = 0; g < G; ++g) {
                if (s0 + g < p.loops && !c.unstable)
                    substep<SPT>(p, s, c, e[g], g, noise_amp, om_amp, sh);
            }
        }
    }
}

__device__ __forceinline__ Shared carve_shared(int n_sites) {
    extern __shared__ float smem[];
    Shared sh;
    sh.red = smem;
    sh.misc = smem + 64;
    sh.f = smem + 72;
    sh.fp = sh.f + n_sites;
    return sh;
}

// ---- kernel 1: one frame, frame sums out ----------------------------------

template <int SPT, class GEN>
__global__ void SQ_K1_BOUNDS(SPT, GEN)
chain_frame_kernel(ChainParams p, const float* __restrict__ f_in,
                   const float* __restrict__ om_in, const float* __restrict__ lrg_in,
                   const float* __restrict__ dtau_in, float* __restrict__ f_out,
                   float* __restrict__ om_out, float* __restrict__ xs_out,
                   float* __restrict__ xxs_out, float* __restrict__ x2s_out,
                   float* __restrict__ x4s_out, float* __restrict__ lrg_out,
                   int32_t* __restrict__ unst_out) {
    const int N = p.n_sites, T = blockDim.x, tid = threadIdx.x;
    const size_t row = (size_t)blockIdx.x * (size_t)N;
    const Shared sh = carve_shared(N);
    Sites<SPT> s;
    #pragma unroll
    for (int k = 0; k < SPT; ++k) {
        const int i = tid + k * T;
        s.f[k] = i < N ? f_in[row + i] : 0.0f;
        s.xs[k] = s.xxs[k] = s.x2s[k] = s.x4s[k] = 0.0f;
    }
    ChainScalars c;
    c.om = om_in[blockIdx.x];
    c.lrg = lrg_in[blockIdx.x];
    c.dtau = dtau_in[blockIdx.x];
    c.unstable = 0;
    run_frame<SPT, GEN>(p, s, c, p.step0, sh);
    #pragma unroll
    for (int k = 0; k < SPT; ++k) {
        const int i = tid + k * T;
        if (i < N) {
            f_out[row + i] = s.f[k];
            xs_out[row + i] = s.xs[k];
            xxs_out[row + i] = s.xxs[k];
            x2s_out[row + i] = s.x2s[k];
            x4s_out[row + i] = s.x4s[k];
        }
    }
    if (tid == 0) {
        om_out[blockIdx.x] = c.om;
        lrg_out[blockIdx.x] = c.lrg;
        unst_out[blockIdx.x] = c.unstable;
    }
}

// ---- kernel 2: K frames, epilogue in-kernel --------------------------------

template <int SPT, class GEN>
__global__ void SQ_K2_BOUNDS(SPT, GEN)
chain_frames_kernel(ChainParams p, const float* __restrict__ f_in,
                    const float* __restrict__ om_in, const float* __restrict__ lrg_in,
                    const float* __restrict__ dtau_in, const float* __restrict__ xm_in,
                    const float* __restrict__ xxm_in, const float* __restrict__ x2m_in,
                    const float* __restrict__ x4m_in, const int64_t* __restrict__ runs_in,
                    const int32_t* __restrict__ stab_in, float* __restrict__ f_out,
                    float* __restrict__ om_out, float* __restrict__ lrg_out,
                    float* __restrict__ dtau_out, float* __restrict__ xm_out,
                    float* __restrict__ xxm_out, float* __restrict__ x2m_out,
                    float* __restrict__ x4m_out, int64_t* __restrict__ runs_out,
                    int32_t* __restrict__ stab_out, int32_t* __restrict__ hist_stable,
                    float* __restrict__ hist_dtau, float* __restrict__ hist_lrg) {
    const int N = p.n_sites, T = blockDim.x, tid = threadIdx.x;
    const int C = p.n_chains, ch = blockIdx.x;
    const size_t row = (size_t)ch * (size_t)N;
    const Shared sh = carve_shared(N);
    Sites<SPT> s;
    float xm[SPT], xxm[SPT], x2m[SPT], x4m[SPT], f_snap[SPT];
    #pragma unroll
    for (int k = 0; k < SPT; ++k) {
        const int i = tid + k * T;
        const bool ok = i < N;
        s.f[k] = ok ? f_in[row + i] : 0.0f;
        xm[k] = ok ? xm_in[row + i] : 0.0f;
        xxm[k] = ok ? xxm_in[row + i] : 0.0f;
        x2m[k] = ok ? x2m_in[row + i] : 0.0f;
        x4m[k] = ok ? x4m_in[row + i] : 0.0f;
    }
    ChainScalars c;
    c.om = om_in[ch];
    c.lrg = lrg_in[ch];
    c.dtau = dtau_in[ch];
    uint32_t lo = (uint32_t)runs_in[2 * ch], hi = (uint32_t)runs_in[2 * ch + 1];
    int32_t stab = stab_in[ch];
    const uint32_t loops_u = (uint32_t)p.loops;

    for (int j = 0; j < p.n_frames; ++j) {
        #pragma unroll
        for (int k = 0; k < SPT; ++k) {
            f_snap[k] = s.f[k];
            s.xs[k] = s.xxs[k] = s.x2s[k] = s.x4s[k] = 0.0f;
        }
        const float om_snap = c.om, lrg_snap = c.lrg;
        c.unstable = 0;
        run_frame<SPT, GEN>(p, s, c, p.step0 + (uint32_t)j * loops_u, sh);

        // epilogue: stochquant_tpu/integrators/langevin.py frame epilogue and
        // accum.merge_frame_sum, expression for expression
        const bool accept = !c.unstable;
        const uint32_t lo_n = lo + loops_u;
        const uint32_t hi_n = hi + (lo_n < lo ? 1u : 0u);
        const float n_new = __uint2float_rn(hi_n) * 4294967296.0f + __uint2float_rn(lo_n);
        const float w = p.loops_f / n_new;
        if (accept) {
            #pragma unroll
            for (int k = 0; k < SPT; ++k) {
                xm[k] = xm[k] + (s.xs[k] * p.inv_loops - xm[k]) * w;
                xxm[k] = xxm[k] + (s.xxs[k] * p.inv_loops - xxm[k]) * w;
                x2m[k] = x2m[k] + (s.x2s[k] * p.inv_loops - x2m[k]) * w;
                x4m[k] = x4m[k] + (s.x4s[k] * p.inv_loops - x4m[k]) * w;
            }
            lo = lo_n;
            hi = hi_n;
        } else {
            #pragma unroll
            for (int k = 0; k < SPT; ++k) s.f[k] = f_snap[k];
            c.om = om_snap;
            c.lrg = lrg_snap;
        }
        const bool grow = accept && stab >= p.grow_after;
        float dtau = grow ? c.dtau / p.shrink : (accept ? c.dtau : c.dtau * p.shrink);
        if (p.has_dtau_max) dtau = fminf(dtau, p.dtau_max);
        c.dtau = dtau;
        stab = accept ? (grow ? 0 : stab + 1) : 0;
        if (tid == 0) {
            hist_stable[(size_t)j * C + ch] = accept ? 1 : 0;
            hist_dtau[(size_t)j * C + ch] = c.dtau;
            hist_lrg[(size_t)j * C + ch] = c.lrg;
        }
    }

    #pragma unroll
    for (int k = 0; k < SPT; ++k) {
        const int i = tid + k * T;
        if (i < N) {
            f_out[row + i] = s.f[k];
            xm_out[row + i] = xm[k];
            xxm_out[row + i] = xxm[k];
            x2m_out[row + i] = x2m[k];
            x4m_out[row + i] = x4m[k];
        }
    }
    if (tid == 0) {
        om_out[ch] = c.om;
        lrg_out[ch] = c.lrg;
        dtau_out[ch] = c.dtau;
        runs_out[2 * ch] = (int64_t)lo;
        runs_out[2 * ch + 1] = (int64_t)hi;
        stab_out[ch] = stab;
    }
}

// ---- C entry points (loaded with ctypes) ----------------------------------

static size_t shared_bytes(const ChainParams& p) {
    return (size_t)(72 + 2 * p.n_sites) * sizeof(float);
}

static bool valid_launch(const ChainParams& p) {
    return p.n_chains > 0 && p.threads > 0 && p.threads <= SQ_MAX_THREADS &&
           p.threads % 32 == 0 && (long)p.threads * p.sites_per_thread >= p.n_sites &&
           (p.rounds == 20 || p.rounds == 13) && (p.philox == 0 || p.philox == 1) &&
           p.n_sites >= 2 && p.loops >= 1;
}

// The dispatch key: sites per thread, then the generator (Threefry's round
// count, or 10 for Philox-4x32-10).
#define SQ_CASE(KERNEL, SPT, TAG, GEN, ...)                                        \
    case SPT * 100 + TAG:                                                          \
        KERNEL<SPT, GEN><<<grid, block, smem, st>>>(*p, __VA_ARGS__);              \
        break;
#define SQ_CASES(KERNEL, SPT, ...)                                                 \
    SQ_CASE(KERNEL, SPT, 20, Threefry20, __VA_ARGS__)                              \
    SQ_CASE(KERNEL, SPT, 13, Threefry13, __VA_ARGS__)                              \
    SQ_CASE(KERNEL, SPT, 10, PhiloxNoise, __VA_ARGS__)
#define SQ_DISPATCH(KERNEL, ...)                                                   \
    do {                                                                           \
        const dim3 grid(p->n_chains), block(p->threads);                           \
        const size_t smem = shared_bytes(*p);                                      \
        cudaStream_t st = (cudaStream_t)stream;                                    \
        const int key = p->sites_per_thread * 100 + (p->philox ? 10 : p->rounds);  \
        switch (key) {                                                             \
            SQ_CASES(KERNEL, 1, __VA_ARGS__)                                       \
            SQ_CASES(KERNEL, 2, __VA_ARGS__)                                       \
            SQ_CASES(KERNEL, 4, __VA_ARGS__)                                       \
            SQ_CASES(KERNEL, 8, __VA_ARGS__)                                       \
            default: return (int)cudaErrorInvalidValue;                            \
        }                                                                          \
    } while (0)

extern "C" int sq_chain_frame(const ChainParams* p, const float* f_in, const float* om_in,
                              const float* lrg_in, const float* dtau_in, float* f_out,
                              float* om_out, float* xs, float* xxs, float* x2s, float* x4s,
                              float* lrg_out, int32_t* unst_out, void* stream) {
    if (!valid_launch(*p)) return (int)cudaErrorInvalidValue;
    SQ_DISPATCH(chain_frame_kernel, f_in, om_in, lrg_in, dtau_in, f_out, om_out, xs, xxs,
                x2s, x4s, lrg_out, unst_out);
    return (int)cudaGetLastError();
}

extern "C" int sq_chain_frames(const ChainParams* p, const float* f_in, const float* om_in,
                               const float* lrg_in, const float* dtau_in, const float* xm_in,
                               const float* xxm_in, const float* x2m_in, const float* x4m_in,
                               const int64_t* runs_in, const int32_t* stab_in, float* f_out,
                               float* om_out, float* lrg_out, float* dtau_out, float* xm_out,
                               float* xxm_out, float* x2m_out, float* x4m_out,
                               int64_t* runs_out, int32_t* stab_out, int32_t* hist_stable,
                               float* hist_dtau, float* hist_lrg, void* stream) {
    if (!valid_launch(*p) || p->n_frames < 1) return (int)cudaErrorInvalidValue;
    SQ_DISPATCH(chain_frames_kernel, f_in, om_in, lrg_in, dtau_in, xm_in, xxm_in, x2m_in,
                x4m_in, runs_in, stab_in, f_out, om_out, lrg_out, dtau_out, xm_out, xxm_out,
                x2m_out, x4m_out, runs_out, stab_out, hist_stable, hist_dtau, hist_lrg);
    return (int)cudaGetLastError();
}

extern "C" const char* sq_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

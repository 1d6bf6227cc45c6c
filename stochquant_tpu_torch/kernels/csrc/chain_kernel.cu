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
// What bounds it on the card: arithmetic and latency, not memory.  The state
// is read once and written once per launch; in between every site-update
// spends about ten Threefry-2x32 rounds of 32-bit integer work (20 or 13
// rounds per pair of micro-steps), half a Box-Muller (logf, sqrtf, sinf, cosf
// per pair), one tanhf for the kink background (BACKGROUND formulation) and
// ~30 float ops of drift, clamp, detector and observable sums.  At the
// headline shape (65536 chains x 200 sites x 1000 micro-steps) that is ~1e13
// integer and float operations per frame against ~2e8 bytes.  Every
// micro-step of a chain also needs its neighbours' new values and the
// chain-wide detector maxima before the next one can start, so the exchange
// between the threads of a chain sets the pace as much as the arithmetic.
//
// What the design does about it: a chain lives in a group of G warps, and
// each lane holds S contiguous sites (thread t = 32 w + lane of the group
// holds sites t S ... t S + S - 1), so the chain's field, its four frame sums
// and (kernel 2) its running means stay in registers for the whole launch and
// the S sites' noise draws interleave as independent work.  Only a lane's
// first and last site need a partner: one __shfl_up_sync / __shfl_down_sync
// each.  The collective coordinate's noise is the layout's site N: the thread
// whose range reaches N draws it in that slot, in the same straight-line draw
// as the field noise, and the geometry always leaves that slot free
// (32 G S >= N + 1), so no lane with a full share draws it.  Per micro-step
// the chain makes one exchange, with the detector folded into it: a vote for
// the trip (max |det| > lrg over the chain is any lane's local max > lrg) and
// a redux.sync max over the bit patterns of max |x| (order-preserving for
// non-negative floats, and NaN above +inf, so the max propagates NaN as
// torch.maximum does).  At G = 1 (one chain per warp, several warps per
// block) that exchange is shuffles, a vote and a redux: no barrier, no shared
// memory.  At G > 1 (one chain per block) each warp writes its edge values,
// its trip flag and its max into a shared buffer double-buffered by step
// parity; one barrier, then lane l < G reads warp l's partials and the warp
// reduces them with one vote and one redux (no serial loop over partials).
// Heun adds its predictor's edge exchange (shuffles, or one more barrier).
// The generator is a template parameter (sq_rng.cuh: Threefry-2x32 at 20 or
// 13 rounds, one evaluation per site and two micro-steps; or Philox-4x32-10
// for rng_impl='hardware', one per site and four micro-steps), so the rounds
// unroll into straight-line integer code; so is S, whose three ranges are
// compiled in three translation units in parallel.  launch_geometry in
// stochquant_tpu_torch/kernels/chain_kernel.py picks (G, S, chains per block)
// from the registers each S is given and the chains that then stay resident:
// on the card the layouts with few sites a lane and many threads won (the
// headline: G = 4, S = 2; config 2: G = 11, S = 3), since a lane's S sites
// are updated one after the other and the registers of S > 3 spill.
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
// at any layout, resumable at any frame boundary, and fresh for a rejected
// frame's retry (the counter advances by `loops` regardless).
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
// equal.  The per-site sums keep their order, and the maxima are order-free,
// so the layout changes no result.

#include "sq_rng.cuh"

// Mirrors ChainParams in stochquant_tpu_torch/kernels/_build.py: every field
// is 4 bytes, so the two layouts agree without padding rules.
struct ChainParams {
    int32_t n_chains;     // chains in this launch
    int32_t n_sites;      // N
    int32_t warps_per_chain;   // G: 1, or one chain per block of G <= 32 warps
    int32_t sites_per_lane;    // S, 1 .. 7, with 32 G S >= N + 1
    int32_t chains_per_block;  // warps of a block at G = 1; 1 at G > 1
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

#define SQ_MAX_WARPS 32        // G <= 32 warps a chain
#define SQ_MAX_SPL 7           // S <= 7
#define SQ_FULL 0xffffffffu
// The most threads a block may hold at S sites a lane, and so (65,536 / that)
// the registers a thread may use: 64 at S <= 2, 80 at S <= 4, 96 beyond.
// Enough for 4096 + 1 slots at S = 7 (640 threads).
#define SQ_MAX_THREADS(S) ((S) <= 2 ? 1024 : (S) <= 4 ? 768 : 640)

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

// NaN-propagating max, as torch.maximum
__device__ __forceinline__ float nan_max(float a, float b) { return (a > b || isnan(a)) ? a : b; }

// ---- layout ----------------------------------------------------------------

// Where a thread sits in its chain: its slots hold sites base + j.  The
// special sites (mid, N - 1, and N: the collective coordinate's noise) sit
// in slot j_* of thread t_*; those six are the same for every thread.
struct Lane {
    int t, lane, w;        // thread of the chain's group, its lane and warp
    int base;              // t * S
    int t_mid, t_last, t_om;
    int j_mid, j_last, j_om;
};

template <int S>
__device__ __forceinline__ Lane make_lane(const ChainParams& p, int t) {
    const int N = p.n_sites, mid = N / 2;
    Lane L;
    L.t = t;
    L.lane = t & 31;
    L.w = t >> 5;
    L.base = t * S;
    L.j_mid = mid % S;
    L.j_last = (N - 1) % S;
    L.j_om = N % S;
    L.t_mid = mid / S;
    L.t_last = (N - 1) / S;
    L.t_om = N / S;
    return L;
}

// Per-thread slice of one chain: sites base + j for j < S (those < N).
template <int S>
struct Sites {
    float f[S];
    float xs[S], xxs[S], x2s[S], x4s[S];
};

// Chain-uniform scalars (warp-uniform at G = 1, block-uniform at G > 1).
struct ChainScalars {
    float om, lrg, dtau;
    int unstable;
};

// G > 1: the per-step exchange between the warps of a chain, double-buffered
// by the parity of the exchange counter; the Heun predictor's edges.
struct Xbuf {
    float lo[2][SQ_MAX_WARPS];       // each warp's first site
    float hi[2][SQ_MAX_WARPS];       // each warp's last slot (lane 31, slot S - 1)
    uint32_t mx[2][SQ_MAX_WARPS];    // bits of each warp's max |x_new|
    int32_t trip[2][SQ_MAX_WARPS];   // each warp's vote: some |det| > lrg
    float fend[2], fmid[2], eta[2];  // site N - 1, site mid, the collective noise
    float plo[SQ_MAX_WARPS], phi[SQ_MAX_WARPS], pend;  // Heun predictor
};

// The value of v at slot j (a runtime index into a register array).
template <int S>
__device__ __forceinline__ float pick(const float (&v)[S], int j) {
    float out = v[0];
    #pragma unroll
    for (int k = 1; k < S; ++k) if (k == j) out = v[k];
    return out;
}

// Write the edge values of v (the field, or the Heun predictor) that the
// other warps of the chain read: lo/hi of this warp and the chain's last site.
template <int S>
__device__ __forceinline__ void post_edges(const Lane& L, const float (&v)[S], float* lo,
                                           float* hi, float* end) {
    if (L.lane == 0) lo[L.w] = v[0];
    if (L.lane == 31) hi[L.w] = v[S - 1];
    if (L.t == L.t_last) *end = pick<S>(v, L.j_last);
}

// The partners of a thread's first and last slot: `left` of slot 0, `right`
// of slot S - 1, and `right_end`, the right partner of site N - 1 (used by
// the slot that holds it).  gl, gr: the FIXED_BG / DIRICHLET ghosts.  At
// G > 1, lo / hi / end are the posted edges of v (after a barrier).
template <int S>
__device__ __forceinline__ void partners(const ChainParams& p, const Lane& L, const float (&v)[S],
                                         float gl, float gr, const float* lo, const float* hi,
                                         const float* end, float& left, float& right,
                                         float& right_end) {
    const bool periodic = p.bc == BC_PERIODIC;
    left = __shfl_up_sync(SQ_FULL, v[S - 1], 1);
    right = __shfl_down_sync(SQ_FULL, v[0], 1);
    if (p.warps_per_chain == 1) {
        if (periodic) {
            const float wrap_l = __shfl_sync(SQ_FULL, pick<S>(v, L.j_last), L.t_last);
            right_end = __shfl_sync(SQ_FULL, v[0], 0);
            if (L.t == 0) left = wrap_l;
        } else {
            right_end = gr;
            if (L.t == 0) left = gl;
        }
    } else {
        if (L.lane == 0) left = L.w == 0 ? (periodic ? *end : gl) : hi[L.w - 1];
        if (L.lane == 31 && L.w + 1 < p.warps_per_chain) right = lo[L.w + 1];
        right_end = periodic ? lo[0] : gr;
    }
}

// ---- one micro-step ---------------------------------------------------------

// Laplacian drift of v at every slot (0 where the slot holds no site).
template <int S>
__device__ __forceinline__ void drift(const ChainParams& p, const Lane& L, const float (&v)[S],
                                      const float (&ddv)[S], float left, float right,
                                      float right_end, float (&out)[S]) {
    const int N = p.n_sites;
    #pragma unroll
    for (int k = 0; k < S; ++k) {
        const int i = L.base + k;
        out[k] = 0.0f;
        if (i < N) {
            const float down = k == 0 ? left : v[k - 1];
            float up = k == S - 1 ? right : v[k + 1];
            if (L.t == L.t_last && k == L.j_last) up = right_end;
            const float lap = (up + down - 2.0f * v[k]) * p.inv_dt2;
            out[k] = p.background ? lap - ddv[k] * v[k] : lap - dV(p, v[k]);
        }
    }
}

// One micro-step of a chain that is not frozen (the caller checks).  eta:
// this step's field noise per slot; om_own: the collective coordinate's noise
// in the thread that drew it (slot j_om).  ex counts the exchanges at G > 1.
template <int S>
__device__ void substep(const ChainParams& p, const Lane& L, Sites<S>& s, ChainScalars& c,
                        const float (&eta)[S], float om_own, float noise_amp, float om_amp,
                        Xbuf& xb, int& ex) {
    const int N = p.n_sites, mid = N / 2;
    const bool wide = p.warps_per_chain > 1;
    const int cur = ex & 1;
    float bg[S], ddv[S];
    float xm = 0.0f;
    #pragma unroll
    for (int k = 0; k < S; ++k) {
        const int i = L.base + k;
        bg[k] = 0.0f;
        ddv[k] = 0.0f;
        if (i < N && p.background) {
            bg[k] = x_cl(p, (float)i * p.dt, c.om);
            ddv[k] = ddV(p, bg[k]);
        }
        if (k == L.j_mid) xm = s.f[k] + bg[k];  // used from thread t_mid
    }
    float x_mid;
    if (wide) {
        x_mid = xb.fmid[cur];
        if (p.background) x_mid = x_mid + x_cl(p, (float)mid * p.dt, c.om);
    } else {
        x_mid = __shfl_sync(SQ_FULL, xm, L.t_mid);
    }
    float gl = 0.0f, gr = 0.0f;
    if (p.bc == BC_FIXED_BG && (L.t == 0 || L.t == L.t_last)) {
        // the lane of site 0 needs the left ghost, that of site N - 1 the right
        // one (both when one lane holds the chain)
        if (p.background) {
            if (L.t == 0) gl = p.asym_l - x_cl(p, -p.dt, c.om);
            if (L.t == L.t_last) gr = p.asym_r - x_cl(p, p.t_right, c.om);
        } else {
            gl = p.asym_l;
            gr = p.asym_r;
        }
    }

    float left, right, right_end;
    partners<S>(p, L, s.f, gl, gr, xb.lo[cur], xb.hi[cur], &xb.fend[cur], left, right, right_end);
    float det[S];
    drift<S>(p, L, s.f, ddv, left, right, right_end, det);
    if (p.heun) {
        float fp[S], f2[S];
        #pragma unroll
        for (int k = 0; k < S; ++k) fp[k] = s.f[k] + c.dtau * det[k] + noise_amp * eta[k];
        if (wide) {
            post_edges<S>(L, fp, xb.plo, xb.phi, &xb.pend);
            __syncthreads();
        }
        partners<S>(p, L, fp, gl, gr, xb.plo, xb.phi, &xb.pend, left, right, right_end);
        drift<S>(p, L, fp, ddv, left, right, right_end, f2);
        #pragma unroll
        for (int k = 0; k < S; ++k) det[k] = 0.5f * c.dtau * (det[k] + f2[k]);
        // the predictor buffer is rewritten only after the step's exchange
        // barrier, which every reader of it has passed
    } else {
        #pragma unroll
        for (int k = 0; k < S; ++k) det[k] = det[k] * c.dtau;
    }

    float max_det = 0.0f;
    uint32_t max_x = 0u;  // bits of max |x_new|: ordered as the floats, NaN on top
    #pragma unroll
    for (int k = 0; k < S; ++k) {
        const int i = L.base + k;
        if (i < N) {
            const float f = s.f[k];
            const float new_raw = f + det[k] + noise_amp * eta[k];
            const bool finite = isfinite(new_raw);
            float newf = fminf(fmaxf(new_raw, -p.clamp), p.clamp);
            if (!finite) newf = p.clamp;
            if (p.bc == BC_DIRICHLET && (i == 0 || i == N - 1)) newf = 0.0f;
            max_det = fmaxf(max_det, finite ? fabsf(det[k]) : INFINITY);  // never NaN
            max_x = max(max_x, __float_as_uint(fabsf(newf + bg[k])));
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

    // the exchange: max |det| > lrg over the chain is a vote, max |x_new| a redux
    bool tripped = __any_sync(SQ_FULL, max_det > c.lrg);
    uint32_t mx = __reduce_max_sync(SQ_FULL, max_x);
    float eta_om;
    if (wide) {
        const int nxt = cur ^ 1;
        post_edges<S>(L, s.f, xb.lo[nxt], xb.hi[nxt], &xb.fend[nxt]);
        if (L.lane == 0) {
            xb.trip[nxt][L.w] = tripped;
            xb.mx[nxt][L.w] = mx;
        }
        if (L.t == L.t_mid) xb.fmid[nxt] = pick<S>(s.f, L.j_mid);
        if (L.t == L.t_om) xb.eta[nxt] = om_own;
        __syncthreads();
        const bool here = L.lane < p.warps_per_chain;
        tripped = __any_sync(SQ_FULL, here && xb.trip[nxt][L.lane]);
        mx = __reduce_max_sync(SQ_FULL, here ? xb.mx[nxt][L.lane] : 0u);
        eta_om = xb.eta[nxt];
        ex += 1;
    } else {
        eta_om = __shfl_sync(SQ_FULL, om_own, L.t_om);
    }
    c.lrg = nan_max(c.lrg, __uint_as_float(mx));
    if (p.has_zm) c.om = reflect(c.om + om_amp * eta_om, p.upper);
    c.unstable = tripped;
}

// ---- one frame ------------------------------------------------------------

// G > 1: post the field's edges and its mid site before a frame's first step.
// They go to the buffer that the last step's exchange did not use: its
// readers may still be reading that one.
template <int S>
__device__ __forceinline__ void publish_field(const ChainParams& p, const Lane& L,
                                              const Sites<S>& s, Xbuf& xb, int& ex) {
    if (p.warps_per_chain == 1) return;
    ex += 1;
    const int cur = ex & 1;
    post_edges<S>(L, s.f, xb.lo[cur], xb.hi[cur], &xb.fend[cur]);
    if (L.t == L.t_mid) xb.fmid[cur] = pick<S>(s.f, L.j_mid);
    __syncthreads();
}

// `loops` micro-steps starting at counter step0; leaves a tripped chain frozen.
// Threefry: one evaluation per site and pair of micro-steps, an odd last step
// taking the first output of its own evaluation.  The slot j_om (site N)
// draws the collective coordinate's noise in the same straight-line code as
// the field's: Threefry STREAM_COLLECTIVE at counter (0, step), Philox site N
// of the field stream.
template <int S, class GEN>
__device__ void run_frame(const ChainParams& p, const Lane& L, uint32_t chain, Sites<S>& s,
                          ChainScalars& c, uint32_t step0, Xbuf& xb, int& ex) {
    const int N = p.n_sites;
    const uint32_t k1_field = (uint32_t)STREAM_FIELD ^ (chain << 8);
    const float noise_amp = p.c_amp * sqrtf(2.0f * c.dtau / p.dt);
    const float om_amp = p.zm_c * sqrtf(2.0f * c.dtau);
    publish_field<S>(p, L, s, xb, ex);
    if constexpr (!GEN::PHILOX) {
        constexpr int ROUNDS = GEN::N_ROUNDS;
        const uint32_t k1_om = (uint32_t)STREAM_COLLECTIVE ^ (chain << 8);
        float e0[S], e1[S];
        float om0 = 0.0f, om1 = 0.0f;
        const int pairs = p.loops / 2;
        for (int k = 0; k <= pairs; ++k) {
            const bool tail = k == pairs;
            if (c.unstable || (tail && p.loops % 2 == 0)) break;  // chain-uniform
            const uint32_t step = tail ? step0 + (uint32_t)(p.loops - 1) : step0 + 2u * (uint32_t)k;
            #pragma unroll
            for (int j = 0; j < S; ++j) {
                const bool om_slot = L.t == L.t_om && j == L.j_om;
                e0[j] = e1[j] = 0.0f;
                if (L.base + j < N || (om_slot && p.has_zm)) {
                    float z0, z1;
                    normal_pair<ROUNDS>(p.seed, om_slot ? k1_om : k1_field,
                                        om_slot ? 0u : (uint32_t)(L.base + j), step, z0, z1);
                    if (om_slot) {
                        om0 = z0;
                        om1 = z1;
                    } else {
                        e0[j] = z0;
                        e1[j] = z1;
                    }
                }
            }
            substep<S>(p, L, s, c, e0, om0, noise_amp, om_amp, xb, ex);
            if (tail || c.unstable) continue;
            substep<S>(p, L, s, c, e1, om1, noise_amp, om_amp, xb, ex);
        }
    } else {
        // Philox: groups of GEN::STEPS micro-steps from one evaluation per site,
        // counted from step0; a short last group drops the rest.
        constexpr int NG = GEN::STEPS;
        float e[NG][S], om[NG];
        #pragma unroll
        for (int g = 0; g < NG; ++g) om[g] = 0.0f;
        for (int s0 = 0; s0 < p.loops; s0 += NG) {
            if (c.unstable) break;  // chain-uniform
            const uint32_t step = step0 + (uint32_t)s0;
            #pragma unroll
            for (int j = 0; j < S; ++j) {
                const bool om_slot = L.t == L.t_om && j == L.j_om;
                float z[NG];
                #pragma unroll
                for (int g = 0; g < NG; ++g) z[g] = 0.0f;
                if (L.base + j < N || (om_slot && p.has_zm))
                    GEN::draw(p.seed, k1_field, (uint32_t)(L.base + j), step, z);
                #pragma unroll
                for (int g = 0; g < NG; ++g) {
                    if (om_slot) om[g] = z[g];
                    e[g][j] = om_slot ? 0.0f : z[g];
                }
            }
            #pragma unroll
            for (int g = 0; g < NG; ++g) {
                if (s0 + g < p.loops && !c.unstable)
                    substep<S>(p, L, s, c, e[g], om[g], noise_amp, om_amp, xb, ex);
            }
        }
    }
}

// The chain of this thread, or -1 for a warp of the last block that has none
// (G = 1 only; that warp leaves at once, and no barrier waits for it).
__device__ __forceinline__ int chain_of_thread(const ChainParams& p) {
    const int group = 32 * p.warps_per_chain;
    const int ch = blockIdx.x * p.chains_per_block + threadIdx.x / group;
    return ch < p.n_chains ? ch : -1;
}

// ---- kernel 1: one frame, frame sums out ----------------------------------

template <int S, class GEN>
__global__ void __launch_bounds__(SQ_MAX_THREADS(S))
chain_frame_kernel(ChainParams p, const float* __restrict__ f_in,
                   const float* __restrict__ om_in, const float* __restrict__ lrg_in,
                   const float* __restrict__ dtau_in, float* __restrict__ f_out,
                   float* __restrict__ om_out, float* __restrict__ xs_out,
                   float* __restrict__ xxs_out, float* __restrict__ x2s_out,
                   float* __restrict__ x4s_out, float* __restrict__ lrg_out,
                   int32_t* __restrict__ unst_out) {
    __shared__ Xbuf xb;
    const int ch = chain_of_thread(p);
    if (ch < 0) return;
    const int N = p.n_sites;
    const Lane L = make_lane<S>(p, threadIdx.x % (32 * p.warps_per_chain));
    const size_t row = (size_t)ch * (size_t)N;
    Sites<S> s;
    #pragma unroll
    for (int k = 0; k < S; ++k) {
        const int i = L.base + k;
        s.f[k] = i < N ? f_in[row + i] : 0.0f;
        s.xs[k] = s.xxs[k] = s.x2s[k] = s.x4s[k] = 0.0f;
    }
    ChainScalars c;
    c.om = om_in[ch];
    c.lrg = lrg_in[ch];
    c.dtau = dtau_in[ch];
    c.unstable = 0;
    int ex = 0;
    run_frame<S, GEN>(p, L, p.chain0 + (uint32_t)ch, s, c, p.step0, xb, ex);
    #pragma unroll
    for (int k = 0; k < S; ++k) {
        const int i = L.base + k;
        if (i < N) {
            f_out[row + i] = s.f[k];
            xs_out[row + i] = s.xs[k];
            xxs_out[row + i] = s.xxs[k];
            x2s_out[row + i] = s.x2s[k];
            x4s_out[row + i] = s.x4s[k];
        }
    }
    if (L.t == 0) {
        om_out[ch] = c.om;
        lrg_out[ch] = c.lrg;
        unst_out[ch] = c.unstable;
    }
}

// ---- kernel 2: K frames, epilogue in-kernel --------------------------------

// The running means live in the output arrays between frames, and a frame's
// starting field in f_out (each thread reads back only what it wrote), so the
// registers hold only the field and the frame sums, as in kernel 1.
template <int S, class GEN>
__global__ void __launch_bounds__(SQ_MAX_THREADS(S))
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
    __shared__ Xbuf xb;
    const int ch = chain_of_thread(p);
    if (ch < 0) return;
    const int N = p.n_sites, C = p.n_chains;
    const Lane L = make_lane<S>(p, threadIdx.x % (32 * p.warps_per_chain));
    const size_t row = (size_t)ch * (size_t)N + (size_t)L.base;
    Sites<S> s;
    #pragma unroll
    for (int k = 0; k < S; ++k) {
        s.f[k] = 0.0f;
        if (L.base + k < N) {
            s.f[k] = f_in[row + k];
            xm_out[row + k] = xm_in[row + k];
            xxm_out[row + k] = xxm_in[row + k];
            x2m_out[row + k] = x2m_in[row + k];
            x4m_out[row + k] = x4m_in[row + k];
        }
    }
    ChainScalars c;
    c.om = om_in[ch];
    c.lrg = lrg_in[ch];
    c.dtau = dtau_in[ch];
    uint32_t lo = (uint32_t)runs_in[2 * ch], hi = (uint32_t)runs_in[2 * ch + 1];
    int32_t stab = stab_in[ch];
    const uint32_t loops_u = (uint32_t)p.loops;
    int ex = 0;

    for (int j = 0; j < p.n_frames; ++j) {
        #pragma unroll
        for (int k = 0; k < S; ++k) {
            if (L.base + k < N) f_out[row + k] = s.f[k];  // the frame's start
            s.xs[k] = s.xxs[k] = s.x2s[k] = s.x4s[k] = 0.0f;
        }
        const float om_snap = c.om, lrg_snap = c.lrg;
        c.unstable = 0;
        run_frame<S, GEN>(p, L, p.chain0 + (uint32_t)ch, s, c, p.step0 + (uint32_t)j * loops_u,
                          xb, ex);

        // epilogue: stochquant_tpu/integrators/langevin.py frame epilogue and
        // accum.merge_frame_sum, expression for expression
        const bool accept = !c.unstable;
        const uint32_t lo_n = lo + loops_u;
        const uint32_t hi_n = hi + (lo_n < lo ? 1u : 0u);
        const float n_new = __uint2float_rn(hi_n) * 4294967296.0f + __uint2float_rn(lo_n);
        const float w = p.loops_f / n_new;
        if (accept) {
            #pragma unroll
            for (int k = 0; k < S; ++k) {
                if (L.base + k < N) {
                    const size_t r = row + k;
                    xm_out[r] = xm_out[r] + (s.xs[k] * p.inv_loops - xm_out[r]) * w;
                    xxm_out[r] = xxm_out[r] + (s.xxs[k] * p.inv_loops - xxm_out[r]) * w;
                    x2m_out[r] = x2m_out[r] + (s.x2s[k] * p.inv_loops - x2m_out[r]) * w;
                    x4m_out[r] = x4m_out[r] + (s.x4s[k] * p.inv_loops - x4m_out[r]) * w;
                }
            }
            lo = lo_n;
            hi = hi_n;
        } else {
            #pragma unroll
            for (int k = 0; k < S; ++k) s.f[k] = L.base + k < N ? f_out[row + k] : 0.0f;
            c.om = om_snap;
            c.lrg = lrg_snap;
        }
        const bool grow = accept && stab >= p.grow_after;
        float dtau = grow ? c.dtau / p.shrink : (accept ? c.dtau : c.dtau * p.shrink);
        if (p.has_dtau_max) dtau = fminf(dtau, p.dtau_max);
        c.dtau = dtau;
        stab = accept ? (grow ? 0 : stab + 1) : 0;
        if (L.t == 0) {
            hist_stable[(size_t)j * C + ch] = accept ? 1 : 0;
            hist_dtau[(size_t)j * C + ch] = c.dtau;
            hist_lrg[(size_t)j * C + ch] = c.lrg;
        }
    }

    #pragma unroll
    for (int k = 0; k < S; ++k)
        if (L.base + k < N) f_out[row + k] = s.f[k];
    if (L.t == 0) {
        om_out[ch] = c.om;
        lrg_out[ch] = c.lrg;
        dtau_out[ch] = c.dtau;
        runs_out[2 * ch] = (int64_t)lo;
        runs_out[2 * ch + 1] = (int64_t)hi;
        stab_out[ch] = stab;
    }
}

// ---- launches ----------------------------------------------------------------

struct FrameArgs {  // kernel 1's tensors, in the entry point's order
    const float *f_in, *om_in, *lrg_in, *dtau_in;
    float *f_out, *om_out, *xs, *xxs, *x2s, *x4s, *lrg_out;
    int32_t* unst_out;
};

struct FramesArgs {  // kernel 2's tensors, in the entry point's order
    const float *f_in, *om_in, *lrg_in, *dtau_in, *xm_in, *xxm_in, *x2m_in, *x4m_in;
    const int64_t* runs_in;
    const int32_t* stab_in;
    float *f_out, *om_out, *lrg_out, *dtau_out, *xm_out, *xxm_out, *x2m_out, *x4m_out;
    int64_t* runs_out;
    int32_t *stab_out, *hist_stable;
    float *hist_dtau, *hist_lrg;
};

// One launch of KERNEL<S, generator> over the launch's chains: G = 1 puts
// chains_per_block one-warp chains in a block, G > 1 one chain in a block.
#define SQ_LAUNCH(KERNEL, ...)                                                      \
    do {                                                                            \
        const dim3 grid((p.n_chains + p.chains_per_block - 1) / p.chains_per_block); \
        const dim3 block(32 * p.warps_per_chain * p.chains_per_block);             \
        switch (p.philox ? 10 : p.rounds) {                                         \
            case 20: KERNEL<S, Threefry20><<<grid, block, 0, st>>>(p, __VA_ARGS__); break; \
            case 13: KERNEL<S, Threefry13><<<grid, block, 0, st>>>(p, __VA_ARGS__); break; \
            case 10: KERNEL<S, PhiloxNoise><<<grid, block, 0, st>>>(p, __VA_ARGS__); break; \
            default: return (int)cudaErrorInvalidValue;                             \
        }                                                                           \
        return (int)cudaGetLastError();                                             \
    } while (0)

template <int S>
int launch_frame(const ChainParams& p, const FrameArgs& a, cudaStream_t st) {
    SQ_LAUNCH(chain_frame_kernel, a.f_in, a.om_in, a.lrg_in, a.dtau_in, a.f_out, a.om_out, a.xs,
              a.xxs, a.x2s, a.x4s, a.lrg_out, a.unst_out);
}

template <int S>
int launch_frames(const ChainParams& p, const FramesArgs& a, cudaStream_t st) {
    SQ_LAUNCH(chain_frames_kernel, a.f_in, a.om_in, a.lrg_in, a.dtau_in, a.xm_in, a.xxm_in,
              a.x2m_in, a.x4m_in, a.runs_in, a.stab_in, a.f_out, a.om_out, a.lrg_out,
              a.dtau_out, a.xm_out, a.xxm_out, a.x2m_out, a.x4m_out, a.runs_out, a.stab_out,
              a.hist_stable, a.hist_dtau, a.hist_lrg);
}

// Each S's kernels are compiled in one of three translation units: the build
// compiles this file three times, with SQ_CHAIN_PART 0, 1 and 2, in parallel
// (S = 1-4, 5-6, 7).  Part 0 also holds the C entry points.
#ifndef SQ_CHAIN_PART
#define SQ_CHAIN_PART 0
#endif
#define SQ_INSTANTIATE(S)                                                          \
    template int launch_frame<S>(const ChainParams&, const FrameArgs&, cudaStream_t); \
    template int launch_frames<S>(const ChainParams&, const FramesArgs&, cudaStream_t);
#define SQ_ELSEWHERE(S)                                                            \
    extern template int launch_frame<S>(const ChainParams&, const FrameArgs&, cudaStream_t); \
    extern template int launch_frames<S>(const ChainParams&, const FramesArgs&, cudaStream_t);

#if SQ_CHAIN_PART == 1
SQ_INSTANTIATE(5)
SQ_INSTANTIATE(6)
#elif SQ_CHAIN_PART == 2
SQ_INSTANTIATE(7)
#else
SQ_INSTANTIATE(1)
SQ_INSTANTIATE(2)
SQ_INSTANTIATE(3)
SQ_INSTANTIATE(4)
SQ_ELSEWHERE(5)
SQ_ELSEWHERE(6)
SQ_ELSEWHERE(7)

// ---- C entry points (loaded with ctypes) ----------------------------------

static bool valid_launch(const ChainParams& p) {
    const int G = p.warps_per_chain, S = p.sites_per_lane, cpb = p.chains_per_block;
    return p.n_chains > 0 && G >= 1 && G <= SQ_MAX_WARPS && S >= 1 && S <= SQ_MAX_SPL &&
           cpb >= 1 && (G == 1 || cpb == 1) && 32 * G * cpb <= SQ_MAX_THREADS(S) &&
           32L * G * S >= (long)p.n_sites + 1 && (p.rounds == 20 || p.rounds == 13) &&
           (p.philox == 0 || p.philox == 1) && p.n_sites >= 2 && p.loops >= 1;
}

#define SQ_BY_S(FN, ARGS)                                                          \
    switch (p->sites_per_lane) {                                                   \
        case 1: return FN<1>(*p, ARGS, (cudaStream_t)stream);                      \
        case 2: return FN<2>(*p, ARGS, (cudaStream_t)stream);                      \
        case 3: return FN<3>(*p, ARGS, (cudaStream_t)stream);                      \
        case 4: return FN<4>(*p, ARGS, (cudaStream_t)stream);                      \
        case 5: return FN<5>(*p, ARGS, (cudaStream_t)stream);                      \
        case 6: return FN<6>(*p, ARGS, (cudaStream_t)stream);                      \
        case 7: return FN<7>(*p, ARGS, (cudaStream_t)stream);                      \
        default: return (int)cudaErrorInvalidValue;                                \
    }

extern "C" int sq_chain_frame(const ChainParams* p, const float* f_in, const float* om_in,
                              const float* lrg_in, const float* dtau_in, float* f_out,
                              float* om_out, float* xs, float* xxs, float* x2s, float* x4s,
                              float* lrg_out, int32_t* unst_out, void* stream) {
    if (!valid_launch(*p)) return (int)cudaErrorInvalidValue;
    const FrameArgs a{f_in, om_in, lrg_in, dtau_in, f_out, om_out, xs, xxs, x2s, x4s, lrg_out,
                      unst_out};
    SQ_BY_S(launch_frame, a)
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
    const FramesArgs a{f_in, om_in, lrg_in, dtau_in, xm_in, xxm_in, x2m_in, x4m_in, runs_in,
                       stab_in, f_out, om_out, lrg_out, dtau_out, xm_out, xxm_out, x2m_out,
                       x4m_out, runs_out, stab_out, hist_stable, hist_dtau, hist_lrg};
    SQ_BY_S(launch_frames, a)
}

extern "C" const char* sq_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
#endif

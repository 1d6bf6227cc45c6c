// 2-D compact Wilson gauge Langevin frames for NVIDIA Hopper (sm_90a).
//
// Replaces the three Pallas TPU kernels of stochquant_tpu/kernels/gauge_kernel.py:
//   kernel 10  sq_gauge_frame  <- _frame_call_g / _build_frame_kernel with
//              _u1_ops, _su2_ops (_su2_step_math_fn) and _su3_ops
//              (one frame of `loops` micro-steps per chain; returns the links,
//              the frame plaquette sum, the drift max and the unstable flag;
//              the accept/reject epilogue runs outside in PyTorch)
//   kernel 11  sq_gauge_frames <- _multiframe_call / _build_multiframe_kernel
//              (K frames per launch with the accept/reject, plaquette merge,
//              (lo, hi) sample-count carry and adaptive-dtau epilogue in-kernel)
//   kernel 12  sq_gauge_chunk  <- _chunk_call_g / _build_gauge_chunk_kernel /
//              make_gauge_chunk_step (W micro-steps, W even, of a shard's block
//              of a lattice split along dim 0, extended by H = W halo rows a
//              side, on a thread-block cluster; see "kernel 12" below)
//
// Per micro-step and chain: the drift F of every link; the drift norm, max
// over the chain's lattice; dtau_eff = dtau * min(1, cap / max(dnorm, 1e-30));
// the exact group update (u1: wrap(theta + omega); su2: quaternion
// exponential and normalisation; su3: Cayley-Hamilton exp(i Omega), product
// and one Newton projection with the det phase divided out) with
// omega = dtau_eff F + sqrt(2 dtau_eff) eta; the mean plaquette of the
// pre-update links; a chain whose new links are not finite keeps them and is
// frozen for the rest of the frame.  Noise: one Threefry pair per counter
// (seed, FIELD ^ chain << 8, C-order index over (noise plane, L0, L1), step),
// both Box-Muller outputs, the second for the next micro-step.
//
// Every expression is the one of the plain PyTorch version
// (stochquant_tpu_torch/actions/gauge.py, integrators/gauge.py), operand for
// operand, built with --fmad=false and IEEE division and square root, so the
// two agree bit for bit; only the plaquette's site sum is taken in another
// order than torch.mean.
//
// What bounds it on the card, and the design: operations (su3 ~5,000 flops per
// site and micro-step; PERF.md's kernel table has each group's bound).  The
// drift cap rescales every link of a chain by the chain's global max |F|, so no
// link may move before the whole lattice's drift is known: each micro-step runs
// in two passes, pass 1 computing F (kept for pass 2), the drift norm and the
// plaquette, a fixed-order reduction (NaN-propagating max) making them uniform,
// pass 2 drawing the noise and updating the thread's own links in place.  Pass 1
// reads neighbours' links, pass 2 only its own, so two barriers per micro-step
// suffice.  Two geometries, chosen per launch by gauge_kernel.cluster_geometry
// (GaugeParams.cl_B):
//
//   B > 1, a chain on a thread-block cluster of B blocks (cluster.cuh): block
//   rank b holds its strip of rows of every link plane, with one halo row a side
//   (the staples and the plaquette read rows r - 1 .. r + 1), in shared memory
//   for the whole frame; F and the kept noise live in shared memory where the
//   budget allows (su2 128^2 at B = 8, su3 64^2 at B = 8 or 16), else in global
//   memory, each thread reading back in pass 2 what it wrote in pass 1.  The
//   strip is a lattice of S + 2 rows to pass1 / pass2<G, true> (the chunk
//   kernel's noise counters with H = 1 give the global counters).  Pass 2 pushes
//   a strip's new edge rows into the neighbours' halo rows through distributed
//   shared memory; one cluster barrier after pass 1 (the reduction) and one
//   after pass 2 (the halos).  The reduction goes warps, then ranks, in order:
//   links and every decision are bitwise those of B = 1; only the plaquette's
//   site sum is taken in another order.  u1 256^2 x 32 runs on 128 SMs at B = 4.
//
//   B = 1, one block per chain (the geometry at many chains): links, F and the
//   kept noise in global buffers that stay in L2 (a lattice does not fit one
//   block's shared memory: u1 256^2 512 KiB, su3 64^2 576 KiB); 256 threads a
//   block for su3's registers.

#include "cluster.cuh"
#include "sq_rng.cuh"

// Mirrors GaugeParams in stochquant_tpu_torch/kernels/_build.py: every field
// is 4 bytes, so the two layouts agree without padding rules.
struct GaugeParams {
    int32_t n_chains;     // chains in this launch
    int32_t L0;           // lattice rows (direction 0)
    int32_t L1;           // lattice columns (direction 1)
    int32_t group;        // 0 u1, 1 su2, 2 su3
    int32_t loops;        // micro-steps per frame
    int32_t n_frames;     // K (kernel 11)
    int32_t grow_after;
    int32_t has_dtau_max;
    uint32_t seed;
    uint32_t step0;       // micro-step counter at the first frame
    float coef;           // u1: float32(-beta); su2: float32(-0.5 beta); su3: float32(beta / 12)
    float cap;            // float32(drift_cap)
    float clip_hi;        // float32(1 - 1e-6), the arccos argument's upper bound
    float inv_vol;        // float32(1 / (L0 L1))
    float shrink, dtau_max, inv_loops, loops_f;
    // kernel 12 only; there L0 is the extended block's rows (loc0 + 2 H)
    uint32_t chain_off;   // global id of this launch's first chain
    uint32_t row_off;     // global row of the owned block's first row
    int32_t loc0;         // owned rows
    int32_t H;            // halo rows above and below
    int32_t W;            // micro-steps of the launch
    int32_t L0g;          // rows of the global lattice
    // kernels 10 and 11 (cluster.cuh): the geometry of gauge_kernel.cluster_geometry
    int32_t cl_B;         // blocks of the thread-block cluster a chain runs on (1: one block)
    int32_t cl_rows;      // rows of the largest strip, ceil(L0 / cl_B)
    int32_t cl_scratch;   // 1: F and the kept noise in shared memory; 0: in global memory
    int32_t cl_empty;     // 1: barriers, halos' publication and reductions only (timing)
    int32_t cl_split;     // kernel 12: 1 a work item is one link direction of a site, 0 a site
};

enum { GROUP_U1 = 0, GROUP_SU2 = 1, GROUP_SU3 = 2 };
enum { NOISE_DRAW = 0, NOISE_DRAW_KEEP = 1, NOISE_KEPT = 2 };

// Per group: link planes, noise planes, force planes, threads per block.
template <int G> struct Layout;
template <> struct Layout<GROUP_U1> { enum { P = 2, NP = 2, FP = 2, T = 1024 }; };
template <> struct Layout<GROUP_SU2> { enum { P = 8, NP = 6, FP = 6, T = 512 }; };
template <> struct Layout<GROUP_SU3> { enum { P = 36, NP = 16, FP = 36, T = 256 }; };

// max / min that return NaN when either operand is NaN (torch.maximum,
// torch.minimum); fmaxf / fminf would drop it.
__device__ __forceinline__ float nan_max(float a, float b) { return (a > b || isnan(a)) ? a : b; }
__device__ __forceinline__ float nan_min(float a, float b) { return (a < b || isnan(a)) ? a : b; }

// Lattice neighbours with periodic wrap: the site index of (r + dr, c + dc).
struct Nbr {
    int L0, L1;
    __device__ __forceinline__ int at(int r, int c, int dr, int dc) const {
        r += dr;
        c += dc;
        r = r < 0 ? r + L0 : (r >= L0 ? r - L0 : r);
        c = c < 0 ? c + L1 : (c >= L1 ? c - L1 : c);
        return r * L1 + c;
    }
};

// ---- U(1) -------------------------------------------------------------------

// P01(x) = t0(x) + t1(x+0) - t0(x+1) - t1(x);  P10(x) = t1(x) + t0(x+1) - t1(x+0) - t0(x)
__device__ __forceinline__ float u1_p01(const float* t0, const float* t1, const Nbr& n, int r,
                                        int c) {
    const int x = n.at(r, c, 0, 0);
    return t0[x] + t1[n.at(r, c, 1, 0)] - t0[n.at(r, c, 0, 1)] - t1[x];
}
__device__ __forceinline__ float u1_p10(const float* t0, const float* t1, const Nbr& n, int r,
                                        int c) {
    const int x = n.at(r, c, 0, 0);
    return t1[x] + t0[n.at(r, c, 0, 1)] - t1[n.at(r, c, 1, 0)] - t0[x];
}

// ---- SU(2) quaternions --------------------------------------------------------

struct Quat { float w, x, y, z; };

__device__ __forceinline__ Quat qmul(const Quat& a, const Quat& b) {
    Quat o;
    o.w = a.w * b.w - a.x * b.x - a.y * b.y - a.z * b.z;
    o.x = a.w * b.x + b.w * a.x - (a.y * b.z - a.z * b.y);
    o.y = a.w * b.y + b.w * a.y - (a.z * b.x - a.x * b.z);
    o.z = a.w * b.z + b.w * a.z - (a.x * b.y - a.y * b.x);
    return o;
}
__device__ __forceinline__ Quat qconj(const Quat& a) { return {a.w, -a.x, -a.y, -a.z}; }
__device__ __forceinline__ Quat qadd(const Quat& a, const Quat& b) {
    return {a.w + b.w, a.x + b.x, a.y + b.y, a.z + b.z};
}
// Plane 2c + mu holds component c of direction mu.
__device__ __forceinline__ Quat qload(const float* L, size_t V, int mu, int i) {
    return {L[(0 + mu) * V + i], L[(2 + mu) * V + i], L[(4 + mu) * V + i], L[(6 + mu) * V + i]};
}
__device__ __forceinline__ Quat qexp_su2(float vx, float vy, float vz) {
    const float n2 = vx * vx + vy * vy + vz * vz;
    const float ns = sqrtf(nan_max(n2, 1e-24f));
    const float half = 0.5f * ns;
    const bool small = n2 < 1e-12f;
    const float s = small ? 0.5f - n2 / 48.0f : sinf(half) / ns;
    const float w = small ? 1.0f - n2 / 8.0f : cosf(half);
    return {w, s * vx, s * vy, s * vz};
}
__device__ __forceinline__ Quat qnormalize(const Quat& a) {
    const float inv = 1.0f / sqrtf(a.w * a.w + a.x * a.x + a.y * a.y + a.z * a.z + 1e-30f);
    return {a.w * inv, a.x * inv, a.y * inv, a.z * inv};
}

// ---- SU(3) split-complex 3x3 matrices ---------------------------------------

struct Cx { float re, im; };
struct M3 { Cx a[3][3]; };

__device__ __forceinline__ Cx cmul(Cx a, Cx b) {
    return {a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re};
}
__device__ __forceinline__ Cx cadd(Cx a, Cx b) { return {a.re + b.re, a.im + b.im}; }
__device__ __forceinline__ Cx csub(Cx a, Cx b) { return {a.re - b.re, a.im - b.im}; }

__device__ __forceinline__ M3 mmul(const M3& A, const M3& B) {
    M3 C;
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j) {
            Cx s = cmul(A.a[i][0], B.a[0][j]);
            s = cadd(s, cmul(A.a[i][1], B.a[1][j]));
            s = cadd(s, cmul(A.a[i][2], B.a[2][j]));
            C.a[i][j] = s;
        }
    return C;
}
__device__ __forceinline__ M3 mdag(const M3& A) {
    M3 C;
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j) C.a[i][j] = {A.a[j][i].re, -A.a[j][i].im};
    return C;
}
// Plane mu * 18 + (3 r + c) * 2 + {0: re, 1: im}.
__device__ __forceinline__ M3 mload(const float* L, size_t V, int mu, int i) {
    M3 m;
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
        for (int c = 0; c < 3; ++c) {
            const int p = mu * 18 + (3 * r + c) * 2;
            m.a[r][c] = {L[p * V + i], L[(p + 1) * V + i]};
        }
    return m;
}
__device__ __forceinline__ void mstore(float* L, size_t V, int mu, int i, const M3& m) {
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
        for (int c = 0; c < 3; ++c) {
            const int p = mu * 18 + (3 * r + c) * 2;
            L[p * V + i] = m.a[r][c].re;
            L[(p + 1) * V + i] = m.a[r][c].im;
        }
}
__device__ __forceinline__ float mretr(const M3& m) {
    return m.a[0][0].re + m.a[1][1].re + m.a[2][2].re;
}

// exp(iQ), Cayley-Hamilton (actions/gauge.py:_sexpi).
__device__ M3 expi_su3(const M3& Q, float clip_hi) {
    const M3 q2 = mmul(Q, Q);
    const M3 q3 = mmul(q2, Q);
    const float c1 = 0.5f * mretr(q2);
    const float c0 = mretr(q3) / 3.0f;
    const bool small = c1 < 1e-8f;
    const float c1s = small ? 1.0f : c1;
    const float c0a = fabsf(c0);
    const float c1_3 = c1s / 3.0f;
    const float c0max = 2.0f * (c1_3 * sqrtf(c1_3));
    float x = c0a / c0max;
    x = x < 0.0f ? 0.0f : (x > clip_hi ? clip_hi : x);  // torch.clamp: NaN stays NaN
    const float theta = acosf(x);
    const float theta_3 = theta / 3.0f;
    const float u = sqrtf(c1_3) * cosf(theta_3);
    const float w = sqrtf(c1s) * sinf(theta_3);
    const float w2 = w * w;
    const bool tiny = w2 < 1e-4f;
    const float series = 1.0f - w2 / 6.0f * (1.0f - w2 / 20.0f * (1.0f - w2 / 42.0f));
    const float xi0 = tiny ? series : sinf(w) / w;
    const float cosw = cosf(w);
    const Cx e2iu = {cosf(2.0f * u), sinf(2.0f * u)};
    const Cx emiu = {cosf(u), -sinf(u)};
    const float u2 = u * u;
    const float uw = u2 - w2;
    const Cx h0 = cadd({uw * e2iu.re, uw * e2iu.im},
                       cmul(emiu, {8.0f * u2 * cosw, 2.0f * u * (3.0f * u2 + w2) * xi0}));
    const float tu = 2.0f * u;
    const Cx h1 = csub({tu * e2iu.re, tu * e2iu.im},
                       cmul(emiu, {tu * cosw, -((3.0f * u2 - w2) * xi0)}));
    const Cx h2 = csub(e2iu, cmul(emiu, {cosw, 3.0f * u * xi0}));
    const float denom = 9.0f * u2 - w2;
    Cx f0 = {h0.re / denom, h0.im / denom};
    Cx f1 = {h1.re / denom, h1.im / denom};
    Cx f2 = {h2.re / denom, h2.im / denom};
    if (c0 < 0.0f) {  // f_j(c0) = (-1)^j conj(f_j(|c0|))
        f0.im = -f0.im;
        f1.re = -f1.re;
        f2.im = -f2.im;
    }
    M3 out;
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
        for (int c = 0; c < 3; ++c) {
            Cx closed = cmul(f1, Q.a[r][c]);
            if (r == c) closed = cadd(f0, closed);
            closed = cadd(closed, cmul(f2, q2.a[r][c]));
            const float one = r == c ? 1.0f : 0.0f;
            const Cx tay = {(one - Q.a[r][c].im) - 0.5f * q2.a[r][c].re +
                                q3.a[r][c].im * (1.0f / 6.0f),
                            (Q.a[r][c].re - 0.5f * q2.a[r][c].im) -
                                q3.a[r][c].re * (1.0f / 6.0f)};
            out.a[r][c] = small ? tay : closed;
        }
    return out;
}

// One Newton step toward the nearest unitary, then the det phase divided out
// (actions/gauge.py:_sproject).
__device__ M3 project_su3(const M3& U) {
    const M3 W = mmul(mdag(U), U);
    M3 X;
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
        for (int c = 0; c < 3; ++c)
            X.a[r][c] = {(r == c ? 1.5f : 0.0f) - 0.5f * W.a[r][c].re, -0.5f * W.a[r][c].im};
    const M3 v = mmul(U, X);
    const Cx m0 = csub(cmul(v.a[1][1], v.a[2][2]), cmul(v.a[1][2], v.a[2][1]));
    const Cx m1 = csub(cmul(v.a[1][0], v.a[2][2]), cmul(v.a[1][2], v.a[2][0]));
    const Cx m2 = csub(cmul(v.a[1][0], v.a[2][1]), cmul(v.a[1][1], v.a[2][0]));
    const Cx d = cadd(csub(cmul(v.a[0][0], m0), cmul(v.a[0][1], m1)), cmul(v.a[0][2], m2));
    const float ang = atan2f(d.im, d.re) * (-1.0f / 3.0f);
    const Cx ph = {cosf(ang), sinf(ang)};
    M3 out;
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
        for (int c = 0; c < 3; ++c) out.a[r][c] = cmul(v.a[r][c], ph);
    return out;
}

// Sigma_a eta_a T_a from the eight noise values (actions/gauge.py:_noise_h).
__device__ __forceinline__ M3 noise_h(const float* e) {
    const float t8 = 0.28867513459481287f;    // float32(1 / (2 sqrt 3)) = _GELLMANN[7,0,0]
    const float t8_33 = -0.5773502691896257f;  // float32(-1 / sqrt 3) = _GELLMANN[7,2,2]
    M3 m;
    m.a[0][0] = {0.5f * e[2] + t8 * e[7], 0.0f};
    m.a[0][1] = {0.5f * e[0], -0.5f * e[1]};
    m.a[0][2] = {0.5f * e[3], -0.5f * e[4]};
    m.a[1][0] = {0.5f * e[0], 0.5f * e[1]};
    m.a[1][1] = {-0.5f * e[2] + t8 * e[7], 0.0f};
    m.a[1][2] = {0.5f * e[5], -0.5f * e[6]};
    m.a[2][0] = {0.5f * e[3], 0.5f * e[4]};
    m.a[2][1] = {0.5f * e[5], 0.5f * e[6]};
    m.a[2][2] = {t8_33 * e[7], 0.0f};
    return m;
}

// ---- the two passes of a micro-step, per site --------------------------------

// Pass 1 at site i: the drift of both directions into F, the largest drift
// norm into dn and the pre-update plaquette onto pl.
template <int G>
__device__ __forceinline__ void pass1(const GaugeParams& p, const float* __restrict__ L,
                                      float* __restrict__ F, int i, float& pl, float& dn) {
    const size_t V = (size_t)p.L0 * p.L1;
    const Nbr n{p.L0, p.L1};
    const int r = i / p.L1, c = i - r * p.L1;
    if constexpr (G == GROUP_U1) {
        const float* t0 = L;
        const float* t1 = L + V;
        const float p01 = u1_p01(t0, t1, n, r, c);
        const float a0 = (0.0f + sinf(p01)) - sinf(u1_p01(t0, t1, n, r, c - 1));
        const float a1 = (0.0f + sinf(u1_p10(t0, t1, n, r, c))) - sinf(u1_p10(t0, t1, n, r - 1, c));
        const float f0 = p.coef * a0, f1 = p.coef * a1;
        F[i] = f0;
        F[V + i] = f1;
        dn = nan_max(dn, nan_max(fabsf(f0), fabsf(f1)));
        pl += cosf(p01);
    } else if constexpr (G == GROUP_SU2) {
#pragma unroll
        for (int mu = 0; mu < 2; ++mu) {
            const int nu = 1 - mu;
            const int mr = mu == 0, mc = mu == 1, nr = nu == 0, nc = nu == 1;
            const Quat fwd = qmul(qmul(qload(L, V, nu, n.at(r, c, mr, mc)),
                                       qconj(qload(L, V, mu, n.at(r, c, nr, nc)))),
                                  qconj(qload(L, V, nu, i)));
            const Quat bwd = qmul(qmul(qconj(qload(L, V, nu, n.at(r, c, mr - nr, mc - nc))),
                                       qconj(qload(L, V, mu, n.at(r, c, -nr, -nc)))),
                                  qload(L, V, nu, n.at(r, c, -nr, -nc)));
            const Quat w = qmul(qload(L, V, mu, i), qadd(fwd, bwd));
            const float f0 = p.coef * w.x, f1 = p.coef * w.y, f2 = p.coef * w.z;
            F[(0 + mu) * V + i] = f0;
            F[(2 + mu) * V + i] = f1;
            F[(4 + mu) * V + i] = f2;
            dn = nan_max(dn, sqrtf(f0 * f0 + f1 * f1 + f2 * f2));
        }
        const Quat pq = qmul(qmul(qload(L, V, 0, i), qload(L, V, 1, n.at(r, c, 1, 0))),
                             qmul(qconj(qload(L, V, 0, n.at(r, c, 0, 1))), qconj(qload(L, V, 1, i))));
        pl += pq.w;
    } else {
#pragma unroll 1
        for (int mu = 0; mu < 2; ++mu) {
            const int nu = 1 - mu;
            const int mr = mu == 0, mc = mu == 1, nr = nu == 0, nc = nu == 1;
            const M3 fwd = mmul(mmul(mload(L, V, nu, n.at(r, c, mr, mc)),
                                     mdag(mload(L, V, mu, n.at(r, c, nr, nc)))),
                                mdag(mload(L, V, nu, i)));
            const M3 bwd = mmul(mmul(mdag(mload(L, V, nu, n.at(r, c, mr - nr, mc - nc))),
                                     mdag(mload(L, V, mu, n.at(r, c, -nr, -nc)))),
                                mload(L, V, nu, n.at(r, c, -nr, -nc)));
            M3 staple;
#pragma unroll
            for (int a = 0; a < 3; ++a)
#pragma unroll
                for (int b = 0; b < 3; ++b) staple.a[a][b] = cadd(fwd.a[a][b], bwd.a[a][b]);
            const M3 m = mmul(mload(L, V, mu, i), staple);
            M3 g;
#pragma unroll
            for (int a = 0; a < 3; ++a)
#pragma unroll
                for (int b = 0; b < 3; ++b)
                    g.a[a][b] = {-(m.a[a][b].im + m.a[b][a].im), m.a[a][b].re - m.a[b][a].re};
            const Cx tr = cadd(cadd(g.a[0][0], g.a[1][1]), g.a[2][2]);
            const Cx trn = {tr.re / 3.0f, tr.im / 3.0f};
            M3 h;
            float frob = 0.0f;
#pragma unroll
            for (int a = 0; a < 3; ++a)
#pragma unroll
                for (int b = 0; b < 3; ++b) {
                    const Cx x = a == b ? csub(g.a[a][b], trn) : g.a[a][b];
                    h.a[a][b] = {p.coef * x.re, p.coef * x.im};
                    const float v = h.a[a][b].re * h.a[a][b].re + h.a[a][b].im * h.a[a][b].im;
                    frob = (a == 0 && b == 0) ? v : frob + v;
                }
            mstore(F, V, mu, i, h);
            dn = nan_max(dn, sqrtf(2.0f * frob));
        }
        const M3 pm = mmul(mmul(mload(L, V, 0, i), mload(L, V, 1, n.at(r, c, 1, 0))),
                           mmul(mdag(mload(L, V, 0, n.at(r, c, 0, 1))), mdag(mload(L, V, 1, i))));
        pl += mretr(pm) / 3.0f;
    }
}

// Noise of plane q at site i for this micro-step.  The counter is the C-order
// index over (noise plane, L0, L1) of the *global* lattice: with CHUNK, row r
// of the block `p` describes is global row (row_off + r - H) mod L0g (a
// cluster strip: H = 1, row_off its first row).
template <int NP, bool CHUNK>
__device__ __forceinline__ float noise(const GaugeParams& p, float* __restrict__ zk, int q,
                                       int i, int mode, uint32_t k1, uint32_t step) {
    const size_t V = (size_t)p.L0 * p.L1;
    const size_t at = q * V + i;
    if (mode == NOISE_KEPT) return zk[at];
    uint32_t ctr = (uint32_t)at;
    if constexpr (CHUNK) {
        const int r = i / p.L1, c = i - r * p.L1;
        int rg = ((int)(p.row_off % (uint32_t)p.L0g) + r - p.H) % p.L0g;
        if (rg < 0) rg += p.L0g;
        ctr = (uint32_t)q * (uint32_t)(p.L0g * p.L1) + (uint32_t)rg * (uint32_t)p.L1 + (uint32_t)c;
    }
    float z0, z1;
    normal_pair<20>(p.seed, k1, ctr, step, z0, z1);
    if (mode == NOISE_DRAW_KEEP) zk[at] = z1;
    return z0;
}

// Pass 2 at site i: the update of both directions' links, in place; bad is
// set where a new link is not finite.
template <int G, bool CHUNK = false>
__device__ __forceinline__ void pass2(const GaugeParams& p, float* __restrict__ L,
                                      const float* __restrict__ F, float* __restrict__ zk, int i,
                                      int mode, uint32_t k1, uint32_t step, float de, float na,
                                      int& bad) {
    const size_t V = (size_t)p.L0 * p.L1;
    if constexpr (G == GROUP_U1) {
#pragma unroll
        for (int mu = 0; mu < 2; ++mu) {
            const float eta = noise<2, CHUNK>(p, zk, mu, i, mode, k1, step);
            const float t = L[mu * V + i] + (de * F[mu * V + i] + na * eta);
            const float two_pi = 6.2831854820251465f;  // float32(2 pi)
            const float nt = t - two_pi * rintf(t / two_pi);
            L[mu * V + i] = nt;
            bad |= !isfinite(nt);
        }
    } else if constexpr (G == GROUP_SU2) {
#pragma unroll
        for (int mu = 0; mu < 2; ++mu) {
            float om[3];
#pragma unroll
            for (int a = 0; a < 3; ++a)
                om[a] = de * F[(2 * a + mu) * V + i] +
                        na * noise<6, CHUNK>(p, zk, 2 * a + mu, i, mode, k1, step);
            const Quat q = qnormalize(qmul(qexp_su2(om[0], om[1], om[2]), qload(L, V, mu, i)));
            L[(0 + mu) * V + i] = q.w;
            L[(2 + mu) * V + i] = q.x;
            L[(4 + mu) * V + i] = q.y;
            L[(6 + mu) * V + i] = q.z;
            bad |= !(isfinite(q.w) && isfinite(q.x) && isfinite(q.y) && isfinite(q.z));
        }
    } else {
#pragma unroll 1
        for (int mu = 0; mu < 2; ++mu) {
            float e[8];
#pragma unroll
            for (int a = 0; a < 8; ++a) e[a] = noise<16, CHUNK>(p, zk, 2 * a + mu, i, mode, k1, step);
            const M3 nt = noise_h(e);
            const M3 h = mload(F, V, mu, i);
            M3 om;
#pragma unroll
            for (int a = 0; a < 3; ++a)
#pragma unroll
                for (int b = 0; b < 3; ++b)
                    om.a[a][b] = {de * h.a[a][b].re + na * nt.a[a][b].re,
                                  de * h.a[a][b].im + na * nt.a[a][b].im};
            const M3 u = project_su3(mmul(expi_su3(om, p.clip_hi), mload(L, V, mu, i)));
            mstore(L, V, mu, i, u);
            bool fin = true;
#pragma unroll
            for (int a = 0; a < 3; ++a)
#pragma unroll
                for (int b = 0; b < 3; ++b)
                    fin = fin && isfinite(u.a[a][b].re) && isfinite(u.a[a][b].im);
            bad |= !fin;
        }
    }
}

// ---- block reduction and the frame -------------------------------------------

struct Tot {
    float plaq, dnorm;
    int bad;
};

// Warp xor-shuffle, lane 0 publishes, barrier, then every thread sums the
// warps' partials in warp order: block-uniform and the same on every run.
template <int T>
__device__ __forceinline__ Tot block_reduce(float pl, float dn, int bad, float* red) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        pl += __shfl_xor_sync(0xffffffffu, pl, off);
        dn = nan_max(dn, __shfl_xor_sync(0xffffffffu, dn, off));
        bad |= __shfl_xor_sync(0xffffffffu, bad, off);
    }
    if ((threadIdx.x & 31) == 0) {
        float* w = red + 3 * (threadIdx.x >> 5);
        w[0] = pl;
        w[1] = dn;
        w[2] = (float)bad;
    }
    __syncthreads();
    Tot t{red[0], red[1], red[2] != 0.0f};
#pragma unroll 1
    for (int w = 1; w < T / 32; ++w) {
        t.plaq = t.plaq + red[3 * w];
        t.dnorm = nan_max(t.dnorm, red[3 * w + 1]);
        t.bad |= red[3 * w + 2] != 0.0f;
    }
    return t;
}

struct FrameOut {
    float ps, dmax;
    int unstable;
};

// `loops` micro-steps on the links L (in place) from counter step0; dmax
// enters as the state's drift max.  A chain whose update is not finite keeps
// the links of that micro-step and stops.
template <int G>
__device__ FrameOut run_frame(const GaugeParams& p, float* L, float* F, float* zk,
                              uint32_t step0, uint32_t k1, float dtau, float dmax, float* red) {
    constexpr int T = Layout<G>::T;
    const int V = p.L0 * p.L1;
    FrameOut out{0.0f, dmax, 0};
    int bad = 0;
    for (int k = 0; k < p.loops; ++k) {  // block-uniform control flow
        float pl = 0.0f, dn = 0.0f;
        for (int i = threadIdx.x; i < V; i += T) pass1<G>(p, L, F, i, pl, dn);
        const Tot t = block_reduce<T>(pl, dn, bad, red);
        if (t.bad) {  // the previous micro-step tripped the chain
            out.unstable = 1;
            return out;
        }
        out.ps = out.ps + t.plaq * p.inv_vol;
        out.dmax = nan_max(out.dmax, t.dnorm);
        const float scale = nan_min(1.0f, p.cap / nan_max(t.dnorm, 1e-30f));
        const float de = dtau * scale;
        const float na = sqrtf(2.0f * de);
        const int mode = (k & 1) ? NOISE_KEPT : (k + 1 < p.loops ? NOISE_DRAW_KEEP : NOISE_DRAW);
        const uint32_t step = step0 + (uint32_t)(k & ~1);
        for (int i = threadIdx.x; i < V; i += T) pass2<G>(p, L, F, zk, i, mode, k1, step, de, na, bad);
        __syncthreads();  // new links are read as neighbours next; red is free again
    }
    out.unstable = block_reduce<T>(0.0f, 0.0f, bad, red).bad;
    __syncthreads();
    return out;
}

template <int G>
__device__ __forceinline__ void copy_own(const GaugeParams& p, const float* __restrict__ src,
                                         float* __restrict__ dst) {
    const size_t V = (size_t)p.L0 * p.L1;
    for (int q = 0; q < Layout<G>::P; ++q)
        for (size_t i = threadIdx.x; i < V; i += Layout<G>::T) dst[q * V + i] = src[q * V + i];
}

// ---- kernel 10: one frame --------------------------------------------------

template <int G>
__global__ void __launch_bounds__(Layout<G>::T)
gauge_frame_kernel(GaugeParams p, const float* __restrict__ links_in,
                   const float* __restrict__ dmax_in, const float* __restrict__ dtau_in,
                   float* __restrict__ links_out, float* __restrict__ ps_out,
                   float* __restrict__ dmax_out, int32_t* __restrict__ unst_out,
                   float* __restrict__ force, float* __restrict__ zk) {
    __shared__ float red[3 * (Layout<G>::T / 32)];
    const int ch = blockIdx.x;
    const size_t V = (size_t)p.L0 * p.L1;
    float* L = links_out + ch * Layout<G>::P * V;
    copy_own<G>(p, links_in + ch * Layout<G>::P * V, L);
    __syncthreads();
    const uint32_t k1 = (uint32_t)STREAM_FIELD ^ ((uint32_t)ch << 8);
    const FrameOut fr = run_frame<G>(p, L, force + ch * Layout<G>::FP * V,
                                     zk + ch * Layout<G>::NP * V, p.step0, k1, dtau_in[ch],
                                     dmax_in[ch], red);
    if (threadIdx.x == 0) {
        ps_out[ch] = fr.ps;
        dmax_out[ch] = fr.dmax;
        unst_out[ch] = fr.unstable;
    }
}

// ---- kernel 11: K frames, epilogue in-kernel -------------------------------

template <int G>
__global__ void __launch_bounds__(Layout<G>::T)
gauge_frames_kernel(GaugeParams p, const float* __restrict__ links_in,
                    const float* __restrict__ dmax_in, const float* __restrict__ dtau_in,
                    const float* __restrict__ pm_in, const int64_t* __restrict__ runs_in,
                    const int32_t* __restrict__ stab_in, float* __restrict__ links_out,
                    float* __restrict__ dmax_out, float* __restrict__ dtau_out,
                    float* __restrict__ pm_out, int64_t* __restrict__ runs_out,
                    int32_t* __restrict__ stab_out, int32_t* __restrict__ hist_stable,
                    float* __restrict__ hist_dtau, float* __restrict__ hist_dmax,
                    float* __restrict__ work, float* __restrict__ force,
                    float* __restrict__ zk) {
    __shared__ float red[3 * (Layout<G>::T / 32)];
    const int ch = blockIdx.x, C = p.n_chains;
    const size_t V = (size_t)p.L0 * p.L1;
    float* A = links_out + ch * Layout<G>::P * V;  // the accepted links
    float* W = work + ch * Layout<G>::P * V;       // the frame in flight
    float* Fc = force + ch * Layout<G>::FP * V;
    float* Zc = zk + ch * Layout<G>::NP * V;
    copy_own<G>(p, links_in + ch * Layout<G>::P * V, A);
    float dmax = dmax_in[ch], dtau = dtau_in[ch], pm = pm_in[ch];
    uint32_t lo = (uint32_t)runs_in[2 * ch], hi = (uint32_t)runs_in[2 * ch + 1];
    int32_t stab = stab_in[ch];
    const uint32_t loops_u = (uint32_t)p.loops;
    const uint32_t k1 = (uint32_t)STREAM_FIELD ^ ((uint32_t)ch << 8);

    for (int j = 0; j < p.n_frames; ++j) {
        copy_own<G>(p, A, W);
        __syncthreads();
        const FrameOut fr = run_frame<G>(p, W, Fc, Zc, p.step0 + (uint32_t)j * loops_u, k1,
                                         dtau, dmax, red);
        // epilogue: integrators/gauge.py:gauge_frame_epilogue and
        // accum.merge_frame_sum, expression for expression
        const bool accept = !fr.unstable;
        const uint32_t lo_n = lo + loops_u;
        const uint32_t hi_n = hi + (lo_n < lo ? 1u : 0u);
        const float n_new = __uint2float_rn(hi_n) * 4294967296.0f + __uint2float_rn(lo_n);
        const float w = p.loops_f / n_new;
        if (accept) {
            pm = pm + (fr.ps * p.inv_loops - pm) * w;
            dmax = fr.dmax;
            copy_own<G>(p, W, A);
            lo = lo_n;
            hi = hi_n;
        }
        const bool grow = accept && stab >= p.grow_after;
        float dt = grow ? dtau / p.shrink : (accept ? dtau : dtau * p.shrink);
        if (p.has_dtau_max) dt = fminf(dt, p.dtau_max);
        dtau = dt;
        stab = accept ? (stab >= p.grow_after ? 0 : stab + 1) : 0;
        if (threadIdx.x == 0) {
            hist_stable[(size_t)j * C + ch] = accept ? 1 : 0;
            hist_dtau[(size_t)j * C + ch] = dtau;
            hist_dmax[(size_t)j * C + ch] = fr.dmax;
        }
    }
    if (threadIdx.x == 0) {
        dmax_out[ch] = dmax;
        dtau_out[ch] = dtau;
        pm_out[ch] = pm;
        runs_out[2 * ch] = (int64_t)lo;
        runs_out[2 * ch + 1] = (int64_t)hi;
        stab_out[ch] = stab;
    }
}

// ---- kernels 10 and 11 on a thread-block cluster (B > 1) ------------------

// A block's share of a chain at B > 1.  `lp` is the strip as pass1 and
// pass2<G, true> see it: a lattice of S + 2 rows whose row 1 is global row r0
// (H = 1, row_off = r0, L0g = L0); owned rows 1 .. n never reach its wrap.
struct ClGauge {
    Strip s;
    GaugeParams lp;
    float* L;    // link planes, (S + 2) x L1 each
    float* F;    // force planes, as L (rows 1 .. n used)
    float* zk;   // kept-noise planes, as L
    float* red;  // 3 partials a warp
    float* slot; // this block's partials
    float* gath; // 3 a rank: the cluster's partials
};

// Shared memory of a cluster block, in floats (kernels/_cluster.py mirrors it).
template <int G>
__host__ __device__ __forceinline__ size_t gauge_cl_floats(const GaugeParams& p) {
    const size_t strip = (size_t)(p.cl_rows + 2) * p.L1;
    const size_t scratch = p.cl_scratch ? (size_t)(Layout<G>::FP + Layout<G>::NP) * strip : 0;
    return Layout<G>::P * strip + scratch + 3 * 32 + 4 + 3 * SQ_MAX_CLUSTER;
}

template <int G>
__device__ __forceinline__ ClGauge cl_gauge_layout(const GaugeParams& p, int rank, int ch,
                                                   float* force, float* zk) {
    extern __shared__ float sm[];
    ClGauge w;
    w.s = make_strip(rank, p.cl_B, p.L0);
    w.lp = p;
    w.lp.L0 = p.cl_rows + 2;
    w.lp.H = 1;
    w.lp.row_off = (uint32_t)w.s.r0;
    w.lp.L0g = p.L0;
    const size_t strip = (size_t)(p.cl_rows + 2) * p.L1;
    float* q = sm;
    w.L = q;
    q += Layout<G>::P * strip;
    if (p.cl_scratch) {
        w.F = q;
        w.zk = q + Layout<G>::FP * strip;
        q += (Layout<G>::FP + Layout<G>::NP) * strip;
    } else {  // (C, B, planes, S + 2, L1) in global memory
        const size_t blk = (size_t)ch * p.cl_B + rank;
        w.F = force + blk * Layout<G>::FP * strip;
        w.zk = zk + blk * Layout<G>::NP * strip;
    }
    w.red = q;
    w.slot = q + 3 * 32;
    w.gath = w.slot + 4;
    return w;
}

// Local rows 0 .. n + 1 of every plane from a chain's (P, L0, L1) links.
template <int G>
__device__ __forceinline__ void cl_gauge_load(const GaugeParams& p, const ClGauge& w,
                                              const float* __restrict__ src) {
    const size_t V = (size_t)p.L0 * p.L1, strip = (size_t)(p.cl_rows + 2) * p.L1;
    const int rows = (w.s.n + 2) * p.L1;
    for (int q = 0; q < Layout<G>::P; ++q)
        for (int j = threadIdx.x; j < rows; j += Layout<G>::T) {
            const int lr = j / p.L1, c = j - lr * p.L1;
            w.L[q * strip + j] = src[q * V + (size_t)strip_row(w.s, lr, p.L0) * p.L1 + c];
        }
}

// The own rows of every plane into a chain's (P, L0, L1) links; thread t
// stores the sites it updated in pass 2.
template <int G>
__device__ __forceinline__ void cl_gauge_store(const GaugeParams& p, const ClGauge& w,
                                               float* __restrict__ dst) {
    const size_t V = (size_t)p.L0 * p.L1, strip = (size_t)(p.cl_rows + 2) * p.L1;
    const size_t at = (size_t)w.s.r0 * p.L1;
    const int own = w.s.n * p.L1;
    for (int q = 0; q < Layout<G>::P; ++q)
        for (int j = threadIdx.x; j < own; j += Layout<G>::T)
            dst[q * V + at + j] = w.L[q * strip + p.L1 + j];
}

// block_reduce, then the blocks' totals combined in rank order: the same in
// every thread of the cluster.  Its cluster barrier orders pass 1 before pass 2.
template <int T>
__device__ __forceinline__ Tot cl_reduce(float pl, float dn, int bad, ClGauge& w,
                                         cg::cluster_group& cl) {
    const Tot b = block_reduce<T>(pl, dn, bad, w.red);
    const float mine[3] = {b.plaq, b.dnorm, (float)b.bad};
    cluster_gather<3>(cl, mine, w.slot, w.gath, w.s.B);
    Tot t{w.gath[0], w.gath[1], w.gath[2] != 0.0f};
    for (int r = 1; r < w.s.B; ++r) {
        t.plaq = t.plaq + w.gath[3 * r];
        t.dnorm = nan_max(t.dnorm, w.gath[3 * r + 1]);
        t.bad |= w.gath[3 * r + 2] != 0.0f;
    }
    return t;
}

// run_frame() on the cluster: the strip's links in place, in shared memory.
template <int G>
__device__ FrameOut cl_run_frame(const GaugeParams& p, ClGauge& w, cg::cluster_group& cl,
                                 uint32_t step0, uint32_t k1, float dtau, float dmax) {
    constexpr int T = Layout<G>::T;
    const int L1 = p.L1, n = w.s.n, own = n * L1;
    const size_t strip = (size_t)(p.cl_rows + 2) * L1;
    float* up_halo = cl.map_shared_rank(w.L, w.s.up) + (size_t)(w.s.n_up + 1) * L1;
    float* dn_halo = cl.map_shared_rank(w.L, w.s.dn);
    FrameOut out{0.0f, dmax, 0};
    int bad = 0;
    for (int k = 0; k < p.loops; ++k) {  // cluster-uniform control flow
        float pl = 0.0f, dn = 0.0f;
        if (!p.cl_empty)
            for (int j = threadIdx.x; j < own; j += T) pass1<G>(w.lp, w.L, w.F, L1 + j, pl, dn);
        const Tot t = cl_reduce<T>(pl, dn, bad, w, cl);
        if (t.bad) {  // the previous micro-step tripped the chain
            out.unstable = 1;
            return out;
        }
        out.ps = out.ps + t.plaq * p.inv_vol;
        out.dmax = nan_max(out.dmax, t.dnorm);
        const float scale = nan_min(1.0f, p.cap / nan_max(t.dnorm, 1e-30f));
        const float de = dtau * scale;
        const float na = sqrtf(2.0f * de);
        const int mode = (k & 1) ? NOISE_KEPT : (k + 1 < p.loops ? NOISE_DRAW_KEEP : NOISE_DRAW);
        const uint32_t step = step0 + (uint32_t)(k & ~1);
        if (!p.cl_empty)
            for (int j = threadIdx.x; j < own; j += T) {
                const int i = L1 + j, lr = i / L1;
                pass2<G, true>(w.lp, w.L, w.F, w.zk, i, mode, k1, step, de, na, bad);
                if (lr == 1 || lr == n) {  // an edge row: into the neighbours' halo rows
                    const int c = i - lr * L1;
                    for (int q = 0; q < Layout<G>::P; ++q) {
                        const float v = w.L[q * strip + i];
                        if (lr == 1) up_halo[q * strip + c] = v;
                        if (lr == n) dn_halo[q * strip + c] = v;
                    }
                }
            }
        cl.sync();  // new links and halo rows are read as neighbours next
    }
    out.unstable = cl_reduce<T>(0.0f, 0.0f, bad, w, cl).bad;
    return out;
}

// Kernel 10 at B > 1: gauge_frame_kernel's arguments; force and zk are used
// only where the geometry keeps F and the noise in global memory.
template <int G>
__global__ void __launch_bounds__(Layout<G>::T)
gauge_frame_cl_kernel(GaugeParams p, const float* __restrict__ links_in,
                      const float* __restrict__ dmax_in, const float* __restrict__ dtau_in,
                      float* __restrict__ links_out, float* __restrict__ ps_out,
                      float* __restrict__ dmax_out, int32_t* __restrict__ unst_out,
                      float* __restrict__ force, float* __restrict__ zk) {
    cg::cluster_group cl = cg::this_cluster();
    const int ch = blockIdx.x / p.cl_B;
    const size_t V = (size_t)p.L0 * p.L1;
    ClGauge w = cl_gauge_layout<G>(p, (int)cl.block_rank(), ch, force, zk);
    cl_gauge_load<G>(p, w, links_in + ch * Layout<G>::P * V);
    __syncthreads();
    const uint32_t k1 = (uint32_t)STREAM_FIELD ^ ((uint32_t)ch << 8);
    const FrameOut fr = cl_run_frame<G>(p, w, cl, p.step0, k1, dtau_in[ch], dmax_in[ch]);
    cl_gauge_store<G>(p, w, links_out + ch * Layout<G>::P * V);
    if (w.s.rank == 0 && threadIdx.x == 0) {
        ps_out[ch] = fr.ps;
        dmax_out[ch] = fr.dmax;
        unst_out[ch] = fr.unstable;
    }
    cl.sync();  // no block leaves while a peer may still read its slot
}

// Kernel 11 at B > 1: the accepted links stay in links_out (global), each
// frame starts from them; gauge_frames_kernel's arguments but the work buffer.
template <int G>
__global__ void __launch_bounds__(Layout<G>::T)
gauge_frames_cl_kernel(GaugeParams p, const float* __restrict__ links_in,
                       const float* __restrict__ dmax_in, const float* __restrict__ dtau_in,
                       const float* __restrict__ pm_in, const int64_t* __restrict__ runs_in,
                       const int32_t* __restrict__ stab_in, float* __restrict__ links_out,
                       float* __restrict__ dmax_out, float* __restrict__ dtau_out,
                       float* __restrict__ pm_out, int64_t* __restrict__ runs_out,
                       int32_t* __restrict__ stab_out, int32_t* __restrict__ hist_stable,
                       float* __restrict__ hist_dtau, float* __restrict__ hist_dmax,
                       float* __restrict__ force, float* __restrict__ zk) {
    cg::cluster_group cl = cg::this_cluster();
    const int ch = blockIdx.x / p.cl_B, C = p.n_chains;
    const size_t V = (size_t)p.L0 * p.L1;
    ClGauge w = cl_gauge_layout<G>(p, (int)cl.block_rank(), ch, force, zk);
    const bool lead = w.s.rank == 0 && threadIdx.x == 0;
    float* A = links_out + ch * Layout<G>::P * V;  // the accepted links
    {
        const float* src = links_in + ch * Layout<G>::P * V;
        const size_t at = (size_t)w.s.r0 * p.L1;
        const int own = w.s.n * p.L1;
        for (int q = 0; q < Layout<G>::P; ++q)
            for (int j = threadIdx.x; j < own; j += Layout<G>::T)
                A[q * V + at + j] = src[q * V + at + j];
    }
    float dmax = dmax_in[ch], dtau = dtau_in[ch], pm = pm_in[ch];
    uint32_t lo = (uint32_t)runs_in[2 * ch], hi = (uint32_t)runs_in[2 * ch + 1];
    int32_t stab = stab_in[ch];
    const uint32_t loops_u = (uint32_t)p.loops;
    const uint32_t k1 = (uint32_t)STREAM_FIELD ^ ((uint32_t)ch << 8);

    for (int j = 0; j < p.n_frames; ++j) {
        __threadfence();
        cl.sync();  // every rank's accepted rows are in links_out; no peer reads our strip
        cl_gauge_load<G>(p, w, A);
        __syncthreads();
        const FrameOut fr = cl_run_frame<G>(p, w, cl, p.step0 + (uint32_t)j * loops_u, k1,
                                            dtau, dmax);
        // epilogue: gauge_frames_kernel's, expression for expression
        const bool accept = !fr.unstable;
        const uint32_t lo_n = lo + loops_u;
        const uint32_t hi_n = hi + (lo_n < lo ? 1u : 0u);
        const float n_new = __uint2float_rn(hi_n) * 4294967296.0f + __uint2float_rn(lo_n);
        const float wgt = p.loops_f / n_new;
        if (accept) {
            pm = pm + (fr.ps * p.inv_loops - pm) * wgt;
            dmax = fr.dmax;
            cl_gauge_store<G>(p, w, A);
            lo = lo_n;
            hi = hi_n;
        }
        const bool grow = accept && stab >= p.grow_after;
        float dt = grow ? dtau / p.shrink : (accept ? dtau : dtau * p.shrink);
        if (p.has_dtau_max) dt = fminf(dt, p.dtau_max);
        dtau = dt;
        stab = accept ? (stab >= p.grow_after ? 0 : stab + 1) : 0;
        if (lead) {
            hist_stable[(size_t)j * C + ch] = accept ? 1 : 0;
            hist_dtau[(size_t)j * C + ch] = dtau;
            hist_dmax[(size_t)j * C + ch] = fr.dmax;
        }
    }
    if (lead) {
        dmax_out[ch] = dmax;
        dtau_out[ch] = dtau;
        pm_out[ch] = pm;
        runs_out[2 * ch] = (int64_t)lo;
        runs_out[2 * ch + 1] = (int64_t)hi;
        stab_out[ch] = stab;
    }
    cl.sync();  // no block leaves while a peer may still read its slot
}

// ---- kernel 12: the chunk kernel on a thread-block cluster --------------------
//
// W micro-steps (W even) on the links of a shard's block of a lattice split
// along dim 0, extended by H = W rows of its ring neighbours above and below:
// (C, P, E0 = loc0 + 2 H, L1).  Dim 1 spans the whole lattice and wraps.  The
// halo rows are recomputed, not exchanged: their noise comes from the global
// counters, so they take the values their owner computes.  Chunk mode has no
// drift-cap rescale (it would need the lattice-wide drift max of every step: a
// collective per micro-step): while the cap is quiescent the scale of kernels
// 10 and 11 is exactly 1, so the links agree with theirs bit for bit.  A step
// whose drift norm (max over the chain's owned sites) exceeds the cap sets
// `capped`, a non-finite owned link sets `bad`, and the runner rejects the
// frame for either.  Out: the owned rows after W steps, the sum over steps of
// the owned sites' plaquette (a sum: the runner completes it across shards and
// normalises), the owned drift-norm max (NaN propagates) and the two flags.
//
// Design.  Step k (0-based) updates only the rows [k + 1, E0 - 1 - k): they
// alone reach the owned rows [H, H + loc0) by step W - 1, and they read only
// the rows [k, E0 - k) that step k - 1 updated (the input at k = 0), so nothing
// wraps in dim 0.  A chain runs on a cluster of B blocks (GaugeParams.cl_B,
// gauge_kernel.chunk_geometry): rank b owns the rows [b E0 / B, (b + 1) E0 / B)
// of the extended block (no ring: rank 0 has no rank above it, rank B - 1 none
// below) and holds them, with a halo row a side, in two buffers: step k reads
// one and writes the other, so a link is updated in one pass from its own
// drift (the scale is 1; pass1's and pass2's expressions, operand for operand)
// and no F goes to memory.  A block pushes its new first and last rows into
// its neighbours' halo rows of the buffer it wrote, through distributed shared
// memory: one cluster barrier a step, no reduction.  The kept odd-step noise
// (one Threefry pair serves two steps) stays per site of the strip, in shared
// memory where the budget allows (GaugeParams.cl_scratch), else in device
// memory.  Each block keeps its owned plaquette sum, its owned drift-norm max
// of every step (a warp's a step, in shared memory) and its `bad` flag; after
// the last step rank 0 combines the ranks' partials once, in rank order,
// through DSMEM, with no atomics.  `capped` compares each step's chain max
// (NaN-propagating over the ranks) with the cap, so a NaN drift in one block
// and a cap event in another at the same step give the chain's answer, NaN
// (not capped), as gauge_chunk_ref does.  Work items are the strip's sites of
// the step, or (GaugeParams.cl_split) a site's two link directions, over the
// block's threads.  At B = 1 the two buffers and the kept noise live in device
// memory (a whole extended block fits no block's shared memory at the timed
// shapes: u1 (144, 256) 584 KiB).

// Shared memory of a chunk block, in floats (kernels/_cluster.py mirrors it):
// the two link buffers of the strip (B > 1), the kept noise of the strip's rows
// if in shared memory, then the partials: a drift max a step and warp, the
// warps' plaquette sums, the block's slot (plaquette, bad, W step maxima), the
// gathered slots and the chain's drift max a step.
template <int G>
__host__ __device__ __forceinline__ size_t gauge_chunk_floats(const GaugeParams& p) {
    const size_t strip = p.cl_B > 1 ? (size_t)(p.cl_rows + 2) * p.L1 : 0;
    const size_t kept = p.cl_scratch ? (size_t)Layout<G>::NP * p.cl_rows * p.L1 : 0;
    const size_t W = (size_t)p.W;
    return 2 * Layout<G>::P * strip + kept + 32 * (W + 1) + (1 + SQ_MAX_CLUSTER) * (W + 2) + W;
}

// The planes of link direction mu: u1 plane mu; su2 2 c + mu; su3 18 mu + j.
template <int G>
__device__ __forceinline__ int dir_plane(int mu, int j) {
    if constexpr (G == GROUP_U1) return mu;
    else if constexpr (G == GROUP_SU2) return 2 * j + mu;
    else return 18 * mu + j;
}

// A site's noise in a chunk launch: the counter is noise<NP, true>'s (C-order
// over (noise plane, L0g, L1) of the global lattice); the second Box-Muller
// output is kept at zk[q * kv + j] for the next micro-step.
struct ChunkNoise {
    float* zk;
    size_t kv;       // floats of a kept-noise plane: cl_rows * L1
    int j;           // the site in a kept plane: (row - first strip row) * L1 + column
    uint32_t gsite;  // global row * L1 + column
};

__device__ __forceinline__ float chunk_noise(const GaugeParams& p, const ChunkNoise& z, int q,
                                             int mode, uint32_t k1, uint32_t step) {
    float* at = z.zk + q * z.kv + z.j;
    if (mode == NOISE_KEPT) return *at;
    float z0, z1;
    normal_pair<20>(p.seed, k1, (uint32_t)q * (uint32_t)(p.L0g * p.L1) + z.gsite, step, z0, z1);
    *at = z1;
    return z0;
}

// One link of a chunk micro-step: direction mu at row r, column c of the strip
// as pass1 sees it (`lp`: a lattice of cl_rows + 2 rows), its drift from the
// links A and its update into O.  `own`: an owned row, whose plaquette (with
// mu = 0), drift norm and finiteness count.
template <int G>
__device__ __forceinline__ void chunk_link(const GaugeParams& lp, const float* __restrict__ A,
                                           float* __restrict__ O, const ChunkNoise& z, int r,
                                           int c, int mu, int mode, uint32_t k1, uint32_t step,
                                           float de, float na, bool own, float& pl, float& dn,
                                           int& bad) {
    const size_t V = (size_t)lp.L0 * lp.L1;
    const Nbr n{lp.L0, lp.L1};
    const int i = r * lp.L1 + c;
    if constexpr (G == GROUP_U1) {
        const float* t0 = A;
        const float* t1 = A + V;
        float a;
        if (mu == 0) {
            const float p01 = u1_p01(t0, t1, n, r, c);
            a = (0.0f + sinf(p01)) - sinf(u1_p01(t0, t1, n, r, c - 1));
            if (own) pl += cosf(p01);
        } else {
            a = (0.0f + sinf(u1_p10(t0, t1, n, r, c))) - sinf(u1_p10(t0, t1, n, r - 1, c));
        }
        const float f = lp.coef * a;
        const float eta = chunk_noise(lp, z, mu, mode, k1, step);
        const float t = A[mu * V + i] + (de * f + na * eta);
        const float two_pi = 6.2831854820251465f;  // float32(2 pi)
        const float nt = t - two_pi * rintf(t / two_pi);
        O[mu * V + i] = nt;
        if (own) {
            dn = nan_max(dn, fabsf(f));
            bad |= !isfinite(nt);
        }
    } else if constexpr (G == GROUP_SU2) {
        const int nu = 1 - mu;
        const int mr = mu == 0, mc = mu == 1, nr = nu == 0, nc = nu == 1;
        const Quat fwd = qmul(qmul(qload(A, V, nu, n.at(r, c, mr, mc)),
                                   qconj(qload(A, V, mu, n.at(r, c, nr, nc)))),
                              qconj(qload(A, V, nu, i)));
        const Quat bwd = qmul(qmul(qconj(qload(A, V, nu, n.at(r, c, mr - nr, mc - nc))),
                                   qconj(qload(A, V, mu, n.at(r, c, -nr, -nc)))),
                              qload(A, V, nu, n.at(r, c, -nr, -nc)));
        const Quat link = qload(A, V, mu, i);
        const Quat w = qmul(link, qadd(fwd, bwd));
        const float f[3] = {lp.coef * w.x, lp.coef * w.y, lp.coef * w.z};
        if (own && mu == 0) {
            const Quat pq = qmul(qmul(link, qload(A, V, 1, n.at(r, c, 1, 0))),
                                 qmul(qconj(qload(A, V, 0, n.at(r, c, 0, 1))),
                                      qconj(qload(A, V, 1, i))));
            pl += pq.w;
        }
        float om[3];
#pragma unroll
        for (int a = 0; a < 3; ++a)
            om[a] = de * f[a] + na * chunk_noise(lp, z, 2 * a + mu, mode, k1, step);
        const Quat q = qnormalize(qmul(qexp_su2(om[0], om[1], om[2]), link));
        O[(0 + mu) * V + i] = q.w;
        O[(2 + mu) * V + i] = q.x;
        O[(4 + mu) * V + i] = q.y;
        O[(6 + mu) * V + i] = q.z;
        if (own) {
            dn = nan_max(dn, sqrtf(f[0] * f[0] + f[1] * f[1] + f[2] * f[2]));
            bad |= !(isfinite(q.w) && isfinite(q.x) && isfinite(q.y) && isfinite(q.z));
        }
    } else {
        const int nu = 1 - mu;
        const int mr = mu == 0, mc = mu == 1, nr = nu == 0, nc = nu == 1;
        const M3 fwd = mmul(mmul(mload(A, V, nu, n.at(r, c, mr, mc)),
                                 mdag(mload(A, V, mu, n.at(r, c, nr, nc)))),
                            mdag(mload(A, V, nu, i)));
        const M3 bwd = mmul(mmul(mdag(mload(A, V, nu, n.at(r, c, mr - nr, mc - nc))),
                                 mdag(mload(A, V, mu, n.at(r, c, -nr, -nc)))),
                            mload(A, V, nu, n.at(r, c, -nr, -nc)));
        M3 staple;
#pragma unroll
        for (int a = 0; a < 3; ++a)
#pragma unroll
            for (int b = 0; b < 3; ++b) staple.a[a][b] = cadd(fwd.a[a][b], bwd.a[a][b]);
        const M3 m = mmul(mload(A, V, mu, i), staple);
        M3 g;
#pragma unroll
        for (int a = 0; a < 3; ++a)
#pragma unroll
            for (int b = 0; b < 3; ++b)
                g.a[a][b] = {-(m.a[a][b].im + m.a[b][a].im), m.a[a][b].re - m.a[b][a].re};
        const Cx tr = cadd(cadd(g.a[0][0], g.a[1][1]), g.a[2][2]);
        const Cx trn = {tr.re / 3.0f, tr.im / 3.0f};
        M3 h;
        float frob = 0.0f;
#pragma unroll
        for (int a = 0; a < 3; ++a)
#pragma unroll
            for (int b = 0; b < 3; ++b) {
                const Cx x = a == b ? csub(g.a[a][b], trn) : g.a[a][b];
                h.a[a][b] = {lp.coef * x.re, lp.coef * x.im};
                const float v = h.a[a][b].re * h.a[a][b].re + h.a[a][b].im * h.a[a][b].im;
                frob = (a == 0 && b == 0) ? v : frob + v;
            }
        if (own && mu == 0) {
            const M3 pm = mmul(mmul(mload(A, V, 0, i), mload(A, V, 1, n.at(r, c, 1, 0))),
                               mmul(mdag(mload(A, V, 0, n.at(r, c, 0, 1))),
                                    mdag(mload(A, V, 1, i))));
            pl += mretr(pm) / 3.0f;
        }
        float e[8];
#pragma unroll
        for (int a = 0; a < 8; ++a) e[a] = chunk_noise(lp, z, 2 * a + mu, mode, k1, step);
        const M3 nt = noise_h(e);
        M3 om;
#pragma unroll
        for (int a = 0; a < 3; ++a)
#pragma unroll
            for (int b = 0; b < 3; ++b)
                om.a[a][b] = {de * h.a[a][b].re + na * nt.a[a][b].re,
                              de * h.a[a][b].im + na * nt.a[a][b].im};
        const M3 u = project_su3(mmul(expi_su3(om, lp.clip_hi), mload(A, V, mu, i)));
        mstore(O, V, mu, i, u);
        if (own) {
            bool fin = true;
#pragma unroll
            for (int a = 0; a < 3; ++a)
#pragma unroll
                for (int b = 0; b < 3; ++b)
                    fin = fin && isfinite(u.a[a][b].re) && isfinite(u.a[a][b].im);
            dn = nan_max(dn, sqrtf(2.0f * frob));
            bad |= !fin;
        }
    }
}

// Kernel 12 on C clusters of B blocks (B = 1: one block a chain, SMEM false:
// the link buffers in `links`, (C, 2, P, E0 + 2, L1)).  `zk`: the kept noise,
// (C, B, NP, cl_rows, L1), where shared memory does not hold it.
template <int G, bool SMEM>
__global__ void __launch_bounds__(Layout<G>::T)
gauge_chunk_kernel(GaugeParams p, const float* __restrict__ ext_in,
                   const float* __restrict__ dtau_in, float* __restrict__ owned_out,
                   float* __restrict__ ps_out, float* __restrict__ dmax_out,
                   int32_t* __restrict__ bad_out, int32_t* __restrict__ cap_out,
                   float* __restrict__ links, float* __restrict__ zk_g) {
    constexpr int T = Layout<G>::T, P = Layout<G>::P, NP = Layout<G>::NP, NW = T / 32;
    extern __shared__ float sm[];
    cg::cluster_group cl = cg::this_cluster();
    const int B = p.cl_B, rank = (int)cl.block_rank(), ch = blockIdx.x / B;
    const int E0 = p.L0, L1 = p.L1, W = p.W;
    const int r0 = strip_first(rank, E0, B), n = strip_first(rank + 1, E0, B) - r0;
    const size_t strip = (size_t)(p.cl_rows + 2) * L1, kv = (size_t)p.cl_rows * L1;
    const size_t blk = (size_t)ch * B + rank;
    float* q = sm;
    float* buf = SMEM ? q : links + blk * 2 * P * strip;  // buffer b at buf + b P strip
    if (SMEM) q += 2 * P * strip;
    float* zk = q;
    if (p.cl_scratch) q += NP * kv;
    else zk = zk_g + blk * NP * kv;
    float* dnw = q;                               // W x 32: a warp's owned drift max a step
    float* red = dnw + 32 * W;                    // 32: the warps' plaquette sums
    float* slot = red + 32;                       // W + 2: plaquette, bad, the step maxima
    float* gath = slot + W + 2;                   // SQ_MAX_CLUSTER x (W + 2): rank 0's copy
    float* cdn = gath + SQ_MAX_CLUSTER * (W + 2);  // W: the chain's drift max a step

    // rows r0 - 1 .. r0 + n of the extended block, those that exist, into buffer 0
    const float* src = ext_in + (size_t)ch * P * E0 * L1;
    for (int qp = 0; qp < P; ++qp)
        for (int j = threadIdx.x; j < (n + 2) * L1; j += T) {
            const int lr = j / L1, r = r0 + lr - 1;
            if (r >= 0 && r < E0)
                buf[qp * strip + j] = src[((size_t)qp * E0 + r) * L1 + (j - lr * L1)];
        }
    // the neighbours' halo rows of each buffer: rank - 1's row n_up + 1, rank + 1's row 0
    float* up_halo[2] = {nullptr, nullptr};
    float* dn_halo[2] = {nullptr, nullptr};
    if constexpr (SMEM) {
        const int n_up = r0 - strip_first(rank - 1, E0, B);
        for (int b = 0; b < 2; ++b) {
            if (rank > 0)
                up_halo[b] = cl.map_shared_rank(buf + b * P * strip, rank - 1) +
                             (size_t)(n_up + 1) * L1;
            if (rank + 1 < B) dn_halo[b] = cl.map_shared_rank(buf + b * P * strip, rank + 1);
        }
    }
    cl.sync();  // every strip loaded and every block of the cluster running (DSMEM below)

    GaugeParams lp = p;
    lp.L0 = p.cl_rows + 2;
    const int g0 = (int)(p.row_off % (uint32_t)p.L0g) - p.H;  // global row of extended row 0
    const uint32_t k1 = (uint32_t)STREAM_FIELD ^ ((p.chain_off + (uint32_t)ch) << 8);
    const float dtau = dtau_in[ch];
    const float na = sqrtf(2.0f * dtau);
    const int own_lo = p.H, own_hi = p.H + p.loc0;
    const int per = p.cl_split ? 1 : 2;  // link directions an item
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    float pl = 0.0f;
    int bad = 0;
    for (int k = 0; k < W; ++k) {  // cluster-uniform control flow
        const float* A = buf + (k & 1) * P * strip;
        float* O = buf + ((k & 1) ^ 1) * P * strip;
        const int lo = max(r0, k + 1), hi = min(r0 + n, E0 - 1 - k);
        const int sites = hi > lo ? (hi - lo) * L1 : 0;
        const int items = per == 1 ? 2 * sites : sites;
        const int mode = (k & 1) ? NOISE_KEPT : NOISE_DRAW_KEEP;
        const uint32_t step = p.step0 + (uint32_t)(k & ~1);
        float dn = 0.0f;
        for (int it = threadIdx.x; it < items; it += T) {
            const int mu0 = it >= sites ? 1 : 0;
            const int s = it - mu0 * sites, rr = s / L1, c = s - rr * L1;
            const int r = lo + rr, lr = r - r0 + 1;  // extended and local row
            int rg = (g0 + r) % p.L0g;
            if (rg < 0) rg += p.L0g;
            const ChunkNoise z{zk, kv, (r - r0) * L1 + c, (uint32_t)rg * (uint32_t)L1 + (uint32_t)c};
            const bool own = r >= own_lo && r < own_hi;
#pragma unroll 1
            for (int mu = mu0; mu < mu0 + per; ++mu) {
                chunk_link<G>(lp, A, O, z, lr, c, mu, mode, k1, step, dtau, na, own, pl, dn, bad);
                if constexpr (SMEM) {  // an edge row: into the neighbour's halo row
                    float* to = lr == 1 ? up_halo[(k & 1) ^ 1] : nullptr;
                    float* to2 = lr == n ? dn_halo[(k & 1) ^ 1] : nullptr;
                    if (to || to2)
                        for (int j = 0; j < P / 2; ++j) {
                            const size_t at = (size_t)dir_plane<G>(mu, j) * strip;
                            const float v = O[at + (size_t)lr * L1 + c];
                            if (to) to[at + c] = v;
                            if (to2) to2[at + c] = v;
                        }
                }
            }
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
            dn = nan_max(dn, __shfl_xor_sync(0xffffffffu, dn, off));
        if (lane == 0) dnw[k * 32 + warp] = dn;
        cl.sync();  // the new rows and halo rows are read as neighbours next
    }

    // W is even: the last step wrote buffer 0.  The owned rows of this strip out.
    const int olo = max(r0, own_lo), ohi = min(r0 + n, own_hi);
    const size_t own = (size_t)p.loc0 * L1;
    for (int qp = 0; qp < P; ++qp)
        for (int j = threadIdx.x; j < (ohi - olo) * L1; j += T)
            owned_out[((size_t)ch * P + qp) * own + (size_t)(olo - own_lo) * L1 + j] =
                buf[qp * strip + (size_t)(olo - r0 + 1) * L1 + j];

    // the block's slot: its plaquette sum (warps in order), bad, each step's max
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) pl += __shfl_xor_sync(0xffffffffu, pl, off);
    if (lane == 0) red[warp] = pl;
    const int bad_blk = __syncthreads_or(bad);
    if (threadIdx.x == 0) {
        float s = red[0];
        for (int w = 1; w < NW; ++w) s = s + red[w];
        slot[0] = s;
        slot[1] = (float)bad_blk;
    }
    for (int k = threadIdx.x; k < W; k += T) {
        float m = dnw[k * 32];
        for (int w = 1; w < NW; ++w) m = nan_max(m, dnw[k * 32 + w]);
        slot[2 + k] = m;
    }
    cl.sync();  // every rank's slot is written
    if (rank == 0) {  // the ranks in order, once
        const int nv = W + 2;
        for (int j = threadIdx.x; j < B * nv; j += T) gath[j] = cl.map_shared_rank(slot, j / nv)[j % nv];
        __syncthreads();
        for (int k = threadIdx.x; k < W; k += T) {
            float m = gath[2 + k];
            for (int r = 1; r < B; ++r) m = nan_max(m, gath[r * nv + 2 + k]);
            cdn[k] = m;
        }
        __syncthreads();
        if (threadIdx.x == 0) {
            float ps = gath[0];
            int bd = gath[1] != 0.0f;
            for (int r = 1; r < B; ++r) {
                ps = ps + gath[r * nv];
                bd |= gath[r * nv + 1] != 0.0f;
            }
            float dmax = 0.0f;
            int capped = 0;
            for (int k = 0; k < W; ++k) {  // the chain's max of each step, as kernels 10, 11
                dmax = nan_max(dmax, cdn[k]);
                capped |= cdn[k] > p.cap;
            }
            ps_out[ch] = ps;
            dmax_out[ch] = dmax;
            bad_out[ch] = bd;
            cap_out[ch] = capped;
        }
    }
    cl.sync();  // no block leaves while rank 0 may still read its slot
}

// ---- C entry points (loaded with ctypes) ----------------------------------

static bool valid_gauge_launch(const GaugeParams& p) {
    const int B = p.cl_B;
    const bool cluster = B == 1 || ((B == 2 || B == 4 || B == 8 || B == 16) && B <= p.L0 &&
                                    p.cl_rows == (p.L0 + B - 1) / B &&
                                    (p.cl_scratch == 0 || p.cl_scratch == 1));
    return p.n_chains > 0 && p.n_chains <= 65535 && p.L0 >= 1 && p.L1 >= 1 &&
           (long long)p.L0 * p.L1 <= (1LL << 24) && p.loops >= 1 && p.group >= GROUP_U1 &&
           p.group <= GROUP_SU3 && cluster;
}

#define SQ_GAUGE_DISPATCH(KERNEL, ...)                                                     \
    do {                                                                                   \
        cudaStream_t st = (cudaStream_t)stream;                                            \
        if (p->group == GROUP_U1)                                                          \
            KERNEL<GROUP_U1><<<p->n_chains, Layout<GROUP_U1>::T, 0, st>>>(*p, __VA_ARGS__);  \
        else if (p->group == GROUP_SU2)                                                    \
            KERNEL<GROUP_SU2><<<p->n_chains, Layout<GROUP_SU2>::T, 0, st>>>(*p, __VA_ARGS__); \
        else                                                                               \
            KERNEL<GROUP_SU3><<<p->n_chains, Layout<GROUP_SU3>::T, 0, st>>>(*p, __VA_ARGS__); \
    } while (0)

// B > 1: n_chains clusters of B blocks; returns the launch's error.
#define SQ_GAUGE_CL_LAUNCH(KERNEL, G, ...)                                                 \
    return (int)launch_cluster(KERNEL<G>, p->n_chains, Layout<G>::T,                       \
                               gauge_cl_floats<G>(*p) * sizeof(float), p->cl_B,            \
                               (cudaStream_t)stream, *p, __VA_ARGS__)
#define SQ_GAUGE_CL_DISPATCH(KERNEL, ...)                                                  \
    do {                                                                                   \
        if (p->group == GROUP_U1) SQ_GAUGE_CL_LAUNCH(KERNEL, GROUP_U1, __VA_ARGS__);       \
        if (p->group == GROUP_SU2) SQ_GAUGE_CL_LAUNCH(KERNEL, GROUP_SU2, __VA_ARGS__);     \
        SQ_GAUGE_CL_LAUNCH(KERNEL, GROUP_SU3, __VA_ARGS__);                                \
    } while (0)

extern "C" int sq_gauge_frame(const GaugeParams* p, const float* links_in, const float* dmax_in,
                              const float* dtau_in, float* links_out, float* ps_out,
                              float* dmax_out, int32_t* unst_out, float* force, float* zk,
                              void* stream) {
    if (!valid_gauge_launch(*p)) return (int)cudaErrorInvalidValue;
    if (p->cl_B > 1)
        SQ_GAUGE_CL_DISPATCH(gauge_frame_cl_kernel, links_in, dmax_in, dtau_in, links_out, ps_out,
                             dmax_out, unst_out, force, zk);
    SQ_GAUGE_DISPATCH(gauge_frame_kernel, links_in, dmax_in, dtau_in, links_out, ps_out,
                      dmax_out, unst_out, force, zk);
    return (int)cudaGetLastError();
}

extern "C" int sq_gauge_frames(const GaugeParams* p, const float* links_in,
                               const float* dmax_in, const float* dtau_in, const float* pm_in,
                               const int64_t* runs_in, const int32_t* stab_in,
                               float* links_out, float* dmax_out, float* dtau_out,
                               float* pm_out, int64_t* runs_out, int32_t* stab_out,
                               int32_t* hist_stable, float* hist_dtau, float* hist_dmax,
                               float* work, float* force, float* zk, void* stream) {
    if (!valid_gauge_launch(*p) || p->n_frames < 1) return (int)cudaErrorInvalidValue;
    if (p->cl_B > 1)
        SQ_GAUGE_CL_DISPATCH(gauge_frames_cl_kernel, links_in, dmax_in, dtau_in, pm_in, runs_in,
                             stab_in, links_out, dmax_out, dtau_out, pm_out, runs_out, stab_out,
                             hist_stable, hist_dtau, hist_dmax, force, zk);
    SQ_GAUGE_DISPATCH(gauge_frames_kernel, links_in, dmax_in, dtau_in, pm_in, runs_in, stab_in,
                      links_out, dmax_out, dtau_out, pm_out, runs_out, stab_out, hist_stable,
                      hist_dtau, hist_dmax, work, force, zk);
    return (int)cudaGetLastError();
}

static bool valid_gauge_chunk(const GaugeParams& p) {
    const int B = p.cl_B;
    return valid_gauge_launch(p) && p.W >= 2 && p.W % 2 == 0 && p.H == p.W && p.loc0 >= 1 &&
           p.L0 == p.loc0 + 2 * p.H && p.L0g >= 1 && (long long)p.L0g * p.L1 <= (1LL << 24) &&
           p.cl_rows == (p.L0 + B - 1) / B && (B > 1 || p.cl_scratch == 0) &&
           (p.cl_split == 0 || p.cl_split == 1);
}

// B > 1: n_chains clusters of B blocks, the strips in shared memory; B = 1: one
// block a chain, the buffers in device memory.  Returns the launch's error.
template <int G, typename... Args>
static int launch_gauge_chunk(const GaugeParams& p, cudaStream_t st, Args... args) {
    const size_t smem = gauge_chunk_floats<G>(p) * sizeof(float);
    if (p.cl_B > 1)
        return (int)launch_cluster(gauge_chunk_kernel<G, true>, p.n_chains, Layout<G>::T, smem,
                                   p.cl_B, st, p, args...);
    return (int)launch_cluster(gauge_chunk_kernel<G, false>, p.n_chains, Layout<G>::T, smem, 1,
                               st, p, args...);
}

extern "C" int sq_gauge_chunk(const GaugeParams* p, const float* ext_in, const float* dtau_in,
                              float* owned_out, float* ps_out, float* dmax_out,
                              int32_t* bad_out, int32_t* cap_out, float* links, float* zk,
                              void* stream) {
    if (!valid_gauge_chunk(*p)) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    if (p->group == GROUP_U1)
        return launch_gauge_chunk<GROUP_U1>(*p, st, ext_in, dtau_in, owned_out, ps_out, dmax_out,
                                            bad_out, cap_out, links, zk);
    if (p->group == GROUP_SU2)
        return launch_gauge_chunk<GROUP_SU2>(*p, st, ext_in, dtau_in, owned_out, ps_out,
                                             dmax_out, bad_out, cap_out, links, zk);
    return launch_gauge_chunk<GROUP_SU3>(*p, st, ext_in, dtau_in, owned_out, ps_out, dmax_out,
                                         bad_out, cap_out, links, zk);
}

// Chains of kernel 12 the card runs at once in the geometry of p: resident
// clusters of cl_B blocks, or at cl_B = 1 resident blocks (the rule's answer).
template <int G>
static cudaError_t gauge_chunk_resident(const GaugeParams& p, int* out) {
    constexpr int T = Layout<G>::T;
    const size_t smem = gauge_chunk_floats<G>(p) * sizeof(float);
    if (p.cl_B == 1) return resident_blocks(gauge_chunk_kernel<G, false>, T, out, smem);
    return resident_clusters(gauge_chunk_kernel<G, true>, T, smem, p.cl_B, out);
}

extern "C" int sq_gauge_chunk_resident(const GaugeParams* p, int, int* out) {
    *out = 0;
    if (!valid_gauge_chunk(*p)) return (int)cudaErrorInvalidValue;
    if (p->group == GROUP_U1) return (int)gauge_chunk_resident<GROUP_U1>(*p, out);
    if (p->group == GROUP_SU2) return (int)gauge_chunk_resident<GROUP_SU2>(*p, out);
    return (int)gauge_chunk_resident<GROUP_SU3>(*p, out);
}

// Chains of kernel 10 (multi = 0) or 11 (multi = 1) the card runs at once in
// the geometry of p (cl_B, cl_rows, cl_scratch): resident clusters of cl_B
// blocks, or at cl_B = 1 resident blocks.  The geometry rule's occupancy answer.
template <int G>
static cudaError_t gauge_resident(const GaugeParams& p, int multi, int* out) {
    constexpr int T = Layout<G>::T;
    if (p.cl_B == 1)
        return multi ? resident_blocks(gauge_frames_kernel<G>, T, out)
                     : resident_blocks(gauge_frame_kernel<G>, T, out);
    const size_t smem = gauge_cl_floats<G>(p) * sizeof(float);
    return multi ? resident_clusters(gauge_frames_cl_kernel<G>, T, smem, p.cl_B, out)
                 : resident_clusters(gauge_frame_cl_kernel<G>, T, smem, p.cl_B, out);
}

extern "C" int sq_gauge_resident(const GaugeParams* p, int multi, int* out) {
    *out = 0;
    if (!valid_gauge_launch(*p)) return (int)cudaErrorInvalidValue;
    if (p->group == GROUP_U1) return (int)gauge_resident<GROUP_U1>(*p, multi, out);
    if (p->group == GROUP_SU2) return (int)gauge_resident<GROUP_SU2>(*p, multi, out);
    return (int)gauge_resident<GROUP_SU3>(*p, multi, out);
}

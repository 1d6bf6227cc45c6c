// Reference oracle: a from-scratch, deterministic C++ implementation of the
// algorithm of the reference implementation (tauhost.c + tau_kernel.cl), used for
//   (a) measuring the reference baseline in site-updates/sec on the host
//       (the OpenCL original's GPU trajectories are irreproducible because
//       every work-item races on one RNG seed, SURVEY.md flaw F2),
//   (b) statistical cross-validation of equilibrium observables against the
//       port's kernels at identical lattice/step parameters, and
//   (c) reading/writing the reference's "%a" hex-float checkpoint format
//       (tauhost.c:562-581 writer, tauhost.c:103-173 reader).
//
// Semantics mirrored from the reference (cited per function); the shared-seed
// LCG is serialised in ascending site order to make it deterministic.
//
// Built at first use by stochquant_tpu_torch/oracle.py (g++, the flags there)
// into build/stochquant_tpu_torch/oracle/<hash>/liboracle.so and loaded with
// ctypes; the same source as the JAX package's stochquant_tpu/cc/oracle.cpp.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <chrono>

namespace {

// Physics constants, tau_kernel.cl:19-22.
constexpr double kEta = 0.8;
constexpr double kV0 = 2.0;
constexpr double kMass = 1.0;

// Backgrounds / curvatures / zero-mode constants, tau_kernel.cl:184-256.
double kink(double t, double t0) {
  return kEta * std::tanh(std::sqrt(2.0 * kV0 / kMass) * (t - t0) / kEta);
}

double x_cl(double t, double t0, int pot) {
  return pot == 3 ? kink(t, t0) : 0.0;  // pot 0: harmOscSol ≡ 0
}

double dd_pot(double a, int pot) {
  if (pot == 3) return (12.0 * kV0 * a * a / (kEta * kEta) - 4.0 * kV0) / (kEta * kEta);
  return 2.0;  // pot 0: harmOscPot ≡ 2
}

double zero_mode_const(int pot) {
  if (pot == 3)
    return std::sqrt(3.0) * std::pow(2.0, -1.25) * std::pow(kV0, -0.25) /
           std::sqrt(kEta);
  return 0.0;
}

// 48-bit LCG with drand48 constants + Box–Muller, tau_kernel.cl:269-284.
// The reference lets every work-item hammer one shared seed; we serialise the
// same update in site order, keeping the gid-offset scheme.
struct RefRng {
  uint64_t seed;

  double normal(int gid) {
    constexpr uint64_t kA = 0x5DEECE66DULL, kB = 0xBULL;
    constexpr uint64_t kMask = (1ULL << 48) - 1;
    double result;
    do {
      uint64_t temp = ((seed + (uint64_t)gid) * kA + kB) & kMask;
      double v1 = (double)(temp >> 16) / 4294967296.0;
      temp = ((temp + (uint64_t)gid) * kA + kB) & kMask;
      double v2 = (double)(temp >> 16) / 4294967296.0;
      result = std::cos(2.0 * 3.1415 * v2) * std::sqrt(-2.0 * std::log(v1));
      // seed update rule, tau_kernel.cl:278-281
      if (seed < (1ULL << 31) && temp < (1ULL << 31))
        seed += temp;
      else
        seed = temp - (1ULL << 31);
    } while (std::isinf(result));
    return result;
  }
};

}  // namespace

extern "C" {

// One frame = `loops` micro-steps of the synchronous update over N sites plus
// the collective coordinate (tau_kernel.cl:64-173), with the reference's
// clamp, argmax-site stability detector and running means.  Returns 1 if the
// frame stayed stable.  State arrays are length N; scratch `newf` likewise.
int sq_ref_frame(int N, double dt, double dtau, int loops, int pot, double c,
                 double* f, double* x, double* xx0, double* omega,
                 uint64_t* rng_seed, int* lrg_el, double* lrg_vl, int runs,
                 double* newf, double* newx, double* newxx0) {
  RefRng rng{*rng_seed};
  int stable = 1;
  const int midpt = N / 2;
  const double max_clamp = 1000.0;
  double om = *omega;
  for (int j = 0; j < loops && stable; ++j) {
    const double amp = c * std::sqrt(2.0 * dtau / dt);
    // synchronous site update reading the old field (the reference's
    // double-buffer newf[], tau_kernel.cl:111-117 with BC mode 1 at :74,:92)
    for (int i = 0; i < N; ++i) {
      double dw = amp * rng.normal(i);
      double left = (i == 0) ? (-kEta - x_cl(-dt, om, pot)) : f[i - 1];
      double right = (i == N - 1) ? (kEta - x_cl((double)N * dt, om, pot)) : f[i + 1];
      double lap = kMass * (right + left - 2.0 * f[i]) / (dt * dt);
      double nf = f[i] + dtau * lap -
                  dd_pot(x_cl((double)i * dt, om, pot), pot) * f[i] * dtau + dw;
      // clamp + definitize, tau_kernel.cl:119-133
      if (nf > max_clamp) nf = max_clamp;
      if (nf < -max_clamp) nf = -max_clamp;
      if (std::isinf(nf) || std::isnan(nf)) nf = max_clamp;
      newf[i] = nf;
      // argmax-site stability detector, tau_kernel.cl:135-143
      double xi = nf + x_cl((double)i * dt, om, pot);
      double xa = newf[*lrg_el] + x_cl((double)(*lrg_el) * dt, om, pot);
      if (xi > xa) {
        *lrg_el = i;
        if (std::fabs(nf - f[i] - dw) > *lrg_vl) stable = 0;
      }
      if (std::fabs(xi) > *lrg_vl) *lrg_vl = std::fabs(xi);
      // running means of the pre-update field, tau_kernel.cl:144-145
      double xo = f[i] + x_cl((double)i * dt, om, pot);
      double xm = f[midpt] + x_cl((double)midpt * dt, om, pot);
      double n = (double)(runs + j + 1);
      newxx0[i] = xx0[i] + (xo * xm - xx0[i]) / n;
      newx[i] = x[i] + (xo - x[i]) / n;
    }
    // collective coordinate (virtual work-item N), tau_kernel.cl:103-110 +
    // reflection :155-167
    double dw_om = c * std::sqrt(2.0 * dtau) * rng.normal(N);
    double nom = om + zero_mode_const(pot) * dw_om;
    double upper = (double)(N - 1) * dt;
    if (nom > upper)
      om = 2.0 * upper - nom;
    else if (nom < 0)
      om = -nom;
    else
      om = nom;
    // buffer swap (tau_kernel.cl:147-151; last-iteration copy is harmless
    // here because the caller only sees the arrays we hand back)
    std::memcpy(f, newf, sizeof(double) * N);
    std::memcpy(x, newx, sizeof(double) * N);
    std::memcpy(xx0, newxx0, sizeof(double) * N);
  }
  *omega = om;
  *rng_seed = rng.seed;
  return stable;
}

// Host macro-step loop with adaptive dtau (tauhost.c:479-560): rollback on
// unstable frames, shrink by 0.95, grow by /0.95 after >10 stable frames.
// Returns achieved site-updates/sec.  `dtau` is in/out; `runs` accumulates
// accepted micro-steps.
double sq_ref_run(int N, double dt, double* dtau, int frames, int loops,
                  int pot, double c, uint64_t seed0, double* f, double* x,
                  double* xx0, double* xavg, double* omega, int* runs) {
  double* newf = (double*)malloc(sizeof(double) * N);
  double* newx = (double*)malloc(sizeof(double) * N);
  double* newxx0 = (double*)malloc(sizeof(double) * N);
  double* f_save = (double*)malloc(sizeof(double) * N);
  double* x_save = (double*)malloc(sizeof(double) * N);
  double* xx0_save = (double*)malloc(sizeof(double) * N);
  uint64_t seed = seed0;
  int lrg_el = 0;
  double lrg_vl = 0.0;
  int stab_cnt = 0;
  const int midpt = N / 2;
  uint64_t updates = 0;
  auto t0 = std::chrono::steady_clock::now();
  for (int frame = 0; frame < frames; ++frame) {
    std::memcpy(f_save, f, sizeof(double) * N);
    std::memcpy(x_save, x, sizeof(double) * N);
    std::memcpy(xx0_save, xx0, sizeof(double) * N);
    double om_save = *omega;
    int stable = sq_ref_frame(N, dt, *dtau, loops, pot, c, f, x, xx0, omega,
                              &seed, &lrg_el, &lrg_vl, *runs, newf, newx,
                              newxx0);
    updates += (uint64_t)(N + 1) * (uint64_t)loops;
    if (stable) {
      for (int i = 0; i < N; ++i) xavg[i] = xx0[i] - x[i] * x[midpt];
      if (stab_cnt > 10) {  // growth rule, tauhost.c:523-528
        stab_cnt = 0;
        *dtau /= 0.95;
      }
      ++stab_cnt;
      *runs += loops;
    } else {  // rollback + shrink, tauhost.c:533-544
      std::memcpy(f, f_save, sizeof(double) * N);
      std::memcpy(x, x_save, sizeof(double) * N);
      std::memcpy(xx0, xx0_save, sizeof(double) * N);
      *omega = om_save;
      *dtau *= 0.95;
      stab_cnt = 0;
    }
  }
  auto t1 = std::chrono::steady_clock::now();
  double secs = std::chrono::duration<double>(t1 - t0).count();
  free(newf); free(newx); free(newxx0);
  free(f_save); free(x_save); free(xx0_save);
  return secs > 0 ? (double)updates / secs : 0.0;
}

// Cold start (tauhost.c:84-102): f ~ width*N(0,1) via rand()-driven
// Box–Muller; omega at the lattice midpoint plus noise, folded into range.
void sq_ref_init(int N, double dt, double dtau, uint64_t seed, double* f,
                 double* x, double* xx0, double* xavg, double* omega) {
  srand((unsigned)seed);
  for (int i = 0; i < N; ++i) {
    double v1 = (rand() + 1.0) / ((double)RAND_MAX + 2.0);
    double v2 = (rand() + 1.0) / ((double)RAND_MAX + 2.0);
    f[i] = std::sqrt(2.0 * dtau) * std::cos(2.0 * M_PI * v2) *
           std::sqrt(-2.0 * std::log(v1));
    x[i] = 0.0;
    xx0[i] = 0.0;
    xavg[i] = 0.0;
  }
  double om = dt * N / 2.0 +
              std::sqrt(dt) * ((rand() / (double)RAND_MAX) - 0.5);
  double upper = (double)(N - 1) * dt;
  if (om > upper) om = 2.0 * upper - om;
  if (om < 0) om = -om;
  *omega = om;
}

// "%a" checkpoint writer, format of tauhost.c:562-581:
//   N rows "xavg| xx0| x| f" as hex floats, then omega, total runs, dtau.
int sq_ckpt_write(const char* path, int N, const double* xavg,
                  const double* xx0, const double* x, const double* f,
                  double omega, int runs, double dtau, int width) {
  FILE* fp = std::fopen(path, "w");
  if (!fp) return -1;
  for (int i = 0; i < N; ++i)
    std::fprintf(fp, "% -*a| % -*a| % -*a| % -*a\n", width, xavg[i], width,
                 xx0[i], width, x[i], width, f[i]);
  std::fprintf(fp, "% -*a|omega\n", width, omega);
  std::fprintf(fp, "%*d|N\n", width, runs);
  std::fprintf(fp, "% -*e|deltaTau\n", width, dtau);
  std::fclose(fp);
  return 0;
}

// Checkpoint reader.  Unlike the reference's char-at-a-time parser
// (tauhost.c:103-173), this reads whole lines; unlike the reference it
// returns omega instead of discarding it (flaw F4).
int sq_ckpt_read(const char* path, int N, double* xavg, double* xx0, double* x,
                 double* f, double* omega, int* runs, double* dtau) {
  FILE* fp = std::fopen(path, "r");
  if (!fp) return -1;
  char line[4096];
  for (int i = 0; i < N; ++i) {
    if (!std::fgets(line, sizeof(line), fp)) { std::fclose(fp); return -2; }
    char* p = line;
    double* dst[4] = {&xavg[i], &xx0[i], &x[i], &f[i]};
    for (int k = 0; k < 4; ++k) {
      dst[k][0] = std::strtod(p, &p);
      while (*p == ' ' || *p == '|') ++p;
    }
  }
  if (!std::fgets(line, sizeof(line), fp)) { std::fclose(fp); return -2; }
  *omega = std::strtod(line, nullptr);
  if (!std::fgets(line, sizeof(line), fp)) { std::fclose(fp); return -2; }
  *runs = (int)std::strtol(line, nullptr, 10);
  if (!std::fgets(line, sizeof(line), fp)) { std::fclose(fp); return -2; }
  *dtau = std::strtod(line, nullptr);
  std::fclose(fp);
  return 0;
}

}  // extern "C"

// Per-ray physics of the hprop=False right-hand side, and the per-tile
// height window, shared by the per-stage kernels (K2-K4, rhs_windowed.cu)
// and the whole-run kernel (K5-K7, step_resident.cu).  The terms a ray's
// frozen fields fix (RayInv) are split from those of each stage
// (stage_terms), so that the whole-run kernel computes them once per
// launch; the split keeps every expression's order of operations.
//
// The physics is the Pallas kernels' (msgwam_tpu/ops/rhs_pallas.py:_kernel
// and its copies in rhs_pallas_windowed.py and step_pallas.py), written
// once: cg_r with the ray's own phi (one reciprocal, one rsqrt); the
// deposit inputs (cell span from r * (1/dz), values carrying the folded
// 1/dz and the phase volume |dkk dll dm|); the hat coordinates of the shear
// lookup at r and of the rho lookup at r + cg_r dt; dm/dt = -(k du/dz +
// l dv/dz); and the online saturation tendency (f0 from the configured
// phi0, the volume from area/dr, exceed tested on the uncorrected cap).
// Every expression keeps the order of operations of K2's first version, so
// that K2's results did not change when this header was taken out of it.
//
// The window rule is rhs_pallas_windowed.py:124-147: a tile's window
// [win, win + W) starts at the lowest cell its active rays touch, rounded
// down to a multiple of 8 and clipped to c_pad - W; if the tile's highest
// touched cell does not fit, a second tier W2 is tried, and past that the
// tile reads the whole table (the exact full-width path).  On the TPU the
// window cut the O(cells) hat-basis work per ray.  Here a lookup is a
// two-point read from a table in shared memory whatever its width, so the
// window restricts which entries a tile may read and costs one block
// reduction per tile; it never changes a result.
#pragma once

#include <climits>
#include <cuda_runtime.h>

#include "deposit.cuh"

namespace msgwam {

constexpr float kRotEarth = 7.2921e-5f;
constexpr int kEmptyLo = 1000000000;      // an inactive ray's window bounds
constexpr int kEmptyHi = -1000000000;

// The 11 f32 ray fields and the activity mask, each (n,).  dens, r and m
// may alias the outputs of K4-K7, which update them in place.
struct RayFields {
  const float *dens, *r, *dr, *k, *l, *m, *dm, *phi, *dkk, *dll, *area;
  const unsigned char* act;
};

struct Ray {
  float dens = 0.0f, r = 0.0f, dr = 0.0f, k = 0.0f, l = 0.0f, m = 0.0f;
  float dm = 0.0f, phi = 0.0f, dkk = 0.0f, dll = 0.0f, area = 0.0f;
  bool act = false;
};

__device__ __forceinline__ Ray load_ray(const RayFields& f, int i) {
  Ray y;
  y.dens = f.dens[i];
  y.r = f.r[i];
  y.dr = f.dr[i];
  y.k = f.k[i];
  y.l = f.l[i];
  y.m = f.m[i];
  y.dm = f.dm[i];
  y.phi = f.phi[i];
  y.dkk = f.dkk[i];
  y.dll = f.dll[i];
  y.area = f.area[i];
  y.act = f.act[i] != 0;
  return y;
}

// The grid as the tables see it: centers g0c + c dz (rho, n_tab of them),
// interior faces g0f + c dz (the shears, n_tab - 1), deposit cells
// [g0c + c dz, g0c + (c+1) dz) for c < n_tab - 1.
struct Geometry {
  float g0c, dz, g0f, idz, hi_c, hi_f;
  int n_tab, n_flux, nzmax;

  __device__ Geometry(float g0c_, float dz_, float g0f_, int n_tab_)
      : g0c(g0c_), dz(dz_), g0f(g0f_), idz(1.0f / dz_),
        hi_c(g0c_ + (static_cast<float>(n_tab_) - 1.0f) * dz_),
        hi_f(g0f_ + (static_cast<float>(n_tab_) - 2.0f) * dz_),
        n_tab(n_tab_), n_flux(n_tab_ - 1), nzmax(n_tab_ - 2) {}
};

// What a ray contributes before the winds are known.
struct RayTerms {
  float kh2 = 0.0f, ik2 = 0.0f, cgr = 0.0f;         // dispersion
  float r_lo = 0.0f, r_up = 0.0f, fvk = 0.0f, fvl = 0.0f;   // deposit
  int nlow = 0, nup = 0;
  bool live = false;
  float qf = 0.0f, qr = 0.0f;   // hat coordinates: shear at r, rho at r_fin
};

// The terms of a ray that its frozen fields fix: computed once per launch
// by the whole-run kernel (K5-K7), once per call by K2-K4.  Each is a
// subexpression of the formulas below, evaluated in the same order, so the
// split changes no result: ff2 = ff ff, bk = bvf^2 kh2, hdr = dr / 2,
// pv = |dkk dll dm|, pvol = dkk dll (area / dr).
struct RayInv {
  float hdr = 0.0f, k = 0.0f, l = 0.0f, kh2 = 0.0f, bk = 0.0f, ff2 = 0.0f;
  float pv = 0.0f, pvol = 0.0f;
};

__device__ __forceinline__ RayInv ray_invariants(const Ray& y, float bvf) {
  RayInv v;
  const float ff = 2.0f * kRotEarth * sinf(y.phi);
  v.ff2 = ff * ff;
  v.kh2 = y.k * y.k + y.l * y.l;
  v.bk = bvf * bvf * v.kh2;
  v.hdr = 0.5f * y.dr;
  v.k = y.k;
  v.l = y.l;
  v.pv = fabsf(y.dkk * y.dll * y.dm);
  const float dmm_fin = y.area / y.dr;       // dr tendency = 0
  v.pvol = y.dkk * y.dll * dmm_fin;
  return v;
}

// The terms of one stage from the invariants and the evolving dens, r, m.
__device__ __forceinline__ RayTerms stage_terms(const RayInv& v, float dens,
                                                float r, float m, bool act,
                                                const Geometry& g, float dt) {
  RayTerms t;
  // dispersion: one reciprocal + one rsqrt, as the Pallas kernel
  t.kh2 = v.kh2;
  const float k2 = t.kh2 + m * m;
  t.ik2 = 1.0f / k2;
  const float om2 = (v.bk + v.ff2 * m * m) * t.ik2;
  t.cgr = -m * (om2 - v.ff2) * rsqrtf(om2) * t.ik2;

  // flux deposit inputs (independent of the winds with hprop off)
  t.r_lo = r - v.hdr;
  t.r_up = r + v.hdr;
  t.live = cell_span(t.r_lo * g.idz, t.r_up * g.idz + 1.0f, g.nzmax, t.nlow,
                     t.nup) && act;
  if (t.live) {
    const float fv = t.cgr * dens * g.idz;
    t.fvk = fv * v.k * v.pv;
    t.fvl = fv * v.l * v.pv;
  }

  t.qf = (fminf(fmaxf(r, g.g0f), g.hi_f) - g.g0f) * g.idz;
  const float r_fin = r + t.cgr * dt;
  t.qr = (fminf(fmaxf(r_fin, g.g0c), g.hi_c) - g.g0c) * g.idz;
  return t;
}

__device__ __forceinline__ RayTerms ray_terms(const Ray& y, const Geometry& g,
                                              float dt, float bvf) {
  return stage_terms(ray_invariants(y, bvf), y.dens, y.r, y.m, y.act, g, dt);
}

// Two-point linear interpolation of a table of ``len`` entries at the hat
// coordinate q >= 0: i = trunc(q) clamped to len - 2, so the clipped query
// at the top reads the last entry.  The two entries read are kept inside
// the window [base, base + width) of the table; for an active ray of the
// tile the window holds i and i + 1 by construction, so the clamp changes
// nothing, and an inactive ray (whose result is discarded) never reads
// outside it.
__device__ __forceinline__ float interp_window(const float* f, int len,
                                               int base, int width, float q) {
  const int i = min(static_cast<int>(q), len - 2);
  const float t = q - static_cast<float>(i);
  const int j = base + min(max(i - base, 0), width - 2);
  return f[j] * (1.0f - t) + f[j + 1] * t;
}

// The full-width lookup (K2).
__device__ __forceinline__ float interp2(const float* f, int len, float q) {
  return interp_window(f, len, 0, len, q);
}

struct Tendencies {
  float dens, r, m;
};

// dm/dt and the online saturation tendency from the looked-up shears and
// rho; the tendencies of an inactive ray are 0.
__device__ __forceinline__ Tendencies stage_tendencies(
    const RayInv& v, float dens, float m, bool act, const RayTerms& t,
    float du, float dv, float rho, float dt, float bvf, float kappa, float f0,
    bool online, bool faithful) {
  const float dmm = -(v.k * du + v.l * dv);
  float dst = 0.0f;
  if (online) {
    const float m_fin = m + dmm * dt;
    const float omh2 = (v.bk + f0 * f0 * m * m) * t.ik2;
    const float cap = kappa * kappa * 0.5f * rho * omh2 * rsqrtf(omh2) *
                      bvf * bvf / (m_fin * m_fin * (omh2 - f0 * f0));
    const float cap_applied = faithful ? cap : cap / v.pvol;
    if (cap < dens * v.pvol) dst = (cap_applied - dens) * (1.0f / dt);
  }
  return {act ? dst : 0.0f, act ? t.cgr : 0.0f, act ? dmm : 0.0f};
}

__device__ __forceinline__ Tendencies ray_tendencies(
    const Ray& y, const RayTerms& t, float du, float dv, float rho, float dt,
    float bvf, float kappa, float f0, bool online, bool faithful) {
  RayInv v;
  v.k = y.k;
  v.l = y.l;
  v.bk = bvf * bvf * t.kh2;
  v.pvol = y.dkk * y.dll * (y.area / y.dr);
  return stage_tendencies(v, y.dens, y.m, y.act, t, du, dv, rho, dt, bvf,
                          kappa, f0, online, faithful);
}

// One Williamson RK3 stage of one field (lib/libprop.py:693-698,
// rhs_pallas_windowed.py:290-309): q' = dt f - c q, y' = y + b q'; the first
// stage has q' = dt f and adds q'/3 by division.  q is read (after the first
// stage) and written in place; returns y'.
__device__ __forceinline__ float rk3_stage(float tend, float y, float* q,
                                           float dt, float cc, float bc,
                                           bool first) {
  const float qn = first ? dt * tend : dt * tend - cc * (*q);
  *q = qn;
  return first ? y + qn / 3.0f : y + bc * qn;
}

// A ray's touched-cell bounds for the window rule: the hat reads of both
// lookups and the deposit span [nlow, nup).  q >= 0, so trunc is floor.
__device__ __forceinline__ void window_bounds(const RayTerms& t, bool act,
                                              int& lo, int& hi) {
  const int fq = static_cast<int>(t.qf);
  const int rq = static_cast<int>(t.qr);
  lo = act ? min(min(fq, rq) - 1, t.nlow) : kEmptyLo;
  hi = act ? max(max(fq, rq) + 2, t.nup) : kEmptyHi;
}

struct WindowScratch {
  int lo[kWarps];
  int hi[kWarps];
};

// The tile's window from its rays' bounds, in two halves around one block
// barrier: window_stage (every thread, before the barrier) leaves each
// warp's extremes in ``s``; window_read (every thread, after it) returns the
// tier (1: width w1, 2: width w2, 0: full width) and sets the window
// [base, base + width) of the tile's table reads.  ``s`` is free again
// after the next barrier.
__device__ __forceinline__ void window_stage(WindowScratch& s, int lo, int hi) {
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  if ((threadIdx.x & 31) == 0) {
    s.lo[threadIdx.x >> 5] = lo;
    s.hi[threadIdx.x >> 5] = hi;
  }
}

__device__ __forceinline__ int window_read(const WindowScratch& s, int c_pad,
                                           int w1, int w2, int& base,
                                           int& width) {
  int lo = s.lo[0], hi = s.hi[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) {
    lo = min(lo, s.lo[w]);
    hi = max(hi, s.hi[w]);
  }
  // floor(lo / 8) * 8, then the clip at 0 (a negative lo clips to 0 anyway)
  const int lo8 = lo < 0 ? 0 : (lo / 8) * 8;
  base = min(lo8, c_pad - w1);
  width = w1;
  if (hi - base <= w1) return 1;
  if (w2 > 0) {
    base = min(lo8, c_pad - w2);
    width = w2;
    if (hi - base <= w2) return 2;
  }
  base = 0;
  width = c_pad;
  return 0;
}

// Both halves with the barrier between them, by the whole block.  The
// caller __syncthreads() at least once before the next call (the deposit
// does).
__device__ __forceinline__ int tile_window(WindowScratch& s, int lo, int hi,
                                           int c_pad, int w1, int w2,
                                           int& base, int& width) {
  window_stage(s, lo, hi);
  __syncthreads();
  return window_read(s, c_pad, w1, w2, base, width);
}

// n tile windows counted by their tier (0 full width, 1 first window, 2
// second): one integer atomicAdd into the block's row of the (kTierSlots,
// 4) counts (full, first, second, unused: utils/profiling.py's order), row
// blockIdx.x % kTierSlots, each row on its own 32-byte sector, so that
// blocks that count together do not queue on the same words.  K3-K5 add
// each window as it is read (the add overlaps the tile's work); K6/K7 add
// their block's shared-memory counts once, at the launch's end.  Integer
// atomics change no float result: a counted launch's outputs are bitwise
// an uncounted one's.
constexpr int kTierSlots = 1024;

__device__ __forceinline__ void count_tier(unsigned long long* counts,
                                           int tier,
                                           unsigned long long n = 1) {
  atomicAdd(counts + 4 * (blockIdx.x % kTierSlots) + tier, n);
}

}  // namespace msgwam

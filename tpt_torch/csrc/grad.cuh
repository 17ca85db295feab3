// Device code shared by the two backward kernels (trace_grad.cu, the tape
// kernel, and trace_grad_adjoint.cu, the adjoint kernel): the tape's layout,
// the decision code, and one bounce of a live path in three modes.
//
// The tape of one launch (n_rows x width pixels, npix of them) lives in
// device memory, one plane of npix words per (sample, bounce, word), so a
// warp's 32 pixels read or write one 128-byte line a word:
//   carries f32[spp][slots][10][npix]: the input carry of each live bounce,
//     origin, direction, throughput and the seed's bits; slots = ray_depth,
//     or (ray_depth + 1) / 2 with half_stores (even bounces only);
//   codes   i32[spp][ray_depth][npix]: the decision code of each live bounce;
//   counts  i32[spp][npix]: each (pixel, sample) item's live bounces.
// Only an item's first counts[.] bounces are written and read.
//
// The decision code holds every discrete decision of a bounce, so the
// adjoint kernel replays none of them:
//   bits 0-7   the winner's table row + 1 (0: the ray escaped);
//   bit  8     inside (the hit is the far root: the ray leaves a medium);
//   bit  9     the specular lobe was taken;   bit 10  the refraction lobe;
//   bit  11    pick2 (t1 < 0, so t = t2);      bit 12  ok (a sphere's disc >= 0);
//   bit  13    total internal reflection;      bit 14  len_ok (refraction kept);
//   bit  15    the path survived Russian roulette;
//   bits 16-18 the cuboid normal's active faces (x, y, z), by epsilon proximity.

#pragma once

#include "common.cuh"

namespace tpt {

constexpr int kRows = 128;       // ATTR_ROWS
constexpr int kCols = 24;        // ATTR_COLS
constexpr int kNCam = 20;
constexpr int kMaxDepth = 50;
constexpr int kCarryWords = 10;  // o.xyz, d.xyz, thr.xyz, seed

// Phases of the backward the ablate modes turn off (tpt_torch/kernels/
// trace_grad.py ABLATE_FLAGS); every flag set is the full backward.
constexpr int kFlagStores = 1;    // carries on the tape
constexpr int kFlagReverse = 2;   // the reverse sweep
constexpr int kFlagAdjoint = 4;   // the adjoint maths of each bounce (else the replay only)
constexpr int kFlagCamera = 8;    // the camera adjoint
constexpr int kFlagTable = 16;    // the table accumulation
constexpr int kFlagsAll = 31;

struct Carry {
  V3 o, d, thr;
  uint32_t seed;
};

// Cotangents of a bounce's outputs on the way in, of its inputs on the way out.
struct Cot {
  V3 o, d, thr, md, mt;
};

// The decisions of one bounce; `row` is -1 for a ray that escaped.
struct Decision {
  int row;
  bool inside, spec, refr, pick2, ok, tir, len_ok, survive;
  int faces;
};

__device__ __forceinline__ int32_t encode(const Decision& c) {
  return (c.row + 1) | (c.inside << 8) | (c.spec << 9) | (c.refr << 10) | (c.pick2 << 11) |
         (c.ok << 12) | (c.tir << 13) | (c.len_ok << 14) | (c.survive << 15) | (c.faces << 16);
}

__device__ __forceinline__ Decision decode(int32_t v) {
  Decision c;
  c.row = (v & 0xff) - 1;
  c.inside = (v >> 8) & 1;
  c.spec = (v >> 9) & 1;
  c.refr = (v >> 10) & 1;
  c.pick2 = (v >> 11) & 1;
  c.ok = (v >> 12) & 1;
  c.tir = (v >> 13) & 1;
  c.len_ok = (v >> 14) & 1;
  c.survive = (v >> 15) & 1;
  c.faces = (v >> 16) & 7;
  return c;
}

__host__ __device__ __forceinline__ int carry_slots(int ray_depth, bool half) {
  return half ? (ray_depth + 1) / 2 : ray_depth;
}

__device__ __forceinline__ int64_t carry_at(int s, int slot, int slots, int64_t npix, int64_t i) {
  return (static_cast<int64_t>(s) * slots + slot) * kCarryWords * npix + i;
}

__device__ __forceinline__ int64_t code_at(int s, int j, int ray_depth, int64_t npix, int64_t i) {
  return (static_cast<int64_t>(s) * ray_depth + j) * npix + i;
}

__device__ __forceinline__ void store_carry(float* p, int64_t npix, const Carry& c) {
  p[0] = c.o.x; p[npix] = c.o.y; p[2 * npix] = c.o.z;
  p[3 * npix] = c.d.x; p[4 * npix] = c.d.y; p[5 * npix] = c.d.z;
  p[6 * npix] = c.thr.x; p[7 * npix] = c.thr.y; p[8 * npix] = c.thr.z;
  p[9 * npix] = __uint_as_float(c.seed);
}

__device__ __forceinline__ Carry load_carry(const float* p, int64_t npix) {
  Carry c;
  c.o = make(p[0], p[npix], p[2 * npix]);
  c.d = make(p[3 * npix], p[4 * npix], p[5 * npix]);
  c.thr = make(p[6 * npix], p[7 * npix], p[8 * npix]);
  c.seed = __float_as_uint(p[9 * npix]);
  return c;
}

__device__ __forceinline__ V3 zero3() { return make(0.0f, 0.0f, 0.0f); }

// cuboid_normal (common.cuh) in two steps: which faces the hit point is
// within epsilon of, then the normal from them, in cuboid_normal's order.
__device__ __forceinline__ int cuboid_faces(V3 mn, V3 mx, V3 hp) {
  const V3 half = (mx - mn) * 0.5f;
  const V3 cs = hp - (mx + mn) * 0.5f;
  return (fabsf(fabsf(cs.x) - half.x) <= kEps ? 1 : 0) |
         (fabsf(fabsf(cs.y) - half.y) <= kEps ? 2 : 0) |
         (fabsf(fabsf(cs.z) - half.z) <= kEps ? 4 : 0);
}

__device__ __forceinline__ V3 cuboid_normal_of(V3 mn, V3 mx, V3 hp, int faces) {
  const V3 cs = hp - (mx + mn) * 0.5f;
  const V3 act = make((faces & 1) ? 1.0f : 0.0f, (faces & 2) ? 1.0f : 0.0f,
                      (faces & 4) ? 1.0f : 0.0f);
  return normalize_floor(make(sgn(cs.x), sgn(cs.y), sgn(cs.z)) * act, kTiny);
}

// d max(x, other) / dx (or min), given the result ans, under the rule of
// jnp.maximum / jnp.minimum: 1 where x is the result, 1/2 at a tie, 0
// otherwise (NaN gives 0).
__device__ __forceinline__ float share(float x, float other, float ans) {
  return (x == ans ? 1.0f : 0.0f) / (other == ans ? 2.0f : 1.0f);
}

// Adjoint of y = a / s with s = sqrt(q), q = max(dot(a, a), eps): returns
// the cotangent of a; `tie` is d q / d dot(a, a) (1 without a floor).
__device__ __forceinline__ V3 normalize_adjoint(V3 a, float s, V3 gy, float tie) {
  const float gs = -dot(gy, a) / (s * s);
  const float gq = gs * (0.5f / s) * tie;
  return gy / s + a * (2.0f * gq);
}

// Adjoint of ray_cuboid's slab test: accumulates the cotangents of the
// origin, direction and bounds from those of (t1, t2).
__device__ __forceinline__ void slab_adjoint(V3 o, V3 d, V3 mn, V3 mx, float g1, float g2,
                                             V3& g_o, V3& g_d, V3& g_mn, V3& g_mx) {
  const float oo[3] = {o.x, o.y, o.z}, dd[3] = {d.x, d.y, d.z};
  const float lo[3] = {mn.x, mn.y, mn.z}, hi[3] = {mx.x, mx.y, mx.z};
  float a[3], b[3], sm[3], bg[3];
  for (int k = 0; k < 3; ++k) {
    a[k] = (lo[k] - oo[k]) / dd[k];
    b[k] = (hi[k] - oo[k]) / dd[k];
    sm[k] = nmin(a[k], b[k]);
    bg[k] = nmax(a[k], b[k]);
  }
  const float B1 = nmax(sm[1], sm[2]), A1 = nmax(sm[0], B1), T1 = nmax(A1, -kFloatMax);
  const float B2 = nmin(bg[1], bg[2]), A2 = nmin(bg[0], B2), T2 = nmin(A2, kFloatMax);
  float gsm[3], gbg[3];
  const float gA1 = g1 * share(A1, -kFloatMax, T1);
  gsm[0] = gA1 * share(sm[0], B1, A1);
  const float gB1 = gA1 * share(B1, sm[0], A1);
  gsm[1] = gB1 * share(sm[1], sm[2], B1);
  gsm[2] = gB1 * share(sm[2], sm[1], B1);
  const float gA2 = g2 * share(A2, kFloatMax, T2);
  gbg[0] = gA2 * share(bg[0], B2, A2);
  const float gB2 = gA2 * share(B2, bg[0], A2);
  gbg[1] = gB2 * share(bg[1], bg[2], B2);
  gbg[2] = gB2 * share(bg[2], bg[1], B2);
  float go[3] = {0.0f, 0.0f, 0.0f}, gd[3], glo[3], ghi[3];
  for (int k = 0; k < 3; ++k) {
    const float ga = gsm[k] * share(a[k], b[k], sm[k]) + gbg[k] * share(a[k], b[k], bg[k]);
    const float gb = gsm[k] * share(b[k], a[k], sm[k]) + gbg[k] * share(b[k], a[k], bg[k]);
    const float qa = ga / dd[k], qb = gb / dd[k];
    glo[k] = qa;
    ghi[k] = qb;
    go[k] = -qa - qb;
    gd[k] = -(ga * a[k]) / dd[k] - (gb * b[k]) / dd[k];
  }
  g_o = g_o + make(go[0], go[1], go[2]);
  g_d = g_d + make(gd[0], gd[1], gd[2]);
  g_mn = g_mn + make(glo[0], glo[1], glo[2]);
  g_mx = g_mx + make(ghi[0], ghi[1], ghi[2]);
}

// The cotangent of one winner row from one adjoint bounce: the geometry
// lanes (a sphere's center and radius in geo[0:4], a cuboid's min and max in
// geo[0:6]) and the 14 material lanes.  row -1: nothing to add.
struct RowCot {
  int row;
  float geo[6];
  float mat[kMatLanes];
};

enum BounceMode { kTape, kReplay, kAdjoint };

// One bounce of a live path with the decisions `dc`, the winner's
// attributes from the table row in shared memory: the forward of
// tpt_torch.integrator.table_hit_trace + bounce_step on one lane.
//
// kTape: dc.row and dc.inside come from the closest-hit fold; decides the
//   rest of dc, advances the carry and returns whether the path lives.  The
//   operations and their order are the forward kernel's (trace.cu), so
//   under -fmad=false the decisions are its decisions bit for bit.
// kReplay: takes every decision from dc, advances the carry, returns
//   dc.survive.
// kAdjoint: takes every decision from dc, leaves the carry alone, maps the
//   cotangents `g` of the bounce's outputs to those of its inputs, and
//   writes the winner row's cotangent to *rc.
template <BounceMode kMode>
__device__ __forceinline__ bool bounce(const float* tab, int ns, Decision& dc, bool rr, Carry& c,
                                       Cot& g, V3 g_rad, RowCot* rc) {
  constexpr bool kAdj = kMode == kAdjoint;
  constexpr bool kDecide = kMode == kTape;
  if (dc.row < 0) {  // escaped: miss_dir = d, miss_thr = thr, the path ends
    if (kAdj) {
      g.d = g.d + g.md;
      g.thr = g.thr + g.mt;
      g.md = zero3();
      g.mt = zero3();
      rc->row = -1;
    }
    return false;
  }
  const bool is_sphere = dc.row < ns;
  const float* A = tab + dc.row * kCols;
  const V3 o = c.o, d = c.d, thr = c.thr;

  // ---- table_hit_trace: the winning t from the winner's geometry ----
  V3 cen = zero3(), mn = zero3(), mx = zero3(), oc = zero3();
  float r = 0.0f, rs = 1.0f, b = 0.0f, disc = 0.0f, xs = 1.0f;
  float t1, t2;
  if (is_sphere) {
    cen = make(A[0], A[1], A[2]);
    r = A[3];
    rs = nmax(r, kEps);
    oc = o - cen;
    b = dot(d, oc);
    const float cc = dot(oc, oc) - rs * rs;
    disc = b * b - cc;
    if (kDecide) dc.ok = disc >= 0.0f;
    xs = dc.ok ? nmax(disc, 0.0f) : 1.0f;
    const float sq = sqrtf(xs);
    t1 = -b - sq;
    t2 = -b + sq;
  } else {
    mn = make(A[4], A[5], A[6]);
    mx = make(A[7], A[8], A[9]);
    slab(o, d, &A[4], &A[7], t1, t2);
  }
  if (kDecide) dc.pick2 = t1 < 0.0f;
  const float t = dc.pick2 ? t2 : t1;

  // ---- bounce_step ----
  const float* M = A + 10;
  const V3 albedo = make(M[0], M[1], M[2]);
  const float spec0 = M[3];
  const V3 emissive = make(M[4], M[5], M[6]);
  const float spec_rough = M[7];
  const V3 absorb = make(M[8], M[9], M[10]);
  const float refr0 = M[11];
  const float refr_rough = M[12];
  const float ior = M[13];
  const float ior_safe = nmax(ior, kEps);
  const bool inside = dc.inside;

  const V3 hp = o + d * t;
  V3 n_raw;
  if (is_sphere) {
    n_raw = (hp - cen) / rs;
  } else {
    if (kDecide) dc.faces = cuboid_faces(mn, mx, hp);
    n_raw = cuboid_normal_of(mn, mx, hp, dc.faces);
  }
  const V3 n = inside ? -n_raw : n_raw;

  // Beer's law when exiting a medium
  V3 e = make(1.0f, 1.0f, 1.0f), thr_b = thr;
  if (inside) {
    e = make(expf(-absorb.x * t), expf(-absorb.y * t), expf(-absorb.z * t));
    thr_b = thr * e;
  }

  // BSDF lobe probabilities
  const float n1 = inside ? ior_safe : 1.0f;
  const float n2 = inside ? 1.0f : ior_safe;
  const float cos_t = dot(-d, n);
  const float r0a = (n1 - n2) / (n1 + n2);
  const float r0 = r0a * r0a;
  const float m = 1.0f - cos_t;
  const float m2 = m * m;
  const float m4 = m2 * m2;
  const float m5 = m4 * m;
  const float fres = r0 + (1.0f - r0) * m5;
  const float spec_f = spec0 + (1.0f - spec0) * fres;
  const float diffuse_c = 1.0f - spec_f - refr0;
  const bool sp = spec0 > 0.0f;
  const float spec = sp ? spec_f : spec0;
  const float refr = sp ? 1.0f - spec_f - diffuse_c : refr0;

  // RNG draws, in shader order
  uint32_t seed = c.seed;
  const float r_z = rand01(seed);
  const float r_a = rand01(seed);
  const V3 dif_a = n + hemisphere_offset(r_z, r_a);
  const float dif_s = sqrtf(dot(dif_a, dif_a));
  const V3 diffuse = dif_a / dif_s;
  const float roll = rand01(seed);
  const uint32_t s3 = seed;
  if (kDecide) {
    dc.spec = spec > roll;
    dc.refr = !dc.spec && (spec + refr > roll);
  }
  const bool take_spec = dc.spec, take_refr = dc.refr;
  const float r_z2 = rand01(seed);
  const float r_a2 = rand01(seed);
  if (!take_refr) seed = s3;

  // lobe directions (only the taken lobe is evaluated)
  const float h = 2.0f * dot(n, d);
  const V3 refl_pure = d - n * h;
  V3 new_d;
  float sr2 = 0.0f, q = 1.0f, qs = 1.0f;                     // specular lobe
  V3 mixr = zero3();
  float eta = 1.0f, ndi = 0.0f, k = 0.0f, xk = 1.0f, w = 0.0f;  // refraction lobe
  float hemi_s = 1.0f, rr2 = 0.0f, len2 = 0.0f, lq = 1.0f, ls = 1.0f;
  V3 refr_raw = zero3(), hemi_a = zero3(), hemi = zero3(), refr_mixed = zero3();
  if (take_spec) {
    sr2 = spec_rough * spec_rough;
    mixr = refl_pure + (diffuse - refl_pure) * sr2;
    q = nmax(dot(mixr, mixr), kTiny);
    qs = sqrtf(q);
    new_d = mixr / qs;
  } else if (take_refr) {
    eta = inside ? ior_safe : 1.0f / ior_safe;
    ndi = dot(n, d);
    k = 1.0f - eta * eta * (1.0f - ndi * ndi);
    if (kDecide) dc.tir = k < 0.0f;
    if (!dc.tir) {
      xk = nmax(k, 0.0f);
      w = eta * ndi + sqrtf(xk);
      refr_raw = d * eta - n * w;
    }
    hemi_a = -n + hemisphere_offset(r_z2, r_a2);
    hemi_s = sqrtf(dot(hemi_a, hemi_a));
    hemi = hemi_a / hemi_s;
    rr2 = refr_rough * refr_rough;
    refr_mixed = refr_raw + (hemi - refr_raw) * rr2;
    len2 = dot(refr_mixed, refr_mixed);
    if (kDecide) dc.len_ok = len2 > kTirLen2;
    if (dc.len_ok) {
      lq = nmax(len2, kTirLen2);
      ls = sqrtf(lq);
      new_d = refr_mixed / ls;
    } else {
      new_d = refl_pure;  // TIR with ~zero roughness: mirror reflection
    }
  } else {
    new_d = diffuse;
  }
  const float p = take_spec ? spec : (take_refr ? refr : 1.0f - spec - refr);
  const float pm = nmax(p, kEps);

  // throughput updates and Russian roulette
  const V3 thr_x = take_refr ? thr_b : thr_b * albedo;
  const V3 thr_a = thr_x / pm;
  const float m12 = nmax(thr_a.y, thr_a.z);
  const float p_max = nmax(thr_a.x, m12);
  const float rr_roll = rand01(seed);
  if (kDecide) dc.survive = rr ? !(rr_roll > p_max) : true;
  const bool survive = dc.survive;

  if (!kAdj) {
    c.o = hp + new_d * kEps;
    c.d = new_d;
    c.thr = (rr && survive) ? thr_a / p_max : thr_a;
    c.seed = seed;
    return survive;
  }

  // ================= adjoint =================
  V3 g_thr_a = g.thr;
  if (rr && survive) {
    g_thr_a = g.thr / p_max;
    const float g_pmax = -dot(g.thr, thr_a) / (p_max * p_max);
    g_thr_a.x = g_thr_a.x + g_pmax * share(thr_a.x, m12, p_max);
    const float g_m12 = g_pmax * share(m12, thr_a.x, p_max);
    g_thr_a.y = g_thr_a.y + g_m12 * share(thr_a.y, thr_a.z, m12);
    g_thr_a.z = g_thr_a.z + g_m12 * share(thr_a.z, thr_a.y, m12);
  }
  // thr_a = thr_x / pm
  const V3 g_thr_x = g_thr_a / pm;
  const float g_pm = -dot(g_thr_a, thr_x) / (pm * pm);
  V3 g_thr_b, g_alb = zero3();
  if (take_refr) {
    g_thr_b = g_thr_x;
  } else {
    g_thr_b = g_thr_x * albedo;
    g_alb = g_thr_x * thr_b;
  }
  // radiance pickup: rad += emissive * thr_b
  const V3 g_em = g_rad * thr_b;
  g_thr_b = g_thr_b + g_rad * emissive;
  // new_o = hp + new_d * EPS
  V3 g_hp = g.o;
  const V3 g_nd = g.d + g.o * kEps;
  // p and its floor
  const float g_p = g_pm * share(p, kEps, pm);
  float g_spec = 0.0f, g_refr = 0.0f;
  if (take_spec) {
    g_spec = g_p;
  } else if (take_refr) {
    g_refr = g_p;
  } else {
    g_spec = -g_p;
    g_refr = -g_p;
  }

  V3 g_n = zero3(), g_d = zero3(), g_dif = zero3(), g_rp = zero3();
  float g_ios = 0.0f, g_sr = 0.0f, g_rrough = 0.0f;
  if (take_spec) {
    const V3 g_mix = normalize_adjoint(mixr, qs, g_nd, share(dot(mixr, mixr), kTiny, q));
    const V3 u = diffuse - refl_pure;
    const V3 g_u = g_mix * sr2;
    const float g_sr2 = dot(g_mix, u);
    g_rp = g_rp + g_mix - g_u;
    g_dif = g_dif + g_u;
    g_sr = 2.0f * g_sr2 * spec_rough;
  } else if (take_refr) {
    V3 g_rm = zero3();
    if (dc.len_ok) {
      g_rm = normalize_adjoint(refr_mixed, ls, g_nd, share(len2, kTirLen2, lq));
    } else {
      g_rp = g_rp + g_nd;
    }
    const V3 u = hemi - refr_raw;
    const V3 g_u = g_rm * rr2;
    const float g_rr2 = dot(g_rm, u);
    const V3 g_raw = g_rm - g_u;
    g_rrough = 2.0f * g_rr2 * refr_rough;
    g_n = g_n - normalize_adjoint(hemi_a, hemi_s, g_u, 1.0f);  // hemi = normalize(-n + s2)
    float g_eta = 0.0f;
    if (!dc.tir) {
      // refr_raw = eta * d - w * n, w = eta * ndi + sqrt(xk)
      g_eta = dot(g_raw, d);
      g_d = g_d + g_raw * eta;
      const float g_w = -dot(g_raw, n);
      g_n = g_n - g_raw * w;
      g_eta = g_eta + g_w * ndi;
      float g_ndi = g_w * eta;
      const float g_xk = g_w * (0.5f / sqrtf(nmax(xk, 1e-12f)));  // sqrt_clamped_grad
      const float g_k = g_xk * share(k, 0.0f, xk);
      // k = 1 - (eta * eta) * (1 - ndi * ndi)
      const float om = 1.0f - ndi * ndi;
      g_eta = g_eta - 2.0f * eta * (g_k * om);
      g_ndi = g_ndi + 2.0f * ndi * (g_k * (eta * eta));
      g_n = g_n + d * g_ndi;
      g_d = g_d + n * g_ndi;
    }
    g_ios = inside ? g_eta : -g_eta / (ior_safe * ior_safe);
  } else {
    g_dif = g_dif + g_nd;
  }
  // refl_pure = d - n * h, h = 2 * dot(n, d)
  g_d = g_d + g_rp;
  g_n = g_n - g_rp * h;
  const float g_ndot = 2.0f * -dot(g_rp, n);
  g_n = g_n + d * g_ndot;
  g_d = g_d + n * g_ndot;
  // diffuse = normalize(n + s1)
  g_n = g_n + normalize_adjoint(dif_a, dif_s, g_dif, 1.0f);

  // spec / refr from spec_f, spec0, refr0
  float g_specf = 0.0f, g_spec0 = 0.0f, g_refr0 = 0.0f;
  if (sp) {
    const float g_dc = -g_refr;               // refr = 1 - spec_f - diffuse_c
    g_specf = g_spec - g_refr - g_dc;         // diffuse_c = 1 - spec_f - refr0
    g_refr0 = -g_dc;
  } else {
    g_spec0 = g_spec;
    g_refr0 = g_refr;
  }
  // spec_f = spec0 + (1 - spec0) * fres
  g_spec0 = g_spec0 + g_specf - g_specf * fres;
  const float g_fres = g_specf * (1.0f - spec0);
  // fres = r0 + (1 - r0) * m5, m5 = (m2 * m2) * m, m = 1 - cos
  const float g_r0 = g_fres - g_fres * m5;
  const float g_m5 = g_fres * (1.0f - r0);
  const float g_m4 = g_m5 * m;
  const float g_m2 = 2.0f * g_m4 * m2;
  const float g_m = g_m5 * m4 + 2.0f * g_m2 * m;
  const float g_cos = -g_m;
  // r0 = r0a * r0a, r0a = (n1 - n2) / (n1 + n2)
  const float g_r0a = 2.0f * g_r0 * r0a;
  const float den = n1 + n2;
  const float g_num = g_r0a / den;
  const float g_den = -(g_r0a * r0a) / den;
  g_ios = g_ios + (inside ? g_num + g_den : g_den - g_num);
  // cos = dot(-d, n)
  g_d = g_d - n * g_cos;
  g_n = g_n - d * g_cos;
  const V3 g_nraw = inside ? -g_n : g_n;

  // Beer's law
  float g_t = 0.0f;
  V3 g_thr = g_thr_b, g_ab = zero3();
  if (inside) {
    g_thr = g_thr_b * e;
    const V3 g_arg = g_thr_b * thr * e;       // arg = (-absorb) * t, e = exp(arg)
    g_ab = -(g_arg * t);
    g_t = -dot(g_arg, absorb);
  }
  // sphere normal (hp - cen) / rs; the cuboid normal has no gradient
  V3 g_cen = zero3();
  float g_r = 0.0f;
  if (is_sphere) {
    const V3 gq = g_nraw / rs;
    g_hp = g_hp + gq;
    g_cen = g_cen - gq;
    const float g_rs = -dot(g_nraw, hp - cen) / (rs * rs);
    g_r = g_r + g_rs * share(r, kEps, rs);
  }
  // hp = o + d * t
  V3 g_o = g_hp;
  g_d = g_d + g_hp * t;
  g_t = g_t + dot(g_hp, d);

  // t = t1 < 0 ? t2 : t1
  const float g_t1 = dc.pick2 ? 0.0f : g_t;
  const float g_t2 = dc.pick2 ? g_t : 0.0f;
  V3 g_mn = zero3(), g_mx = zero3();
  if (is_sphere) {
    float g_b = -g_t1 - g_t2;
    const float g_sq = g_t2 - g_t1;
    const float g_xs = g_sq * (0.5f / sqrtf(nmax(xs, 1e-12f)));  // sqrt_clamped_grad
    const float g_disc = dc.ok ? g_xs * share(disc, 0.0f, xs) : 0.0f;
    g_b = g_b + 2.0f * g_disc * b;               // disc = b * b - cc
    const float g_cc = -g_disc;                  // cc = dot(oc, oc) - rs * rs
    V3 g_oc = oc * (2.0f * g_cc) + d * g_b;      // b = dot(d, oc)
    g_d = g_d + oc * g_b;
    g_o = g_o + g_oc;
    g_cen = g_cen - g_oc;
    g_r = g_r + (-2.0f * g_cc * rs) * share(r, kEps, rs);
  } else {
    slab_adjoint(o, d, mn, mx, g_t1, g_t2, g_o, g_d, g_mn, g_mx);
  }
  const float g_ior = g_ios * share(ior, kEps, ior_safe);

  g.o = g_o;
  g.d = g_d;
  g.thr = g_thr;  // md, mt pass through a hit bounce

  rc->row = dc.row;
  if (is_sphere) {
    rc->geo[0] = g_cen.x; rc->geo[1] = g_cen.y; rc->geo[2] = g_cen.z;
    rc->geo[3] = g_r; rc->geo[4] = 0.0f; rc->geo[5] = 0.0f;
  } else {
    rc->geo[0] = g_mn.x; rc->geo[1] = g_mn.y; rc->geo[2] = g_mn.z;
    rc->geo[3] = g_mx.x; rc->geo[4] = g_mx.y; rc->geo[5] = g_mx.z;
  }
  rc->mat[0] = g_alb.x; rc->mat[1] = g_alb.y; rc->mat[2] = g_alb.z;
  rc->mat[3] = g_spec0;
  rc->mat[4] = g_em.x; rc->mat[5] = g_em.y; rc->mat[6] = g_em.z;
  rc->mat[7] = g_sr;
  rc->mat[8] = g_ab.x; rc->mat[9] = g_ab.y; rc->mat[10] = g_ab.z;
  rc->mat[11] = g_refr0;
  rc->mat[12] = g_rrough;
  rc->mat[13] = g_ior;
  return survive;
}

}  // namespace tpt

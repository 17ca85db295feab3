// Backward kernel of the differentiable path trace, for NVIDIA Hopper (sm_90a).
//
// Replaces tpt/kernels/trace_grad.py::pallas_trace_grad (body _grad_kernel),
// with its half_stores and ablate variants.  Given the cotangents of one
// frame's differentiable outputs -- g_rad f32[3, P] (P = n_rows * width
// pixels) and g_missd / g_misst f32[spp, 3, P] -- it returns the cotangents
// of the winner-attribute table d_table f32[128, 24] (row-major, the layout
// of tpt_torch.integrator.build_attr_table) and of the 20 camera scalars
// d_cam f32[20] (cam20 order: ip00 ip01 ip02 ip10 ip11 ip12, the inverse
// view's right, up, backward and eye columns, focal length, aperture).
//
// Design (simple first):
//   * one thread per pixel, a 1-D grid of 128-thread blocks; the pixel map
//     is trace.cu's.  The scene geometry (for the closest-hit fold) and the
//     live rows of the attribute table sit in shared memory;
//   * per sample, the thread recomputes the seed from pixel_seed(px, py,
//     frame) (or chains it from the previous sample), the draws and the
//     primary ray, then runs a FORWARD SWEEP: the closest-hit fold picks the
//     winner, one bounce is evaluated from the winner's table row, and the
//     bounce's input carry (origin, direction, throughput, seed: 10 words)
//     and hit record (winner index, inside flag: 1 word) are stored in a
//     per-thread array in local memory.  The walk stops when the path dies,
//     so only live bounces are stored: a dead bounce is the identity, and
//     the miss fields at a live bounce's input are always zero (a sample
//     misses at most once), so they are not stored.  With half_stores only
//     even bounces store their carry; the reverse sweep recomputes an odd
//     bounce's carry with one extra bounce from the stored carry before it;
//   * a REVERSE SWEEP from the last live bounce back to the first re-runs
//     each bounce from its stored carry and hit record and applies its
//     hand-written adjoint (the adjoint of tpt_torch.integrator's
//     table_hit_trace + bounce_step pair).  The radiance cotangent is the
//     same g_rad at every bounce, as radiance accumulates additively.  Each
//     bounce adds its winner row's cotangent (sphere geometry, cuboid
//     geometry, material lanes) to the block's table in shared memory;
//   * finally the adjoint of primary_ray maps the origin and direction
//     cotangents at bounce 0 to the camera scalars.
//
// Reductions: per-block shared-memory atomics for the table (<= 128 x 24
// floats), warp shuffles then shared atomics for the 20 camera scalars, and
// one global atomicAdd per non-zero entry per block.  Atomics were chosen
// over per-block partials (which would take nblocks x 3092 floats, 200 MB at
// 1080p): the order of the float sums then varies from run to run, so two
// launches agree to rounding, not bit for bit, and parity with the plain
// version is by tolerance.
//
// Decisions must match the forward kernel bit for bit: the forward sweep
// uses common.cuh's fold, the parity policy there (-fmad=false, IEEE
// division and square root) and the plain version's operation order; the
// winning distance is recomputed from the gathered row exactly as
// table_hit_trace does, which equals the fold's to the bit.
//
// The adjoint follows the reverse-mode rules of JAX and PyTorch: a max or min
// gives half the cotangent to each side at a tie (also against a constant,
// as jnp.maximum does), sqrt of a sphere's discriminant and of refract's k
// takes the clamped derivative 0.5 / sqrt(max(x, 1e-12))
// (tpt_torch.vecmath.sqrt_clamped_grad), and IEEE arithmetic is kept with
// no guard that the plain version lacks: an axis-parallel ray on a cuboid
// winner divides a zero cotangent by a zero direction component and gives
// NaN, which the wrapper's finite filter zeroes and counts.  Branches that a
// select discards are not differentiated: their cotangent is zero and their
// partials are finite except on measure-zero sets.
//
// What bounds it on this card: per-thread FP32 maths (the fold over every
// primitive per bounce, then about three bounce evaluations per live bounce:
// forward, replay and adjoint), divergence across a warp's path lengths, and
// local-memory traffic for the stored carries.  The adjoint's live set is
// large, so ptxas spills; its report is printed by the build.
//
// Ablations (timing probes of tpt, results meaningless except "none"):
// 1 nocam (no camera adjoint), 2 nostores (no stores; the reverse sweep
// replays the first bounce's carry), 3 nodtbl (no table accumulation),
// 4 norev (no reverse sweep), 5 primalonly (the reverse sweep re-runs the
// primal only).

#include "common.cuh"

namespace {

using namespace tpt;

constexpr int kBlock = 128;
constexpr int kRows = 128;   // ATTR_ROWS
constexpr int kCols = 24;    // ATTR_COLS
constexpr int kNCam = 20;
constexpr int kMaxDepth = 50;

enum Ablate { kNone = 0, kNoCam = 1, kNoStores = 2, kNoDtbl = 3, kNoRev = 4, kPrimalOnly = 5 };

struct Carry {
  V3 o, d, thr;
  uint32_t seed;
};

// Cotangents of a bounce's outputs on the way in, of its inputs on the way out.
struct Cot {
  V3 o, d, thr, md, mt;
};

__device__ __forceinline__ V3 zero3() { return make(0.0f, 0.0f, 0.0f); }

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

// One bounce of a live path from its hit record (idx, inside), with the
// winner's attributes from the table row in shared memory: the forward of
// tpt_torch.integrator.table_hit_trace + bounce_step on one lane.
//
// kAdjoint = false: advances the carry and returns whether the path lives.
// kAdjoint = true: leaves the carry alone, maps the cotangents `g` of the
// bounce's outputs to those of its inputs, and (if dtab is not null) adds
// the winner row's cotangent to dtab.
template <bool kAdjoint>
__device__ __forceinline__ bool bounce(const float* tab, int ns, int idx, bool inside,
                                       bool rr, Carry& c, Cot& g, V3 g_rad, float* dtab) {
  if (idx < 0) {  // escaped: miss_dir = d, miss_thr = thr, the path ends
    if (kAdjoint) {
      g.d = g.d + g.md;
      g.thr = g.thr + g.mt;
      g.md = zero3();
      g.mt = zero3();
    }
    return false;
  }
  const bool is_sphere = idx < kMaxSpheres;
  const int row = is_sphere ? idx : idx - kMaxSpheres + ns;
  const float* A = tab + row * kCols;
  const V3 o = c.o, d = c.d, thr = c.thr;

  // ---- table_hit_trace: the winning t from the winner's geometry ----
  V3 cen = zero3(), mn = zero3(), mx = zero3(), oc = zero3();
  float r = 0.0f, rs = 1.0f, b = 0.0f, disc = 0.0f, xs = 1.0f;
  bool ok = false;
  float t1, t2;
  if (is_sphere) {
    cen = make(A[0], A[1], A[2]);
    r = A[3];
    rs = nmax(r, kEps);
    oc = o - cen;
    b = dot(d, oc);
    const float cc = dot(oc, oc) - rs * rs;
    disc = b * b - cc;
    ok = disc >= 0.0f;
    xs = ok ? nmax(disc, 0.0f) : 1.0f;
    const float sq = sqrtf(xs);
    t1 = -b - sq;
    t2 = -b + sq;
  } else {
    mn = make(A[4], A[5], A[6]);
    mx = make(A[7], A[8], A[9]);
    slab(o, d, &A[4], &A[7], t1, t2);
  }
  const bool pick2 = t1 < 0.0f;
  const float t = pick2 ? t2 : t1;

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

  const V3 hp = o + d * t;
  const V3 n_raw = is_sphere ? (hp - cen) / rs : cuboid_normal(mn, mx, hp);
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
  const bool take_spec = spec > roll;
  const bool take_refr = !take_spec && (spec + refr > roll);
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
  bool tir = true, len_ok = false;
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
    tir = k < 0.0f;
    if (!tir) {
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
    len_ok = len2 > kTirLen2;
    if (len_ok) {
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
  const bool survive = rr ? !(rr_roll > p_max) : true;

  if (!kAdjoint) {
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
    if (len_ok) {
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
    if (!tir) {
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
  const float g_t1 = pick2 ? 0.0f : g_t;
  const float g_t2 = pick2 ? g_t : 0.0f;
  V3 g_mn = zero3(), g_mx = zero3();
  if (is_sphere) {
    float g_b = -g_t1 - g_t2;
    const float g_sq = g_t2 - g_t1;
    const float g_xs = g_sq * (0.5f / sqrtf(nmax(xs, 1e-12f)));  // sqrt_clamped_grad
    const float g_disc = ok ? g_xs * share(disc, 0.0f, xs) : 0.0f;
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

  if (dtab != nullptr) {
    float* D = dtab + row * kCols;
    if (is_sphere) {
      atomicAdd(D + 0, g_cen.x);
      atomicAdd(D + 1, g_cen.y);
      atomicAdd(D + 2, g_cen.z);
      atomicAdd(D + 3, g_r);
    } else {
      atomicAdd(D + 4, g_mn.x);
      atomicAdd(D + 5, g_mn.y);
      atomicAdd(D + 6, g_mn.z);
      atomicAdd(D + 7, g_mx.x);
      atomicAdd(D + 8, g_mx.y);
      atomicAdd(D + 9, g_mx.z);
    }
    const float gm[kMatLanes] = {g_alb.x, g_alb.y, g_alb.z, g_spec0, g_em.x, g_em.y, g_em.z,
                                 g_sr, g_ab.x, g_ab.y, g_ab.z, g_refr0, g_rrough, g_ior};
#pragma unroll
    for (int l = 0; l < kMatLanes; ++l) atomicAdd(D + 10 + l, gm[l]);
  }
  return survive;
}

// Adjoint of primary_ray: adds the camera cotangents (cam20 order) of the
// ray's origin and direction cotangents to gc.
__device__ __forceinline__ void primary_ray_adjoint(const Camera& cam, float fpx, float fpy,
                                                    float fw, float fh, bool jitter_center,
                                                    const Draws& w, V3 g_o, V3 g_d,
                                                    float* gc) {
  float u, v;
  pixel_ndc(fpx, fpy, fw, fh, jitter_center, w, u, v);
  const float ex = cam.ip00 * u + cam.ip01 * v - cam.ip02;
  const float ey = cam.ip10 * u + cam.ip11 * v - cam.ip12;
  const V3 a = cam.right * ex + cam.up * ey - cam.backward;
  const float as = sqrtf(dot(a, a));
  const V3 d1 = a / as;
  const V3 fp = cam.eye + d1 * cam.focal;
  const float angle = w.r_angle * kTwoPi;
  const float rl = sqrtf(w.r_radius);
  const float cx = cosf(angle) * rl;
  const float cy = sinf(angle) * rl;
  const float half_ap = cam.aperture * 0.5f;
  const float offx = half_ap * cx, offy = half_ap * cy;
  const V3 o = cam.eye + cam.right * offx + cam.up * offy;
  const V3 bv = fp - o;
  const float bs = sqrtf(dot(bv, bv));

  const V3 g_b = normalize_adjoint(bv, bs, g_d, 1.0f);   // d = normalize(fp - o)
  const V3 g_ot = g_o - g_b;                             // o = eye + right*offx + up*offy
  V3 g_eye = g_ot + g_b;                                 // fp = eye + d1 * focal
  V3 g_right = g_ot * offx;
  V3 g_up = g_ot * offy;
  const float g_ap = (dot(g_ot, cam.right) * cx + dot(g_ot, cam.up) * cy) * 0.5f;
  const float g_focal = dot(g_b, d1);
  const V3 g_a = normalize_adjoint(a, as, g_b * cam.focal, 1.0f);
  g_right = g_right + g_a * ex;
  g_up = g_up + g_a * ey;
  const float g_ex = dot(g_a, cam.right);
  const float g_ey = dot(g_a, cam.up);
  gc[0] += g_ex * u;
  gc[1] += g_ex * v;
  gc[2] -= g_ex;
  gc[3] += g_ey * u;
  gc[4] += g_ey * v;
  gc[5] -= g_ey;
  gc[6] += g_right.x; gc[7] += g_right.y; gc[8] += g_right.z;
  gc[9] += g_up.x; gc[10] += g_up.y; gc[11] += g_up.z;
  gc[12] -= g_a.x; gc[13] -= g_a.y; gc[14] -= g_a.z;
  gc[15] += g_eye.x; gc[16] += g_eye.y; gc[17] += g_eye.z;
  gc[18] += g_focal;
  gc[19] += g_ap;
}

__global__ void __launch_bounds__(kBlock)
trace_grad_kernel(const float* __restrict__ sphere_pos_radius,
                  const float* __restrict__ cuboid_min, const float* __restrict__ cuboid_max,
                  const float* __restrict__ table, int ns, int nc,
                  const float* __restrict__ cam20, int frame, int width, int height, int n_rows,
                  int row0, int spp, int ray_depth, int jitter_center, int rr, int half_stores,
                  int ablate, const float* __restrict__ g_rad_in,
                  const float* __restrict__ g_missd, const float* __restrict__ g_misst,
                  float* __restrict__ d_table, float* __restrict__ d_cam) {
  __shared__ GeomSmem geo;
  __shared__ float tab[kRows * kCols];
  __shared__ float dtab[kRows * kCols];
  __shared__ float dcam[kNCam];
  stage_geometry(geo, sphere_pos_radius, cuboid_min, cuboid_max, ns, nc);
  const int live = (ns + nc) * kCols;
  for (int k = threadIdx.x; k < live; k += blockDim.x) {
    tab[k] = table[k];
    dtab[k] = 0.0f;
  }
  if (threadIdx.x < kNCam) dcam[threadIdx.x] = 0.0f;
  __syncthreads();

  const Camera cam = camera_from20(cam20);
  const int64_t npix = static_cast<int64_t>(n_rows) * width;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  float gc[kNCam];
#pragma unroll
  for (int k = 0; k < kNCam; ++k) gc[k] = 0.0f;

  if (i < npix) {
    const int px = static_cast<int>(i % width);
    const int py = min(static_cast<int>(i / width) + row0, height - 1);
    const float fpx = static_cast<float>(px), fpy = static_cast<float>(py);
    const float fw = static_cast<float>(width), fh = static_cast<float>(height);
    const bool center = jitter_center != 0, russian = rr != 0, half = half_stores != 0;
    const V3 g_rad = make(g_rad_in[i], g_rad_in[npix + i], g_rad_in[2 * npix + i]);
    float* acc = ablate == kNoDtbl ? nullptr : dtab;

    Carry stored[kMaxDepth];
    int rec[kMaxDepth];   // (winner index + 1) * 2 + inside
    uint32_t seed = pixel_seed(px, py, static_cast<uint32_t>(frame));
    for (int s = 0; s < spp; ++s) {
      const Draws w = sample_draws(seed);
      Carry c;
      primary_ray(cam, fpx, fpy, fw, fh, center, w, c.o, c.d);
      c.thr = make(1.0f, 1.0f, 1.0f);
      c.seed = seed;
      const Carry first = c;
      Cot unused;
      int first_rec = 0;

      // ---- forward sweep: run and store each live bounce's input carry ----
      int n = 0;
      bool alive = true;
      while (alive && n < ray_depth) {
        const Hit hit = closest_hit(geo, ns, nc, c.o, c.d);
        const int code = (hit.idx + 1) * 2 + (hit.inside ? 1 : 0);
        if (n == 0) first_rec = code;
        if (ablate != kNoStores) {
          if (!half || n % 2 == 0) stored[half ? n / 2 : n] = c;
          rec[n] = code;
        }
        alive = bounce<false>(tab, ns, hit.idx, hit.inside, russian, c, unused, g_rad, nullptr);
        ++n;
      }
      seed = c.seed;

      // ---- reverse sweep: the adjoint of one bounce per step ----
      Cot g;
      g.o = zero3();
      g.d = zero3();
      g.thr = zero3();
      const int64_t slot = static_cast<int64_t>(s) * 3 * npix + i;
      g.md = make(g_missd[slot], g_missd[slot + npix], g_missd[slot + 2 * npix]);
      g.mt = make(g_misst[slot], g_misst[slot + npix], g_misst[slot + 2 * npix]);
      if (ablate != kNoRev) {
        for (int j = n - 1; j >= 0; --j) {
          Carry cj;
          int code;
          if (ablate == kNoStores) {
            cj = first;
            code = first_rec;
          } else {
            code = rec[j];
            if (half && (j % 2 == 1)) {
              cj = stored[j / 2];
              const int prev = rec[j - 1];
              bounce<false>(tab, ns, prev / 2 - 1, (prev & 1) != 0, russian, cj, unused, g_rad,
                            nullptr);
            } else {
              cj = stored[half ? j / 2 : j];
            }
          }
          if (ablate == kPrimalOnly) {
            bounce<false>(tab, ns, code / 2 - 1, (code & 1) != 0, russian, cj, unused, g_rad,
                          nullptr);
            g.o = g.o + cj.o * 1e-30f;
            g.d = g.d + cj.d * 1e-30f;
          } else {
            bounce<true>(tab, ns, code / 2 - 1, (code & 1) != 0, russian, cj, g, g_rad, acc);
          }
        }
      }
      if (ablate != kNoCam) primary_ray_adjoint(cam, fpx, fpy, fw, fh, center, w, g.o, g.d, gc);
    }
  }

  // ---- reductions: warp shuffles and shared atomics, then global atomics ----
#pragma unroll
  for (int k = 0; k < kNCam; ++k) {
    float v = gc[k];
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if ((threadIdx.x & 31) == 0) atomicAdd(&dcam[k], v);
  }
  __syncthreads();
  for (int k = threadIdx.x; k < live; k += blockDim.x) {
    const float v = dtab[k];
    if (v != 0.0f) atomicAdd(&d_table[k], v);
  }
  if (threadIdx.x < kNCam && dcam[threadIdx.x] != 0.0f) atomicAdd(&d_cam[threadIdx.x], dcam[threadIdx.x]);
}

}  // namespace

// C entry point, bound with ctypes by tpt_torch/kernels/_build.py.  Every
// pointer is a device buffer: the scene's sphere_pos_radius f32[256, 4],
// cuboid_min / cuboid_max f32[64, 3]; table f32[128, 24]; cam20 f32[20];
// g_rad f32[3, n_rows*width]; g_missd, g_misst f32[spp, 3, n_rows*width].
// d_table f32[128, 24] and d_cam f32[20] must be zero on entry; the kernel
// adds into them.  Launches on `stream` and returns cudaGetLastError().
extern "C" int tpt_trace_grad(
    const float* sphere_pos_radius, const float* cuboid_min, const float* cuboid_max,
    const float* table, int num_spheres, int num_cuboids, const float* cam20, int frame,
    int width, int height, int n_rows, int row0, int spp, int ray_depth, int jitter_center,
    int russian_roulette, int half_stores, int ablate, const float* g_rad,
    const float* g_missd, const float* g_misst, float* d_table, float* d_cam, void* stream) {
  if (num_spheres < 0 || num_spheres > tpt::kMaxSpheres || num_cuboids < 0 ||
      num_cuboids > tpt::kMaxCuboids || num_spheres + num_cuboids > kRows || width <= 0 ||
      height <= 0 || n_rows <= 0 || spp <= 0 || ray_depth < 0 || ray_depth > kMaxDepth ||
      ablate < kNone || ablate > kPrimalOnly) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t npix = static_cast<int64_t>(n_rows) * width;
  const unsigned blocks = static_cast<unsigned>((npix + kBlock - 1) / kBlock);
  trace_grad_kernel<<<blocks, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      sphere_pos_radius, cuboid_min, cuboid_max, table, num_spheres, num_cuboids, cam20, frame,
      width, height, n_rows, row0, spp, ray_depth, jitter_center, russian_roulette, half_stores,
      ablate, g_rad, g_missd, g_misst, d_table, d_cam);
  return static_cast<int>(cudaGetLastError());
}

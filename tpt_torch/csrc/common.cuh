// Device code shared by the CUDA kernels of tpt_torch (trace.cu, trace_grad.cu):
// vector helpers, the PCG random stream, the scene's geometry in shared
// memory with the closest-hit fold, and the camera sample.
//
// Static counts.  A build may fix the scene's primitive counts at compile
// time, as tpt's accelerator path compiles its trace kernels for a scene's
// static (n_spheres, n_cuboids) (tpt/kernels/trace.py:197-212):
// -DTPT_NUM_SPHERES=ns -DTPT_NUM_CUBOIDS=nc keeps the fold's primitive loops
// rolled at the constant trip counts (tpt's default, the full unroll, lost
// on the H100).  The fold (closest_hit) and the staging
// (stage_geometry) take their trip counts from sphere_count / cuboid_count,
// so every kernel that folds the scan gets the constants through them; a
// specialised build's entry points refuse other counts (counts_match).
// Without the defines one build serves any scene, the counts read at run
// time.  The arithmetic and its order are the same in both builds, so
// under -fmad=false they give the same bits.
//
// Parity policy.  The plain PyTorch versions (tpt_torch/integrator.py) round
// every operation on its own, so every kernel is compiled with -fmad=false
// and without --use_fast_math (IEEE division and square root stay on): a
// contracted FMA shifts a float by an ulp, which can flip the lobe roll, the
// Russian-roulette roll against p_max or a closest-hit near-tie.  Every
// expression keeps the plain version's operation order, and uses expf / sinf
// / cosf / sqrtf, the functions PyTorch's CUDA elementwise ops call.
// min/max propagate NaN like torch.minimum/maximum (an origin on a slab
// plane with a zero direction component gives 0/0 in ray_cuboid), and sign()
// is 0 at 0 like torch.sign.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tpt {

constexpr int kMaxSpheres = 256;
constexpr int kMaxCuboids = 64;
constexpr int kMatLanes = 14;      // material lanes 0..13 (14, 15 are padding)
constexpr int kMatStride = 16;

constexpr float kFloatMax = 3.4028235e38f;
constexpr float kEps = 0.001f;             // KERNEL_EPSILON
constexpr float kTwoPi = 6.28318530717958647692f;  // rounds to float32(2*pi)
constexpr float kU32ToFloat = 1.0f / 4294967296.0f;  // 2^-32, exact
constexpr float kTiny = 1e-20f;
constexpr float kTirLen2 = 1e-12f;

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 make(float x, float y, float z) { return V3{x, y, z}; }
__device__ __forceinline__ V3 operator+(V3 a, V3 b) { return make(a.x + b.x, a.y + b.y, a.z + b.z); }
__device__ __forceinline__ V3 operator-(V3 a, V3 b) { return make(a.x - b.x, a.y - b.y, a.z - b.z); }
__device__ __forceinline__ V3 operator-(V3 a) { return make(-a.x, -a.y, -a.z); }
__device__ __forceinline__ V3 operator*(V3 a, V3 b) { return make(a.x * b.x, a.y * b.y, a.z * b.z); }
__device__ __forceinline__ V3 operator*(V3 a, float s) { return make(a.x * s, a.y * s, a.z * s); }
__device__ __forceinline__ V3 operator/(V3 a, float s) { return make(a.x / s, a.y / s, a.z / s); }
__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }

// torch.minimum / torch.maximum: NaN in either operand gives NaN.
__device__ __forceinline__ float nmin(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fminf(a, b));
}
__device__ __forceinline__ float nmax(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fmaxf(a, b));
}
// torch.sign: (0 < x) - (x < 0), so 0 at +-0.
__device__ __forceinline__ float sgn(float x) {
  return static_cast<float>((0.f < x) - (x < 0.f));
}

// normalize3(a) and normalize3(a, eps): a / sqrt(max(dot(a, a), eps)).
__device__ __forceinline__ V3 normalize(V3 a) { return a / sqrtf(dot(a, a)); }
__device__ __forceinline__ V3 normalize_floor(V3 a, float eps) {
  return a / sqrtf(nmax(dot(a, a), eps));
}
// mix3(a, b, t) = a + (b - a) * t
__device__ __forceinline__ V3 mix(V3 a, V3 b, float t) { return a + (b - a) * t; }

// ---- PCG hash RNG (tpt_torch/rng.py; compute.glsl:334-344) ----
__device__ __forceinline__ uint32_t pixel_seed(uint32_t x, uint32_t y, uint32_t frame) {
  return (x * 1973u + y * 9277u + frame * 2699u) | 1u;
}
__device__ __forceinline__ float rand01(uint32_t& seed) {
  seed = seed * 747796405u + 2891336453u;
  uint32_t word = ((seed >> ((seed >> 28u) + 4u)) ^ seed) * 277803737u;
  word = (word >> 22u) ^ word;
  return __uint2float_rn(word) * kU32ToFloat;
}

// The uniform unit-sphere point of cosine_sample_hemisphere
// (tpt_torch/ops/sampling.py): z = r_z*2-1 first, then the angle.
__device__ __forceinline__ V3 hemisphere_offset(float r_z, float r_angle) {
  float z = r_z * 2.0f - 1.0f;
  float a = r_angle * kTwoPi;
  float r = sqrtf(nmax(1.0f - z * z, 0.0f));
  return make(r * cosf(a), r * sinf(a), z);
}
// cosine_sample_hemisphere: normalize(n + uniform unit-sphere point)
__device__ __forceinline__ V3 cosine_hemisphere(V3 n, float r_z, float r_angle) {
  return normalize(n + hemisphere_offset(r_z, r_angle));
}

// ---- the fold's trip counts: the build's constants or the run-time counts ----
#if defined(TPT_NUM_SPHERES) != defined(TPT_NUM_CUBOIDS)
#error "a specialised build defines both TPT_NUM_SPHERES and TPT_NUM_CUBOIDS"
#endif
#ifdef TPT_NUM_SPHERES
constexpr bool kStaticCounts = true;
constexpr int kStaticSpheres = TPT_NUM_SPHERES;
constexpr int kStaticCuboids = TPT_NUM_CUBOIDS;
static_assert(0 <= kStaticSpheres && kStaticSpheres <= kMaxSpheres, "TPT_NUM_SPHERES");
static_assert(0 <= kStaticCuboids && kStaticCuboids <= kMaxCuboids, "TPT_NUM_CUBOIDS");
#else
constexpr bool kStaticCounts = false;
constexpr int kStaticSpheres = 0;
constexpr int kStaticCuboids = 0;
#endif

__host__ __device__ __forceinline__ int sphere_count(int ns) {
  return kStaticCounts ? kStaticSpheres : ns;
}
__host__ __device__ __forceinline__ int cuboid_count(int nc) {
  return kStaticCounts ? kStaticCuboids : nc;
}
// Whether a launch's counts are those the build was made for (any counts
// for the dynamic build).
inline bool counts_match(int ns, int nc) {
  return !kStaticCounts || (ns == kStaticSpheres && nc == kStaticCuboids);
}

// The rows a kernel stages in shared memory: the scene tables' for the
// dynamic build, the constant counts' (at least one) for a specialised one.
constexpr int kSmemSpheres = !kStaticCounts ? kMaxSpheres : kStaticSpheres > 0 ? kStaticSpheres : 1;
constexpr int kSmemCuboids = !kStaticCounts ? kMaxCuboids : kStaticCuboids > 0 ? kStaticCuboids : 1;

// ---- scene geometry in shared memory and the closest-hit fold ----
struct GeomSmem {
  float sph[kSmemSpheres * 4];            // center.xyz, radius
  float cmin[kSmemCuboids * 3];
  float cmax[kSmemCuboids * 3];
};

// Copy the live rows of the scene's geometry into shared memory; every
// thread of the block takes part.  The caller synchronises.
__device__ __forceinline__ void stage_geometry(GeomSmem& g, const float* sphere_pos_radius,
                                               const float* cuboid_min, const float* cuboid_max,
                                               int ns, int nc) {
  ns = sphere_count(ns);
  nc = cuboid_count(nc);
  for (int k = threadIdx.x; k < ns * 4; k += blockDim.x) g.sph[k] = sphere_pos_radius[k];
  for (int k = threadIdx.x; k < nc * 3; k += blockDim.x) {
    g.cmin[k] = cuboid_min[k];
    g.cmax[k] = cuboid_max[k];
  }
}

// ray_cuboid's slab test (compute.glsl:280-294): (t1, t2); ok is t1 <= t2.
__device__ __forceinline__ void slab(V3 o, V3 d, const float* mn, const float* mx,
                                     float& t1, float& t2) {
  float t0x = (mn[0] - o.x) / d.x, t0y = (mn[1] - o.y) / d.y, t0z = (mn[2] - o.z) / d.z;
  float t1x = (mx[0] - o.x) / d.x, t1y = (mx[1] - o.y) / d.y, t1z = (mx[2] - o.z) / d.z;
  t1 = nmax(nmax(nmin(t0x, t1x), nmax(nmin(t0y, t1y), nmin(t0z, t1z))), -kFloatMax);
  t2 = nmin(nmin(nmax(t0x, t1x), nmin(nmax(t0y, t1y), nmax(t0z, t1z))), kFloatMax);
}

// cuboid_normal (tpt_torch/ops/intersect.py): the face normal by epsilon
// proximity, corners and edges giving normalised diagonals.
__device__ __forceinline__ V3 cuboid_normal(V3 mn, V3 mx, V3 hp) {
  V3 half = (mx - mn) * 0.5f;
  V3 cs = hp - (mx + mn) * 0.5f;
  V3 act = make(fabsf(fabsf(cs.x) - half.x) <= kEps ? 1.0f : 0.0f,
                fabsf(fabsf(cs.y) - half.y) <= kEps ? 1.0f : 0.0f,
                fabsf(fabsf(cs.z) - half.z) <= kEps ? 1.0f : 0.0f);
  return normalize_floor(make(sgn(cs.x), sgn(cs.y), sgn(cs.z)) * act, kTiny);
}

struct Hit {
  bool found;
  bool inside;
  int idx;
  float t;
};

// Closest-hit fold in the shader's scan order (compute.glsl:226-258):
// spheres first, then cuboids; a candidate wins when ok && t2 > 0 &&
// t1 < best (raw t1 against the incumbent's smallest positive t).  A
// specialised build scans its constant counts, its loops kept rolled.
__device__ __forceinline__ Hit closest_hit(const GeomSmem& sc, int ns, int nc, V3 o, V3 d) {
  ns = sphere_count(ns);
  nc = cuboid_count(nc);
  float best_t = kFloatMax;
  int best_idx = -1;
  bool inside = false;
#ifdef TPT_NUM_SPHERES
#pragma unroll 1
#endif
  for (int i = 0; i < ns; ++i) {
    V3 oc = o - make(sc.sph[4 * i], sc.sph[4 * i + 1], sc.sph[4 * i + 2]);
    float r = sc.sph[4 * i + 3];
    float b = dot(d, oc);
    float c = dot(oc, oc) - r * r;
    float disc = b * b - c;
    bool ok = disc >= 0.0f;
    float sq = sqrtf(ok ? nmax(disc, 0.0f) : 1.0f);
    float t1 = -b - sq;
    float t2 = -b + sq;
    if (ok && t2 > 0.0f && t1 < best_t) {
      best_t = (t1 < 0.0f) ? t2 : t1;
      best_idx = i;
      inside = best_t == t2;
    }
  }
#ifdef TPT_NUM_SPHERES
#pragma unroll 1
#endif
  for (int i = 0; i < nc; ++i) {
    float t1, t2;
    slab(o, d, &sc.cmin[3 * i], &sc.cmax[3 * i], t1, t2);
    bool ok = t1 <= t2;
    if (ok && t2 > 0.0f && t1 < best_t) {
      best_t = (t1 < 0.0f) ? t2 : t1;
      best_idx = kMaxSpheres + i;
      inside = best_t == t2;
    }
  }
  return Hit{best_t != kFloatMax, inside, best_idx, best_t};
}

// ---- the camera sample ----
struct Camera {
  float ip00, ip01, ip02, ip10, ip11, ip12;
  V3 right, up, backward, eye;
  float focal, aperture;
};

// The camera in the cam20 order of tpt.kernels.trace_grad: six
// inverse-projection entries, the inverse view's columns right, up,
// backward, eye, then the focal length and the aperture diameter.
__device__ __host__ __forceinline__ Camera camera_from20(const float* c) {
  Camera cam;
  cam.ip00 = c[0]; cam.ip01 = c[1]; cam.ip02 = c[2];
  cam.ip10 = c[3]; cam.ip11 = c[4]; cam.ip12 = c[5];
  cam.right = V3{c[6], c[7], c[8]};
  cam.up = V3{c[9], c[10], c[11]};
  cam.backward = V3{c[12], c[13], c[14]};
  cam.eye = V3{c[15], c[16], c[17]};
  cam.focal = c[18];
  cam.aperture = c[19];
  return cam;
}

// The four per-sample draws (sample_draws): jitter x/y, lens angle, lens radius.
struct Draws {
  float jx, jy, r_angle, r_radius;
};
__device__ __forceinline__ Draws sample_draws(uint32_t& seed) {
  Draws w;
  w.jx = rand01(seed);
  w.jy = rand01(seed);
  w.r_angle = rand01(seed);
  w.r_radius = rand01(seed);
  return w;
}

// Sub-pixel position in NDC: "corner" (the compute variant) or "center" (the
// shipped fragment variant), in primary_ray's operation order.
__device__ __forceinline__ void pixel_ndc(float fpx, float fpy, float fw, float fh,
                                          bool jitter_center, const Draws& w, float& u,
                                          float& v) {
  if (jitter_center) {
    u = ((fpx + 0.5f) / fw + (w.jx - 0.5f) / fw) * 2.0f - 1.0f;
    v = ((fpy + 0.5f) / fh + (w.jy - 0.5f) / fh) * 2.0f - 1.0f;
  } else {
    u = (fpx + w.jx) / fw * 2.0f - 1.0f;
    v = (fpy + w.jy) / fh * 2.0f - 1.0f;
  }
}

// primary_ray (compute.glsl:113-121,352-357): jittered thin-lens eye ray.
__device__ __forceinline__ void primary_ray(const Camera& cam, float fpx, float fpy, float fw,
                                            float fh, bool jitter_center, const Draws& w,
                                            V3& o, V3& d) {
  float u, v;
  pixel_ndc(fpx, fpy, fw, fh, jitter_center, w, u, v);
  float ex = cam.ip00 * u + cam.ip01 * v - cam.ip02;
  float ey = cam.ip10 * u + cam.ip11 * v - cam.ip12;
  V3 d1 = normalize(cam.right * ex + cam.up * ey - cam.backward);
  V3 focal_point = cam.eye + d1 * cam.focal;
  float angle = w.r_angle * kTwoPi;
  float rl = sqrtf(w.r_radius);
  float cx = cosf(angle) * rl;
  float cy = sinf(angle) * rl;
  float half_ap = cam.aperture * 0.5f;
  o = cam.eye + cam.right * (half_ap * cx) + cam.up * (half_ap * cy);
  d = normalize(focal_point - o);
}

}  // namespace tpt

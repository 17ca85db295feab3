// Path-tracing transport kernel for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernels of the JAX package's forward trace:
//   * tpt/kernels/trace.py::pallas_trace_progressive (the refill kernel of
//     the progressive render path), and
//   * tpt/kernels/trace.py::pallas_trace (the per-frame kernel), which is
//     the same transport at n_frames = 1, with either of its winner
//     gathers: "select" (masked selects over the scene's rows) and
//     "onehot" (trace.py:226-264, the winner's row of the f32[128, 24]
//     attribute table taken by a one-hot [24, 128] x [128, B] product).
// One transport serves all three; the winner gather is a template
// parameter (kTable), and each gather has its own C entry point.  The Python
// wrappers in tpt_torch/kernels/trace.py only name the outputs differently.
//
// Design (simple first):
//   * one thread per pixel of the n_rows x width band, a 1-D grid of
//     128-thread blocks; px = i % width, py = min(i / width + row0,
//     height - 1), pixels past the end are masked;
//   * the live scene rows are copied into shared memory at block start:
//     the fold's geometry, and either the 14 used material lanes (select,
//     at most ~23 KB in all) or the live rows of the attribute table (table
//     mode, at most 12 KB beside the geometry).  Every thread of a warp
//     reads the same primitive at the same time, so the reads are
//     broadcasts (the analogue of the TPU kernel's SMEM scalars and of the
//     shader's UBO);
//   * the winner's attributes are read by index.  The TPU needed the one-hot
//     product only because it has no per-lane gather; a thread reads its
//     winner's row directly, and gets the same values, so the two modes give
//     the same bits.  In both, t is the fold's own;
//   * each thread runs its pixel's samples as a queue: for frame f < n_valid
//     and sample s < spp it reseeds from pixel_seed(px, py, frame0 + f) at
//     s == 0 (else chains the running seed), draws the camera sample and
//     bounces up to ray_depth times.  The random stream is fixed per pixel,
//     so the results are those of tpt_torch.integrator.progressive_iteration
//     whatever the scheduling.  Slots of frames >= n_valid are written zero.
//
// What bounds it on this card: per-thread FP32 transport maths (a
// closest-hit scan over every primitive per bounce) and divergence across a
// warp's path lengths.  Device-memory traffic is small except the
// 2 * F * spp * 3 floats per pixel of deferred miss slots.
//
// Left for later: warp-level refill and compaction of live paths, sampling
// the environment inline at escape instead of storing miss slots, FMA
// contraction, and compile-time primitive counts.
//
// Parity policy: see common.cuh.  Every float operation repeats the plain
// PyTorch version's, in the same order, with no FMA contraction.

#include "common.cuh"

namespace {

using namespace tpt;

constexpr int kBlock = 128;
constexpr int kAttrRows = 128;  // build_attr_table: sphere i is row i, cuboid j row ns + j
constexpr int kAttrCols = 24;   // 0:4 sphere center, radius | 4:7 min | 7:10 max | 10:24 material

// The scene in shared memory: the fold's geometry and the winners' attributes,
// as the scene's material rows (select) or as the attribute table (kTable).
template <bool kTable>
struct SceneSmem;

template <>
struct SceneSmem<false> {
  GeomSmem g;
  float smat[kMaxSpheres * kMatLanes];
  float cmat[kMaxCuboids * kMatLanes];
};

template <>
struct SceneSmem<true> {
  GeomSmem g;
  float tab[kAttrRows * kAttrCols];
};

__device__ __forceinline__ void stage_attrs(SceneSmem<false>& sc, const float* sphere_material,
                                            const float* cuboid_material, const float*, int ns,
                                            int nc) {
  for (int k = threadIdx.x; k < ns * kMatLanes; k += blockDim.x)
    sc.smat[k] = sphere_material[(k / kMatLanes) * kMatStride + k % kMatLanes];
  for (int k = threadIdx.x; k < nc * kMatLanes; k += blockDim.x)
    sc.cmat[k] = cuboid_material[(k / kMatLanes) * kMatStride + k % kMatLanes];
}

__device__ __forceinline__ void stage_attrs(SceneSmem<true>& sc, const float*, const float*,
                                            const float* table, int ns, int nc) {
  for (int k = threadIdx.x; k < (ns + nc) * kAttrCols; k += blockDim.x) sc.tab[k] = table[k];
}

// The winner's attributes in shared memory: its 14 material lanes, and its
// sphere center and radius or its cuboid min and max.
struct WinnerRows {
  const float* mat;
  const float* sph;
  const float* cmin;
  const float* cmax;
};

__device__ __forceinline__ WinnerRows winner_rows(const SceneSmem<false>& sc, int idx, int) {
  if (idx < kMaxSpheres)
    return WinnerRows{&sc.smat[idx * kMatLanes], &sc.g.sph[4 * idx], nullptr, nullptr};
  const int j = idx - kMaxSpheres;
  return WinnerRows{&sc.cmat[j * kMatLanes], nullptr, &sc.g.cmin[3 * j], &sc.g.cmax[3 * j]};
}

// tpt/kernels/trace.py:238-240: row idx for a sphere, idx - MAX_SPHERES + ns
// for a cuboid.
__device__ __forceinline__ WinnerRows winner_rows(const SceneSmem<true>& sc, int idx, int ns) {
  const float* row = &sc.tab[(idx < kMaxSpheres ? idx : idx - kMaxSpheres + ns) * kAttrCols];
  return WinnerRows{row + 10, row, row + 4, row + 7};
}

struct Path {
  V3 o, d, thr, rad, miss_d, miss_t;
  uint32_t seed;
  bool alive;
};

// One bounce of the Radiance loop (compute.glsl:132-182) on a live path;
// tpt_torch.integrator.bounce_step restricted to its alive lane.
template <bool kTable>
__device__ __forceinline__ void bounce(const SceneSmem<kTable>& sc, int ns, int nc, bool rr,
                                       Path& p) {
  Hit h = closest_hit(sc.g, ns, nc, p.o, p.d);
  if (!h.found) {  // escaped: defer the environment fetch
    p.miss_d = p.d;
    p.miss_t = p.thr;
    p.alive = false;
    return;
  }
  const bool is_sphere = h.idx < kMaxSpheres;
  const WinnerRows w = winner_rows(sc, h.idx, ns);
  const float* mat = w.mat;
  V3 albedo = make(mat[0], mat[1], mat[2]);
  float spec0 = mat[3];
  V3 emissive = make(mat[4], mat[5], mat[6]);
  float spec_rough = mat[7];
  V3 absorb = make(mat[8], mat[9], mat[10]);
  float refr0 = mat[11];
  float refr_rough = mat[12];
  float ior_safe = nmax(mat[13], kEps);
  const float t = h.t;
  const bool inside = h.inside;

  V3 hp = p.o + p.d * t;
  V3 n;
  if (is_sphere) {
    const float* s = w.sph;
    n = (hp - make(s[0], s[1], s[2])) / nmax(s[3], kEps);
  } else {
    n = cuboid_normal(make(w.cmin[0], w.cmin[1], w.cmin[2]), make(w.cmax[0], w.cmax[1], w.cmax[2]),
                      hp);
  }
  if (inside) n = -n;

  V3 thr = p.thr;
  if (inside) thr = thr * make(expf(-absorb.x * t), expf(-absorb.y * t), expf(-absorb.z * t));

  // --- BSDF lobe probabilities (compute.glsl:184-195) ---
  float n1 = inside ? ior_safe : 1.0f;
  float n2 = inside ? 1.0f : ior_safe;
  float cos_theta = dot(-p.d, n);
  float r0 = (n1 - n2) / (n1 + n2);
  r0 = r0 * r0;
  float m = 1.0f - cos_theta;
  float m2 = m * m;
  float fres = r0 + (1.0f - r0) * (m2 * m2 * m);
  float spec_f = spec0 + (1.0f - spec0) * fres;
  float diffuse_c = 1.0f - spec_f - refr0;
  float spec = spec0 > 0.0f ? spec_f : spec0;
  float refr = spec0 > 0.0f ? 1.0f - spec_f - diffuse_c : refr0;

  // --- RNG draws, in shader order ---
  uint32_t seed = p.seed;
  float r_z = rand01(seed);
  float r_a = rand01(seed);
  V3 diffuse_ray = cosine_hemisphere(n, r_z, r_a);
  float roll = rand01(seed);
  const uint32_t s3 = seed;
  bool take_spec = spec > roll;
  bool take_refr = !take_spec && (spec + refr > roll);
  float r_z2 = rand01(seed);
  float r_a2 = rand01(seed);
  if (!take_refr) seed = s3;

  // --- lobe directions ---
  V3 refl_pure = p.d - n * (2.0f * dot(n, p.d));
  V3 new_d;
  if (take_spec) {
    new_d = normalize_floor(mix(refl_pure, diffuse_ray, spec_rough * spec_rough), kTiny);
  } else if (take_refr) {
    float eta = inside ? ior_safe : 1.0f / ior_safe;
    float n_dot_i = dot(n, p.d);
    float k = 1.0f - eta * eta * (1.0f - n_dot_i * n_dot_i);
    V3 refr_raw = make(0.0f, 0.0f, 0.0f);
    if (!(k < 0.0f)) {
      float sq = sqrtf(nmax(k, 0.0f));
      refr_raw = p.d * eta - n * (eta * n_dot_i + sq);
    }
    V3 hemi_neg = cosine_hemisphere(-n, r_z2, r_a2);
    V3 refr_mixed = mix(refr_raw, hemi_neg, refr_rough * refr_rough);
    float refr_len2 = dot(refr_mixed, refr_mixed);
    // TIR with ~zero roughness degenerates to the zero vector (shader UB);
    // defined policy: mirror reflection.
    new_d = refr_len2 > kTirLen2 ? refr_mixed / sqrtf(nmax(refr_len2, kTirLen2)) : refl_pure;
  } else {
    new_d = diffuse_ray;
  }
  float prob = take_spec ? spec : (take_refr ? refr : 1.0f - spec - refr);
  prob = nmax(prob, kEps);
  V3 new_o = hp + new_d * kEps;

  // --- throughput / radiance updates (compute.glsl:156-164) ---
  p.rad = p.rad + emissive * thr;
  V3 thr_after = take_refr ? thr : thr * albedo;
  thr_after = thr_after / prob;

  // --- Russian roulette (compute.glsl:166-173) ---
  float p_max = nmax(thr_after.x, nmax(thr_after.y, thr_after.z));
  float rr_roll = rand01(seed);
  bool survive = true;
  if (rr) {
    survive = !(rr_roll > p_max);
    if (survive) thr_after = thr_after / p_max;
  }
  p.o = new_o;
  p.d = new_d;
  p.thr = thr_after;
  p.seed = seed;
  p.alive = survive;
}

// kTable: read the winners from `table` (the attribute table, f32[128, 24]);
// else from sphere_material / cuboid_material.  The other pointers of the
// pair are not read.
template <bool kTable>
__global__ void __launch_bounds__(kBlock)
trace_progressive_kernel(const float* __restrict__ sphere_pos_radius,
                         const float* __restrict__ sphere_material,
                         const float* __restrict__ cuboid_min,
                         const float* __restrict__ cuboid_max,
                         const float* __restrict__ cuboid_material,
                         const float* __restrict__ table,
                         int ns, int nc, Camera cam, int width, int height,
                         int n_rows, int row0, int frame0, int n_frames,
                         int n_valid, int spp, int ray_depth, int jitter_center,
                         int rr, float* __restrict__ rad_sum,
                         float* __restrict__ miss_dir, float* __restrict__ miss_thr,
                         int32_t* __restrict__ ray_count, int64_t* __restrict__ seed_out) {
  __shared__ SceneSmem<kTable> sc;
  stage_geometry(sc.g, sphere_pos_radius, cuboid_min, cuboid_max, ns, nc);
  stage_attrs(sc, sphere_material, cuboid_material, table, ns, nc);
  __syncthreads();

  const int64_t npix = static_cast<int64_t>(n_rows) * width;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= npix) return;
  const int px = static_cast<int>(i % width);
  const int py = min(static_cast<int>(i / width) + row0, height - 1);
  const float fpx = static_cast<float>(px);
  const float fpy = static_cast<float>(py);
  const float fw = static_cast<float>(width);
  const float fh = static_cast<float>(height);

  V3 acc = make(0.0f, 0.0f, 0.0f);
  int32_t rays = 0;
  uint32_t seed = 0;
  for (int f = 0; f < n_valid; ++f) {
    for (int s = 0; s < spp; ++s) {
      if (s == 0) seed = pixel_seed(px, py, static_cast<uint32_t>(frame0 + f));
      const Draws w = sample_draws(seed);
      Path p;
      primary_ray(cam, fpx, fpy, fw, fh, jitter_center != 0, w, p.o, p.d);
      p.thr = make(1.0f, 1.0f, 1.0f);
      p.rad = make(0.0f, 0.0f, 0.0f);
      p.miss_d = make(0.0f, 0.0f, 0.0f);
      p.miss_t = make(0.0f, 0.0f, 0.0f);
      p.seed = seed;
      p.alive = true;
      for (int b = 0; b < ray_depth && p.alive; ++b) {
        ++rays;
        bounce<kTable>(sc, ns, nc, rr != 0, p);
      }
      seed = p.seed;
      acc = acc + p.rad;
      const int64_t slot = static_cast<int64_t>(f) * spp + s;
      float* md = miss_dir + slot * 3 * npix + i;
      float* mt = miss_thr + slot * 3 * npix + i;
      md[0] = p.miss_d.x; md[npix] = p.miss_d.y; md[2 * npix] = p.miss_d.z;
      mt[0] = p.miss_t.x; mt[npix] = p.miss_t.y; mt[2 * npix] = p.miss_t.z;
    }
  }
  for (int64_t slot = static_cast<int64_t>(n_valid) * spp;
       slot < static_cast<int64_t>(n_frames) * spp; ++slot) {
    for (int c = 0; c < 3; ++c) {
      miss_dir[(slot * 3 + c) * npix + i] = 0.0f;
      miss_thr[(slot * 3 + c) * npix + i] = 0.0f;
    }
  }
  rad_sum[i] = acc.x;
  rad_sum[npix + i] = acc.y;
  rad_sum[2 * npix + i] = acc.z;
  ray_count[i] = rays;
  seed_out[i] = static_cast<int64_t>(seed);
}

// The host side of both entry points: the camera from host memory, the
// checks, the launch.
template <bool kTable>
int launch(const float* sphere_pos_radius, const float* sphere_material,
           const float* cuboid_min, const float* cuboid_max, const float* cuboid_material,
           const float* table, int num_spheres, int num_cuboids, const float* camera_host,
           int width, int height, int n_rows, int row0, int frame0, int n_frames, int n_valid,
           int spp, int ray_depth, int jitter_center, int russian_roulette, float* rad_sum,
           float* miss_dir, float* miss_thr, int32_t* ray_count, int64_t* seed, void* stream) {
  if (num_spheres < 0 || num_spheres > kMaxSpheres || num_cuboids < 0 ||
      num_cuboids > kMaxCuboids || (kTable && num_spheres + num_cuboids > kAttrRows) ||
      width <= 0 || height <= 0 || n_rows <= 0 || n_frames < 0 || n_valid < 0 ||
      n_valid > n_frames || spp <= 0 || ray_depth < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* c = camera_host;
  const float* iv = c + 16;  // inverse view, row-major: column j is iv[j], iv[4 + j], iv[8 + j]
  const float cam20[20] = {c[0], c[1], c[2], c[4], c[5], c[6],
                           iv[0], iv[4], iv[8], iv[1], iv[5], iv[9],
                           iv[2], iv[6], iv[10], iv[3], iv[7], iv[11], c[32], c[33]};
  const Camera cam = camera_from20(cam20);

  const int64_t npix = static_cast<int64_t>(n_rows) * width;
  const unsigned blocks = static_cast<unsigned>((npix + kBlock - 1) / kBlock);
  trace_progressive_kernel<kTable><<<blocks, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      sphere_pos_radius, sphere_material, cuboid_min, cuboid_max, cuboid_material, table,
      num_spheres, num_cuboids, cam, width, height, n_rows, row0, frame0, n_frames, n_valid,
      spp, ray_depth, jitter_center, russian_roulette, rad_sum, miss_dir, miss_thr, ray_count,
      seed);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points, bound with ctypes by tpt_torch/kernels/_build.py.
// camera_host: 34 floats in host memory (inv_proj row-major, inv_view
// row-major, focal length, aperture diameter).  Outputs are device buffers:
// rad_sum f32[3, n_rows*width]; miss_dir, miss_thr f32[n_frames*spp, 3,
// n_rows*width]; ray_count i32[n_rows*width]; seed i64[n_rows*width]
// holding uint32 values.  Each launches on `stream` and returns
// cudaGetLastError().

// The select gather, n_frames progressive frames (pallas_trace_progressive,
// and pallas_trace at n_frames = 1).
extern "C" int tpt_trace_progressive(
    const float* sphere_pos_radius, const float* sphere_material,
    const float* cuboid_min, const float* cuboid_max, const float* cuboid_material,
    int num_spheres, int num_cuboids, const float* camera_host, int width,
    int height, int n_rows, int row0, int frame0, int n_frames, int n_valid,
    int spp, int ray_depth, int jitter_center, int russian_roulette,
    float* rad_sum, float* miss_dir, float* miss_thr, int32_t* ray_count,
    int64_t* seed, void* stream) {
  return launch<false>(sphere_pos_radius, sphere_material, cuboid_min, cuboid_max,
                       cuboid_material, nullptr, num_spheres, num_cuboids, camera_host, width,
                       height, n_rows, row0, frame0, n_frames, n_valid, spp, ray_depth,
                       jitter_center, russian_roulette, rad_sum, miss_dir, miss_thr, ray_count,
                       seed, stream);
}

// The one-hot gather's table mode, one frame (pallas_trace, gather="onehot"):
// table is the device buffer f32[128, 24] of build_attr_table(scene,
// (num_spheres, num_cuboids)), num_spheres + num_cuboids <= 128.
extern "C" int tpt_trace_onehot(
    const float* sphere_pos_radius, const float* cuboid_min, const float* cuboid_max,
    const float* table, int num_spheres, int num_cuboids, const float* camera_host,
    int width, int height, int n_rows, int row0, int frame, int spp, int ray_depth,
    int jitter_center, int russian_roulette, float* radiance, float* miss_dir,
    float* miss_thr, int32_t* ray_count, int64_t* seed, void* stream) {
  return launch<true>(sphere_pos_radius, nullptr, cuboid_min, cuboid_max, nullptr, table,
                      num_spheres, num_cuboids, camera_host, width, height, n_rows, row0,
                      frame, 1, 1, spp, ray_depth, jitter_center, russian_roulette, radiance,
                      miss_dir, miss_thr, ray_count, seed, stream);
}

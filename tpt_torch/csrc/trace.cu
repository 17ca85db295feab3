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
// One transport serves them all.  Three template parameters choose:
//   * kTable, the winner gather: the scene's rows (select) or the attribute
//     table (one-hot);
//   * kEnv, what an escaped path leaves.  Without it (the per-frame path and
//     trace_diff's forward) the kernel writes each sample's escape direction
//     and throughput to its miss slots and the caller fetches the
//     environment.  With it (the block path,
//     tpt_torch.kernels.render.progressive_frames) the kernel looks the
//     environment up itself when a path escapes and adds throughput x
//     environment to the sample's radiance; it writes no slots.  That is the
//     JAX render path's deferred fetch (tpt/kernels/render.py:110-113) done
//     in the kernel, its sum taken per sample;
//   * kBf16, with kEnv, the table's width: the f32 table's 48-byte rows or
//     the opt-in bf16 table's 24-byte rows (tpt/env.py:252-260, the JAX
//     package's --env-bf16), which halve the bytes a lookup reads.
// Each instantiation has its own C entry point.  The Python wrappers in
// tpt_torch/kernels/trace.py only name the outputs differently.
//
// Design:
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
//   * per-lane refill (select and table modes): each thread runs its pixel's
//     (frame, sample) items for f < n_valid, s < spp as a queue, in one loop
//     of bounces.  In the iteration in which its path ends, a lane finishes
//     the item (the sum, the slots) and starts the next: it reseeds from
//     pixel_seed(px, py, frame0 + f) at s == 0, else chains the running
//     seed, and draws the camera sample.  A warp so runs until its longest
//     per-pixel total of segments, where nested sample and bounce loops ran
//     each sample until the warp's longest path (lane efficiency 0.51 at
//     1080p, depth 13, Russian roulette).  tpt_torch.integrator.
//     trace_progressive has the same schedule.  Slots of frames >= n_valid
//     are written zero.  The render, training and viewer paths launch these
//     modes with one frame of one sample, one item a lane, where there is
//     nothing to balance (and the select kernel's 72 registers leave no
//     room for a pool);
//   * the warp-pooled queue (kEnv, trace_pooled): a warp's 32 pixels own
//     their n_valid items (pixel, frame), item k being frame k / live of
//     pixel k % live (live: the warp's pixels inside the band).  A lane
//     whose item ends, or that has none, claims the next unclaimed item of
//     its warp (a ballot and a popcount, no atomics), so lanes that finish
//     early take other pixels' frames and the warp no longer waits on its
//     longest pixel.  A frame's spp samples stay in order on the lane that
//     claimed it, reseeding at the first and chaining the seed after.  Each
//     finished sample writes its radiance and segments into the warp's
//     ring in shared memory, slot (sample mod kRing, pixel), and each
//     pixel's own lane folds its slots in sample order from zero, acc =
//     acc + rad, so rad_sum, ray_count and seed are the per-lane loop's
//     bits.  A sample never overwrites an unfolded slot: when a pixel has
//     more samples than the ring has rows, a sample whose slot still holds
//     an earlier one waits, holding its result, until the pixel's lane
//     folds it; else every sample has its own slot and the fold runs once
//     at the end.  A lane with nothing left stays in the loop, idle, until
//     its warp's items are done, so the warp-collective calls see every
//     lane.  At one item a pixel this is the per-lane schedule;
//   * in both, the random stream is fixed per pixel and a pixel's sums keep
//     their order, so the results are the plain version's bits;
//   * the environment lookup (kEnv) repeats
//     tpt_torch.env.sample_environment_blocked's arithmetic in its order:
//     GL face selection, an IEEE 1 / max(ma, 1e-30), the bilinear taps and
//     weights, and three independent loads of the tap's pack_block_table
//     row: 16 bytes each from the f32 table's 48-byte row (the table, 19.2
//     MB for the 256^2 sky, stays in the 50 MB L2), 8 bytes each from the
//     bf16 table's 24-byte row, which is 8-byte but not 16-byte aligned
//     (9.6 MB).  A bf16 texel widens to f32 by a 16-bit shift, which is
//     exact, and the blend then runs the f32 table's operations in their
//     order, so both tables give the plain version's bits.
//
// What bounds it on this card: per-thread FP32 transport maths (a
// closest-hit scan over every primitive per bounce) and, in the per-lane
// loop, the lanes of a warp left idle while others finish their pixel's
// longer paths (in the pooled queue, only the warp's last items).  Device-memory
// traffic is small except, without kEnv, the 2 * F * spp * 3 floats per
// pixel of miss slots.
//
// Static counts (common.cuh): built with -DTPT_NUM_SPHERES and
// -DTPT_NUM_CUBOIDS, every instantiation scans the scene's constant counts,
// as tpt's accelerator path builds pallas_trace and pallas_trace_progressive
// for a scene's static counts (tpt/kernels/trace.py:197-212, :425-433); its
// entry points then refuse other counts.  tpt_torch/kernels/_build.py keys
// each such build by its counts beside the one dynamic build.
//
// Left for later: FMA contraction.
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
  float smat[kSmemSpheres * kMatLanes];
  float cmat[kSmemCuboids * kMatLanes];
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

// The environment of kEnv: a tpt_torch.env.pack_block_table table,
// f32[6 (size + 2)^2, 12] on a 16-byte boundary, or with kBf16 its bf16
// form f32[6 (size + 2)^2, 6] on an 8-byte boundary (bf16 value 2j in the
// low 16 bits of word j, value 2j + 1 in the high 16 bits).  Row
// (face (S + 2) + y0) (S + 2) + x0 holds the four taps [t00, t01, t10, t11]
// of the bilinear footprint whose top-left padded texel is (y0, x0), each
// rgb.
struct EnvTable {
  const float* rows;
  int size;
};

constexpr float kInvMaFloor = 1e-30f;  // tpt_torch.env._INV_MA_FLOOR

// The 12 texels of row `row`: three 16-byte loads of an f32 row, or three
// 8-byte loads of a bf16 row, each bf16 value widened by a 16-bit shift.
template <bool kBf16>
__device__ __forceinline__ void fetch_taps(const EnvTable& env, int64_t row, float* tap) {
  if constexpr (kBf16) {
    const uint2* r = reinterpret_cast<const uint2*>(env.rows + row * 6);
    const uint2 q0 = __ldg(r), q1 = __ldg(r + 1), q2 = __ldg(r + 2);
    const uint32_t w[6] = {q0.x, q0.y, q1.x, q1.y, q2.x, q2.y};
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      tap[2 * j] = __uint_as_float(w[j] << 16);
      tap[2 * j + 1] = __uint_as_float(w[j] & 0xFFFF0000u);
    }
  } else {
    const float4* r = reinterpret_cast<const float4*>(env.rows + row * 12);
    const float4 q0 = __ldg(r), q1 = __ldg(r + 1), q2 = __ldg(r + 2);
    const float t[12] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w, q2.x, q2.y, q2.z, q2.w};
#pragma unroll
    for (int k = 0; k < 12; ++k) tap[k] = t[k];
  }
}

// tpt_torch.env.sample_environment_blocked at one direction:
// cubemap_face_uv_planar, _bilinear_taps and _lerp2, each rounding in their
// order (1 - fx is its own rounding; 1.0 / x is torch's reciprocal, an IEEE
// division).
template <bool kBf16>
__device__ __forceinline__ V3 environment(const EnvTable& env, V3 d) {
  const float ax = fabsf(d.x), ay = fabsf(d.y), az = fabsf(d.z);
  const bool x_major = ax >= ay && ax >= az;
  const bool y_major = !x_major && ay >= az;
  int face;
  float ma, sc, tc;
  if (x_major) {
    face = d.x > 0.0f ? 0 : 1;
    ma = ax;
    sc = d.x > 0.0f ? -d.z : d.z;
    tc = -d.y;
  } else if (y_major) {
    face = d.y > 0.0f ? 2 : 3;
    ma = ay;
    sc = d.x;
    tc = d.y > 0.0f ? d.z : -d.z;
  } else {
    face = d.z > 0.0f ? 4 : 5;
    ma = az;
    sc = d.z > 0.0f ? d.x : -d.x;
    tc = -d.y;
  }
  const float inv_ma = 1.0f / nmax(ma, kInvMaFloor);
  const float s = 0.5f * (sc * inv_ma + 1.0f);
  const float t = 0.5f * (tc * inv_ma + 1.0f);
  const float fsize = static_cast<float>(env.size);
  const float x = s * fsize - 0.5f;
  const float y = t * fsize - 0.5f;
  const float x0f = floorf(x);
  const float y0f = floorf(y);
  const float fx = x - x0f;
  const float fy = y - y0f;
  // +1 for the pad ring; x0 + 1 stays <= size + 1
  const int x0 = min(max(static_cast<int>(x0f), -1), env.size - 1) + 1;
  const int y0 = min(max(static_cast<int>(y0f), -1), env.size - 1) + 1;
  const int pad = env.size + 2;
  const int64_t row = static_cast<int64_t>((face * pad + y0) * pad + x0);
  float tap[12];
  fetch_taps<kBf16>(env, row, tap);
  const float gx = 1.0f - fx, gy = 1.0f - fy;
  float out[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float top = tap[c] * gx + tap[3 + c] * fx;
    const float bot = tap[6 + c] * gx + tap[9 + c] * fx;
    out[c] = top * gy + bot * fy;
  }
  return make(out[0], out[1], out[2]);
}

// One bounce of the Radiance loop (compute.glsl:132-182) on a live path;
// tpt_torch.integrator.bounce_step restricted to its alive lane.
// At escape, kEnv adds the environment term as the plain version's flush
// does, radiance + miss_thr * env(miss_dir); else it defers the fetch.
template <bool kTable, bool kEnv, bool kBf16>
__device__ __forceinline__ void bounce(const SceneSmem<kTable>& sc, int ns, int nc, bool rr,
                                       const EnvTable& env, Path& p) {
  Hit h = closest_hit(sc.g, ns, nc, p.o, p.d);
  if (!h.found) {
    if constexpr (kEnv) {
      p.rad = p.rad + p.thr * environment<kBf16>(env, p.d);
    } else {
      p.miss_d = p.d;
      p.miss_t = p.thr;
    }
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

constexpr unsigned kFullWarp = 0xffffffffu;
constexpr int kWarps = kBlock / 32;
// Rows of the pooled queue's ring (a power of two).  A build for given
// counts stages only their rows, which leaves room for a whole 8-frame
// block's samples at 8 blocks/SM (64 registers, 23,984 shared bytes a block
// for (48, 7)); the dynamic build stages kMax-sized rows and takes 2 rows,
// at 7 blocks/SM (31,232 shared bytes).
constexpr int kRing = kStaticCounts ? 8 : 2;
static_assert((kRing & (kRing - 1)) == 0, "kRing is a power of two");

// The environment mode's schedule, a warp-pooled queue (design notes at the
// top of the file).  Each warp owns its 32 consecutive pixels' items, item k
// being frame k / live of pixel k % live (live: the warp's pixels inside the
// band); lanes claim items in that order as they fall idle and run a frame's
// spp samples in order, chaining the seed.  A sample's result goes to the
// ring slot (sample mod kRing, pixel); each pixel's own lane folds its slots
// in sample order.  warp_iters, when not null, gets each warp's loop
// iterations.
template <bool kBf16>
__device__ __forceinline__ void trace_pooled(const SceneSmem<false>& sc, int ns, int nc, bool rr,
                                             const EnvTable& env, const Camera& cam, int width,
                                             int height, int n_rows, int row0, int frame0,
                                             int n_valid, int spp, int ray_depth,
                                             bool jitter_center, float* __restrict__ rad_sum,
                                             int32_t* __restrict__ ray_count,
                                             int64_t* __restrict__ seed_out,
                                             int32_t* __restrict__ warp_iters) {
  // a slot: the sample's radiance and, as int bits in w, its segments (-1: empty)
  __shared__ float4 rings[kWarps][kRing][32];
  // each pixel's fold so far while the loop runs: its sum, segments and samples
  __shared__ float4 sums[kWarps][32];
  __shared__ int folds[kWarps][32];
  // each pixel's (px, py), so a claim costs no 64-bit division
  __shared__ int2 pixels[kWarps][32];
  const int64_t npix = static_cast<int64_t>(n_rows) * width;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kBlock + (threadIdx.x & ~31);
  if (base >= npix) return;  // the whole warp lies past the band
  const int live = npix - base < 32 ? static_cast<int>(npix - base) : 32;
  float4(&ring)[kRing][32] = rings[warp];
#pragma unroll
  for (int r = 0; r < kRing; ++r) ring[r][lane].w = __int_as_float(-1);
  sums[warp][lane] = make_float4(0.0f, 0.0f, 0.0f, __int_as_float(0));
  folds[warp][lane] = 0;
  {
    const int64_t i = base + lane;
    pixels[warp][lane] = make_int2(static_cast<int>(i % width),
                                   min(static_cast<int>(i / width) + row0, height - 1));
  }
  __syncwarp();

  const int per_pixel = n_valid * spp;  // a pixel's samples, in the order its sum takes them
  const int total = live * n_valid;     // the warp's items
  // Every sample has a slot of its own when the ring holds a pixel's every
  // sample: the fold then waits for the loop's end.  Else slots are reused,
  // and a sample whose slot still holds an unfolded sample waits, holding
  // its result, until its pixel's lane folds that one.
  const bool streaming = per_pixel > kRing;
  const unsigned below = (1u << lane) - 1u;
  const float fw = static_cast<float>(width);
  const float fh = static_cast<float>(height);

  // Fold the lane's own pixel's samples that have arrived, in sample order,
  // into (acc, rays) from sample `folded` on.
  auto fold = [&](V3& acc, int32_t& rays, int& folded) {
    while (folded < per_pixel) {
      float4& slot = ring[folded & (kRing - 1)][lane];
      const int seg = __float_as_int(slot.w);
      if (seg < 0) break;
      acc = acc + make(slot.x, slot.y, slot.z);
      rays += seg;
      slot.w = __int_as_float(-1);
      ++folded;
    }
  };

  int next = 0;        // items claimed so far, the same in every lane
  int32_t iters = 0;
  bool busy = false;   // the lane holds an item
  int q = 0, j = 0, j_end = 0, b = 0;  // its pixel, its sample and the item's end, bounces
  uint32_t seed = 0;
  Path p;
  // Start sample j of the item; a frame's first sample (f >= 0) reseeds
  // from the pixel hash, later ones chain the running seed.
  auto start = [&](int f) {
    const int2 xy = pixels[warp][q];
    if (f >= 0) seed = pixel_seed(xy.x, xy.y, static_cast<uint32_t>(frame0 + f));
    const Draws w = sample_draws(seed);
    primary_ray(cam, static_cast<float>(xy.x), static_cast<float>(xy.y), fw, fh, jitter_center,
                w, p.o, p.d);
    p.thr = make(1.0f, 1.0f, 1.0f);
    p.rad = make(0.0f, 0.0f, 0.0f);
    p.seed = seed;
    p.alive = true;
    b = 0;
  };
  while (true) {
    // idle lanes claim the next items, in lane order
    const unsigned idle = __ballot_sync(kFullWarp, !busy);
    if (idle != 0 && next < total) {
      const int k = next + __popc(idle & below);
      if (!busy && k < total) {
        q = live == 32 ? k & 31 : k % live;
        const int f = live == 32 ? k >> 5 : k / live;
        j = f * spp;
        j_end = j + spp;
        start(f);
        busy = true;
      }
      next += __popc(idle);
    }
    if (__ballot_sync(kFullWarp, busy) == 0) break;
    ++iters;
    if (busy && p.alive && b < ray_depth) {
      bounce<false, true, kBf16>(sc, ns, nc, rr, env, p);
      ++b;
    }
    if (busy && (!p.alive || b >= ray_depth) && (!streaming || j < folds[warp][q] + kRing)) {
      // the sample ends: its slot, then the item's next sample or its end
      ring[j & (kRing - 1)][q] = make_float4(p.rad.x, p.rad.y, p.rad.z, __int_as_float(b));
      seed = p.seed;
      if (++j < j_end) {
        start(-1);
      } else {
        busy = false;
        if (j == per_pixel) seed_out[base + q] = static_cast<int64_t>(seed);
      }
    }
    if (streaming) {
      __syncwarp();
      if (lane < live) {
        int folded = folds[warp][lane];
        if (folded < per_pixel && __float_as_int(ring[folded & (kRing - 1)][lane].w) >= 0) {
          const float4 sum = sums[warp][lane];
          V3 acc = make(sum.x, sum.y, sum.z);
          int32_t rays = __float_as_int(sum.w);
          fold(acc, rays, folded);
          sums[warp][lane] = make_float4(acc.x, acc.y, acc.z, __int_as_float(rays));
          folds[warp][lane] = folded;
        }
      }
      __syncwarp();
    }
  }
  __syncwarp();
  if (lane < live) {
    const float4 sum = sums[warp][lane];
    V3 acc = make(sum.x, sum.y, sum.z);
    int32_t rays = __float_as_int(sum.w);
    int folded = folds[warp][lane];
    fold(acc, rays, folded);
    const int64_t i = base + lane;
    rad_sum[i] = acc.x;
    rad_sum[npix + i] = acc.y;
    rad_sum[2 * npix + i] = acc.z;
    ray_count[i] = rays;
    if (per_pixel == 0) seed_out[i] = 0;
  }
  if (lane == 0 && warp_iters != nullptr) warp_iters[base >> 5] = iters;
}

// kTable: read the winners from `table` (the attribute table, f32[128, 24]);
// else from sphere_material / cuboid_material.  The other pointers of the
// pair are not read.  kEnv: `env` is read, miss_dir / miss_thr are not
// written and the pooled queue runs (trace_pooled); else the reverse, and
// the per-lane refill loop runs.  kBf16: `env` is the bf16 table.
template <bool kTable, bool kEnv, bool kBf16>
__global__ void __launch_bounds__(kBlock)
trace_progressive_kernel(const float* __restrict__ sphere_pos_radius,
                         const float* __restrict__ sphere_material,
                         const float* __restrict__ cuboid_min,
                         const float* __restrict__ cuboid_max,
                         const float* __restrict__ cuboid_material,
                         const float* __restrict__ table, EnvTable env,
                         int ns, int nc, Camera cam, int width, int height,
                         int n_rows, int row0, int frame0, int n_frames,
                         int n_valid, int spp, int ray_depth, int jitter_center,
                         int rr, float* __restrict__ rad_sum,
                         float* __restrict__ miss_dir, float* __restrict__ miss_thr,
                         int32_t* __restrict__ ray_count, int64_t* __restrict__ seed_out,
                         int32_t* __restrict__ warp_iters) {
  __shared__ SceneSmem<kTable> sc;
  stage_geometry(sc.g, sphere_pos_radius, cuboid_min, cuboid_max, ns, nc);
  stage_attrs(sc, sphere_material, cuboid_material, table, ns, nc);
  __syncthreads();

  if constexpr (kEnv) {
    static_assert(!kTable, "the environment mode reads the scene's rows");
    trace_pooled<kBf16>(sc, ns, nc, rr != 0, env, cam, width, height, n_rows, row0, frame0,
                        n_valid, spp, ray_depth, jitter_center != 0, rad_sum, ray_count,
                        seed_out, warp_iters);
  } else {
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
    int f = 0, s = 0, b = 0;  // the lane's item, sample s of frame f, and its bounces so far
    Path p;
    // Start item (f, s): a frame's first sample reseeds from the pixel hash,
    // later samples chain the running seed.
    auto start = [&]() {
      if (s == 0) seed = pixel_seed(px, py, static_cast<uint32_t>(frame0 + f));
      const Draws w = sample_draws(seed);
      primary_ray(cam, fpx, fpy, fw, fh, jitter_center != 0, w, p.o, p.d);
      p.thr = make(1.0f, 1.0f, 1.0f);
      p.rad = make(0.0f, 0.0f, 0.0f);
      p.miss_d = make(0.0f, 0.0f, 0.0f);
      p.miss_t = make(0.0f, 0.0f, 0.0f);
      p.seed = seed;
      p.alive = true;
      b = 0;
    };
    bool busy = n_valid > 0;
    if (busy) start();
    while (busy) {
      if (b < ray_depth) {
        ++rays;
        bounce<kTable, false, false>(sc, ns, nc, rr != 0, env, p);
        ++b;
      }
      if (!p.alive || b >= ray_depth) {  // the item ends: its sums, its slots, the next item
        seed = p.seed;
        acc = acc + p.rad;
        const int64_t slot = static_cast<int64_t>(f) * spp + s;
        float* md = miss_dir + slot * 3 * npix + i;
        float* mt = miss_thr + slot * 3 * npix + i;
        md[0] = p.miss_d.x; md[npix] = p.miss_d.y; md[2 * npix] = p.miss_d.z;
        mt[0] = p.miss_t.x; mt[npix] = p.miss_t.y; mt[2 * npix] = p.miss_t.z;
        if (++s == spp) {
          s = 0;
          ++f;
        }
        busy = f < n_valid;
        if (busy) start();
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
}

// The host side of the entry points: the camera from host memory, the
// checks, the launch.
template <bool kTable, bool kEnv, bool kBf16>
int launch(const float* sphere_pos_radius, const float* sphere_material,
           const float* cuboid_min, const float* cuboid_max, const float* cuboid_material,
           const float* table, EnvTable env, int num_spheres, int num_cuboids,
           const float* camera_host, int width, int height, int n_rows, int row0, int frame0,
           int n_frames, int n_valid, int spp, int ray_depth, int jitter_center,
           int russian_roulette, float* rad_sum, float* miss_dir, float* miss_thr,
           int32_t* ray_count, int64_t* seed, int32_t* warp_iters, void* stream) {
  if (num_spheres < 0 || num_spheres > kMaxSpheres || num_cuboids < 0 ||
      num_cuboids > kMaxCuboids || (kTable && num_spheres + num_cuboids > kAttrRows) ||
      !counts_match(num_spheres, num_cuboids) ||
      width <= 0 || height <= 0 || n_rows <= 0 || n_frames < 0 || n_valid < 0 ||
      n_valid > n_frames || spp <= 0 || ray_depth < 0 ||
      (kEnv && (env.rows == nullptr || env.size < 1 ||
                reinterpret_cast<uintptr_t>(env.rows) % (kBf16 ? 8 : 16) != 0))) {
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
  trace_progressive_kernel<kTable, kEnv, kBf16>
      <<<blocks, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
          sphere_pos_radius, sphere_material, cuboid_min, cuboid_max, cuboid_material, table,
          env, num_spheres, num_cuboids, cam, width, height, n_rows, row0, frame0, n_frames,
          n_valid, spp, ray_depth, jitter_center, russian_roulette, rad_sum, miss_dir, miss_thr,
          ray_count, seed, warp_iters);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points, bound with ctypes by tpt_torch/kernels/_build.py.
// camera_host: 34 floats in host memory (inv_proj row-major, inv_view
// row-major, focal length, aperture diameter).  Outputs are device buffers:
// rad_sum f32[3, n_rows*width]; miss_dir, miss_thr f32[n_frames*spp, 3,
// n_rows*width]; ray_count i32[n_rows*width]; seed i64[n_rows*width]
// holding uint32 values.  Each launches on `stream` and returns
// cudaGetLastError(), or cudaErrorInvalidValue without a launch for bad
// arguments, among them counts other than a specialised build's.

// The select gather, n_frames progressive frames with their miss slots
// (pallas_trace_progressive, and pallas_trace at n_frames = 1).
extern "C" int tpt_trace_progressive(
    const float* sphere_pos_radius, const float* sphere_material,
    const float* cuboid_min, const float* cuboid_max, const float* cuboid_material,
    int num_spheres, int num_cuboids, const float* camera_host, int width,
    int height, int n_rows, int row0, int frame0, int n_frames, int n_valid,
    int spp, int ray_depth, int jitter_center, int russian_roulette,
    float* rad_sum, float* miss_dir, float* miss_thr, int32_t* ray_count,
    int64_t* seed, void* stream) {
  return launch<false, false, false>(sphere_pos_radius, sphere_material, cuboid_min, cuboid_max,
                                     cuboid_material, nullptr, EnvTable{nullptr, 0}, num_spheres,
                                     num_cuboids, camera_host, width, height, n_rows, row0,
                                     frame0, n_frames, n_valid, spp, ray_depth, jitter_center,
                                     russian_roulette, rad_sum, miss_dir, miss_thr, ray_count,
                                     seed, nullptr, stream);
}

// The select gather with the environment fetched at escape: n_frames
// progressive frames, rad_sum holding the environment term, no miss slots,
// scheduled by the pooled queue.  env_table: the device buffer
// f32[6 (env_size + 2)^2, 12] of tpt_torch.env.pack_block_table, on a
// 16-byte boundary.  warp_iters: null, or the device buffer
// i32[ceil(n_rows*width / 32)] that gets each warp's loop iterations.
extern "C" int tpt_trace_progressive_env(
    const float* sphere_pos_radius, const float* sphere_material,
    const float* cuboid_min, const float* cuboid_max, const float* cuboid_material,
    int num_spheres, int num_cuboids, const float* camera_host, int width,
    int height, int n_rows, int row0, int frame0, int n_frames, int n_valid,
    int spp, int ray_depth, int jitter_center, int russian_roulette,
    const float* env_table, int env_size, float* rad_sum, int32_t* ray_count,
    int64_t* seed, int32_t* warp_iters, void* stream) {
  return launch<false, true, false>(sphere_pos_radius, sphere_material, cuboid_min, cuboid_max,
                                    cuboid_material, nullptr, EnvTable{env_table, env_size},
                                    num_spheres, num_cuboids, camera_host, width, height, n_rows,
                                    row0, frame0, n_frames, n_valid, spp, ray_depth,
                                    jitter_center, russian_roulette, rad_sum, nullptr, nullptr,
                                    ray_count, seed, warp_iters, stream);
}

// The same with the bf16 table: env_table is the device buffer
// f32[6 (env_size + 2)^2, 6] of tpt_torch.env.pack_block_table(dtype=
// torch.bfloat16), on an 8-byte boundary.
extern "C" int tpt_trace_progressive_env_bf16(
    const float* sphere_pos_radius, const float* sphere_material,
    const float* cuboid_min, const float* cuboid_max, const float* cuboid_material,
    int num_spheres, int num_cuboids, const float* camera_host, int width,
    int height, int n_rows, int row0, int frame0, int n_frames, int n_valid,
    int spp, int ray_depth, int jitter_center, int russian_roulette,
    const float* env_table, int env_size, float* rad_sum, int32_t* ray_count,
    int64_t* seed, int32_t* warp_iters, void* stream) {
  return launch<false, true, true>(sphere_pos_radius, sphere_material, cuboid_min, cuboid_max,
                                   cuboid_material, nullptr, EnvTable{env_table, env_size},
                                   num_spheres, num_cuboids, camera_host, width, height, n_rows,
                                   row0, frame0, n_frames, n_valid, spp, ray_depth, jitter_center,
                                   russian_roulette, rad_sum, nullptr, nullptr, ray_count, seed,
                                   warp_iters, stream);
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
  return launch<true, false, false>(sphere_pos_radius, nullptr, cuboid_min, cuboid_max, nullptr,
                                    table, EnvTable{nullptr, 0}, num_spheres, num_cuboids,
                                    camera_host, width, height, n_rows, row0, frame, 1, 1, spp,
                                    ray_depth, jitter_center, russian_roulette, radiance, miss_dir,
                                    miss_thr, ray_count, seed, nullptr, stream);
}

// out: the blocks per SM that cudaOccupancyMaxActiveBlocksPerMultiprocessor
// gives each instantiation at its launch bound, [select, one-hot table,
// environment, environment with the bf16 table] (no launch), in this
// library's build: the dynamic one or one specialised for its counts.
extern "C" int tpt_trace_layout(int* blocks_per_sm) {
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks_per_sm[0], trace_progressive_kernel<false, false, false>, kBlock, 0);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks_per_sm[1], trace_progressive_kernel<true, false, false>, kBlock, 0);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks_per_sm[2], trace_progressive_kernel<false, true, false>, kBlock, 0);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks_per_sm[3], trace_progressive_kernel<false, true, true>, kBlock, 0);
  return static_cast<int>(err);
}

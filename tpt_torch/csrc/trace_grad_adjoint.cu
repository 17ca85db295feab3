// Backward of the differentiable path trace for NVIDIA Hopper (sm_90a), part
// two: the adjoint kernel, which reads the tape that trace_grad.cu's tape
// kernel wrote (layout and decision code: grad.cuh) and runs the reverse
// sweep, the camera adjoint and the reductions.  trace_grad.cu's header says
// which TPU kernel the pair replaces and what it computes.
//
// What bounds it on this card: per-thread FP32 maths, about two bounce
// evaluations per live bounce (the replay of the primal intermediates, then
// the hand-written adjoint of tpt_torch.integrator's table_hit_trace +
// bounce_step), and how many lanes of a warp have work.  Its design:
//
//   * A persistent grid, the occupancy API's blocks per SM times the SMs, of
//     128-thread blocks, its registers capped for 4 blocks per SM (128, a
//     few spills), which ran faster than 3 blocks at 165 registers and no
//     spills.  The (pixel, sample) items form one queue: a warp takes 32 at
//     a time with one atomic, and each lane takes the next item of its
//     warp's share when its own is done, so lanes do not idle on the warp's
//     longest path (the forward kernel's per-thread queue, at the
//     granularity of one bounce).  A lane's state between steps is its item,
//     its bounce and 18 cotangent floats.
//   * A step reads the bounce's carry and decision code from the tape (with
//     half_stores an odd bounce's carry is recomputed by one replayed bounce
//     from the even one before it) and applies the bounce's adjoint.  After
//     an item's first bounce the lane runs the camera adjoint (the draws come
//     from the first carry's seed, four PCG steps undone) and adds its 20
//     cotangents to its own column of a per-warp block of shared memory, so
//     no camera sums stay live in registers.
//   * Every discrete decision of the replay comes from the decision code,
//     none is recomputed, so FMA contraction here could flip no decision
//     (in the tape kernel it could: its decisions must be the forward
//     kernel's).  It is off all the same, as for every source
//     (tpt_torch/kernels/_build.py): a sphere's discriminant b * b - c
//     cancels, and fma(b, b, -c) moves a grazing hit's far more than an
//     ulp, which the derivative 0.5 / sqrt(disc) carries into the sums past
//     the plain version's bars, for a 1-5% gain.
//   * The table cotangent of a bounce (18 or 20 floats, zeros skipped) goes
//     straight into the block's partial in the workspace by global float
//     atomics, which the L2 applies without holding the lane; shared-memory
//     float atomics are compare-and-swap loops on this card, and summing a
//     warp's lanes on one row by shuffles first (__match_any_sync) cost more
//     than it saved.  The first row chunk of a call zeroes the partial
//     (live rows only), later chunks add to it; the 20 camera sums follow,
//     summed in warp and lane order.
//   * The last block of the call's last chunk (an acquire-release counter,
//     which it resets with the queue) sums the partials in block order,
//     applies the finite filter and writes d_table, d_cam and the number of
//     entries zeroed.  No memset, no global atomics across blocks: the
//     cross-block sum has a fixed order; the atomics within a block keep
//     the hardware's order, so two calls may differ in the last bits.
//
// The adjoint follows the reverse-mode rules of JAX and PyTorch: a max or min
// gives half the cotangent to each side at a tie (also against a constant,
// as jnp.maximum does), sqrt of a sphere's discriminant and of refract's k
// takes the clamped derivative 0.5 / sqrt(max(x, 1e-12))
// (tpt_torch.vecmath.sqrt_clamped_grad), and IEEE arithmetic is kept with no
// guard that the plain version lacks: an axis-parallel ray on a cuboid
// winner divides a zero cotangent by a zero direction component and gives
// NaN, which the finite filter zeroes and counts.
//
// Ablate flags (grad.cuh; timing probes, results meaningless unless all are
// set): kFlagReverse off runs no reverse sweep (the camera adjoint sees zero
// cotangents); kFlagAdjoint off replays each bounce's primal only;
// kFlagCamera off skips the camera adjoint; kFlagTable off adds nothing to
// the table; kFlagStores off (nothing on the tape but codes and counts)
// replays the item's first carry, recomputed from the camera with the
// first sample's seed, at every bounce.

#include <cuda/atomic>

#include "grad.cuh"

namespace {

using namespace tpt;

constexpr int kBlock = 128;
constexpr int kMinBlocks = 4;      // blocks per SM the register budget is set for
constexpr int kWarps = kBlock / 32;
constexpr int kGrab = 32;          // items a warp takes from the queue at once
constexpr int kTableWords = kRows * kCols;
constexpr int kPartWords = kTableWords + kNCam;   // 3,092: a block's partial
constexpr int kPartVec = kPartWords / 4;          // as float4
constexpr unsigned kFull = 0xffffffffu;
// The workspace: `grid` partials of kPartWords floats, then the queue (u64)
// and the arrival counter (u32), both 0 between launches.
constexpr int64_t kCounterWords = 4;

// The PCG step's multiplier, its inverse modulo 2^32, and its increment.
constexpr uint32_t kPcgMul = 747796405u, kPcgAdd = 2891336453u;
constexpr uint32_t inverse_mod32(uint32_t a) {
  uint32_t x = a;                               // a * a == 1 (mod 8) for odd a
  for (int k = 0; k < 5; ++k) x *= 2u - a * x;  // Newton: 3 -> 6 -> 12 -> 24 -> 48 bits
  return x;
}
constexpr uint32_t kPcgInv = inverse_mod32(kPcgMul);
static_assert(kPcgMul * kPcgInv == 1u, "PCG multiplier inverse");

// The seed `steps` PCG draws before `seed`.
__device__ __forceinline__ uint32_t unstep(uint32_t seed, int steps) {
  for (int k = 0; k < steps; ++k) seed = (seed - kPcgAdd) * kPcgInv;
  return seed;
}

// Add a lane's row cotangent (rc.row -1: nothing to add) to the block's
// partial in L2, its non-zero values one float atomic each.
__device__ __forceinline__ void add_to_table(float* part, const RowCot& rc, int ns) {
  if (rc.row < 0) return;
  float* D = part + rc.row * kCols;
  const bool sphere = rc.row < ns;
  const int n_geo = sphere ? 4 : 6;
  const int geo_col = sphere ? 0 : 4;
#pragma unroll
  for (int k = 0; k < 6; ++k)
    if (k < n_geo && rc.geo[k] != 0.0f) atomicAdd(D + geo_col + k, rc.geo[k]);
#pragma unroll
  for (int k = 0; k < kMatLanes; ++k)
    if (rc.mat[k] != 0.0f) atomicAdd(D + 10 + k, rc.mat[k]);
}

// The finite filter of one entry: zeroes a non-finite v and counts it.
__device__ __forceinline__ int filter(float& v) {
  if (isfinite(v)) return 0;
  v = 0.0f;
  return 1;
}

// Adjoint of primary_ray: adds the camera cotangents (cam20 order) of the
// ray's origin and direction cotangents to gc[0], gc[stride], ...
__device__ __forceinline__ void primary_ray_adjoint(const Camera& cam, float fpx, float fpy,
                                                    float fw, float fh, bool jitter_center,
                                                    const Draws& w, V3 g_o, V3 g_d, float* gc,
                                                    int stride) {
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
  const V3 g_eye = g_ot + g_b;                           // fp = eye + d1 * focal
  V3 g_right = g_ot * offx;
  V3 g_up = g_ot * offy;
  const float g_ap = (dot(g_ot, cam.right) * cx + dot(g_ot, cam.up) * cy) * 0.5f;
  const float g_focal = dot(g_b, d1);
  const V3 g_a = normalize_adjoint(a, as, g_b * cam.focal, 1.0f);
  g_right = g_right + g_a * ex;
  g_up = g_up + g_a * ey;
  const float g_ex = dot(g_a, cam.right);
  const float g_ey = dot(g_a, cam.up);
  const float add[kNCam] = {g_ex * u, g_ex * v, -g_ex, g_ey * u, g_ey * v, -g_ey,
                            g_right.x, g_right.y, g_right.z, g_up.x, g_up.y, g_up.z,
                            -g_a.x, -g_a.y, -g_a.z, g_eye.x, g_eye.y, g_eye.z, g_focal, g_ap};
#pragma unroll
  for (int k = 0; k < kNCam; ++k) gc[k * stride] += add[k];
}

struct Launch {
  int ns, frame, width, height, row0, spp, ray_depth, flags;
  bool center, rr, half;
  int64_t npix, gstride;
};

// work: `grid` partials, then the queue and the counter (0 on entry, 0 on
// exit).  out: d_table f32[3072], d_cam f32[20], n_zeroed i64, written by
// the last block of the last chunk.
__global__ void __launch_bounds__(kBlock, kMinBlocks)
trace_grad_adjoint_kernel(const float* __restrict__ table, int nc, const float* __restrict__ cam20,
                          Launch L, const float* __restrict__ carries,
                          const int32_t* __restrict__ codes, const int32_t* __restrict__ counts,
                          const float* __restrict__ g_rad, const float* __restrict__ g_missd,
                          const float* __restrict__ g_misst, int first_chunk, int last_chunk,
                          float* __restrict__ work, float* __restrict__ out) {
  __shared__ float tab[kTableWords];
  __shared__ float cam_acc[kWarps * kNCam * 32];   // [warp][k][lane]
  __shared__ float cam_s[kNCam];
  __shared__ bool last;
  __shared__ int n_bad;
  const int ns = L.ns;
  const int live = (ns + nc) * kCols;
  // the block's partial in the workspace: the first chunk of a call zeroes
  // its live table rows, and every chunk adds to them
  float* part = work + static_cast<int64_t>(blockIdx.x) * kPartWords;
  for (int k = threadIdx.x; k < live; k += kBlock) {
    tab[k] = table[k];
    if (first_chunk) part[k] = 0.0f;
  }
  for (int k = threadIdx.x; k < kWarps * kNCam * 32; k += kBlock) cam_acc[k] = 0.0f;
  if (threadIdx.x < kNCam) cam_s[threadIdx.x] = cam20[threadIdx.x];
  __threadfence();
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  float* my_cam = cam_acc + (threadIdx.x / 32) * kNCam * 32 + lane;
  const int64_t npix = L.npix;
  const uint64_t items = static_cast<uint64_t>(L.spp) * npix;
  const int64_t grid_words = static_cast<int64_t>(gridDim.x) * kPartWords;
  unsigned long long* queue = reinterpret_cast<unsigned long long*>(work + grid_words);
  unsigned* counter = reinterpret_cast<unsigned*>(work + grid_words + 2);
  const int slots = carry_slots(L.ray_depth, L.half);
  const bool stores = (L.flags & kFlagStores) != 0;
  const bool adjoint = (L.flags & kFlagAdjoint) != 0;

  // the lane's item: index (-1: none), sample, pixel, next bounce, cotangents
  int64_t item = -1, i = 0;
  int s = 0, j = -1;
  Cot g;
  V3 grad = zero3();
  uint64_t pool = 0, pool_end = 0;   // the warp's share of the queue
  bool drained = false;
  for (;;) {
    // ---- refill: lanes without an item take the next of the warp's share ----
    unsigned need = __ballot_sync(kFull, item < 0);
    while (need != 0u && !drained) {
      if (pool >= pool_end) {
        unsigned long long base = 0;
        if (lane == 0) base = atomicAdd(queue, static_cast<unsigned long long>(kGrab));
        base = __shfl_sync(kFull, base, 0);
        if (base >= items) {
          drained = true;
          break;
        }
        const uint64_t end = base + kGrab;
        pool = base;
        pool_end = end < items ? end : items;
      }
      const int take = min(__popc(need), static_cast<int>(pool_end - pool));
      const int rank = __popc(need & below);
      if (((need >> lane) & 1u) && rank < take) {
        item = static_cast<int64_t>(pool + rank);
        s = static_cast<int>(item / npix);
        i = item - static_cast<int64_t>(s) * npix;
        j = (L.flags & kFlagReverse) ? counts[item] - 1 : -1;
        g.o = zero3();
        g.d = zero3();
        g.thr = zero3();
        const int64_t slot = static_cast<int64_t>(s) * 3 * L.gstride + i;
        g.md = make(g_missd[slot], g_missd[slot + L.gstride], g_missd[slot + 2 * L.gstride]);
        g.mt = make(g_misst[slot], g_misst[slot + L.gstride], g_misst[slot + 2 * L.gstride]);
        grad = make(g_rad[i], g_rad[L.gstride + i], g_rad[2 * L.gstride + i]);
      }
      pool += take;
      need = __ballot_sync(kFull, item < 0);
    }
    if (__ballot_sync(kFull, item >= 0) == 0u) break;

    // ---- one step: a bounce's adjoint, then the camera's after the first ----
    RowCot rc;
    rc.row = -1;
    if (item >= 0) {
      const int px = static_cast<int>(i % L.width);
      const int py = min(static_cast<int>(i / L.width) + L.row0, L.height - 1);
      const float fpx = static_cast<float>(px), fpy = static_cast<float>(py);
      const float fw = static_cast<float>(L.width), fh = static_cast<float>(L.height);
      if (j >= 0) {
        Decision dc = decode(codes[code_at(s, j, L.ray_depth, npix, i)]);
        Carry cj;
        if (!stores) {
          uint32_t seed = pixel_seed(px, py, static_cast<uint32_t>(L.frame));
          const Draws w = sample_draws(seed);
          primary_ray(camera_from20(cam_s), fpx, fpy, fw, fh, L.center, w, cj.o, cj.d);
          cj.thr = make(1.0f, 1.0f, 1.0f);
          cj.seed = seed;
        } else if (L.half && (j & 1)) {
          cj = load_carry(carries + carry_at(s, j / 2, slots, npix, i), npix);
          Decision prev = decode(codes[code_at(s, j - 1, L.ray_depth, npix, i)]);
          Cot unused;
          bounce<kReplay>(tab, ns, prev, L.rr, cj, unused, grad, nullptr);
        } else {
          cj = load_carry(carries + carry_at(s, L.half ? j / 2 : j, slots, npix, i), npix);
        }
        if (adjoint) {
          bounce<kAdjoint>(tab, ns, dc, L.rr, cj, g, grad, &rc);
          if (!(L.flags & kFlagTable)) rc.row = -1;
        } else {
          Cot unused;
          bounce<kReplay>(tab, ns, dc, L.rr, cj, unused, grad, nullptr);
          g.o = g.o + cj.o * 1e-30f;
          g.d = g.d + cj.d * 1e-30f;
        }
        --j;
      }
      if (j < 0) {
        if (L.flags & kFlagCamera) {
          const uint32_t seed0 =
              stores && slots > 0
                  ? unstep(__float_as_uint(carries[carry_at(s, 0, slots, npix, i) +
                                                   (kCarryWords - 1) * npix]), 4)
                  : pixel_seed(px, py, static_cast<uint32_t>(L.frame));
          uint32_t seed = seed0;
          const Draws w = sample_draws(seed);
          primary_ray_adjoint(camera_from20(cam_s), fpx, fpy, fw, fh, L.center, w, g.o, g.d,
                              my_cam, 32);
        }
        item = -1;
      }
    }
    add_to_table(part, rc, ns);
  }

  // ---- the camera sums of this block's partial: stored by the first chunk,
  // added by the rest ----
  __syncthreads();
  if (threadIdx.x < kNCam) {
    float v = 0.0f;
    for (int w = 0; w < kWarps; ++w)
      for (int l = 0; l < 32; ++l) v += cam_acc[(w * kNCam + threadIdx.x) * 32 + l];
    float* p = part + kTableWords + threadIdx.x;
    *p = first_chunk ? v : __ldcg(p) + v;
  }
  // the fence and the barrier order the partial's stores before thread 0's
  // release; the last block's acquire, and its barrier, order them before
  // its loads
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    cuda::atomic_ref<unsigned, cuda::thread_scope_device> arrived(*counter);
    last = arrived.fetch_add(1u, cuda::memory_order_acq_rel) == gridDim.x - 1;
    n_bad = 0;
  }
  __syncthreads();
  if (!last) return;
  if (threadIdx.x == 0) {
    *counter = 0u;
    *queue = 0ull;
  }
  if (!last_chunk) return;

  // ---- the last block: partials summed in block order, the finite filter ----
  const float4* parts = reinterpret_cast<const float4*>(work);
  float4* out4 = reinterpret_cast<float4*>(out);
  const int live4 = live / 4, cam4 = kTableWords / 4;
  int bad = 0;
  for (int q = threadIdx.x; q < kPartVec; q += kBlock) {
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (q < live4 || q >= cam4) {
#pragma unroll 8
      for (int b = 0; b < static_cast<int>(gridDim.x); ++b) {
        const float4 v = __ldcg(parts + static_cast<int64_t>(b) * kPartVec + q);
        acc.x += v.x;
        acc.y += v.y;
        acc.z += v.z;
        acc.w += v.w;
      }
    }
    bad += filter(acc.x) + filter(acc.y) + filter(acc.z) + filter(acc.w);
    out4[q] = acc;
  }
  atomicAdd(&n_bad, bad);
  __syncthreads();
  if (threadIdx.x == 0) *reinterpret_cast<int64_t*>(out + kPartWords) = n_bad;
}

// The persistent grid of the current device: blocks per SM and their total.
int grid_of(int* blocks_per_sm, int* grid) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, trace_grad_adjoint_kernel,
                                                        kBlock, 0);
  *grid = *blocks_per_sm * sms;
  return static_cast<int>(err);
}

}  // namespace

// C entry points, bound with ctypes by tpt_torch/kernels/_build.py.

// The workspace's f32 words for `grid` blocks, and the current device's
// persistent grid: the adjoint kernel's blocks per SM (the occupancy API)
// and their total over the SMs.
extern "C" int tpt_trace_grad_adjoint_layout(int64_t* work_words, int* blocks_per_sm,
                                             int* grid) {
  const int err = grid_of(blocks_per_sm, grid);
  *work_words = static_cast<int64_t>(*grid) * kPartWords + kCounterWords;
  return err;
}

// Every pointer is a device buffer: table f32[128, 24]; cam20 f32[20]; the
// tape of grad.cuh that the tape kernel wrote for the same n_rows x width
// band; g_rad f32[3, gstride] and g_missd, g_misst f32[spp, 3, gstride],
// each offset to the band's first pixel; work, the layout entry's words for
// `grid` blocks, whose counters are 0 (the kernel leaves them 0); out
// f32[3094] (d_table, d_cam, then n_zeroed as i64), written when
// last_chunk is set.  Launches `grid` blocks on `stream` and returns
// cudaGetLastError().
extern "C" int tpt_trace_grad_adjoint(
    const float* table, int num_spheres, int num_cuboids, const float* cam20, int frame,
    int width, int height, int n_rows, int row0, int spp, int ray_depth, int jitter_center,
    int russian_roulette, int half_stores, int flags, const float* carries, const int32_t* codes,
    const int32_t* counts, const float* g_rad, const float* g_missd, const float* g_misst,
    int64_t gstride, int first_chunk, int last_chunk, int grid, float* work, float* out,
    void* stream) {
  const int64_t npix = static_cast<int64_t>(n_rows) * width;
  if (num_spheres < 0 || num_spheres > tpt::kMaxSpheres || num_cuboids < 0 ||
      num_cuboids > tpt::kMaxCuboids || num_spheres + num_cuboids > tpt::kRows || width <= 0 ||
      height <= 0 || n_rows <= 0 || spp <= 0 || ray_depth < 0 || ray_depth > tpt::kMaxDepth ||
      flags < 0 || flags > tpt::kFlagsAll || gstride < npix || grid <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Launch L;
  L.ns = num_spheres;
  L.frame = frame;
  L.width = width;
  L.height = height;
  L.row0 = row0;
  L.spp = spp;
  L.ray_depth = ray_depth;
  L.flags = flags;
  L.center = jitter_center != 0;
  L.rr = russian_roulette != 0;
  L.half = half_stores != 0;
  L.npix = npix;
  L.gstride = gstride;
  trace_grad_adjoint_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      table, num_cuboids, cam20, L, carries, codes, counts, g_rad, g_missd, g_misst,
      first_chunk, last_chunk, work, out);
  return static_cast<int>(cudaGetLastError());
}

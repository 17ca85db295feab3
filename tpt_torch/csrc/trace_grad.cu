// Backward of the differentiable path trace for NVIDIA Hopper (sm_90a), part
// one: the tape kernel.  Part two, the adjoint kernel, is
// trace_grad_adjoint.cu; the device code they share is grad.cuh.
//
// The pair replaces tpt/kernels/trace_grad.py::pallas_trace_grad (body
// _grad_kernel), with its half_stores and ablate variants.  Given the
// cotangents of one frame's differentiable outputs -- g_rad f32[3, P] (P =
// n_rows * width pixels) and g_missd / g_misst f32[spp, 3, P] -- it returns
// the cotangents of the winner-attribute table d_table f32[128, 24]
// (row-major, the layout of tpt_torch.integrator.build_attr_table) and of the
// 20 camera scalars d_cam f32[20] (cam20 order: ip00 ip01 ip02 ip10 ip11
// ip12, the inverse view's right, up, backward and eye columns, focal
// length, aperture), after the finite filter, with the count of entries it
// zeroed.
//
// Why two kernels.  One thread per pixel running the forward sweep, the
// replay and the adjoint in one kernel (this file's first design) spilled:
// its registers were set by the adjoint, the largest phase, and its tape sat
// in local memory, so the forward sweep ran at a fraction of the forward
// kernel's occupancy; and a warp's reverse sweep ran until its longest path
// was done.  The TPU kernel keeps its tape in VMEM scratch; here a tape does
// not fit a block's registers or shared memory, so it goes to device memory
// (grad.cuh), written once and read once in a layout a warp moves as
// 128-byte lines (1.19 GB at 1080p, depth 13, 1 spp: about 0.15 ms of the
// card's memory time each way).
//
// trace_grad_tape_kernel, the forward sweep alone, is bound by per-thread
// FP32 maths (the closest-hit fold over every primitive at each bounce) and
// by divergence across a warp's path lengths, like the forward kernel: one
// thread per pixel, a 1-D grid of 128-thread blocks, the pixel map, the
// geometry and the table in shared memory, and the forward kernel's fold
// and operation order (common.cuh, grad.cuh bounce<kTape>).  Under
// -fmad=false its decisions are the forward kernel's bit for bit: this
// source must never be compiled with FMA contraction.  For each (pixel,
// sample) item and each live bounce it writes the input carry (10 words;
// with half_stores only at even bounces) and the decision code (grad.cuh),
// and each item's live-bounce count.
//
// Static counts: the JAX backward always folds static counts
// (tpt/kernels/trace_grad.py:157-173); on the H100 this kernel built for
// them (common.cuh) was slower than the dynamic build, so the backward
// loads the dynamic build only (tpt_torch/kernels/trace_grad.py).  The
// adjoint kernel reads the winner from the tape, folds no scan, and is
// built once for any scene.
//
// Ablate modes (timing probes; results meaningless except with every flag
// set): kFlagStores off writes no carries (the adjoint kernel then replays
// the first bounce's carry at every bounce); the other flags concern the
// adjoint kernel (trace_grad_adjoint.cu).

#include "grad.cuh"

namespace {

using namespace tpt;

constexpr int kBlock = 128;

__global__ void __launch_bounds__(kBlock)
trace_grad_tape_kernel(const float* __restrict__ sphere_pos_radius,
                       const float* __restrict__ cuboid_min, const float* __restrict__ cuboid_max,
                       const float* __restrict__ table, int ns, int nc,
                       const float* __restrict__ cam20, int frame, int width, int height,
                       int n_rows, int row0, int spp, int ray_depth, int jitter_center, int rr,
                       int half_stores, int flags, float* __restrict__ carries,
                       int32_t* __restrict__ codes, int32_t* __restrict__ counts) {
  __shared__ GeomSmem geo;
  __shared__ float tab[kRows * kCols];
  stage_geometry(geo, sphere_pos_radius, cuboid_min, cuboid_max, ns, nc);
  for (int k = threadIdx.x; k < (ns + nc) * kCols; k += blockDim.x) tab[k] = table[k];
  __syncthreads();

  const int64_t npix = static_cast<int64_t>(n_rows) * width;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= npix) return;
  const int px = static_cast<int>(i % width);
  const int py = min(static_cast<int>(i / width) + row0, height - 1);
  const Camera cam = camera_from20(cam20);
  const bool half = half_stores != 0, stores = (flags & kFlagStores) != 0;
  const int slots = carry_slots(ray_depth, half);

  uint32_t seed = pixel_seed(px, py, static_cast<uint32_t>(frame));
  for (int s = 0; s < spp; ++s) {
    const Draws w = sample_draws(seed);
    Carry c;
    primary_ray(cam, static_cast<float>(px), static_cast<float>(py), static_cast<float>(width),
                static_cast<float>(height), jitter_center != 0, w, c.o, c.d);
    c.thr = make(1.0f, 1.0f, 1.0f);
    c.seed = seed;
    int n = 0;
    bool alive = true;
    while (alive && n < ray_depth) {
      const Hit hit = closest_hit(geo, ns, nc, c.o, c.d);
      if (stores && (!half || n % 2 == 0))
        store_carry(carries + carry_at(s, half ? n / 2 : n, slots, npix, i), npix, c);
      Decision dc = {};
      dc.row = hit.idx < 0 ? -1 : (hit.idx < kMaxSpheres ? hit.idx : hit.idx - kMaxSpheres + ns);
      dc.inside = hit.inside;
      Cot unused;
      alive = bounce<kTape>(tab, ns, dc, rr != 0, c, unused, zero3(), nullptr);
      codes[code_at(s, n, ray_depth, npix, i)] = encode(dc);
      ++n;
    }
    counts[static_cast<int64_t>(s) * npix + i] = n;
    seed = c.seed;
  }
}

}  // namespace

// C entry points, bound with ctypes by tpt_torch/kernels/_build.py.  Every
// pointer is a device buffer: the scene's sphere_pos_radius f32[256, 4],
// cuboid_min / cuboid_max f32[64, 3]; table f32[128, 24]; cam20 f32[20]; the
// tape of grad.cuh for n_rows x width pixels (carries, codes, counts).
// Launches on `stream` and returns cudaGetLastError(), or
// cudaErrorInvalidValue without a launch for bad arguments, among them
// counts other than a specialised build's.
extern "C" int tpt_trace_grad_tape(
    const float* sphere_pos_radius, const float* cuboid_min, const float* cuboid_max,
    const float* table, int num_spheres, int num_cuboids, const float* cam20, int frame,
    int width, int height, int n_rows, int row0, int spp, int ray_depth, int jitter_center,
    int russian_roulette, int half_stores, int flags, float* carries, int32_t* codes,
    int32_t* counts, void* stream) {
  if (num_spheres < 0 || num_spheres > tpt::kMaxSpheres || num_cuboids < 0 ||
      num_cuboids > tpt::kMaxCuboids || num_spheres + num_cuboids > tpt::kRows ||
      !tpt::counts_match(num_spheres, num_cuboids) || width <= 0 ||
      height <= 0 || n_rows <= 0 || spp <= 0 || ray_depth < 0 || ray_depth > tpt::kMaxDepth ||
      flags < 0 || flags > tpt::kFlagsAll) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t npix = static_cast<int64_t>(n_rows) * width;
  const unsigned blocks = static_cast<unsigned>((npix + kBlock - 1) / kBlock);
  trace_grad_tape_kernel<<<blocks, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      sphere_pos_radius, cuboid_min, cuboid_max, table, num_spheres, num_cuboids, cam20, frame,
      width, height, n_rows, row0, spp, ray_depth, jitter_center, russian_roulette, half_stores,
      flags, carries, codes, counts);
  return static_cast<int>(cudaGetLastError());
}

// The tape kernel's blocks per SM at its launch bound (the occupancy API),
// in this library's build.
extern "C" int tpt_trace_grad_tape_layout(int* blocks_per_sm) {
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, trace_grad_tape_kernel, kBlock, 0));
}

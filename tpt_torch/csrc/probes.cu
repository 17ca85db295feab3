// Kernels of the backward-design probes for NVIDIA Hopper (sm_90a).
//
// Replace the nine Pallas probes of benchmarks/exp_bwd_probes.py, which
// asked what Mosaic could lower for the one-hot backward kernel.  Their
// inputs are the harness's: idx i32[N, 128] of winner rows in [0, 55),
// table f32[128, 32], g f32[N, 128], N = GRID * 16.  Three kernels serve
// them:
//
//   * probe_gather_kernel, p1 (exp_bwd_probes.py:46-54) and p3 (:82-91):
//     out[b] = table[idx[b], col].  The TPU took the row with a one-hot
//     [B, 128] x [128, 32] product because it has no per-lane gather; here
//     each thread reads its rows by index from the table's column, staged
//     in shared memory (512 bytes).  An index outside the table gives 0,
//     the one-hot product's value.  The design moves the bytes as the
//     elementwise kernel does: each thread reads idx 16 bytes (4 elements)
//     and writes 16 bytes at a time, over a grid of at most
//     kGatherBlocksPerSm 256-thread blocks per SM that strides over the
//     int4s, so the column's staging and its barrier are paid once per
//     block, not once per 1024 elements; a thread issues its first idx
//     load before the staging, so the two latencies overlap.  Reading the
//     column through the read-only cache instead (no staging, no barrier)
//     makes a warp's 32 lookups touch up to 32 cache lines a load; shared
//     memory serves them in a few bank wavefronts (gather_designs.py
//     times both).
//   * probe_scatter_kernel, p1t (:57-70), p5 (:109-121), p6 (:126-144),
//     p7 (:148-165) and p8 (:168-185): the transposes of the gather,
//     d[r, k] = a_k * sum_{b in window, idx[b] = r} g[b]
//             + c_k * #{b in window: idx[b] = r},
//     with column weights a, c from the probe (a ColWeights the wrapper
//     builds once per probe; the entry copies it into the launch by value)
//     and the window every element (p5: the last 16 x 128 tile, the one
//     whose sums its SMEM output keeps).  One launch, no zeroed scratch:
//       - each warp keeps its own 128-row histogram in shared memory (f32
//         sums, u32 counts), so only the lanes of one warp contend for a
//         row: each lane reads 4 elements of idx and g with one 16-byte load
//         each and adds them with shared-memory atomics;
//       - the grid is at most one block of 1024 threads per SM.  Each block
//         sums its 32 warp histograms in warp order and writes its whole
//         partial (2 x 128 words) into the wrapper's workspace, so the
//         workspace needs no zeroing;
//       - the last block to arrive (a u32 counter after the partials,
//         raised by thread 0 with acquire-release order) sums the partials
//         in block order, 16 bytes a load, writes d and sets the counter
//         back to 0 for the next launch on the stream.  The wrapper keeps
//         one workspace per (device, stream), zeroed once when it is made,
//         of the size tpt_probe_scatter_layout gives.  A grid of one
//         block (p5) writes d from its own partial.
//     The counts are exact.  The sums are merged in a fixed order, but a
//     warp's colliding shared-memory atomics are applied in the hardware's
//     order, which CUDA does not fix, so two calls may differ in the last
//     bits of a sum (chip_smoke.py reports whether they did).  Aggregating
//     equal rows in a warp with __match_any_sync and shuffles (no float
//     atomic at all) and per-lane private sums (128-192 KB of shared
//     memory a block) were measured and were slower.
//   * probe_elementwise_kernel, p2 (:73-79): 2x; and p4 (:94-106):
//     f(x) + f'(x) g with y = x rsqrt(x^2 + 1), z = x > 0 ? y^2 : exp(-y),
//     f = tanh(z) + y / (z + 2), its reverse mode written out by hand (CUDA
//     has no autodiff).  One 16-byte load and store a thread.
//
// What bounds them on this card: bytes.  Each reads 8 bytes an element
// (idx and g, or x alone when g is x) and writes 4 (the gather and the
// elementwise) or a 16 KB table (the scatter); p4's ~33 operations an
// element are far below the card's 67 TFLOP/s fp32 at 3.35 TB/s.  At the
// harness's GRID = 100 (204,800 elements, ~1.6 MB) the bound is ~0.5 us,
// so the launch, and for the scatter the merge's round trips, set the time.
//
// Every kernel loads 16 bytes at a time, so idx, g, x and out must start
// on a 16-byte boundary and hold a multiple of 4 elements; the wrapper
// checks the pointers and raises, and the entry points refuse what is not
// (cudaErrorInvalidValue).  The library is built
// with the flags of the trace kernels (-fmad=false, IEEE division and
// sqrt).  p4 takes its fused multiply-adds from explicit fmaf calls,
// and one reciprocal of z + 2 serves its three divisions by it: it stays
// within a few ulp of autograd, far inside its bar (rtol 1e-5).  The sums
// differ from the plain versions only by their order.

#include <cuda/atomic>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

constexpr int kMaxCols = 32;   // the table's columns K

// The scatter probes' column weights.
struct ColWeights {
  float a[kMaxCols];
  float c[kMaxCols];
};

namespace {

constexpr int kBlock = 256;
constexpr int kRows = 128;     // the table's rows: the one-hot width R

constexpr int kGatherBlocksPerSm = 8;   // 2048 threads: the SM's full occupancy

__device__ __forceinline__ float lookup(const float* column, int r) {
  return (r >= 0 && r < kRows) ? column[r] : 0.0f;
}

// out4[i] = the column at the 4 rows of idx4[i], for i < n4, in a grid
// that strides over the int4s.
__global__ void __launch_bounds__(kBlock)
probe_gather_kernel(const int4* __restrict__ idx4, const float* __restrict__ table, int cols,
                    int col, int64_t n4, float4* __restrict__ out4) {
  __shared__ float column[kRows];
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kBlock;
  int64_t i = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
  int4 r = i < n4 ? __ldg(idx4 + i) : make_int4(0, 0, 0, 0);
  if (threadIdx.x < kRows) column[threadIdx.x] = __ldg(table + threadIdx.x * cols + col);
  __syncthreads();
  while (i < n4) {
    const int64_t next = i + stride;
    const int4 rn = next < n4 ? __ldg(idx4 + next) : r;   // in flight while this one is stored
    out4[i] = make_float4(lookup(column, r.x), lookup(column, r.y), lookup(column, r.z),
                          lookup(column, r.w));
    r = rn;
    i = next;
  }
}

// ---- the scatter ----

constexpr int kScatterBlock = 1024;
constexpr int kWarps = kScatterBlock / 32;
// A histogram, a warp's or a block's: kWords 32-bit words, the f32 row sums
// then the u32 row counts, read and written as kChunks 16-byte chunks.
constexpr int kWords = 2 * kRows;
constexpr int kChunks = kWords / 4;
constexpr int kParts = 8;          // threads that share one chunk's sum in a merge
constexpr int kMaxBlocks = 1024;   // partials the wrapper's workspace holds
// the workspace: kMaxBlocks partials of kWords words, then the counter
constexpr int64_t kWorkspaceWords = static_cast<int64_t>(kMaxBlocks) * kWords + 1;

__device__ __forceinline__ void add_row(int r, float v, float* sum, uint32_t* cnt) {
  if (r >= 0 && r < kRows) {
    atomicAdd(sum + r, v);
    atomicAdd(cnt + r, 1u);
  }
}

__device__ __forceinline__ uint4 add_chunk(uint4 a, uint4 b, bool sums) {
  if (!sums) return make_uint4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
  return make_uint4(__float_as_uint(__uint_as_float(a.x) + __uint_as_float(b.x)),
                    __float_as_uint(__uint_as_float(a.y) + __uint_as_float(b.y)),
                    __float_as_uint(__uint_as_float(a.z) + __uint_as_float(b.z)),
                    __float_as_uint(__uint_as_float(a.w) + __uint_as_float(b.w)));
}

// The chunk-wise sum of `terms` histograms at hist[j * kChunks], j in
// order: kParts threads sum each chunk, each over a contiguous share of
// the terms in order, and thread t < kChunks adds the shares in order and
// gets chunk t's total.  kFromL2: the terms are other blocks' stores.
template <bool kFromL2>
__device__ __forceinline__ uint4 ordered_sum(const uint4* hist, int terms, uint4* share) {
  const int t = threadIdx.x, c = t % kChunks, part = t / kChunks;
  const bool sums = c < kRows / 4;
  uint4 acc = make_uint4(0u, 0u, 0u, 0u);
  if (part < kParts) {
    const int per = (terms + kParts - 1) / kParts;
    const int lo = min(terms, part * per), hi = min(terms, lo + per);
#pragma unroll 4
    for (int j = lo; j < hi; ++j) {
      const uint4* p = hist + static_cast<int64_t>(j) * kChunks + c;
      acc = add_chunk(acc, kFromL2 ? __ldcg(p) : *p, sums);
    }
    share[part * kChunks + c] = acc;
  }
  __syncthreads();
  acc = make_uint4(0u, 0u, 0u, 0u);
  if (t < kChunks)
    for (int q = 0; q < kParts; ++q) acc = add_chunk(acc, share[q * kChunks + c], sums);
  return acc;
}

// work: kMaxBlocks partials of kChunks chunks, then the u32 counter, which
// is 0 on entry and is 0 again on exit.
__global__ void __launch_bounds__(kScatterBlock, 1)
probe_scatter_kernel(const int4* __restrict__ idx, const float4* __restrict__ g, int64_t n4,
                     ColWeights w, int rows, int cols, uint4* __restrict__ work,
                     float* __restrict__ d) {
  __shared__ uint4 hist[kWarps * kChunks];
  __shared__ uint4 share[kParts * kChunks];
  __shared__ uint4 total[kChunks];
  __shared__ float col_a[kMaxCols], col_c[kMaxCols];
  __shared__ bool last;
  for (int e = threadIdx.x; e < kWarps * kChunks; e += kScatterBlock)
    hist[e] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();

  uint32_t* mine = reinterpret_cast<uint32_t*>(hist + threadIdx.x / 32 * kChunks);
  float* sum = reinterpret_cast<float*>(mine);
  uint32_t* cnt = mine + kRows;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kScatterBlock;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kScatterBlock + threadIdx.x; i < n4;
       i += stride) {
    const int4 r = idx[i];
    const float4 v = g[i];
    add_row(r.x, v.x, sum, cnt);
    add_row(r.y, v.y, sum, cnt);
    add_row(r.z, v.z, sum, cnt);
    add_row(r.w, v.w, sum, cnt);
  }
  __syncthreads();

  // this block's partial: the warp histograms summed in warp order
  uint4 all = ordered_sum<false>(hist, kWarps, share);
  unsigned* counter = reinterpret_cast<unsigned*>(work + static_cast<int64_t>(kMaxBlocks) * kChunks);
  if (gridDim.x > 1) {
    if (threadIdx.x < kChunks) work[static_cast<int64_t>(blockIdx.x) * kChunks + threadIdx.x] = all;
    // the barrier orders the partial's stores before thread 0's release;
    // the last block's acquire, and its barrier, order them before its loads
    __syncthreads();
    if (threadIdx.x == 0) {
      cuda::atomic_ref<unsigned, cuda::thread_scope_device> arrived(*counter);
      last = arrived.fetch_add(1u, cuda::memory_order_acq_rel) == gridDim.x - 1;
    }
    __syncthreads();
    if (!last) return;
    // the partials summed in block order
    all = ordered_sum<true>(work, static_cast<int>(gridDim.x), share);
  }
  if (threadIdx.x < kChunks) total[threadIdx.x] = all;
  // the weights staged once: a warp's reads of w at 32 column indices
  // would serialise in the constant cache on every element of d
  if (threadIdx.x < kMaxCols) {
    col_a[threadIdx.x] = w.a[threadIdx.x];
    col_c[threadIdx.x] = w.c[threadIdx.x];
  }
  __syncthreads();
  const float* row_sum = reinterpret_cast<const float*>(total);
  const uint32_t* row_cnt = reinterpret_cast<const uint32_t*>(total) + kRows;
  for (int e = threadIdx.x; e < rows * cols; e += kScatterBlock) {
    const int r = e / cols, k = e % cols;
    d[e] = col_a[k] * row_sum[r] + col_c[k] * static_cast<float>(row_cnt[r]);
  }
  if (gridDim.x > 1 && threadIdx.x == 0) *counter = 0u;
}

// ---- the elementwise pair ----

// mode 1: f(x) + f'(x) g.  The reverse sweep follows jax.vjp's rules
// (rsqrt'(u) = -0.5 rsqrt(u) / u, taken as -0.5 s^3; tanh' = 1 - tanh^2;
// (a / b)' = 1 / b and -a / b^2, with one reciprocal of b).  rsqrt is
// 1.0f / sqrtf(u), two correctly rounded operations, not rsqrtf, whose
// result may be 2 ulp off: the plain version's torch.rsqrt rounds
// correctly.
__device__ __forceinline__ float p4(float v, float gv) {
  const float u = fmaf(v, v, 1.0f);
  const float s = 1.0f / sqrtf(u);
  const float y = v * s;
  float z, dz_dy;
  if (v > 0.0f) {
    z = y * y;
    dz_dy = y + y;
  } else {
    z = expf(-y);
    dz_dy = -z;
  }
  const float th = tanhf(z);
  const float rw = 1.0f / (z + 2.0f);
  const float q = y * rw;
  const float f = th + q;
  // reverse sweep with the cotangent gv
  const float g_w = -(gv * q) * rw;
  const float g_z = fmaf(gv, fmaf(-th, th, 1.0f), g_w);
  const float g_y = fmaf(g_z, dz_dy, gv * rw);
  const float g_u = (g_y * v) * ((-0.5f * s) * (s * s));
  const float g_x = fmaf(g_y, s, g_u * (v + v));
  return f + g_x;
}

__device__ __forceinline__ float4 p4(float4 v, float4 gv) {
  return make_float4(p4(v.x, gv.x), p4(v.y, gv.y), p4(v.z, gv.z), p4(v.w, gv.w));
}

// mode 0: out = 2 x (p2).  mode 1: out = f(x) + f'(x) g (p4); g may be x,
// which is then read once.  One float4 a thread: at these sizes more work a
// thread measured slower (fewer threads in flight).
template <int kMode>
__global__ void __launch_bounds__(kBlock)
probe_elementwise_kernel(const float4* __restrict__ x, const float4* __restrict__ g, int64_t n4,
                         float4* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
  if (i >= n4) return;
  const float4 v = x[i];
  if (kMode == 0) out[i] = make_float4(v.x * 2.0f, v.y * 2.0f, v.z * 2.0f, v.w * 2.0f);
  else out[i] = p4(v, g == x ? v : g[i]);
}

unsigned blocks_for(int64_t n, int64_t per_block) {
  return static_cast<unsigned>((n + per_block - 1) / per_block);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0u; }

// The SMs of the current device, asked once per device: the gather's grid
// is at most kGatherBlocksPerSm blocks a SM; the scatter's at most one
// block of kScatterBlock threads a SM (a second block per SM doubles the
// partials the last block sums and measured slower), and at most
// kMaxBlocks.
cudaError_t sm_count(unsigned* sms) {
  constexpr int kMaxDevices = 64;
  static unsigned counts[kMaxDevices];   // 0 until first asked; a race writes the same value
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (counts[dev] == 0u) {
    int n = 0;
    err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    counts[dev] = static_cast<unsigned>(n);
  }
  *sms = counts[dev];
  return cudaSuccess;
}

}  // namespace

// C entry points, bound with ctypes by tpt_torch/kernels/_build.py.  Device
// buffers unless said otherwise; each but tpt_probe_scatter_layout launches
// one kernel on `stream` and returns cudaGetLastError()
// (cudaErrorInvalidValue for arguments it refuses, without launching).

// out f32[n] = table[idx[b] * cols + col] for the table f32[128, cols]; n a
// multiple of 4, idx and out 16-byte aligned.
extern "C" int tpt_probe_gather(const int32_t* idx, const float* table, int cols, int col,
                                int64_t n, float* out, void* stream) {
  if (cols <= 0 || cols > kMaxCols || col < 0 || col >= cols || n <= 0 || n % 4 != 0 ||
      !aligned16(idx) || !aligned16(out))
    return static_cast<int>(cudaErrorInvalidValue);
  unsigned sms = 0u;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n4 = n / 4;
  const unsigned want = blocks_for(n4, kBlock), cap = sms * kGatherBlocksPerSm;
  probe_gather_kernel<<<want < cap ? want : cap, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const int4*>(idx), table, cols, col, n4, reinterpret_cast<float4*>(out));
  return static_cast<int>(cudaGetLastError());
}

// The scatter's layout, which this file alone owns: the words of its
// workspace and the bytes of a ColWeights (host memory).
extern "C" int tpt_probe_scatter_layout(int64_t* workspace_words, int64_t* weights_bytes) {
  *workspace_words = kWorkspaceWords;
  *weights_bytes = static_cast<int64_t>(sizeof(ColWeights));
  return static_cast<int>(cudaSuccess);
}

// d f32[rows, cols] from the elements [first, n) of idx and g (first and n
// multiples of 4, idx and g 16-byte aligned); w: the column weights in host
// memory, copied into the launch; work: the (device, stream)'s workspace,
// kWorkspaceWords 32-bit words (16-byte aligned) whose last word is 0.
extern "C" int tpt_probe_scatter(const int32_t* idx, const float* g, int64_t first, int64_t n,
                                 const ColWeights* w, int rows, int cols, uint32_t* work,
                                 float* d, void* stream) {
  if (w == nullptr || rows <= 0 || rows > kRows || cols <= 0 || cols > kMaxCols || first < 0 ||
      first >= n ||
      (first | n) % 4 != 0 || !aligned16(idx) || !aligned16(g) || !aligned16(work))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n4 = (n - first) / 4;
  unsigned sms = 0u;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned cap = sms < static_cast<unsigned>(kMaxBlocks) ? sms : kMaxBlocks;
  const unsigned want = blocks_for(n4, kScatterBlock);   // at least one float4 a thread
  probe_scatter_kernel<<<want < cap ? want : cap, kScatterBlock, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const int4*>(idx + first), reinterpret_cast<const float4*>(g + first),
      n4, *w, rows, cols, reinterpret_cast<uint4*>(work), d);
  return static_cast<int>(cudaGetLastError());
}

// out f32[n]: 2 x (mode 0) or f(x) + f'(x) g (mode 1); n a multiple of 4,
// x, g and out 16-byte aligned.
extern "C" int tpt_probe_elementwise(const float* x, const float* g, int64_t n, int mode,
                                     float* out, void* stream) {
  if (n <= 0 || n % 4 != 0 || mode < 0 || mode > 1 || !aligned16(x) || !aligned16(g) ||
      !aligned16(out))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n4 = n / 4;
  const unsigned blocks = blocks_for(n4, kBlock);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* x4 = reinterpret_cast<const float4*>(x);
  const auto* g4 = reinterpret_cast<const float4*>(g);
  auto* out4 = reinterpret_cast<float4*>(out);
  if (mode == 0) probe_elementwise_kernel<0><<<blocks, kBlock, 0, s>>>(x4, g4, n4, out4);
  else probe_elementwise_kernel<1><<<blocks, kBlock, 0, s>>>(x4, g4, n4, out4);
  return static_cast<int>(cudaGetLastError());
}

// Kernels of the backward-design probes for NVIDIA Hopper (sm_90a).
//
// Replace the nine Pallas probes of benchmarks/exp_bwd_probes.py, which
// asked what Mosaic could lower for the one-hot backward kernel.  Their
// inputs are the harness's: idx i32[N, 128] of winner rows in [0, 55),
// table f32[128, 32], g f32[N, 128], N = GRID * 16.  Three kernels serve
// them, one thread per element, simple first:
//
//   * probe_gather_kernel, p1 (exp_bwd_probes.py:46-54) and p3 (:82-91):
//     out[b] = table[idx[b], col].  The TPU took the row with a one-hot
//     [B, 128] x [128, 32] product because it has no per-lane gather; here
//     each block stages the table's column in shared memory (512 bytes) and
//     each thread reads its row by index.  An index outside the table gives
//     0, the one-hot product's value.
//   * probe_scatter_kernel, p1t (:57-70), p5 (:109-121), p6 (:126-144),
//     p7 (:148-165) and p8 (:168-185): the transposes of the gather,
//     d[r, k] = a_k * sum_{b in window, idx[b] = r} g[b]
//             + c_k * #{b in window: idx[b] = r},
//     with column weights a, c from the probe and the window every element
//     (p5: the last 16 x 128 tile, the one whose sums its SMEM output keeps).
//     A grid-stride loop over at most kMaxBlocks blocks sums each block's
//     elements into shared-memory rows; each block then sends one global
//     atomic per non-zero row (as trace_grad.cu does for its table) into a
//     zeroed scratch of row sums and counts, and the last block to finish
//     expands the scratch into d.  Counts are float sums of ones, exact below
//     2^24 per row.
//   * probe_elementwise_kernel, p2 (:73-79): 2x; and p4 (:94-106):
//     f(x) + f'(x) g with y = x rsqrt(x^2 + 1), z = x > 0 ? y^2 : exp(-y),
//     f = tanh(z) + y / (z + 2), its reverse mode written out by hand (CUDA
//     has no autodiff).
//
// What bounds them on this card: bytes.  Each reads 8 bytes an element
// (idx and g, or x alone when g is x) and writes 4 (the gather and the
// elementwise) or a 16 KB table (the scatter); p4's ~40 operations an
// element are far below the card's 67 TFLOP/s fp32 at 3.35 TB/s.  At the
// harness's GRID = 100 (204,800 elements, ~1.6 MB) the bound is ~0.5 us,
// so the launch sets their time.
//
// Built with the flags of the trace kernels (-fmad=false, IEEE division
// and sqrt): the sums differ from the plain versions only by the order of
// the float atomics.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;
constexpr int kRows = 128;       // the table's rows: the one-hot width R
constexpr int kMaxCols = 32;     // the table's columns K
constexpr int kMaxBlocks = 264;  // two blocks per SM of a 132-SM H100

__global__ void __launch_bounds__(kBlock)
probe_gather_kernel(const int32_t* __restrict__ idx, const float* __restrict__ table, int cols,
                    int col, int64_t n, float* __restrict__ out) {
  __shared__ float column[kRows];
  for (int r = threadIdx.x; r < kRows; r += blockDim.x) column[r] = table[r * cols + col];
  __syncthreads();
  const int64_t b = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= n) return;
  const int r = idx[b];
  out[b] = (r >= 0 && r < kRows) ? column[r] : 0.0f;
}

struct ColWeights {
  float a[kMaxCols];
  float c[kMaxCols];
};

// scratch: f32[2 * kRows] of row sums and counts, then one u32 block
// counter, all zero on entry.
__global__ void __launch_bounds__(kBlock)
probe_scatter_kernel(const int32_t* __restrict__ idx, const float* __restrict__ g, int64_t first,
                     int64_t n, ColWeights w, int rows, int cols, float* __restrict__ scratch,
                     float* __restrict__ d) {
  __shared__ float sum[kRows];
  __shared__ float cnt[kRows];
  __shared__ bool last;
  for (int r = threadIdx.x; r < kRows; r += blockDim.x) {
    sum[r] = 0.0f;
    cnt[r] = 0.0f;
  }
  __syncthreads();
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t b = first + static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; b < n;
       b += stride) {
    const int r = idx[b];
    if (r >= 0 && r < kRows) {
      atomicAdd(&sum[r], g[b]);
      atomicAdd(&cnt[r], 1.0f);
    }
  }
  __syncthreads();
  for (int r = threadIdx.x; r < kRows; r += blockDim.x) {
    if (cnt[r] != 0.0f) {
      atomicAdd(&scratch[r], sum[r]);
      atomicAdd(&scratch[kRows + r], cnt[r]);
    }
  }
  // the last block to arrive sees every block's atomics (threadFenceReduction)
  __threadfence();
  __syncthreads();
  unsigned* done = reinterpret_cast<unsigned*>(scratch + 2 * kRows);
  if (threadIdx.x == 0) last = atomicAdd(done, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int e = threadIdx.x; e < rows * cols; e += blockDim.x) {
    const int r = e / cols, k = e % cols;
    d[e] = w.a[k] * __ldcg(&scratch[r]) + w.c[k] * __ldcg(&scratch[kRows + r]);
  }
}

// mode 0: out = 2 x (p2).  mode 1: out = f(x) + f'(x) g (p4).  The reverse
// sweep follows jax.vjp's rules (rsqrt' = -0.5 rsqrt(u) / u, tanh' = 1 -
// tanh^2, (a / b)' = 1 / b and -a / b^2).  rsqrt is 1.0f / sqrtf(u), two
// correctly rounded operations, not rsqrtf, whose result may be 2 ulp off:
// the plain version's torch.rsqrt rounds correctly on the CPU, and the p4
// bar (rtol 1e-5) should hold against libm's tanh and exp alone.
__global__ void __launch_bounds__(kBlock)
probe_elementwise_kernel(const float* __restrict__ x, const float* __restrict__ g, int64_t n,
                         int mode, float* __restrict__ out) {
  const int64_t b = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= n) return;
  const float v = x[b];
  if (mode == 0) {
    out[b] = v * 2.0f;
    return;
  }
  const float u = v * v + 1.0f;
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
  const float wz = z + 2.0f;
  const float f = th + y / wz;
  // reverse sweep with the cotangent gv
  const float gv = g[b];
  const float g_w = -gv * y / (wz * wz);
  const float g_z = gv * (1.0f - th * th) + g_w;
  const float g_y = gv / wz + g_z * dz_dy;
  const float g_s = g_y * v;
  const float g_u = g_s * (-0.5f * (s / u));
  const float g_x = g_y * s + g_u * (v + v);
  out[b] = f + g_x;
}

unsigned blocks_for(int64_t n) { return static_cast<unsigned>((n + kBlock - 1) / kBlock); }

}  // namespace

// C entry points, bound with ctypes by tpt_torch/kernels/_build.py.  Device
// buffers unless named host; each launches on `stream` and returns
// cudaGetLastError().

// out f32[n] = table[idx[b] * cols + col] for the table f32[128, cols].
extern "C" int tpt_probe_gather(const int32_t* idx, const float* table, int cols, int col,
                                int64_t n, float* out, void* stream) {
  if (cols <= 0 || cols > kMaxCols || col < 0 || col >= cols || n <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  probe_gather_kernel<<<blocks_for(n), kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      idx, table, cols, col, n, out);
  return static_cast<int>(cudaGetLastError());
}

// d f32[rows, cols] from the elements [first, n) of idx and g; a_host,
// c_host: the cols column weights in host memory; scratch: 2 * 128 + 1
// zeroed 32-bit words.
extern "C" int tpt_probe_scatter(const int32_t* idx, const float* g, int64_t first, int64_t n,
                                 const float* a_host, const float* c_host, int rows, int cols,
                                 float* scratch, float* d, void* stream) {
  if (rows <= 0 || rows > kRows || cols <= 0 || cols > kMaxCols || first < 0 || first >= n)
    return static_cast<int>(cudaErrorInvalidValue);
  ColWeights w{};
  for (int k = 0; k < cols; ++k) {
    w.a[k] = a_host[k];
    w.c[k] = c_host[k];
  }
  const unsigned want = blocks_for(n - first), cap = static_cast<unsigned>(kMaxBlocks);
  const unsigned blocks = want < cap ? want : cap;
  probe_scatter_kernel<<<blocks, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      idx, g, first, n, w, rows, cols, scratch, d);
  return static_cast<int>(cudaGetLastError());
}

// out f32[n]: 2 x (mode 0) or f(x) + f'(x) g (mode 1).
extern "C" int tpt_probe_elementwise(const float* x, const float* g, int64_t n, int mode,
                                     float* out, void* stream) {
  if (n <= 0 || mode < 0 || mode > 1) return static_cast<int>(cudaErrorInvalidValue);
  probe_elementwise_kernel<<<blocks_for(n), kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      x, g, n, mode, out);
  return static_cast<int>(cudaGetLastError());
}

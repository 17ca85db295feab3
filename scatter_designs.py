"""Time the scatter probe's kernel against the designs it was chosen over,
on one CUDA card.

    python3 scatter_designs.py

Builds one CUDA library from a source that includes
tpt_torch/csrc/probes.cu, so the kept kernel is the port's own, and adds
the alternative; then, on p1t's inputs at the probes' GRID 100 and 1013
(``tpt_torch.bwd_probes.make_inputs``), runs:

  * ``warp atomics, 1 block/SM``: probe_scatter_kernel as the port
    launches it (a 128-row histogram per warp, filled by shared-memory
    atomics; at most one 1024-thread block per SM);
  * ``warp atomics, 2 blocks/SM``: the same kernel over up to twice that
    grid, so the last block merges up to twice the partials;
  * ``match_any, 1 block/SM``: the same kernel with equal rows aggregated
    in each warp by __match_any_sync and shuffles in lane order, and no
    atomic: two calls give the same bits by construction.

Each design is held against p1t's plain version at p1t's bar, called twice
to see whether the bits repeat, and timed by torch.profiler (mean device
time of 20 launches after one warm-up, inputs warm in the L2).  Prints one
line per design and grid, then one JSON line; exits non-zero without a
card or if a design misses the bar.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import tempfile

import torch

HERE = os.path.dirname(os.path.abspath(__file__))

SOURCE = r"""
#include "PROBES_CU"

namespace {

// One element per lane: the lanes that hold row r (peers) sum their values
// in lane order; the lowest of them alone adds the sum and the count to
// the warp's histogram.  __syncwarp orders these plain stores before the
// next element's, whose leader for a row may be another lane.
__device__ __forceinline__ void add_group(int r, float v, int lane, float* sum, uint32_t* cnt) {
  const unsigned peers = __match_any_sync(0xffffffffu, r);
  float s = 0.0f;
  for (unsigned m = peers; m != 0u; m &= m - 1u) s += __shfl_sync(peers, v, __ffs(m) - 1);
  if (r >= 0 && r < kRows && lane == __ffs(peers) - 1) {
    sum[r] += s;
    cnt[r] += static_cast<uint32_t>(__popc(peers));
  }
  __syncwarp();
}

// probe_scatter_kernel for p1t (d[r, k] = the sum of row r) with add_group
// in place of the atomics; the merge is the same.
__global__ void __launch_bounds__(kScatterBlock, 1)
match_any_kernel(const int4* __restrict__ idx, const float4* __restrict__ g, int64_t n4,
                 uint4* __restrict__ work, float* __restrict__ d) {
  __shared__ uint4 hist[kWarps * kChunks];
  __shared__ uint4 share[kParts * kChunks];
  __shared__ uint4 total[kChunks];
  __shared__ bool last;
  for (int e = threadIdx.x; e < kWarps * kChunks; e += kScatterBlock)
    hist[e] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();

  uint32_t* mine = reinterpret_cast<uint32_t*>(hist + threadIdx.x / 32 * kChunks);
  float* sum = reinterpret_cast<float*>(mine);
  uint32_t* cnt = mine + kRows;
  const int lane = threadIdx.x % 32;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kScatterBlock;
  // the warp's lanes take the same trips: __match_any_sync needs them all
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * kScatterBlock + threadIdx.x - lane;
       base < n4; base += stride) {
    const int64_t i = base + lane;
    const int4 r = i < n4 ? idx[i] : make_int4(-1, -1, -1, -1);
    const float4 v = i < n4 ? g[i] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    add_group(r.x, v.x, lane, sum, cnt);
    add_group(r.y, v.y, lane, sum, cnt);
    add_group(r.z, v.z, lane, sum, cnt);
    add_group(r.w, v.w, lane, sum, cnt);
  }
  __syncthreads();

  uint4 all = ordered_sum<false>(hist, kWarps, share);
  unsigned* counter = reinterpret_cast<unsigned*>(work + static_cast<int64_t>(kMaxBlocks) * kChunks);
  if (gridDim.x > 1) {
    if (threadIdx.x < kChunks) work[static_cast<int64_t>(blockIdx.x) * kChunks + threadIdx.x] = all;
    __syncthreads();
    if (threadIdx.x == 0) {
      cuda::atomic_ref<unsigned, cuda::thread_scope_device> arrived(*counter);
      last = arrived.fetch_add(1u, cuda::memory_order_acq_rel) == gridDim.x - 1;
    }
    __syncthreads();
    if (!last) return;
    all = ordered_sum<true>(work, static_cast<int>(gridDim.x), share);
  }
  if (threadIdx.x < kChunks) total[threadIdx.x] = all;
  __syncthreads();
  const float* row_sum = reinterpret_cast<const float*>(total);
  for (int e = threadIdx.x; e < kRows * kMaxCols; e += kScatterBlock) d[e] = row_sum[e / kMaxCols];
  if (gridDim.x > 1 && threadIdx.x == 0) *counter = 0u;
}

}  // namespace

// p1t's d f32[128, 32] from idx, g (n elements, a multiple of 4, 16-byte
// aligned) by design 0 (probe_scatter_kernel) or 1 (match_any_kernel) over
// `blocks` blocks; work: a workspace as tpt_probe_scatter_layout gives it.
extern "C" int scatter_design(int design, const int32_t* idx, const float* g, int64_t n,
                              unsigned blocks, uint32_t* work, float* d, void* stream) {
  if (design < 0 || design > 1 || n <= 0 || n % 4 != 0 || blocks == 0u ||
      blocks > static_cast<unsigned>(kMaxBlocks) || !aligned16(idx) || !aligned16(g) ||
      !aligned16(work))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* idx4 = reinterpret_cast<const int4*>(idx);
  const auto* g4 = reinterpret_cast<const float4*>(g);
  auto* work4 = reinterpret_cast<uint4*>(work);
  if (design == 0) {
    ColWeights w{};
    for (int k = 0; k < kMaxCols; ++k) w.a[k] = 1.0f;
    probe_scatter_kernel<<<blocks, kScatterBlock, 0, s>>>(idx4, g4, n / 4, w, kRows, kMaxCols,
                                                          work4, d);
  } else {
    match_any_kernel<<<blocks, kScatterBlock, 0, s>>>(idx4, g4, n / 4, work4, d);
  }
  return static_cast<int>(cudaGetLastError());
}
"""

# (label, design, blocks per SM, the kernel's name in the profiler)
DESIGNS = (("warp atomics, 1 block/SM", 0, 1, "probe_scatter_kernel"),
           ("warp atomics, 2 blocks/SM", 0, 2, "probe_scatter_kernel"),
           ("match_any, 1 block/SM", 1, 1, "match_any_kernel"))


def build(tmp: str):
    """The library's ctypes handle, built by nvcc with the port's flags."""
    from tpt_torch.kernels import _build
    src, lib = os.path.join(tmp, "scatter_designs.cu"), os.path.join(tmp, "libscatter_designs.so")
    with open(src, "w") as f:
        f.write(SOURCE.replace("PROBES_CU", str(_build.SRC_DIR / "probes.cu")))
    proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", lib, src],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
    handle = ctypes.CDLL(lib)
    handle.scatter_design.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                                      ctypes.c_int64, ctypes.c_uint, ctypes.c_void_p,
                                      ctypes.c_void_p, ctypes.c_void_p]
    handle.scatter_design.restype = ctypes.c_int
    handle.tpt_probe_scatter_layout.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    handle.tpt_probe_scatter_layout.restype = ctypes.c_int
    return handle


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("scatter_designs: no CUDA device")
    sys.path.insert(0, HERE)
    import chip_smoke
    from tpt_torch.bwd_probes import make_inputs
    from tpt_torch.kernels import probes as P

    card = chip_smoke.gpu_name_and_power()
    print(card, flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    results = []
    with tempfile.TemporaryDirectory() as tmp:
        lib = build(tmp)
        words, weights_bytes = ctypes.c_int64(), ctypes.c_int64()
        lib.tpt_probe_scatter_layout(ctypes.byref(words), ctypes.byref(weights_bytes))
        work = torch.zeros(words.value, dtype=torch.int32, device="cuda")
        for grid in chip_smoke.PROBE_GRIDS:
            idx, table, g = make_inputs(grid, "cuda")
            want = P.p1t_plain(idx, table, g)
            n = g.numel()
            for label, design, per_sm, kernel in DESIGNS:
                # at least one float4 a thread, as the port launches it
                blocks = min(sms * per_sm, -(-n // (4 * 1024)))

                def call():
                    d = torch.empty_like(want)
                    err = lib.scatter_design(design, idx.data_ptr(), g.data_ptr(), n, blocks,
                                             work.data_ptr(), d.data_ptr(), stream)
                    if err != 0:
                        raise RuntimeError(f"scatter_design {label}: CUDA error {err}")
                    return d

                first, second = call(), call()
                torch.cuda.synchronize()
                err = max(chip_smoke.check_probe("p1t", first, want),
                          chip_smoke.check_probe("p1t", second, want))
                same = torch.equal(first.view(torch.int32), second.view(torch.int32))
                dev_ms = chip_smoke.device_profile(call, kernel, reps=20)
                results.append({"grid": grid, "design": label, "blocks": blocks,
                                "device_ms": dev_ms, "max_abs_err": err, "repeat_bit_equal": same})
                shown = "not measured" if dev_ms is None else f"{dev_ms * 1e3:.2f} us"
                print(f"[scatter] GRID {grid}, {n} elements, {label}: {blocks} blocks, {shown} in "
                      f"the kernel (torch.profiler), max abs err {err:.3g}, a second call "
                      f"bit-equal: {same} ({card})", flush=True)
    print(json.dumps({"card": card, "designs": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

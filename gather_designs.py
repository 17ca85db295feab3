"""Time the gather probe's kernel against the designs it was chosen over,
on one CUDA card.

    python3 gather_designs.py

Builds one CUDA library from a source that includes
tpt_torch/csrc/probes.cu, so the kept kernel is the port's own, and adds
the alternatives; then, on p1's inputs at the probes' GRID 100 and 1013
(``tpt_torch.bwd_probes.make_inputs``), runs:

  * ``staged, strided``: probe_gather_kernel as the port launches it (the
    table's column staged in shared memory once per block, int4 loads and
    float4 stores over a grid of at most 8 blocks per SM);
  * ``staged, one int4 a thread``: the same kernel over a grid of one int4
    a thread (no stride, no prefetch, the staging in every block);
  * ``read-only cache``: the column read through __ldg, no staging and no
    barrier, one int4 a thread;
  * ``one element a thread``: the form of the kernel before its redesign
    (4-byte loads and stores, the column staged in every 256-thread block).

Each design is held against p1's plain version exactly and timed by
torch.profiler: the mean device time of 20 launches after one warm-up
with the inputs warm in the L2, and with a cold L2
(``chip_smoke.cold_device_ms``: the calls rotate through input copies four
times the L2), which is the one to hold against the bytes bound.  Prints
one line per design and grid, then one JSON line; exits non-zero without a
card or if a design is not exact.
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

// The column through the read-only cache: no staging, no barrier.
__global__ void __launch_bounds__(kBlock)
gather_ldg_kernel(const int4* __restrict__ idx4, const float* __restrict__ table, int cols,
                  int col, int64_t n4, float4* __restrict__ out4) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
  if (i >= n4) return;
  const int4 r = __ldg(idx4 + i);
  const float* c = table + col;
  auto at = [&](int row) { return (row >= 0 && row < kRows) ? __ldg(c + row * cols) : 0.0f; };
  out4[i] = make_float4(at(r.x), at(r.y), at(r.z), at(r.w));
}

// One element a thread, the column staged in every block.
__global__ void __launch_bounds__(kBlock)
gather_scalar_kernel(const int32_t* __restrict__ idx, const float* __restrict__ table, int cols,
                     int col, int64_t n, float* __restrict__ out) {
  __shared__ float column[kRows];
  for (int r = threadIdx.x; r < kRows; r += blockDim.x) column[r] = table[r * cols + col];
  __syncthreads();
  const int64_t b = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= n) return;
  out[b] = lookup(column, idx[b]);
}

}  // namespace

// out f32[n] = table[idx[b] * cols + col] by design 1 (gather_ldg_kernel),
// 2 (gather_scalar_kernel) or 3 (probe_gather_kernel over one int4 a
// thread); design 0 is the port's entry, tpt_probe_gather.
extern "C" int gather_design(int design, const int32_t* idx, const float* table, int cols,
                             int col, int64_t n, float* out, void* stream) {
  if (design == 0) return tpt_probe_gather(idx, table, cols, col, n, out, stream);
  if (design < 0 || design > 3 || n <= 0 || n % 4 != 0 || !aligned16(idx) || !aligned16(out))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  if (design == 1)
    gather_ldg_kernel<<<blocks_for(n / 4, kBlock), kBlock, 0, s>>>(
        reinterpret_cast<const int4*>(idx), table, cols, col, n / 4,
        reinterpret_cast<float4*>(out));
  else if (design == 2)
    gather_scalar_kernel<<<blocks_for(n, kBlock), kBlock, 0, s>>>(idx, table, cols, col, n, out);
  else
    probe_gather_kernel<<<blocks_for(n / 4, kBlock), kBlock, 0, s>>>(
        reinterpret_cast<const int4*>(idx), table, cols, col, n / 4,
        reinterpret_cast<float4*>(out));
  return static_cast<int>(cudaGetLastError());
}
"""

# (label, design, the kernel's name in the profiler)
DESIGNS = (("staged, strided", 0, "probe_gather_kernel"),
           ("staged, one int4 a thread", 3, "probe_gather_kernel"),
           ("read-only cache", 1, "gather_ldg_kernel"),
           ("one element a thread", 2, "gather_scalar_kernel"))


def build(tmp: str):
    """The library's ctypes handle, built by nvcc with the port's flags."""
    from tpt_torch.kernels import _build
    src, lib = os.path.join(tmp, "gather_designs.cu"), os.path.join(tmp, "libgather_designs.so")
    with open(src, "w") as f:
        f.write(SOURCE.replace("PROBES_CU", str(_build.SRC_DIR / "probes.cu")))
    proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", lib, src],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
    handle = ctypes.CDLL(lib)
    handle.gather_design.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_int64, ctypes.c_void_p,
                                     ctypes.c_void_p]
    handle.gather_design.restype = ctypes.c_int
    return handle


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("gather_designs: no CUDA device")
    sys.path.insert(0, HERE)
    import chip_smoke
    from tpt_torch.bwd_probes import make_inputs
    from tpt_torch.kernels import probes as P

    card = chip_smoke.gpu_name_and_power()
    print(card, flush=True)
    stream = torch.cuda.current_stream().cuda_stream
    results = []
    us = lambda v: "not measured" if v is None else f"{v * 1e3:.2f} us"
    with tempfile.TemporaryDirectory() as tmp:
        lib = build(tmp)
        for grid in chip_smoke.PROBE_GRIDS:
            inputs = make_inputs(grid, "cuda")
            want = P.p1_plain(*inputs)
            n = want.numel()
            b_ms, _ = chip_smoke.probe_bound("p1", n, *want.shape)
            for label, design, kernel in DESIGNS:

                def call(idx, table, g, design=design, label=label):
                    out = torch.empty_like(g)
                    err = lib.gather_design(design, idx.data_ptr(), table.data_ptr(), P.K, 0,
                                            g.numel(), out.data_ptr(), stream)
                    if err != 0:
                        raise RuntimeError(f"gather_design {label}: CUDA error {err}")
                    return out

                got = call(*inputs)
                torch.cuda.synchronize()
                err = chip_smoke.check_probe("p1", got, want)
                warm = chip_smoke.device_profile(lambda: call(*inputs), kernel, reps=20)
                cold = chip_smoke.cold_device_ms(call, inputs, kernel)
                results.append({"grid": grid, "design": label, "device_ms": warm,
                                "device_cold_ms": cold, "bound_ms": b_ms, "max_abs_err": err})
                share = "not measured" if cold is None else f"{b_ms / cold:.0%} of the bound"
                print(f"[gather] GRID {grid}, {n} elements, {label}: {us(warm)} warm, "
                      f"{us(cold)} with a cold L2 ({share}; bound {b_ms * 1e3:.2f} us, bytes) "
                      f"in the kernel (torch.profiler), max abs err {err:.3g} ({card})",
                      flush=True)
    print(json.dumps({"card": card, "designs": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

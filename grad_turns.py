"""Measure the backward kernels of one or two checkouts of the port in turns
on one CUDA card, with this checkout's measurement code.

    python3 grad_turns.py [OTHER_CHECKOUT]

Each turn runs in a fresh process with ``tpt_torch`` imported from one
checkout, which builds its own kernels into its own tpt_torch/_build
(``probe_turns.run_turns``).  The turns are this, this; with
OTHER_CHECKOUT, one turn of it first and one last.  A turn reports:

  * for every ``__global__`` kernel of the checkout's csrc/trace_grad*.cu:
    ptxas's registers, spill stores and loads and stack frame
    (``chip_smoke.ptxas_report`` of the builds' logs), and the blocks per
    SM that cudaOccupancyMaxActiveBlocksPerMultiprocessor gives at the
    kernel's launch bound (``chip_smoke.grad_blocks_per_sm``);
  * ``trace_grad`` at the 1080p train_bench launch (1920x1080, depth 13,
    1 spp, Russian roulette, frame 0) and at the inverse demo's two 512^2
    launches (depth 8, rr off): the call's time by CUDA events, and each
    backward kernel's mean device time by torch.profiler; at the default
    view's 512^2 launch also the worst error over its scale against
    ``trace_grad_plain`` and the groups beyond chip_smoke.py's bars, and
    the host time a call (chip_smoke.host_ms: 200 calls, no synchronise);
  * ``python -m tpt_torch.inverse_demo`` for 40 steps at 512^2: its wall
    time (the PNGs included) and the caching allocator's cudaMalloc calls
    and retries during it (torch.cuda.memory_stats).

The turns of this checkout also report the lane efficiency of a
one-thread-per-pixel reverse sweep at each launch
(``tpt_torch.kernels.trace_grad.lane_efficiency`` of the forward kernel's
ray counts; it depends on the data only).  Each turn prints one JSON line
{"turn", "checkout", "card", "kernels", "launches", "inverse_demo_40_steps"}.
Both checkouts need ``tpt_torch.kernels.trace_grad.libraries``.  Exits
non-zero if a turn fails.
"""

from __future__ import annotations

import argparse
import os
import sys

from probe_turns import HERE, other_checkout, run_turns

TURN = r'''
import importlib.util, json, os, sys, tempfile, time
import torch
sys.path.insert(0, {root!r})
spec = importlib.util.spec_from_file_location("chip_smoke", {smoke!r})
smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(smoke)
import tpt_torch
assert tpt_torch.__file__.startswith({root!r}), tpt_torch.__file__
from tpt_torch import CameraConfig, demo_scene
from tpt_torch.camera import camera_matrices
from tpt_torch.integrator import build_attr_table
from tpt_torch.inverse_demo import GRID_CAM, RAY_DEPTH
from tpt_torch.kernels import trace as K
from tpt_torch.kernels import trace_grad as G

def kernel_reports():
    """{{kernel: {{"ptxas": its report, "blocks_per_sm"}}}} for the backward's kernels."""
    per_sm = smoke.grad_blocks_per_sm()
    occ = {{"trace_grad_tape_kernel": per_sm["tape"],
           "trace_grad_adjoint_kernel": per_sm["adjoint"]}}
    return {{k: {{"ptxas": v, "blocks_per_sm": occ[k.split("<")[0]]}}
            for lib in G.libraries() for k, v in smoke.ptxas_report(lib.log).items()
            if k.split("<")[0] in occ}}

dev = torch.device("cuda")
card = smoke.gpu_name_and_power()
scene = demo_scene().build(dev)
counts = scene.counts
table = build_attr_table(scene, counts)
cam = CameraConfig()
launches = {{}}
for label, c, w, h, depth, rr in (("1080p train_bench", cam, 1920, 1080, 13, True),
                                  ("512^2 demo grid view", GRID_CAM, 512, 512, RAY_DEPTH, False),
                                  ("512^2 demo default view", cam, 512, 512, RAY_DEPTH, False)):
    ip, iv, _ = camera_matrices(c, w, h)
    cam20 = G.camera_vector(ip, iv, c.focal_length, c.aperture_diameter, device=dev)
    gen = torch.Generator(device=dev).manual_seed(7)
    cots = [torch.randn(s, generator=gen, device=dev) for s in ((3, h, w), (1, 3, h, w), (1, 3, h, w))]
    kw = dict(width=w, height=h, ray_depth=depth, spp=1, counts=counts, rr=rr)
    run = lambda: G.trace_grad(scene, table, cam20, 0, *cots, **kw)
    rec = {{"ms": smoke.cuda_ms(run, 5 if w == 1920 else 20)}}
    ops, mine = smoke.profiled(lambda: [run() for _ in range(5)], "trace_grad", 5)
    names = sorted({{e.name for e in mine}})
    rec["kernels_ms"] = {{n: smoke.mean_ms([e for e in mine if e.name == n]) for n in names}}
    if label == "512^2 demo default view":
        got, want = run(), G.trace_grad_plain(scene, table, cam20, 0, *cots, **kw)
        errs, floors, bad = smoke.compare_grads(got, want, counts)
        rec["worst_err_over_scale"] = max(
            e / max(big, floors["camera" if k in smoke.CAM_LEAVES else "table"], 1e-30)
            for k, (e, big) in errs.items())
        rec["beyond_bars"] = bad
        rec["host_ms"] = smoke.host_ms(run)
    if {this!r}:
        rays = K.trace(scene, ip, iv, 0, c.focal_length, c.aperture_diameter, **kw).ray_count
        rec["segments"] = int(rays.sum())
        rec["lane_efficiency"] = G.lane_efficiency(rays)
    launches[label] = rec

# the inverse demo's first 40 steps: the wall clock, and the allocator's
# calls to cudaMalloc (segments) and its retries after freeing its cache
import contextlib, io
from tpt_torch import inverse_demo
before = torch.cuda.memory_stats(dev)
with tempfile.TemporaryDirectory() as tmp, contextlib.redirect_stdout(io.StringIO()):
    t0 = time.perf_counter()
    assert inverse_demo.main(["--steps", "40", "--size", "512x512", "--device", "cuda",
                              "--out", os.path.join(tmp, "demo.json")]) == 0
    demo_s = time.perf_counter() - t0
after = torch.cuda.memory_stats(dev)
demo = {{"wall_s": demo_s,
        "cuda_mallocs": after["segment.all.allocated"] - before["segment.all.allocated"],
        "alloc_retries": after["num_alloc_retries"] - before["num_alloc_retries"]}}

print(json.dumps({{"turn": {turn}, "checkout": {root!r}, "card": card, "kernels": kernel_reports(),
                  "launches": launches, "inverse_demo_40_steps": demo}}), flush=True)
'''


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", nargs="?", help="root of the other checkout (holding tpt_torch/)")
    args = ap.parse_args(argv)
    roots = [HERE, HERE]
    if args.other is not None:
        other = other_checkout(ap, args.other)
        roots = [other] + roots + [other]
    return run_turns("grad_turns", TURN, roots)


if __name__ == "__main__":
    sys.exit(main())

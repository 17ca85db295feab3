"""Measure the render path's forward kernel of one or two checkouts of the
port in turns on one CUDA card, with this checkout's measurement code.

    python3 render_turns.py [OTHER_CHECKOUT]

Each turn runs in a fresh process with ``tpt_torch`` imported from one
checkout, which builds its own kernels into its own tpt_torch/_build
(``probe_turns.run_turns``).  The turns are this, this; with
OTHER_CHECKOUT, one turn of it first and one last.  A turn reports:

  * the forward kernel's instantiations in the dynamic build and in the
    build for the demo scene's counts (48, 7), which the render path's
    blocks take: ptxas's registers, spill stores and loads, stack frame
    (``chip_smoke.ptxas_report`` of the trace library's kept build log)
    and static shared bytes, and the blocks per SM that the occupancy API
    gives (the layout entry ``tpt_trace_layout``);
  * for the render path's 8-frame block (the offline cell's, ``cli
    render --chunk``'s default) and its 30-frame block
    (``progressive_frames`` with the scene's counts: the demo scene, depth
    13, 1 spp, the 256^2 atmosphere): ms per block by CUDA events over
    several blocks after one, Mrays/s, a block's peak allocation above the
    tensors resident before it; its forward launch alone (the environment
    mode) by CUDA events, with its segments, and the same launch through
    the dynamic build (the environment mode's launches without counts);
    its lane efficiency, the segments over 32 x the warps' loop
    iterations (the kernel's ``warp_iters``, and the per-lane loop's,
    ``tpt_torch.kernels.trace_grad.lane_efficiency`` of the ray counts);
    and, for the 30-frame block, the escapes (``chip_smoke.escaped_samples``
    of the slot mode's launch at the same inputs) and the bound
    (``chip_smoke.trace_bound``);
  * the per-frame launches: the 1080p frame (depth 13, Russian roulette,
    the train_bench step's) and the inverse demo's two 512^2 depth-8
    launches (rr off, its grid and default views): ms by CUDA events, and
    the 1080p frame's lane efficiency.

Both checkouts need ``tpt_torch.kernels._build.library``, which loads one
library per source and counts.

Each turn prints one JSON line {"turn", "checkout", "card", "kernels",
"blocks", "frames"}.  Exits non-zero if a turn fails.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import re
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
WIDTH, HEIGHT, DEPTH, BLOCKS = 1920, 1080, 13, (8, 30)
COUNTS = (48, 7)

TURN = """
import importlib.util, os, sys
sys.path.insert(0, {root!r})
spec = importlib.util.spec_from_file_location(
    "render_turns", os.path.join(os.path.dirname({smoke!r}), "render_turns.py"))
turns = importlib.util.module_from_spec(spec)
spec.loader.exec_module(turns)
turns.turn({root!r}, {turn})
"""


def _load(name: str, path: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def smem_bytes(log: str) -> dict:
    """{kernel: static shared bytes} from nvcc's -Xptxas -v output."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\S*?([a-z_]+_kernel)I((?:L\w\d+E)+)E", line)
        if m:
            args = re.findall(r"L(\w)(\d+)E", m.group(2))
            name = m.group(1) + "<" + ",".join(("false", "true")[int(v)] for _, v in args) + ">"
            continue
        m = re.search(r"(\d+) bytes smem", line)
        if name is not None and m:
            out[name] = int(m.group(1))
    return out


def kernel_reports(smoke, _build, counts=None) -> dict:
    """{instantiation: {"ptxas", "smem_bytes", "blocks_per_sm"}} of the
    forward kernel in the build for ``counts`` (None: the dynamic one)."""
    lib = _build.library("trace.cu", counts)
    report, smem = smoke.ptxas_report(lib.log), smem_bytes(lib.log)
    names = [f"trace_progressive_kernel<{t}>" for t in (
        "false,false,false", "true,false,false", "false,true,false", "false,true,true")]
    per_sm = smoke.trace_blocks_per_sm(lib)
    return {n: {"ptxas": report.get(n), "smem_bytes": smem.get(n), "blocks_per_sm": b}
            for n, b in zip(names, per_sm)}


def turn(root: str, index: int) -> None:
    import torch
    import tpt_torch
    if not tpt_torch.__file__.startswith(root):
        raise RuntimeError(f"tpt_torch imported from {tpt_torch.__file__}, not {root}")
    smoke = _load("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    from tpt_torch import CameraConfig, demo_scene
    from tpt_torch.camera import camera_matrices
    from tpt_torch.config import AtmosphereConfig
    from tpt_torch.env import pack_block_table
    from tpt_torch.inverse_demo import GRID_CAM, RAY_DEPTH
    from tpt_torch.kernels import _build
    from tpt_torch.kernels import trace as K
    from tpt_torch.kernels import trace_grad as G
    from tpt_torch.kernels.render import progressive_frames
    from tpt_torch.progressive import init_accumulator
    from tpt_torch.sky import compute_atmosphere

    dev = torch.device("cuda")
    rec = {"turn": index, "checkout": root, "card": smoke.gpu_name_and_power(),
           "kernels": {"dynamic": kernel_reports(smoke, _build),
                       str(COUNTS): kernel_reports(smoke, _build, COUNTS)}}
    scene = demo_scene().build(dev)
    assert tuple(scene.counts) == COUNTS
    cam = CameraConfig()
    focal, ap = cam.focal_length, cam.aperture_diameter
    table = pack_block_table(compute_atmosphere(AtmosphereConfig(size=256), dev))
    ip, iv, _ = camera_matrices(cam, WIDTH, HEIGHT)

    rec["blocks"] = {}
    for n_frames in BLOCKS:
        out = rec["blocks"][str(n_frames)] = {}
        reps = max(3, 90 // n_frames)
        # the render path's block
        acc = init_accumulator(HEIGHT, WIDTH, dev)

        def block():
            return progressive_frames(acc, scene, table, ip, iv, acc.frame, focal, ap,
                                      width=WIDTH, height=HEIGHT, ray_depth=DEPTH, spp=1,
                                      counts=COUNTS, n_frames=n_frames)[1]

        block()
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        rays = [block() for _ in range(reps)]
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / reps
        segments = sum(int(r) for r in rays)
        out["block"] = {"ms": ms, "mrays_per_s": segments / (ms * reps * 1e-3) / 1e6,
                        "peak_bytes_above_resident":
                            torch.cuda.max_memory_allocated(dev) - resident}
        del acc

        # its forward launch alone, from frame 0
        kw = dict(width=WIDTH, height=HEIGHT, ray_depth=DEPTH, spp=1, n_frames=n_frames,
                  counts=COUNTS)

        def launch():
            return K.trace_progressive(scene, ip, iv, 0, focal, ap, env_table=table, **kw)

        def launch_dynamic():
            return K.trace_progressive(scene, ip, iv, 0, focal, ap, env_table=table,
                                       **dict(kw, counts=None))

        res = launch()
        segments = int(res.ray_count.sum())
        out["kernel"] = {"ms": smoke.cuda_ms(launch, reps), "segments": segments,
                         "dynamic_build_ms": smoke.cuda_ms(launch_dynamic, reps)}
        iters = torch.empty(K.n_warps(WIDTH * HEIGHT), dtype=torch.int32, device=dev)
        again = K._launch(scene, ip, iv, 0, focal, ap, n_valid=n_frames, n_rows=HEIGHT,
                          row0=0, jitter="corner", rr=True, env_table=table,
                          warp_iters=iters, **kw)
        if not torch.equal(again.ray_count, res.ray_count):
            raise AssertionError("two launches at the same inputs gave other ray counts")
        out["lane_efficiency"] = {"per_lane": G.lane_efficiency(res.ray_count),
                                  "pooled": segments / (32.0 * int(iters.sum()))}
        del res
        if n_frames == BLOCKS[-1]:
            slots = {k: v for k, v in kw.items() if k != "counts"}
            escapes = smoke.escaped_samples(
                K.trace_progressive(scene, ip, iv, 0, focal, ap, **slots).miss_dir)
            pixels = WIDTH * HEIGHT
            out["kernel"]["escapes"] = escapes
            out["kernel"]["bound_ms"], out["kernel"]["bound_by"] = smoke.trace_bound(
                segments, pixels * n_frames, pixels, 0, scene.counts,
                env_bytes=table.numel() * 4, escapes=escapes)

    # the per-frame launches
    rec["frames"] = {}
    for label, c, w, h, depth, rr in (
            ("1080p train_bench", cam, WIDTH, HEIGHT, DEPTH, True),
            ("512^2 demo grid view", GRID_CAM, 512, 512, RAY_DEPTH, False),
            ("512^2 demo default view", cam, 512, 512, RAY_DEPTH, False)):
        fip, fiv, _ = camera_matrices(c, w, h)
        one = dict(width=w, height=h, ray_depth=depth, spp=1, rr=rr)

        def frame(fip=fip, fiv=fiv, c=c, one=one):
            return K.trace(scene, fip, fiv, 0, c.focal_length, c.aperture_diameter, **one)

        rays = frame().ray_count
        rec["frames"][label] = {"ms": smoke.cuda_ms(frame, 20), "segments": int(rays.sum())}
        if w == WIDTH:
            rec["frames"][label]["lane_efficiency"] = G.lane_efficiency(rays)

    print(json.dumps(rec), flush=True)


def main(argv=None) -> int:
    from probe_turns import other_checkout, run_turns
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", nargs="?", help="root of the other checkout (holding tpt_torch/)")
    args = ap.parse_args(argv)
    roots = [HERE, HERE]
    if args.other is not None:
        other = other_checkout(ap, args.other)
        roots = [other] + roots + [other]
    return run_turns("render_turns", TURN, roots)


if __name__ == "__main__":
    sys.exit(main())

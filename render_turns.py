"""Measure the render path's forward kernel of one or two checkouts of the
port in turns on one CUDA card, with this checkout's measurement code.

    python3 render_turns.py [OTHER_CHECKOUT]

Each turn runs in a fresh process with ``tpt_torch`` imported from one
checkout, which builds its own kernels into its own tpt_torch/_build
(``probe_turns.run_turns``).  The turns are this, this; with
OTHER_CHECKOUT, one turn of it first and one last.  A turn reports:

  * the forward kernel's instantiations: ptxas's registers, spill stores
    and loads and stack frame (``chip_smoke.ptxas_report`` of the trace
    library's kept build log) and the blocks per SM that the occupancy API
    gives (the layout entry ``tpt_trace_layout``);
  * the render path's 30-frame 1080p block (``progressive_frames``: the
    demo scene, depth 13, 1 spp, the 256^2 atmosphere): ms per block by
    CUDA events over 3 blocks after one, Mrays/s, and a block's peak
    allocation above the tensors resident before it;
  * that block's forward launch alone, in the environment mode: ms by CUDA
    events, segments, escapes (``chip_smoke.escaped_samples`` of the slot
    mode's launch at the same inputs) and the bound
    (``chip_smoke.trace_bound``);
  * the lane efficiency (``tpt_torch.kernels.trace_grad.lane_efficiency``)
    of the block's ray counts, which the per-lane refill loop runs at, and
    of one 1080p frame's;
  * the per-frame launches: the 1080p frame (depth 13, Russian roulette,
    the train_bench step's) and the inverse demo's two 512^2 depth-8
    launches (rr off, its grid and default views): ms by CUDA events.

Both checkouts need the forward kernel's environment mode and its layout
entry.

Each turn prints one JSON line {"turn", "checkout", "card", "kernels",
"block", "kernel", "lane_efficiency", "frames"}.
Exits non-zero if a turn fails.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
WIDTH, HEIGHT, DEPTH, BLOCK = 1920, 1080, 13, 30

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


def kernel_reports(smoke, _build) -> dict:
    """{instantiation: {"ptxas", "blocks_per_sm"}} of the forward kernel."""
    paths, _ = _build.ensure_built()
    report = smoke.ptxas_report(paths["trace.cu"].with_suffix(".log").read_text())
    # the layout entry's order; a checkout from before the bf16 table has the
    # first three instantiations, named by two template arguments
    names = ("<false,false,false>", "<true,false,false>", "<false,true,false>",
             "<false,true,true>")
    if f"trace_progressive_kernel{names[0]}" not in report:
        names = ("<false,false>", "<true,false>", "<false,true>")
    return {f"trace_progressive_kernel{t}": {"ptxas": report.get(f"trace_progressive_kernel{t}"),
                                             "blocks_per_sm": n}
            for t, n in zip(names, smoke.trace_blocks_per_sm())}


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
           "kernels": kernel_reports(smoke, _build)}
    scene = demo_scene().build(dev)
    cam = CameraConfig()
    focal, ap = cam.focal_length, cam.aperture_diameter
    table = pack_block_table(compute_atmosphere(AtmosphereConfig(size=256), dev))
    ip, iv, _ = camera_matrices(cam, WIDTH, HEIGHT)

    # the render path's block
    acc = init_accumulator(HEIGHT, WIDTH, dev)

    def block():
        return progressive_frames(acc, scene, table, ip, iv, acc.frame, focal, ap, width=WIDTH,
                                  height=HEIGHT, ray_depth=DEPTH, spp=1, n_frames=BLOCK)[1]

    block()
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    rays = [block() for _ in range(3)]
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / 3
    segments = sum(int(r) for r in rays)
    rec["block"] = {"ms": ms, "mrays_per_s": segments / (ms * 3e-3) / 1e6,
                    "segments": segments // 3, "resident_bytes": resident,
                    "peak_bytes_above_resident": torch.cuda.max_memory_allocated(dev) - resident}
    del acc

    # its forward launch alone, and the slot mode's at the same inputs for
    # the escapes: the environment changes no decision
    kw = dict(width=WIDTH, height=HEIGHT, ray_depth=DEPTH, spp=1, n_frames=BLOCK)
    escapes = smoke.escaped_samples(K.trace_progressive(scene, ip, iv, 0, focal, ap, **kw).miss_dir)

    def launch():
        return K.trace_progressive(scene, ip, iv, 0, focal, ap, env_table=table, **kw)

    res = launch()
    pixels, segments = WIDTH * HEIGHT, int(res.ray_count.sum())
    bound_ms, bound_by = smoke.trace_bound(segments, pixels * BLOCK, pixels, 0, scene.counts,
                                           env_bytes=table.numel() * 4, escapes=escapes)
    rec["kernel"] = {"ms": smoke.cuda_ms(launch, 3), "segments": segments, "escapes": escapes,
                     "bound_ms": bound_ms, "bound_by": bound_by}
    rec["lane_efficiency"] = {"block": G.lane_efficiency(res.ray_count)}
    del res

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
            rec["lane_efficiency"]["frame"] = G.lane_efficiency(rays)

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

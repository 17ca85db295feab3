"""Where the time of one progressive block of the render path, or of one
training step, goes on a CUDA card.

Renders the demo scene with the 256^2 atmosphere through
tpt_torch.kernels.render.progressive_frames at the main path's size
(1920x1080, 30-frame blocks), through the kernel built for the scene's
counts as ``cli render`` runs it: one warm-up block, then two blocks under
torch.profiler (CPU and CUDA activities), the window timed with CUDA
events.  Device time is split into the trace kernel (which fetches the
environment itself), the block fold (its elementwise kernels) and the rest
(the ray count's sum, copies), each per block; the idle share is the part
of the window in which no CUDA kernel ran.  Prints the card's name and
power limit, one JSON line, and the device kernels by total time.

``--train`` profiles the training step of benchmarks/train_bench.py instead
(1920x1080, ray depth 13, 1 spp, Russian roulette on, loss
``mean((img - 0.25)^2)``, SGD with lr 0.01 on the material tables): one
warm-up step, then steps under the profiler.  Device time is split into the
forward trace kernel, the backward's two kernels (tape and adjoint, also
each apart), the optimizer update (the ``tpt::optimizer`` range) and the
rest (the environment fetch and the loss, their backward, the maps from
the table to the scene), each per step, plus the idle share.

    python -m tpt_torch.profile_block [--train]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch


def card_name_and_power() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def profile_blocks(width: int, height: int, n_frames: int, n_blocks: int):
    """Returns (summary dict, [(device ms, calls, kernel name), ...] sorted
    by time, over all ``n_blocks`` blocks)."""
    from torch.profiler import ProfilerActivity, profile

    from .camera import camera_matrices
    from .config import AtmosphereConfig, CameraConfig
    from .env import pack_block_table
    from .kernels.render import kernel_counts, progressive_frames
    from .progressive import init_accumulator
    from .scene import demo_scene
    from .sky import compute_atmosphere

    if not torch.cuda.is_available():
        raise RuntimeError("profile_block times a CUDA card; no CUDA device is available")
    dev = torch.device("cuda")
    cam = CameraConfig()
    inv_p, inv_v, _ = camera_matrices(cam, width, height)
    scene = demo_scene().build(dev)
    table = pack_block_table(compute_atmosphere(AtmosphereConfig(size=256), dev))
    acc = init_accumulator(height, width, dev)

    def block():
        return progressive_frames(acc, scene, table, inv_p, inv_v, acc.frame,
                                  cam.focal_length, cam.aperture_diameter,
                                  width=width, height=height, ray_depth=13, spp=1,
                                  counts=kernel_counts(scene, dev), n_frames=n_frames)[1]

    block()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        rays = [block() for _ in range(n_blocks)]
        end.record()
        torch.cuda.synchronize()
    window_ms = start.elapsed_time(end)
    rows = sorted(((k.device_time_total / 1e3, k.count, k.key)
                   for k in prof.key_averages()
                   if k.device_type.name == "CUDA" and not k.key.startswith("tpt::")),
                  reverse=True)
    busy = sum(r[0] for r in rows)
    trace = sum(r[0] for r in rows if "trace_progressive_kernel" in r[2])
    fold = sum(r[0] for r in rows if "elementwise" in r[2])
    segments = sum(int(r) for r in rays)
    summary = {
        "width": width, "height": height, "frames_per_block": n_frames, "blocks": n_blocks,
        "window_ms_per_block": window_ms / n_blocks,
        "trace_kernel_ms_per_block": trace / n_blocks,
        "fold_ms_per_block": fold / n_blocks,
        "rest_ms_per_block": (busy - trace - fold) / n_blocks,
        "idle_share": 1.0 - busy / window_ms,
        "segments_per_block": segments / n_blocks,
        "mrays_per_s": segments / (window_ms * 1e-3) / 1e6,
    }
    return summary, rows


def make_train_bench_step(width: int, height: int, device):
    """The training step of benchmarks/train_bench.py on ``device``: the
    demo scene from the default camera, ray depth 13, 1 spp, Russian
    roulette on, loss ``mean((img - 0.25)^2)`` over the constant-sky frame,
    SGD with lr 0.01 on the two material tables.  Returns ``step() ->
    loss``; each call traces the next frame.  Its phases are the spans
    ``forward``, ``env_loss``, ``backward`` and ``optimizer``
    (tpt_torch.utils.profiling), the profiler ranges ``tpt::<phase>``."""
    import dataclasses

    from .camera import camera_matrices
    from .config import CameraConfig
    from .env import constant_environment, pack_block_table
    from .integrator import apply_environment_blocked
    from .kernels.trace_grad import trace_diff
    from .scene import demo_scene
    from .utils.profiling import span

    cam = CameraConfig()
    inv_p, inv_v, _ = camera_matrices(cam, width, height)
    scene = demo_scene().build(device)
    table = pack_block_table(constant_environment((0.7, 0.8, 1.0), device=device))
    params = [scene.sphere_material, scene.cuboid_material]
    frame = 0

    def step():
        nonlocal params, frame
        leaves = [p.detach().requires_grad_(True) for p in params]
        s = dataclasses.replace(scene, sphere_material=leaves[0], cuboid_material=leaves[1])
        with span("forward"):
            res = trace_diff(s, inv_p, inv_v, frame, cam.focal_length, cam.aperture_diameter,
                             width=width, height=height, ray_depth=13, spp=1, counts=(48, 7))
        with span("env_loss"):
            img = torch.movedim(apply_environment_blocked(res, table, 1), 0, -1)
            loss = torch.mean((img - 0.25) ** 2)
        with span("backward", for_workers=True):
            grads = torch.autograd.grad(loss, leaves)
        with span("optimizer"):
            params = [p - 0.01 * g for p, g in zip(leaves, grads)]
        frame += 1
        return loss.detach()

    return step


def profile_train_steps(width: int, height: int, n_steps: int):
    """The training step's split: (summary dict, kernel rows as in
    :func:`profile_blocks`, over all ``n_steps`` steps)."""
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise RuntimeError("profile_block times a CUDA card; no CUDA device is available")
    step = make_train_bench_step(width, height, torch.device("cuda"))
    step()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(n_steps):
            step()
        end.record()
        torch.cuda.synchronize()
    window_ms = start.elapsed_time(end)
    rows = sorted(((k.device_time_total / 1e3, k.count, k.key)
                   for k in prof.key_averages()
                   if k.device_type.name == "CUDA" and not k.key.startswith("tpt::")),
                  reverse=True)
    busy = sum(r[0] for r in rows)
    fwd = sum(r[0] for r in rows if "trace_progressive_kernel" in r[2])
    tape = sum(r[0] for r in rows if "trace_grad_tape_kernel" in r[2])
    adjoint = sum(r[0] for r in rows if "trace_grad_adjoint_kernel" in r[2])
    bwd = tape + adjoint
    opt = sum(e.device_time_total / 1e3 for e in prof.events()
              if e.name == "tpt::optimizer" and e.device_type.name == "CPU")
    summary = {
        "width": width, "height": height, "steps": n_steps,
        "window_ms_per_step": window_ms / n_steps,
        "forward_kernel_ms_per_step": fwd / n_steps,
        "backward_kernel_ms_per_step": bwd / n_steps,
        "tape_kernel_ms_per_step": tape / n_steps,
        "adjoint_kernel_ms_per_step": adjoint / n_steps,
        "optimizer_ms_per_step": opt / n_steps,
        "env_loss_rest_ms_per_step": (busy - fwd - bwd - opt) / n_steps,
        "idle_share": 1.0 - busy / window_ms,
    }
    return summary, rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m tpt_torch.profile_block")
    ap.add_argument("--train", action="store_true",
                    help="split a 1080p training step instead of a render block")
    if ap.parse_args(argv).train:
        summary, rows = profile_train_steps(1920, 1080, 5)
    else:
        summary, rows = profile_blocks(1920, 1080, 30, 2)
    print(card_name_and_power())
    print(json.dumps(summary))
    for ms, calls, key in rows[:25]:
        print(f"{ms:10.3f} ms  {calls:6d}  {key[:100]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

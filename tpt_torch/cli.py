"""Command-line interface of the PyTorch port (port of tpt.cli).

Same subcommands, flags, defaults and output as ``python -m tpt.cli``,
with ``--device`` (default ``cuda``) in place of ``--platform``.  The
kernel backend of ``render`` runs the progressive main path: blocks of
frames through tpt_torch.kernels.render.progressive_frames, whose trace
kernel is the CUDA kernel of tpt_torch/csrc/trace.cu on a CUDA device.
``--backend oracle`` is the user's choice of the plain renderer,
tpt_torch.reference, one frame at a time; the kernel backend is the
default and never gives way to it.  A ``cuda`` device that is not there
is an error; the CLI never carries on on the CPU.

Usage:
    python -m tpt_torch.cli render --frames 64 --out out.png
    python -m tpt_torch.cli render --width 1920 --height 1080 --frames 90 \
        --chunk 30 --checkpoint state.npz
    python -m tpt_torch.cli render --backend oracle --frames 4 --out oracle.png
    python -m tpt_torch.cli sky --atmosphere-size 256 --out sky.png   # debug face strip
    python -m tpt_torch.cli pick --x 416 --y 416               # CPU picking
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch


def _build_scene(name: str):
    from . import scene as scene_mod
    scenes = {"demo": scene_mod.demo_scene, "cornell": scene_mod.cornell_scene}
    if name not in scenes:
        raise SystemExit(f"unknown scene '{name}' (choose from {sorted(scenes)})")
    return scenes[name]()


def _build_env(args, device):
    from .config import AtmosphereConfig
    if args.env == "constant":
        from .env import constant_environment
        color = tuple(float(c) for c in args.env_color.split(","))
        return constant_environment(color, device=device)
    if args.env == "atmosphere":
        from .sky import compute_atmosphere
        cfg = AtmosphereConfig(size=args.atmosphere_size, i_steps=args.isteps,
                               j_steps=args.jsteps, time=args.time,
                               light_intensity=args.light_intensity)
        return compute_atmosphere(cfg, device=device)
    if args.env == "cubemap":
        from .env import load_cubemap_files
        return load_cubemap_files(args.cubemap_files.split(",")).to(device)
    if args.env == "skybox":
        from .env import bundled_skybox
        return bundled_skybox().to(device)
    raise SystemExit(f"unknown env '{args.env}'")


def _camera_from_args(args):
    from .config import CameraConfig
    pos = tuple(float(c) for c in args.camera_pos.split(","))
    return CameraConfig(position=pos, look_x=args.yaw, look_y=args.pitch,
                        fov_degrees=args.fov, focal_length=args.focal_length,
                        aperture_diameter=args.aperture)


def resolve_device(name: str) -> torch.device:
    """The requested device; a CUDA device that is not there is an error."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no CUDA device is available")
    return device


def _add_common_flags(p):
    # defaults/ranges mirror src/MainWindow.cs:189 and src/Render/Gui.cs:40-66
    p.add_argument("--width", type=int, default=832)
    p.add_argument("--height", type=int, default=832)
    p.add_argument("--spp", type=int, default=1, help="samples/pixel/frame (GUI range 1-10)")
    p.add_argument("--ray-depth", type=int, default=13, help="max bounces (GUI range 1-50)")
    p.add_argument("--jitter", default="corner", choices=["corner", "center"],
                   help="sub-pixel jitter arithmetic: compute-shader corner "
                        "convention or the shipped fragment variant's "
                        "centered convention (algebraically identical)")
    p.add_argument("--focal-length", type=float, default=20.0)
    p.add_argument("--aperture", type=float, default=0.14)
    p.add_argument("--fov", type=float, default=103.0)
    p.add_argument("--camera-pos", default="-17.14,3.53,-8.62")
    p.add_argument("--yaw", type=float, default=-32.2)
    p.add_argument("--pitch", type=float, default=0.8)
    p.add_argument("--scene", default="demo")
    p.add_argument("--env", default="atmosphere",
                   choices=["atmosphere", "constant", "cubemap", "skybox"])
    p.add_argument("--env-color", default="0.7,0.8,1.0")
    p.add_argument("--env-seamless", action="store_true",
                   help="GL-seamless cubemap filtering analogue: pad the env "
                        "table with adjacent-face edge texels")
    p.add_argument("--env-bf16", action="store_true",
                   help="half-width environment gather table (bf16 texels "
                        "bit-packed in f32 words): half the bytes of each "
                        "environment lookup, at ~0.06%% mean image error, "
                        "below GL bilinear filter precision but outside "
                        "the f32 oracle-parity contract")
    p.add_argument("--cubemap-files", default="",
                   help="6 comma-separated face images (+X,-X,+Y,-Y,+Z,-Z)")
    p.add_argument("--atmosphere-size", type=int, default=256)
    p.add_argument("--isteps", type=int, default=50)
    p.add_argument("--jsteps", type=int, default=15)
    p.add_argument("--time", type=float, default=0.5)
    p.add_argument("--light-intensity", type=float, default=15.0)
    p.add_argument("--device", default="cuda",
                   help="torch device to render on (cuda, cuda:1, cpu)")


def cmd_render(args) -> int:
    from .config import RenderConfig
    from .postfx import post_process
    from .progressive import (init_accumulator, load_checkpoint, save_checkpoint,
                              samples_per_pixel)
    from .utils import write_png

    device = resolve_device(args.device)
    cfg = RenderConfig(width=args.width, height=args.height,
                       ray_depth=args.ray_depth, spp=args.spp,
                       jitter=args.jitter)
    scene = _build_scene(args.scene).build(device)
    env_faces = _build_env(args, device)
    camera = _camera_from_args(args)

    if args.resume and os.path.exists(args.resume):
        state = load_checkpoint(args.resume, device)
        print(f"resumed from {args.resume} at frame {state.frame}")
    else:
        state = init_accumulator(cfg.height, cfg.width, device)

    t0 = time.time()
    render = _render_kernel if args.backend == "kernel" else _render_oracle
    total_rays = render(args, cfg, scene, env_faces, camera, state, t0)

    if args.checkpoint:
        save_checkpoint(args.checkpoint, state)

    out = args.out
    if not out:
        os.makedirs(args.out_dir, exist_ok=True)
        out = os.path.join(args.out_dir, f"Samples_{samples_per_pixel(state, cfg.spp)}.png")
    write_png(out, post_process(state.image).cpu().numpy())
    dt = time.time() - t0
    print(f"wrote {out}  ({total_rays/1e6:.1f} Mrays in {dt:.1f}s, "
          f"{total_rays/dt/1e6:.1f} Mrays/s)")
    return 0


def _render_kernel(args, cfg, scene, env_faces, camera, state, t0) -> int:
    """The production path: blocks of ``--chunk`` frames, one trace-kernel
    launch and one fold each.  Updates ``state`` in place; returns the
    traced segments."""
    from .camera import camera_matrices
    from .env import pack_block_table
    from .kernels.render import kernel_counts, progressive_frames
    from .progressive import samples_per_pixel, save_checkpoint

    # the kernel built for the scene's counts on a CUDA device, as tpt's
    # render specialises on its accelerator
    counts = kernel_counts(scene, scene.device)
    env_table = pack_block_table(env_faces,
                                 dtype=torch.bfloat16 if args.env_bf16 else torch.float32,
                                 seamless=args.env_seamless)
    inv_p, inv_v, _ = camera_matrices(camera, cfg.width, cfg.height)
    chunk = min(args.chunk, args.frames)

    total_rays = 0
    done = 0
    last_ckpt = 0
    while done < args.frames:
        # every chunk keeps the block size; a partial tail masks the extra
        # frames via n_valid
        n = min(chunk, args.frames - done)
        state, rays = progressive_frames(
            state, scene, env_table, inv_p, inv_v, state.frame,
            camera.focal_length, camera.aperture_diameter,
            width=cfg.width, height=cfg.height, ray_depth=cfg.ray_depth,
            spp=cfg.spp, counts=counts, n_frames=chunk, n_valid=n, jitter=cfg.jitter)
        done += n
        total_rays += int(rays)
        dt = time.time() - t0
        mrays = total_rays / dt / 1e6 if dt > 0 else 0.0
        print(f"frame {state.frame}/{args.frames}  "
              f"samples/px {samples_per_pixel(state, cfg.spp)}  "
              f"{mrays:.1f} Mrays/s", flush=True)
        # checkpoint whenever the quotient advances (chunked progress
        # rarely lands exactly on a multiple of --checkpoint-every)
        if args.checkpoint and (done // args.checkpoint_every
                                > last_ckpt // args.checkpoint_every
                                or done == args.frames):
            save_checkpoint(args.checkpoint, state)
            last_ckpt = done
    return total_rays


def _render_oracle(args, cfg, scene, env_faces, camera, state, t0) -> int:
    """The plain renderer (tpt_torch.reference), one frame at a time, each
    folded into ``state`` by the reference's per-frame mix.  Returns the
    traced segments."""
    from .progressive import accumulate, samples_per_pixel, save_checkpoint
    from .reference import render_frame

    total_rays = 0
    report_every = max(1, args.frames // 10)
    for i in range(args.frames):
        image, rays = render_frame(scene, env_faces, camera, cfg, state.frame)
        accumulate(state, image)
        total_rays += int(rays)
        if (i + 1) % report_every == 0 or i + 1 == args.frames:
            dt = time.time() - t0
            mrays = total_rays / dt / 1e6 if dt > 0 else 0.0
            print(f"frame {state.frame}/{args.frames}  "
                  f"samples/px {samples_per_pixel(state, cfg.spp)}  "
                  f"{mrays:.1f} Mrays/s", flush=True)
        if args.checkpoint and (i + 1) % args.checkpoint_every == 0:
            save_checkpoint(args.checkpoint, state)
    return total_rays


def cmd_sky(args) -> int:
    """The atmosphere cubemap on ``--device``, timed with a device
    synchronise, and its tonemapped face strip (+X,-X,+Y,-Y,+Z,-Z)."""
    import numpy as np
    from .config import AtmosphereConfig
    from .postfx import post_process
    from .sky import compute_atmosphere
    from .utils import write_png

    device = resolve_device(args.device)
    cfg = AtmosphereConfig(size=args.atmosphere_size, i_steps=args.isteps,
                           j_steps=args.jsteps, time=args.time,
                           light_intensity=args.light_intensity)
    t0 = time.time()
    faces = compute_atmosphere(cfg, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = (time.time() - t0) * 1e3
    print(f"atmosphere {cfg.size}^2 x6 in {dt:.1f} ms "
          f"(iSteps={cfg.i_steps} jSteps={cfg.j_steps})")
    strip = np.concatenate(list(post_process(faces).cpu().numpy()), axis=1)
    write_png(args.out, strip)
    print(f"wrote {args.out} (face strip +X,-X,+Y,-Y,+Z,-Z)")
    return 0


def cmd_pick(args) -> int:
    """The object under window point (--x, --y), picked on the host."""
    from .camera import camera_matrices
    from .pick import pick_pixel
    from .scene import SphereObject

    builder = _build_scene(args.scene)
    camera = _camera_from_args(args)
    inv_p, inv_v, pos = camera_matrices(camera, args.width, args.height)
    obj, t1, t2 = pick_pixel(builder, inv_p, inv_v, pos, args.x, args.y,
                             args.width, args.height)
    if obj is None:
        print("picked: nothing")
    else:
        kind = "sphere" if isinstance(obj, SphereObject) else "cuboid"
        idx = builder.objects.index(obj)
        print(f"picked: {kind} object #{idx} at {obj.position} (t1={t1:.3f}, t2={t2:.3f})")
        print(f"  material: {obj.material}")
    return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="tpt_torch", description=__doc__)
    sub = parser.add_subparsers(dest="command", required=True)
    p = sub.add_parser("render", help="progressive render to PNG")
    _add_common_flags(p)
    p.add_argument("--frames", type=int, default=16)
    p.add_argument("--out", default=None)
    p.add_argument("--out-dir", default="Screenshots")
    p.add_argument("--backend", default="kernel", choices=["kernel", "oracle"])
    p.add_argument("--chunk", type=int, default=8,
                   help="frames fused per trace-kernel launch (kernel backend)")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--checkpoint-every", type=int, default=64)
    p.add_argument("--resume", default=None)
    p.set_defaults(fn=cmd_render)

    p = sub.add_parser("sky", help="precompute the atmosphere cubemap to PNG")
    _add_common_flags(p)
    p.add_argument("--out", default="sky.png")
    p.set_defaults(fn=cmd_sky)

    p = sub.add_parser("pick", help="CPU ray picking at a window coordinate")
    _add_common_flags(p)
    p.add_argument("--x", type=float, required=True)
    p.add_argument("--y", type=float, required=True)
    p.set_defaults(fn=cmd_pick)
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())

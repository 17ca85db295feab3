"""Geometry recovery through silhouette-aware gradients (port of
benchmarks/silhouette_demo.py).

A sphere's position (and, in the single-sphere scene, its radius) is
perturbed and recovered by Adam on the pixel-MSE, with
tpt_torch.silhouette.geometry_grad = interior (detached-decision autograd)
+ boundary (edge-sampling) terms.  Interior-only gradients cannot do this
(the radius inflates, the position stalls); with the boundary term both
parameters descend to the target.

    python -m tpt_torch.silhouette_demo [--scene single|demo] [--steps N] [--size N]
        [--device cuda|cpu] [--out PATH]

  * ``--scene single``: one diffuse sphere against a constant sky, 96^2,
    ray depth 2, Adam; the position and radius errors must fall below 15%
    of their start;
  * ``--scene demo``: a 6x6-grid sphere of the full 48-sphere / 7-cuboid
    demo scene, at least 128^2, ray depth 3, boundary-only gradients on the
    position, global-norm-clipped Adam, matched-seed targets; the position
    error must fall below 25% of its start.

The images the loss compares come from the forward trace kernel
(tpt_torch.kernels.trace.trace at one frame, then apply_environment) on a
CUDA device, from its plain version on the CPU.  Prints a line per 25
steps and one JSON line, which is also written to ``--out``; a recovery
that misses its bar raises AssertionError.  The default device is the
card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time

import torch

from .config import CameraConfig

SINGLE_CAM = CameraConfig(position=(0.0, 0.0, 6.0), look_x=-90.0, look_y=0.0,
                          focal_length=8.0, aperture_diameter=0.0)
SINGLE_ENV, SINGLE_DEPTH = (0.15, 0.2, 0.3), 2
TRUE_C, TRUE_R = (0.25, 0.1, 0.0), 1.05
START_C, START_R = (-0.15, -0.35, 0.3), 1.3

DEMO_CAM = CameraConfig(position=(-1.0, -0.8, -21.0), look_x=90.0, look_y=0.0,
                        aperture_diameter=0.0)
DEMO_ENV, DEMO_DEPTH, DEMO_COUNTS, DEMO_IDX = (0.7, 0.8, 1.0), 3, (48, 7), 14  # grid (2, 2)
DEMO_SHIFT = (0.8, -0.6, 0.0)


def make_render(cam: CameraConfig, env_faces, *, width: int, height: int, ray_depth: int,
                counts):
    """``render(scene, frame) -> f32[H, W, 3]``: one frame of the forward
    kernel (fixed depth, 1 spp, pinhole), then the environment term."""
    from .camera import camera_matrices
    from .integrator import apply_environment
    from .kernels.trace import trace

    inv_p, inv_v, _ = camera_matrices(cam, width, height)

    def render(scene, frame):
        res = trace(scene, inv_p, inv_v, frame, cam.focal_length, 0.0, width=width,
                    height=height, ray_depth=ray_depth, spp=1, counts=counts, rr=False)
        return torch.movedim(apply_environment(res, env_faces, 1), 0, -1)

    return render


def _single_sphere(center, radius, device):
    from .materials import Material
    from .scene import SceneBuilder
    b = SceneBuilder()
    b.add_sphere(tuple(map(float, center)), float(radius), Material.make(
        (0.85, 0.3, 0.2), (0, 0, 0), (0, 0, 0), 0.0, 0.0, 1.0, 0.0, 0.0))
    return b.build(device)


def run_single(steps: int, size: int, lr: float, device, log=print) -> dict:
    """Recover one sphere's center and radius.  Returns the result record."""
    from .env import constant_environment
    from .optim import clipped_adam
    from .silhouette import geometry_grad

    w = h = size
    env = constant_environment(SINGLE_ENV, device=device)
    render = make_render(SINGLE_CAM, env, width=w, height=h, ray_depth=SINGLE_DEPTH,
                         counts=(1, 0))
    target = render(_single_sphere(TRUE_C, TRUE_R, device), 0)
    scene = _single_sphere(START_C, START_R, device)
    spr = scene.sphere_pos_radius
    true_c = torch.tensor(TRUE_C, device=device)

    def errors(p):
        return float(torch.linalg.vector_norm(p[0, :3] - true_c)), abs(float(p[0, 3]) - TRUE_R)

    opt = clipped_adam(lr, clip_norm=math.inf)   # optax.adam: no clip
    state = opt.init((spr,))
    pos_err0, rad_err0 = errors(spr)
    t0 = time.time()
    for i in range(steps):
        s = dataclasses.replace(scene, sphere_pos_radius=spr)
        rendered = render(s, i)
        g = geometry_grad(s, SINGLE_CAM, env, rendered, target, i, [0], width=w, height=h,
                          ray_depth=SINGLE_DEPTH, counts=(1, 0), n_edge=1024)
        (update,), state = opt.update((g,), state, (spr,))
        spr = spr + update
        if i % 25 == 0 or i == steps - 1:
            pe, re = errors(spr)
            log(f"step {i:4d}  pos_err {pe:.4f}  rad_err {re:.4f}")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    pos_err, rad_err = errors(spr)
    return {"metric": "silhouette_geometry_recovery", "steps": steps, "size": size,
            "wall_s": round(time.time() - t0, 1),
            "pos_err_before": round(pos_err0, 4), "pos_err_after": round(pos_err, 4),
            "radius_err_before": round(rad_err0, 4), "radius_err_after": round(rad_err, 4)}


def run_demo(steps: int, size: int, lr: float, device, log=print) -> dict:
    """Recover a 6x6-grid sphere's position inside the full demo scene:
    its silhouette lands on the green wall and neighbouring spheres, and
    the boundary estimator's implicit occlusion handling runs for real.
    Returns the result record."""
    from .env import constant_environment
    from .optim import clipped_adam
    from .scene import demo_scene
    from .silhouette import geometry_grad

    w = h = max(size, 128)
    env = constant_environment(DEMO_ENV, device=device)
    render = make_render(DEMO_CAM, env, width=w, height=h, ray_depth=DEMO_DEPTH,
                         counts=DEMO_COUNTS)
    true_scene = demo_scene().build(device)
    true_pos = true_scene.sphere_pos_radius[DEMO_IDX, :3].clone()
    spr = true_scene.sphere_pos_radius.clone()
    spr[DEMO_IDX, :3] += torch.tensor(DEMO_SHIFT, device=device)
    scene = dataclasses.replace(true_scene, sphere_pos_radius=spr)

    def pos_err(p):
        return float(torch.linalg.vector_norm(p[DEMO_IDX, :3] - true_pos))

    # clipped Adam: fixed-depth transport fireflies give huge but
    # correctly-signed gradient frames (tpt_torch.optim)
    opt = clipped_adam(lr * 2.0)
    state = opt.init((spr,))
    pos_err0 = pos_err(spr)
    t0 = time.time()
    for i in range(steps):
        s = dataclasses.replace(scene, sphere_pos_radius=spr)
        rendered = render(s, i)
        # matched-seed target: the TRUE scene at the SAME frame, so the
        # residual is parameter-driven and zero at the optimum
        target = render(true_scene, i)
        # boundary-only gradients, position axes only: the interior term
        # is noise- and bias-dominated in this multi-bounce specular scene
        # and the radius is not perturbed here
        g = geometry_grad(s, DEMO_CAM, env, rendered, target, i, [DEMO_IDX], width=w,
                          height=h, ray_depth=DEMO_DEPTH, counts=DEMO_COUNTS, n_edge=2048,
                          interior=False)
        g[DEMO_IDX, 3] = 0.0
        (update,), state = opt.update((g,), state, (spr,))
        spr = spr + update
        if i % 25 == 0 or i == steps - 1:
            log(f"step {i:4d}  pos_err {pos_err(spr):.4f}")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    rad_err = abs(float(spr[DEMO_IDX, 3]) - float(true_scene.sphere_pos_radius[DEMO_IDX, 3]))
    return {"metric": "silhouette_geometry_recovery_demo_scene", "steps": steps, "size": w,
            "sphere": DEMO_IDX, "wall_s": round(time.time() - t0, 1),
            "pos_err_before": round(pos_err0, 4), "pos_err_after": round(pos_err(spr), 4),
            "radius_err_after": round(rad_err, 4)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m tpt_torch.silhouette_demo")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--size", type=int, default=96)
    ap.add_argument("--lr", type=float, default=0.02)
    ap.add_argument("--scene", default="single", choices=["single", "demo"],
                    help="'single' = isolated sphere vs constant env; 'demo' = a 6x6-grid "
                         "sphere inside the FULL 48-sphere/7-cuboid demo scene (occlusion, "
                         "textured background, secondary bounces)")
    ap.add_argument("--out", default="silhouette_demo.json")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the forward kernel) or cpu (its plain version)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("silhouette_demo: no CUDA device (use --device cpu for the plain "
                         "versions)")

    log = lambda line: print(line, flush=True)
    run = run_demo if args.scene == "demo" else run_single
    result = run(args.steps, args.size, args.lr, device, log)
    result["device"] = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(json.dumps(result))
    out_dir = os.path.dirname(os.path.abspath(args.out))
    os.makedirs(out_dir, exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    # recovery: the errors fall by the demo's factor
    bars = [("pos_err", 0.25 if args.scene == "demo" else 0.15)]
    if args.scene == "single":
        bars.append(("radius_err", 0.15))
    for key, factor in bars:
        before, after = result.get(f"{key}_before"), result[f"{key}_after"]
        if not after < before * factor:
            raise AssertionError(f"{key}: {after} is not below {factor} x {before}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

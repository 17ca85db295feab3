"""Demo-scene-scale inverse rendering on one card: the training path of the
port (counterpart of benchmarks/inverse_demo.py).

Recovers perturbed material parameters of the 48-sphere / 7-cuboid demo
scene — the 36 grid spheres' albedos and the area light's emissive — by
pixel-MSE gradient descent against rendered targets, through
tpt_torch.optim: fixed-depth transport, clipped Adam with the
constant-then-cosine schedule, two views, optimizer checkpoints.  Each
gradient goes through trace_diff: the trace kernel forward and the
hand-written backward kernel on a CUDA device, their plain versions on the
CPU.

    python -m tpt_torch.inverse_demo [--steps N] [--size WxH] [--device cuda|cpu]

Prints a line per 200 steps and one JSON line, which is also written to
``--out``; the before / target / after PNGs go beside it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from .config import CameraConfig

N_OBS = 36  # the grid spheres, whose albedo the transport observes
RAY_DEPTH, SPP, COUNTS = 8, 1, (48, 7)
# faces the 6x6 sphere grid with a pinhole aperture
GRID_CAM = CameraConfig(position=(-1.0, -0.8, -21.0), look_x=90.0, look_y=0.0,
                        aperture_diameter=0.0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m tpt_torch.inverse_demo")
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--size", default="512x512")
    ap.add_argument("--lr", type=float, default=0.005)
    ap.add_argument("--grad-frames", type=int, default=1,
                    help="independent RNG frames averaged per gradient step")
    ap.add_argument("--view", default="both", choices=["both", "grid", "default"],
                    help="'grid' faces the 6x6 sphere grid with a pinhole aperture; "
                         "'default' is the reference camera (sees the glass-sphere rows "
                         "the grid view cannot); 'both' optimises against both")
    ap.add_argument("--checkpoint", default="",
                    help="save/resume optimizer state here every --checkpoint-every steps")
    ap.add_argument("--checkpoint-every", type=int, default=500)
    ap.add_argument("--out", default="artifacts/inverse_demo.json")
    ap.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu (plain versions)")
    args = ap.parse_args(argv)
    width, height = map(int, args.size.split("x"))
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("inverse_demo: no CUDA device (use --device cpu for the plain versions)")

    from .env import constant_environment, pack_block_table
    from .optim import (clipped_adam, load_optim_checkpoint, make_inverse_step,
                        make_renderer, save_optim_checkpoint)
    from .postfx import post_process
    from .scene import demo_scene
    from .utils import write_png

    views = {"grid": [GRID_CAM], "default": [CameraConfig()],
             "both": [GRID_CAM, CameraConfig()]}[args.view]
    scene = demo_scene().build(dev)
    env_table = pack_block_table(constant_environment((0.7, 0.8, 1.0), device=dev))
    render = make_renderer(scene, views, width=width, height=height, ray_depth=RAY_DEPTH,
                           spp=SPP, counts=COUNTS, env_table=env_table)
    true_sm, true_cm = scene.sphere_material, scene.cuboid_material

    def target_frame(frame):
        with torch.no_grad():
            return torch.stack([render(true_sm, true_cm, frame, v) for v in range(len(views))])

    # the perturbation of benchmarks/inverse_demo.py: grid-sphere albedos and
    # the area light's emissive (cuboid 1)
    rng = np.random.default_rng(11)
    sm_true, cm_true = true_sm.cpu().numpy(), true_cm.cpu().numpy()
    sm0, cm0 = sm_true.copy(), cm_true.copy()
    sm0[:N_OBS, 0:3] = rng.uniform(0.2, 0.9, (N_OBS, 3))
    cm0[1, 4:7] = np.clip(cm0[1, 4:7] + rng.uniform(-2, 2, 3), 0.5, None)
    mask_s = np.zeros_like(sm0)
    mask_s[:N_OBS, 0:3] = 1.0
    mask_c = np.zeros_like(cm0)
    mask_c[1, 4:7] = 1.0

    opt = clipped_adam(args.lr, total_steps=args.steps)
    step = make_inverse_step(render, opt, n_views=len(views), grad_frames=args.grad_frames,
                             param_mask=(torch.tensor(mask_s, device=dev),
                                         torch.tensor(mask_c, device=dev)))
    out_dir = os.path.dirname(os.path.abspath(args.out))
    os.makedirs(out_dir, exist_ok=True)

    params = (torch.tensor(sm0, device=dev), torch.tensor(cm0, device=dev))
    opt_state = opt.init(params)
    start = 0
    if args.checkpoint and os.path.exists(args.checkpoint):
        params, opt_state, start = load_optim_checkpoint(args.checkpoint, opt, params)
        print(f"resumed from {args.checkpoint} at step {start}", flush=True)

    def png(name, image):
        write_png(os.path.join(out_dir, name), post_process(image).cpu().numpy())

    with torch.no_grad():
        png("inverse_before.png", render(*params, 0, 0))
    png("inverse_target.png", target_frame(0)[0])
    t0 = time.time()
    losses = []
    for i in range(start, args.steps):
        tgt = torch.stack([target_frame(i * args.grad_frames + f)
                           for f in range(args.grad_frames)])
        params, opt_state, loss = step(params, opt_state, i, tgt)
        if i % 20 == 0 or i == args.steps - 1:
            losses.append(float(loss))
            if i % 200 == 0 or i == args.steps - 1:
                print(f"step {i:4d}  loss {losses[-1]:.6f}", flush=True)
        if args.checkpoint and (i + 1) % args.checkpoint_every == 0:
            save_optim_checkpoint(args.checkpoint, params, opt_state, i + 1)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.time() - t0

    sm, cm = params[0].cpu().numpy(), params[1].cpu().numpy()
    mae = lambda a, b: float(np.abs(a - b).mean())
    median = float(np.median(losses[-10:])) if losses else float("nan")
    result = {
        "metric": "inverse_demo_material_recovery",
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "steps": args.steps, "size": args.size, "wall_s": round(wall, 1),
        # per-frame losses jump with firefly draws under rr=False; the
        # median over the tail is the stable convergence figure
        "loss_first": losses[0] if losses else None,
        "loss_last": losses[-1] if losses else None,
        "loss_final_median": median,
        "loss_reduction_x": round(losses[0] / max(median, 1e-12)) if losses else None,
        "sphere_param_mae_before": round(mae(sm0[:N_OBS, 0:3], sm_true[:N_OBS, 0:3]), 4),
        "sphere_param_mae_after": round(mae(sm[:N_OBS, 0:3], sm_true[:N_OBS, 0:3]), 4),
        "cuboid_param_mae_before": round(mae(cm0[1, 4:7], cm_true[1, 4:7]), 4),
        "cuboid_param_mae_after": round(mae(cm[1, 4:7], cm_true[1, 4:7]), 4),
    }
    with torch.no_grad():
        png("inverse_after.png", render(*params, 0, 0))
    print(json.dumps(result))
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

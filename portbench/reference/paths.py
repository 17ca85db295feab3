"""The benchmark's plain reference of each timed path, in plain PyTorch.

Built only from the frozen copies beside this file and from the inputs the
benchmark hands both sides (a configuration file's arrays and settings,
the seed's draws): it imports nothing of the program and takes nothing the
program made.  Every function runs on any device; on the card it gives the
program's kernels' bits, since the kernels repeat the plain arithmetic in
the same order.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from . import adam, camera, env, integrator, postfx, sky
from .config import MAX_CUBOIDS, MAX_SPHERES, AtmosphereConfig, CameraConfig
from .vecmath import div_scalar

SCENE_FIELDS = ("sphere_pos_radius", "sphere_material", "cuboid_min", "cuboid_max",
                "cuboid_material")
_ROWS = {"sphere_pos_radius": MAX_SPHERES, "sphere_material": MAX_SPHERES,
         "cuboid_min": MAX_CUBOIDS, "cuboid_max": MAX_CUBOIDS, "cuboid_material": MAX_CUBOIDS}


@dataclasses.dataclass(frozen=True)
class Scene:
    """The padded struct-of-arrays scene the plain transport reads."""
    sphere_pos_radius: torch.Tensor
    sphere_material: torch.Tensor
    cuboid_min: torch.Tensor
    cuboid_max: torch.Tensor
    cuboid_material: torch.Tensor
    num_spheres: int
    num_cuboids: int

    @property
    def counts(self) -> Tuple[int, int]:
        return self.num_spheres, self.num_cuboids

    @property
    def device(self) -> torch.device:
        return self.sphere_pos_radius.device


def scene_arrays(scene_cfg: dict) -> Tuple[np.ndarray, ...]:
    """A configuration's ``scene`` block as the seven padded leaves (five
    f32 arrays with MAX_SPHERES / MAX_CUBOIDS rows, then the two counts)."""
    out = []
    for name in SCENE_FIELDS:
        live = np.asarray(scene_cfg[name], np.float32)
        padded = np.zeros((_ROWS[name], live.shape[1]), np.float32)
        padded[:live.shape[0]] = live
        out.append(padded)
    return tuple(out) + (int(scene_cfg["num_spheres"]), int(scene_cfg["num_cuboids"]))


def make_scene(arrays: Sequence, device) -> Scene:
    leaves = {f: torch.tensor(np.asarray(a, np.float32), device=device)
              for f, a in zip(SCENE_FIELDS, arrays)}
    return Scene(**leaves, num_spheres=int(arrays[5]), num_cuboids=int(arrays[6]))


def camera_config(cam: dict) -> CameraConfig:
    return CameraConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in cam.items()})


def environment_faces(env_cfg: dict, device) -> torch.Tensor:
    """f32[6, S, S, 3]: the atmosphere's precompute or a constant sky."""
    if env_cfg["kind"] == "atmosphere":
        keys = ("size", "i_steps", "j_steps", "time", "light_intensity")
        return sky.compute_atmosphere(AtmosphereConfig(**{k: env_cfg[k] for k in keys}), device)
    if env_cfg["kind"] == "constant":
        return env.constant_environment(tuple(env_cfg["color"]), device=device)
    raise ValueError(f"unknown environment kind {env_cfg['kind']!r}")


def pixels(width: int, height: int, device):
    """Pixel coordinates (px, py) i32[height, width], row index = py."""
    flat = torch.arange(width * height, dtype=torch.int32, device=device)
    return (flat % width).reshape(height, width), (flat // width).reshape(height, width)


def block(scene: Scene, table, cam: CameraConfig, width: int, height: int, frame0: int,
          n_frames: int, render: dict):
    """One block of the render path: ``n_frames`` frames traced with the
    environment added at escape.  Returns (rad_sum f32[H, W, 3] summed over
    frames, traced segments, escaped samples)."""
    inv_p, inv_v, _ = camera.camera_matrices(cam, width, height)
    px, py = pixels(width, height, scene.device)
    cp = integrator.camera_params(inv_p, inv_v, cam.focal_length, cam.aperture_diameter)
    res = integrator.trace_progressive(
        integrator.make_scene_trace_fn(scene, scene.counts), cp, px, py, width, height,
        int(frame0), render["ray_depth"], render["spp"], n_frames, table,
        jitter=render["jitter"], russian_roulette=render["russian_roulette"])
    return (torch.movedim(res.rad_sum, 0, -1), int(res.ray_count.sum()), int(res.escapes))


def fold_block(acc_before: torch.Tensor, n0: int, rad_sum: torch.Tensor, n_frames: int,
               spp: int) -> torch.Tensor:
    """The running mean after a block: ``(n0 acc + sum_f frame_f / spp) /
    max(n0 + F, 1)``, in the render path's operation order."""
    total = div_scalar(rad_sum, spp)
    n0 = np.float32(n0)
    denom = max(n0 + np.float32(n_frames), np.float32(1.0))
    out = acc_before.clone()
    return out.mul_(float(n0)).add_(total).div_(torch.tensor(denom, device=out.device))


def frame_mean(scene: Scene, table, cam: CameraConfig, width: int, height: int, frame: int,
               render: dict):
    """One frame of the per-frame path: the trace, then the environment
    fetched from the miss slots.  Returns (mean f32[H, W, 3], segments)."""
    inv_p, inv_v, _ = camera.camera_matrices(cam, width, height)
    px, py = pixels(width, height, scene.device)
    cp = integrator.camera_params(inv_p, inv_v, cam.focal_length, cam.aperture_diameter)
    res = integrator.trace_paths(integrator.make_scene_trace_fn(scene, scene.counts), cp,
                                 px, py, width, height, int(frame), render["ray_depth"],
                                 render["spp"], jitter=render["jitter"],
                                 russian_roulette=render["russian_roulette"])
    mean = integrator.apply_environment_blocked(res, table, render["spp"])
    return torch.movedim(mean, 0, -1), int(res.ray_count.sum())


def mix_frame(acc_before: torch.Tensor, n0: int, mean: torch.Tensor) -> torch.Tensor:
    """The per-frame running mean ``acc + (mean - acc) / (n0 + 1)``."""
    w = np.float32(1.0) / (np.float32(n0) + np.float32(1.0))
    out = acc_before.clone()
    return out.add_((mean - out).mul_(float(w)))


def display_u8(image: torch.Tensor) -> np.ndarray:
    """The viewer's display image: tonemap, clamp, ``* 255 + 0.5``, truncate."""
    u8 = (torch.clamp(postfx.post_process(image), 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)
    return u8.cpu().numpy()


# ---- the training path ----

def attr_table(scene: Scene, materials, counts) -> torch.Tensor:
    """The winner-attribute table of ``scene`` with ``materials`` in place
    of its own: geometry, then the material lanes 0:14 of each live
    primitive."""
    s = dataclasses.replace(scene, sphere_material=materials[0], cuboid_material=materials[1])
    return integrator.build_attr_table(s, tuple(counts))


def diff_render(scene: Scene, attr, table, cam: CameraConfig, width: int, height: int,
                frame: int, render: dict):
    """One frame of the training path, differentiable with respect to the
    attribute table ``attr``: the closest-hit fold on detached rays, the
    winner's row of the table, the environment from the miss slots.
    Returns (image f32[H, W, 3], segments)."""
    counts = tuple(render["counts"])
    trace_fn = integrator.make_table_trace_fn(integrator.make_scene_scan_fn(scene, counts), attr,
                                              counts[0])
    inv_p, inv_v, _ = camera.camera_matrices(cam, width, height)
    px, py = pixels(width, height, scene.device)
    cp = integrator.camera_params(inv_p, inv_v, cam.focal_length, cam.aperture_diameter)
    res = integrator.trace_paths(trace_fn, cp, px, py, width, height, int(frame),
                                 render["ray_depth"], render["spp"], jitter=render["jitter"],
                                 russian_roulette=render["russian_roulette"])
    image = integrator.apply_environment_blocked(res, table, render["spp"])
    return torch.movedim(image, 0, -1), int(res.ray_count.sum())


def inverse_steps(arrays: Sequence, cfg: dict, views: List[CameraConfig], width: int,
                  height: int, start, masks, n_steps: int, device,
                  grad_frames: int = 1) -> Dict[str, object]:
    """The first ``n_steps`` steps of the inverse demo from ``start`` (the
    two material tables as numpy arrays): step ``i`` renders frames ``i *
    grad_frames + f``, each frame's targets with the true materials, and
    takes the mean over the frames and views of the pixel MSE.  Its
    gradient is taken per render with respect to that render's attribute
    table, whose non-finite entries are zeroed (the trace's finite filter:
    an axis-parallel ray on a cuboid gives 0 x inf in the slab test's
    partials), summed, and mapped to the material lanes; then masked by
    ``masks``, then clipped Adam.  Returns {"losses": [float], "grads": the
    gradient the optimizer took at the first step (from its first moment),
    "change": the parameters after the steps minus the start, "segments":
    [segments a gradient render]}."""
    scene = make_scene(arrays, device)
    table = env.pack_block_table(environment_faces(cfg["environment"], device))
    render = cfg["render"]
    ns, nc = render["counts"]
    params = tuple(torch.tensor(np.asarray(a, np.float32), device=device) for a in start)
    start = tuple(p.clone() for p in params)
    mask = tuple(torch.tensor(m, device=device) for m in masks)
    o = cfg["optimizer"]
    opt = adam.ClippedAdam(lr=o["lr"], total_steps=o["total_steps"], clip_norm=o["clip_norm"])
    state = opt.init(params)
    true = attr_table(scene, (scene.sphere_material, scene.cuboid_material), render["counts"])
    losses, segments, grads = [], [], None
    for i in range(n_steps):
        frames = [i * grad_frames + f for f in range(grad_frames)]
        with torch.no_grad():
            targets = [[diff_render(scene, true, table, v, width, height, fr, render)[0]
                        for v in views] for fr in frames]
        attrs, total = [], None
        for fr, tgts in zip(frames, targets):
            for v, tgt in zip(views, tgts):
                attr = attr_table(scene, params, render["counts"]).requires_grad_(True)
                attrs.append(attr)
                image, seg = diff_render(scene, attr, table, v, width, height, fr, render)
                segments.append(seg)
                err = image - tgt
                term = torch.mean(err * err)
                total = term if total is None else total + term
        loss = div_scalar(total, grad_frames * len(views))
        d_table = None
        for d in torch.autograd.grad(loss, attrs):
            d = torch.where(torch.isfinite(d), d, 0.0)
            d_table = d if d_table is None else d_table + d
        g = tuple(torch.zeros_like(p) for p in params)
        g[0][:ns, :14] = d_table[:ns, 10:24]
        g[1][:nc, :14] = d_table[ns:ns + nc, 10:24]
        g = tuple(x * m for x, m in zip(g, mask))
        updates, state = opt.update(g, state, params)
        params = tuple(p.detach() + u for p, u in zip(params, updates))
        losses.append(float(loss.detach()))
        if i == 0:
            grads = tuple(m / (1 - adam.B1) for m in state.mu)
    return {"losses": losses, "grads": grads,
            "change": tuple(p - s for p, s in zip(params, start)), "segments": segments}

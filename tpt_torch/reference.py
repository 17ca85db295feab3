"""The oracle renderer: the whole integrator in plain PyTorch (port of
tpt.reference).

An implementation of the full GLSL algorithm independent of the CUDA
kernels, usable as a renderer in its own right (``cli render --backend
oracle``) and as the reference the kernels are held to.  It runs on the
scene's device.

Two equivalent entry points:
  * :func:`render_fields` — batched over the [H, W] pixel grid directly;
  * :func:`render_fields_vmap` — a per-pixel ``trace_paths`` mapped over
    the pixels by ``torch.func.vmap``.  Identical results.

Image convention: row 0 is the *bottom* of the image (GL pixel layout, as in
the reference's accumulation texture). Flip on export.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .camera import camera_matrices
from .config import CameraConfig, RenderConfig
from .integrator import apply_environment, camera_params, make_scene_trace_fn, trace_paths
from .progressive import AccumulatorState, accumulate


def _pixel_grid(height: int, width: int, device):
    """(px, py) i32[H, W]: column = x, row = GL y."""
    py = torch.arange(height, dtype=torch.int32, device=device)[:, None].expand(height, width)
    px = torch.arange(width, dtype=torch.int32, device=device)[None, :].expand(height, width)
    return px, py


def render_fields(scene, env_faces, inv_proj, inv_view, view_pos, frame,
                  focal_length, aperture_diameter,
                  *, width: int, height: int, ray_depth: int, spp: int,
                  jitter: str = "corner") -> Tuple[torch.Tensor, torch.Tensor]:
    """One frame's mean radiance. Returns (image f32[H, W, 3], rays i64)."""
    del view_pos  # == inv_view translation column
    px, py = _pixel_grid(height, width, scene.device)
    cam = camera_params(inv_proj, inv_view, focal_length, aperture_diameter)
    res = trace_paths(make_scene_trace_fn(scene), cam, px, py, width, height, int(frame),
                      ray_depth, spp, jitter=jitter)
    mean = apply_environment(res, env_faces, spp)
    return torch.movedim(mean, 0, -1), res.ray_count.sum()


def render_fields_vmap(scene, env_faces, inv_proj, inv_view, view_pos, frame,
                       focal_length, aperture_diameter,
                       *, width: int, height: int, ray_depth: int, spp: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The integrator of one pixel, vmapped over the pixel grid's rows and
    columns.  Every bounce runs (a vmapped pixel cannot stop early), which
    changes no result."""
    del view_pos
    px, py = _pixel_grid(height, width, scene.device)
    trace = make_scene_trace_fn(scene)
    cam = camera_params(inv_proj, inv_view, focal_length, aperture_diameter)

    def one_pixel(x, y):
        res = trace_paths(trace, cam, x, y, width, height, int(frame), ray_depth, spp,
                          early_exit=False)
        return apply_environment(res, env_faces, spp), res.ray_count

    mean, rays = torch.func.vmap(torch.func.vmap(one_pixel))(px, py)
    return mean, rays.sum()


def render_frame(scene, env_faces, camera: CameraConfig, cfg: RenderConfig,
                 frame: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Convenience wrapper building camera matrices from a CameraConfig."""
    inv_proj, inv_view, pos = camera_matrices(camera, cfg.width, cfg.height)
    return render_fields(
        scene, env_faces, inv_proj, inv_view, pos, frame,
        camera.focal_length, camera.aperture_diameter,
        width=cfg.width, height=cfg.height, ray_depth=cfg.ray_depth,
        spp=cfg.spp, jitter=cfg.jitter)


def render_progressive(scene, env_faces, camera: CameraConfig,
                       cfg: RenderConfig, state: AccumulatorState,
                       num_frames: int) -> Tuple[AccumulatorState, int]:
    """Accumulate ``num_frames`` progressive frames. Returns (state, rays)."""
    total_rays = 0
    for _ in range(num_frames):
        image, rays = render_frame(scene, env_faces, camera, cfg, state.frame)
        state = accumulate(state, image)
        total_rays += int(rays)
    return state, total_rays

"""Differentiable rendering of a whole frame (port of tpt.diff).

``render_diff`` composes :func:`tpt_torch.kernels.trace_grad.trace_diff`
(the trace kernel forward, the backward kernel in reverse mode) with
:func:`tpt_torch.integrator.apply_environment`, so the environment
cubemap's cotangent comes from autograd through the cubemap gather.  On
CPU tensors both kernels run their plain versions.

Differentiable inputs: the material tables, sphere positions/radii, cuboid
bounds, the environment cubemap, the thin-lens focal length / aperture
diameter and the inverse matrices.  Discrete decisions (lobe choice, RR
survival, scan winner) carry no gradient, as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .integrator import apply_environment
from .kernels.trace_grad import trace_diff
from .scene import Scene


class DiffInputs(NamedTuple):
    """The differentiable leaves of a render."""
    sphere_pos_radius: torch.Tensor
    sphere_material: torch.Tensor
    cuboid_min: torch.Tensor
    cuboid_max: torch.Tensor
    cuboid_material: torch.Tensor
    env_faces: torch.Tensor
    focal_length: torch.Tensor
    aperture_diameter: torch.Tensor

    @staticmethod
    def from_scene(scene: Scene, env_faces, focal_length, aperture_diameter) -> "DiffInputs":
        f32 = dict(dtype=torch.float32, device=scene.device)
        return DiffInputs(scene.sphere_pos_radius, scene.sphere_material,
                          scene.cuboid_min, scene.cuboid_max, scene.cuboid_material,
                          torch.as_tensor(env_faces, **f32),
                          torch.as_tensor(focal_length, **f32),
                          torch.as_tensor(aperture_diameter, **f32))


def render_diff(diff: DiffInputs, inv_proj, inv_view, frame, width: int, height: int,
                ray_depth: int, spp: int, counts: Tuple[int, int], rr: bool = True):
    """Differentiable frame render: f32[H, W, 3] mean radiance.

    ``rr=False`` selects fixed-depth transport — the one that recovers
    albedo scale (tpt_torch.integrator.bounce_step)."""
    dev = diff.sphere_material.device
    scene = Scene(diff.sphere_pos_radius, diff.sphere_material, diff.cuboid_min,
                  diff.cuboid_max, diff.cuboid_material, int(counts[0]), int(counts[1]))
    res = trace_diff(scene, torch.as_tensor(inv_proj, dtype=torch.float32, device=dev),
                     torch.as_tensor(inv_view, dtype=torch.float32, device=dev), int(frame),
                     diff.focal_length, diff.aperture_diameter, width=width, height=height,
                     ray_depth=ray_depth, spp=spp, counts=tuple(counts), rr=rr)
    return torch.movedim(apply_environment(res, diff.env_faces, spp), 0, -1)


def render_scene_diff(scene: Scene, env_faces, inv_proj, inv_view, frame, focal_length,
                      aperture_diameter, *, width: int, height: int, ray_depth: int,
                      spp: int, counts: Tuple[int, int]):
    """Convenience wrapper taking a Scene."""
    diff = DiffInputs.from_scene(scene, env_faces, focal_length, aperture_diameter)
    return render_diff(diff, inv_proj, inv_view, frame, width, height, ray_depth, spp, counts)

"""Silhouette (visibility-boundary) gradients for sphere geometry (port of
tpt.silhouette).

The detached-decision estimator of the differentiable renderer
differentiates only the CONTINUOUS factors of the transport; the
closest-hit winner is detached, so the term "moving a sphere changes WHICH
pixels it covers" is dropped.  That term is a line integral over the
object's silhouette (Li et al. 2018, "Differentiable Monte Carlo Ray
Tracing through Edge Sampling"), and without it interior-only gradients
mislead: a sphere's radius inflates to reduce interior residuals while the
silhouette penalty stays invisible.

This module adds the missing boundary term for SPHERE position/radius on
the primary (camera) hit, where it dominates.  A sphere's silhouette from
a pinhole eye is an exact circle — no edge detection or rejection sampling
needed:

  eye o, center c, radius r, L = |c - o|:
    tangency circle center  m = c - (r^2/L) * (c-o)/L
    tangency circle radius  rho = r * sqrt(1 - (r/L)^2)

The estimator samples M stratified points on that circle, projects them to
the screen, and accumulates for each loss-coupled parameter theta:

    dL/dtheta  +=  sum_j  l'(x_j) . (f_in - f_out)(x_j)
                          * (n_hat_j . d x_j/d theta) * dsigma_j

with l' = the pixel-loss derivative at the edge pixel, f_in/f_out =
radiance just inside/outside the silhouette (two eye rays offset +-eps
pixels along the screen normal — where another object covers the edge,
f_in == f_out and the term vanishes), n_hat = outward screen normal of the
projected curve, dsigma = the screen arc-length element.  The screen
positions x_j(c, r) are exact functions of the sphere parameters, so their
velocities come from torch.func.jacfwd — no finite differences anywhere in
the estimator.

The radiance along the edge rays and the interior term run the plain
integrator (tpt_torch.integrator) on the scene's device, as the JAX package
runs them on its XLA oracle: the backward kernel gives no geometry
gradient.  Callers may render the images the loss compares with the
forward kernel.

Scope and assumptions (documented bias):
  * primary-visibility boundaries only; secondary silhouettes (shadows,
    reflections of edges) remain detached;
  * pinhole camera (aperture 0) for the edge projection — a thin-lens
    silhouette is blurred over the aperture, which this estimator ignores;
  * f_in/f_out are 1-sample Monte-Carlo estimates per edge point (seeded
    per frame): unbiased in expectation, averaged over edge samples.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Tuple

import numpy as np
import torch

from . import rng
from .camera import camera_matrices, look_at, perspective, view_direction
from .config import CameraConfig
from .env import sample_environment_planar
from .integrator import (PathState, apply_environment, bounce_step, camera_params,
                         make_scene_trace_fn, primary_ray, sample_draws, trace_paths)
from .vecmath import div_scalar

F32 = torch.float32


def forward_matrices(cam: CameraConfig, width: int, height: int):
    """Forward view/projection consistent with camera_matrices' inverses:
    ndc = proj @ (view @ [p, 1]), xy divided by w.  f32 on the CPU."""
    eye = torch.as_tensor(cam.position, dtype=F32)
    fwd = view_direction(cam.look_x, cam.look_y)
    view = look_at(eye, eye + fwd, cam.up)
    proj = perspective(cam.fov_degrees, width / height)
    return proj, view


def project_to_screen(proj, view, p, width: int, height: int):
    """World point [..., 3] -> continuous screen (x, y) in pixels, GL
    y-up (the tracer's py convention)."""
    ph = torch.cat([p, torch.ones_like(p[..., :1])], dim=-1)
    q = ph @ view.T @ proj.T
    ndc = q[..., :2] / q[..., 3:4]
    x = (ndc[..., 0] * 0.5 + 0.5) * width
    y = (ndc[..., 1] * 0.5 + 0.5) * height
    return torch.stack([x, y], dim=-1)


def silhouette_points(center, radius, eye, phis):
    """Stratified points on the sphere's tangency circle, differentiable
    w.r.t. (center, radius), in reverse and forward mode."""
    d = center - eye
    L2 = torch.sum(d * d)
    L = torch.sqrt(L2)
    chat = d / L
    # basis perpendicular to the view axis
    up, right = chat.new_tensor([0.0, 1.0, 0.0]), chat.new_tensor([1.0, 0.0, 0.0])
    helper = torch.where(torch.abs(chat[1]) < 0.9, up, right)
    e1 = torch.linalg.cross(chat, helper)
    e1 = e1 / torch.linalg.vector_norm(e1)
    e2 = torch.linalg.cross(chat, e1)
    m = center - (radius * radius / L) * chat
    rho = radius * torch.sqrt(torch.clamp_min(1.0 - (radius / L) ** 2, 1e-12))
    return m[None, :] + rho * (torch.cos(phis)[:, None] * e1[None, :]
                               + torch.sin(phis)[:, None] * e2[None, :])


def _radiance(trace_fn, o, d, seed, ray_depth: int, env_faces,
              russian_roulette: bool = False):
    """Radiance along explicit rays (batch-planar [3, M]) — the bounce loop
    and the deferred environment term, on the plain trace."""
    zero3 = torch.zeros_like(o)
    state = PathState(origin=o, direction=d, throughput=zero3 + 1.0, radiance=zero3,
                      seed=seed, alive=torch.ones_like(seed, dtype=torch.bool),
                      miss_dir=zero3, miss_thr=zero3,
                      ray_count=torch.zeros_like(seed, dtype=torch.int32))
    for _ in range(ray_depth):
        state = bounce_step(state, trace_fn, russian_roulette)
    env = sample_environment_planar(env_faces, state.miss_dir)
    return state.radiance + state.miss_thr * env


@torch.no_grad()
def sphere_silhouette_grad(scene, cam: CameraConfig, env_faces, rendered, target, frame, *,
                           sphere_idx: int, width: int, height: int, ray_depth: int = 6,
                           n_edge: int = 512, counts: Tuple[int, int] | None = None,
                           eps_px: float = 0.35):
    """Boundary term of the pixel-MSE loss w.r.t. sphere ``sphere_idx``'s
    (center xyz, radius).

    ``rendered``/``target``: f32[H, W, 3] current render and target (GL
    row order) — the loss whose boundary term is estimated is
    ``mean((rendered - target)^2)``.  Returns (d_center f32[3], d_radius
    f32[]) on the scene's device.  Add to the interior gradients of the
    differentiable renderer to get the full geometry gradient."""
    dev = scene.device
    proj, view = (m.to(dev) for m in forward_matrices(cam, width, height))
    inv_p, inv_v, _ = camera_matrices(cam, width, height)
    eye = torch.as_tensor(cam.position, dtype=F32, device=dev)
    spr = scene.sphere_pos_radius[sphere_idx].detach()
    # (j + 0.5) * 2 pi / M, the step rounded in f32 as tpt.silhouette rounds it
    step = float(np.float32(2.0) * np.float32(np.pi) / np.float32(n_edge))
    phis = (torch.arange(n_edge, dtype=F32, device=dev) + 0.5) * step

    def screen_of(params, phi):
        p = silhouette_points(params[:3], params[3], eye, phi)
        return project_to_screen(proj, view, p, width, height)

    xy = screen_of(spr, phis)                                      # [M, 2]
    # d screen / d (cx, cy, cz, r): [M, 2, 4]
    vel = torch.func.jacfwd(lambda th: screen_of(th, phis))(spr)
    # screen tangent along the curve: d screen_j / d phi_j touches only
    # sample j, so one jvp with a ones tangent reads the diagonal
    _, tang = torch.func.jvp(lambda ph: screen_of(spr, ph), (phis,), (torch.ones_like(phis),))
    dsigma = torch.linalg.vector_norm(tang, dim=-1) * step
    normal = torch.stack([tang[:, 1], -tang[:, 0]], dim=-1)
    normal = normal / torch.clamp_min(torch.linalg.vector_norm(normal, dim=-1, keepdim=True),
                                      1e-12)
    # orient outward: away from the projected sphere center
    c_scr = project_to_screen(proj, view, spr[None, :3], width, height)[0]
    outward = torch.sum((xy - c_scr[None, :]) * normal, dim=-1) >= 0
    normal = torch.where(outward[:, None], normal, -normal)

    # f_in / f_out: eye rays through screen points eps inside/outside.
    # primary_ray with zero draws and fpx = screen x gives the exact pinhole
    # ray through the continuous screen position (corner-jitter NDC
    # arithmetic with jitter 0).
    cpar = camera_params(inv_p, inv_v, cam.focal_length, 0.0)
    trace = make_scene_trace_fn(scene, counts)
    lanes = torch.arange(n_edge, dtype=torch.int32, device=dev)

    def rad_at(pts):
        zero = pts[:, 0] * 0.0
        o, d = primary_ray(cpar, pts[:, 0], pts[:, 1], width, height, (zero, zero, zero, zero))
        seed = rng.pixel_seed(lanes, 9173, int(frame))
        _draws, seed = sample_draws(seed)  # decorrelate from pixel streams
        return _radiance(trace, o, d, seed, ray_depth, env_faces)

    f_in = rad_at(xy - eps_px * normal)                            # [3, M]
    f_out = rad_at(xy + eps_px * normal)

    # loss derivative at the edge pixels: l' = 2 (I - T) / (H W 3)
    ix = torch.clamp(xy[:, 0].to(torch.int32), 0, width - 1).long()
    iy = torch.clamp(xy[:, 1].to(torch.int32), 0, height - 1).long()
    lprime = div_scalar(2.0 * (rendered[iy, ix] - target[iy, ix]), height * width * 3)
    # zero contribution from edge samples projecting off-screen
    on_screen = ((xy[:, 0] >= 0) & (xy[:, 0] < width)
                 & (xy[:, 1] >= 0) & (xy[:, 1] < height))

    strength = torch.sum(lprime.T * (f_in - f_out), dim=0)        # [M]
    strength = torch.where(on_screen, strength, 0.0)
    nv = torch.einsum("mk,mkp->mp", normal, vel)                   # [M, 4]
    g = torch.sum((strength * dsigma)[:, None] * nv, dim=0)
    return g[:3], g[3]


def _interior_grad(scene, cam: CameraConfig, env_faces, target, frame, *, width: int,
                   height: int, ray_depth: int, counts):
    """Reverse-mode gradient of the pixel-MSE through the plain renderer
    (fixed depth, 1 spp, detached decisions) w.r.t. sphere_pos_radius."""
    dev = scene.device
    inv_p, inv_v, _ = camera_matrices(cam, width, height)
    cpar = camera_params(inv_p, inv_v, cam.focal_length, cam.aperture_diameter)
    py = torch.arange(height, dtype=torch.int32, device=dev)[:, None].expand(height, width)
    px = torch.arange(width, dtype=torch.int32, device=dev)[None, :].expand(height, width)
    spr = scene.sphere_pos_radius.detach().requires_grad_(True)
    with torch.enable_grad():
        s = dataclasses.replace(scene, sphere_pos_radius=spr)
        res = trace_paths(make_scene_trace_fn(s, counts), cpar, px, py, width, height,
                          int(frame), ray_depth, 1, russian_roulette=False)
        img = torch.movedim(apply_environment(res, env_faces, 1), 0, -1)
        loss = torch.mean((img - target) ** 2)
        (g,) = torch.autograd.grad(loss, spr)
    return g


def geometry_grad(scene, cam: CameraConfig, env_faces, rendered, target, frame,
                  sphere_indices: Iterable[int], *, width: int, height: int,
                  ray_depth: int = 6, counts: Tuple[int, int] | None = None,
                  n_edge: int = 512, eps_px: float = 0.35, interior: bool = True):
    """Interior + boundary geometry gradient for the listed spheres.

    Interior term: reverse-mode autograd of the pixel-MSE through the
    plain renderer w.r.t. sphere_pos_radius (detached decisions).  Boundary
    term: :func:`sphere_silhouette_grad` per sphere.  Returns
    d_sphere_pos_radius f32[Ns, 4] with rows outside ``sphere_indices``
    zeroed.

    ``interior=False`` is the boundary-only mode: in multi-bounce specular
    scenes the interior geometry term is noise- and bias-dominated (the
    JAX package measured, on the demo scene, a per-frame std ~40x the
    boundary signal and a systematic radius-inflation bias), while the
    boundary term stays correctly signed on every axis."""
    spr = scene.sphere_pos_radius
    if interior:
        g = _interior_grad(scene, cam, env_faces, target, frame, width=width, height=height,
                           ray_depth=ray_depth, counts=counts)
    else:
        g = torch.zeros_like(spr)
    g = g.detach().clone()
    mask = torch.zeros((spr.shape[0], 1), dtype=F32, device=spr.device)
    for i in (int(i) for i in sphere_indices):
        mask[i] = 1.0
        d_c, d_r = sphere_silhouette_grad(
            scene, cam, env_faces, rendered, target, frame, sphere_idx=i, width=width,
            height=height, ray_depth=ray_depth, counts=counts, n_edge=n_edge, eps_px=eps_px)
        g[i, :3] += d_c
        g[i, 3] += d_r
    # finite filter: grazing intersections have infinite partials (sqrt at
    # disc == 0); a lane landing exactly there poisons the whole reduce.
    # Zeroing the measure-zero event is the same policy as the backward
    # kernel's filter — the estimator is unchanged in expectation.
    g = torch.where(torch.isfinite(g), g, 0.0)
    return g * mask

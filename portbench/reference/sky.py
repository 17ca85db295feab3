"""Frozen copy of tpt_torch.sky: the atmospheric-scattering cubemap precompute.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .camera import inverse_look_at, inverse_perspective
from .config import AtmosphereConfig
from .vecmath import div_scalar, dot3, normalize3

F32 = np.float32
PI = F32(math.pi)

RAY_ORIGIN = (0.0, 6376e3, 0.0)
PLANET_RADIUS = F32(6371e3)
ATMOSPHERE_RADIUS = F32(6471e3)
K_RAYLEIGH = (5.5e-6, 13.0e-6, 22.4e-6)
K_MIE = F32(21e-6)
SCALE_HEIGHT_RAYLEIGH = F32(8e3)
SCALE_HEIGHT_MIE = F32(1.2e3)
MIE_G = F32(0.758)
SUN_DISTANCE = F32(149600000e3)

# Cubemap face cameras (dir, up) in GL face order
# (src/Render/AtmosphericScatterer.cs:76-86).
_FACE_CAMERAS = (
    ((1.0, 0.0, 0.0), (0.0, -1.0, 0.0)),    # +X
    ((-1.0, 0.0, 0.0), (0.0, -1.0, 0.0)),   # -X
    ((0.0, 1.0, 0.0), (0.0, 0.0, 1.0)),     # +Y
    ((0.0, -1.0, 0.0), (0.0, 0.0, -1.0)),   # -Y
    ((0.0, 0.0, 1.0), (0.0, -1.0, 0.0)),    # +Z
    ((0.0, 0.0, -1.0), (0.0, -1.0, 0.0)),   # -Z
)


def sun_position(time) -> torch.Tensor:
    """Sun position from the time-of-day parameter
    (src/Render/AtmosphericScatterer.cs:35-45); f32[3] on the CPU."""
    ang = torch.deg2rad(torch.tensor(time, dtype=torch.float32) * 360.0)
    return torch.stack([torch.tensor(0.0), torch.sin(ang), torch.cos(ang)]) * float(SUN_DISTANCE)


def face_directions(size: int, device="cpu") -> torch.Tensor:
    """View directions for every texel of all 6 faces: f32[3, 6, S, S].
    Texel-corner NDC (compute.glsl:37), rows index t, columns s."""
    inv_proj = inverse_perspective(90.0, 1.0, near=0.1, far=10.0)
    coords = div_scalar(torch.arange(size, dtype=torch.float32, device=device), size) * 2.0 - 1.0
    v, u = torch.meshgrid(coords, coords, indexing="ij")
    ex = float(inv_proj[0, 0]) * u
    ey = float(inv_proj[1, 1]) * v
    ez = torch.full_like(ex, -1.0)
    dirs = []
    for cam_dir, cam_up in _FACE_CAMERAS:
        iv = inverse_look_at((0.0, 0.0, 0.0), cam_dir, cam_up).to(device)
        d = (iv[:3, 0][:, None, None] * ex
             + iv[:3, 1][:, None, None] * ey
             + iv[:3, 2][:, None, None] * ez)
        dirs.append(normalize3(d))
    return torch.stack(dirs, dim=1)


def _rsi(r0, rd, sr):
    """Origin-centered ray/sphere intersection (compute.glsl:58-71).
    Returns (t_near, t_far); no intersection encoded as (1e5, -1e5)."""
    a = dot3(rd, rd)
    b = 2.0 * dot3(rd, r0)
    c = dot3(r0, r0) - float(sr * sr)
    d = b * b - 4.0 * a * c
    miss = d < 0.0
    sq = torch.sqrt(torch.clamp_min(d, 0.0))
    t0 = (-b - sq) / (2.0 * a)
    t1 = (-b + sq) / (2.0 * a)
    return torch.where(miss, 1e5, t0), torch.where(miss, -1e5, t1)


def atmosphere_radiance(direction, sun_pos, light_intensity,
                        i_steps: int, j_steps: int) -> torch.Tensor:
    """Single-scattering radiance along ``direction`` (f32[3, *batch]),
    faithful to Atmosphere() (compute.glsl:73-159) including its quirk of
    marching from the ray origin (not the atmosphere entry point)."""
    batch = tuple(direction.shape[1:])
    col = (3,) + (1,) * len(batch)
    dev = direction.device
    r = normalize3(direction)
    r0 = torch.tensor(RAY_ORIGIN, dtype=torch.float32, device=dev).view(col).expand((3,) + batch)
    p_sun = normalize3(torch.as_tensor(sun_pos, dtype=torch.float32).to(dev)).view(col)
    k_rlh = torch.tensor(K_RAYLEIGH, dtype=torch.float32, device=dev).view(col)

    px, py = _rsi(r0, r, ATMOSPHERE_RADIUS)
    valid = px <= py
    py = torch.minimum(py, _rsi(r0, r, PLANET_RADIUS)[0])
    i_step_size = div_scalar(py - px, i_steps)

    mu = dot3(r, p_sun.expand_as(r))
    mumu = mu * mu
    gg = MIE_G * MIE_G
    p_rlh = float(F32(3.0) / (F32(16.0) * PI)) * (1.0 + mumu)
    p_mie = ((float(F32(3.0) / (F32(8.0) * PI)) * (float(F32(1.0) - gg) * (mumu + 1.0)))
             / (torch.pow(float(F32(1.0) + gg) - 2.0 * mu * float(MIE_G), 1.5)
                * float(F32(2.0) + gg)))

    total_rlh = torch.zeros((3,) + batch, dtype=torch.float32, device=dev)
    total_mie = torch.zeros_like(total_rlh)
    i_od_rlh = torch.zeros(batch, dtype=torch.float32, device=dev)
    i_od_mie = torch.zeros_like(i_od_rlh)
    for i in range(i_steps):
        i_time = float(i) * i_step_size
        i_pos = r0 + r * (i_time + i_step_size * 0.5)
        i_height = torch.sqrt(dot3(i_pos, i_pos)) - float(PLANET_RADIUS)
        od_step_rlh = torch.exp(div_scalar(-i_height, SCALE_HEIGHT_RAYLEIGH)) * i_step_size
        od_step_mie = torch.exp(div_scalar(-i_height, SCALE_HEIGHT_MIE)) * i_step_size
        i_od_rlh = i_od_rlh + od_step_rlh
        i_od_mie = i_od_mie + od_step_mie

        j_step_size = div_scalar(_rsi(i_pos, p_sun.expand_as(i_pos), ATMOSPHERE_RADIUS)[1],
                                 j_steps)
        j_od_rlh = torch.zeros_like(i_od_rlh)
        j_od_mie = torch.zeros_like(i_od_mie)
        for j in range(j_steps):
            j_time = float(j) * j_step_size
            j_pos = i_pos + p_sun * (j_time + j_step_size * 0.5)
            j_height = torch.sqrt(dot3(j_pos, j_pos)) - float(PLANET_RADIUS)
            j_od_rlh = j_od_rlh + torch.exp(div_scalar(-j_height, SCALE_HEIGHT_RAYLEIGH)) * j_step_size
            j_od_mie = j_od_mie + torch.exp(div_scalar(-j_height, SCALE_HEIGHT_MIE)) * j_step_size

        attn = torch.exp(-(float(K_MIE) * (i_od_mie + j_od_mie)
                           + k_rlh * (i_od_rlh + j_od_rlh)))
        total_rlh = total_rlh + od_step_rlh * attn
        total_mie = total_mie + od_step_mie * attn

    color = float(F32(light_intensity)) * (
        p_rlh * k_rlh * total_rlh + (p_mie * float(K_MIE)) * total_mie)
    return torch.where(valid, color, 0.0)


def compute_atmosphere(cfg: AtmosphereConfig, device="cpu") -> torch.Tensor:
    """Precompute the sky cubemap, f32[6, S, S, 3] on ``device`` (the
    AtmosphericScatterer Render() analogue; call on parameter change)."""
    dirs = face_directions(cfg.size, device)                       # [3, 6, S, S]
    color = atmosphere_radiance(dirs, sun_position(cfg.time), cfg.light_intensity,
                                cfg.i_steps, cfg.j_steps)
    return torch.movedim(color, 0, -1).contiguous()                # [6, S, S, 3]

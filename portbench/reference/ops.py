"""Frozen copy of tpt_torch.ops: intersection, sampling and BSDF arithmetic.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .config import KERNEL_EPSILON
from .vecmath import (dot3, max_const, maximum, min_const, minimum, normalize3,
                      sqrt_clamped_grad)




FLOAT_MAX = float(np.float32(3.4028235e38))
FLOAT_MIN = float(np.float32(-3.4028235e38))


def ray_sphere(origin, direction, center, radius):
    """Quadratic sphere test; assumes ``direction`` normalized
    (compute.glsl:261-277).  Returns (t1, t2, ok).  ``center`` broadcasts
    against ``origin`` (``[3, 1...]`` for one sphere)."""
    oc = origin - center
    b = dot3(direction, oc)
    c = dot3(oc, oc) - radius * radius
    disc = b * b - c
    ok = disc >= 0.0
    sq = sqrt_clamped_grad(torch.where(ok, max_const(disc, 0.0), 1.0))
    return -b - sq, -b + sq, ok


def ray_cuboid(origin, direction, box_min, box_max):
    """Slab-method AABB test (compute.glsl:280-294). Returns (t1, t2, ok).

    Axis-parallel rays divide by zero into +-inf, exactly like GLSL IEEE
    semantics.  An origin on a slab plane with a zero direction component
    gives 0/0 = NaN; the minima and maxima propagate it like
    ``jnp.minimum``/``maximum``, so ``ok`` comes out false."""
    t0s = (box_min - origin) / direction
    t1s = (box_max - origin) / direction
    tsm = minimum(t0s, t1s)
    tbg = maximum(t0s, t1s)
    t1 = max_const(maximum(tsm[0], maximum(tsm[1], tsm[2])), FLOAT_MIN)
    t2 = min_const(minimum(tbg[0], minimum(tbg[1], tbg[2])), FLOAT_MAX)
    return t1, t2, t1 <= t2


def smallest_positive(t1, t2):
    """GetSmallestPositive (compute.glsl:347-350): assumes t2 >= t1, t2 > 0."""
    return torch.where(t1 < 0.0, t2, t1)


def sphere_normal(center, radius, surface_pos):
    """(p - c) / r (compute.glsl:316-319)."""
    return (surface_pos - center) / radius


def cuboid_normal(box_min, box_max, surface_pos, eps=KERNEL_EPSILON):
    """Axis-aligned face normal by epsilon proximity (compute.glsl:322-332).

    ``torch.sign`` is 0 at 0, like ``jnp.sign``.  The normalize is guarded
    against a zero vector (GLSL UB) by flooring the squared length."""
    half = (box_max - box_min) * 0.5
    cs = surface_pos - (box_max + box_min) * 0.5
    act = (torch.abs(torch.abs(cs) - half) <= eps).to(torch.float32)
    n = torch.sign(cs) * act
    return normalize3(n, eps=float(np.float32(1e-20)))





TWO_PI = float(np.float32(2.0 * math.pi))


def cosine_sample_hemisphere(normal, r_z, r_angle):
    """normalize(normal + uniform_unit_sphere) — cosine-weighted hemisphere
    around ``normal`` (compute.glsl:297-307).

    Draw order: z = r_z*2-1 first, then angle = r_angle*2*pi."""
    z = r_z * 2.0 - 1.0
    a = r_angle * TWO_PI
    r = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
    x = r * torch.cos(a)
    y = r * torch.sin(a)
    return normalize3(normal + torch.stack([x, y, z]))


def uniform_sample_unit_circle(r_angle, r_radius):
    """Uniform disk sample (compute.glsl:309-314).

    Draw order: angle first, then radius. Returns (x, y)."""
    angle = r_angle * TWO_PI
    r = torch.sqrt(r_radius)
    return torch.cos(angle) * r, torch.sin(angle) * r





def fresnel_schlick(cos_theta, n1, n2):
    """Schlick approximation (compute.glsl:359-364)."""
    r0 = (n1 - n2) / (n1 + n2)
    r0 = r0 * r0
    m = 1.0 - cos_theta
    m2 = m * m
    return r0 + (1.0 - r0) * (m2 * m2 * m)


def reflect3(incident, normal):
    """GLSL reflect: I - 2*dot(N, I)*N."""
    return incident - 2.0 * dot3(normal, incident) * normal


def refract3(incident, normal, eta):
    """GLSL refract: returns (direction f32[3,...], tir_mask bool[...]).

    On total internal reflection GLSL returns vec3(0); so does this, with
    the mask, so callers can apply the defined TIR policy."""
    n_dot_i = dot3(normal, incident)
    k = 1.0 - eta * eta * (1.0 - n_dot_i * n_dot_i)
    tir = k < 0.0
    sq = sqrt_clamped_grad(torch.where(tir, 1.0, max_const(k, 0.0)))
    out = eta * incident - (eta * n_dot_i + sq) * normal
    return torch.where(tir, 0.0, out), tir

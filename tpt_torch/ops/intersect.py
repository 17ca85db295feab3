"""Analytic ray/primitive intersection and normals (port of tpt.ops.intersect).

Mirrors the device intersectors of the reference
(res/shaders/PathTracing/compute.glsl:261-294,316-332).  All functions are
elementwise over arbitrary batch shapes; vectors are ``f32[3, *batch]``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import KERNEL_EPSILON
from ..vecmath import (dot3, max_const, maximum, min_const, minimum, normalize3,
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

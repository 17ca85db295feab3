"""BSDF building blocks: Fresnel, reflect, refract (port of
tpt.ops.bsdf_math; reference compute.glsl:184-224,359-364)."""

from __future__ import annotations

import torch

from ..vecmath import dot3, max_const, sqrt_clamped_grad


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

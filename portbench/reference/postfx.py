"""Frozen copy of tpt_torch.postfx: ACES tonemap and sRGB encode.
"""

from __future__ import annotations

import torch


def aces_film(x):
    x = torch.as_tensor(x, dtype=torch.float32)
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return torch.clamp((x * (a * x + b)) / (x * (c * x + d) + e), 0.0, 1.0)


def linear_to_srgb(rgb, gamma: float = 2.4):
    rgb = torch.as_tensor(rgb, dtype=torch.float32)
    return torch.where(rgb < 0.0031308,
                       rgb * 12.92,
                       torch.pow(rgb, 1.0 / gamma) * 1.055 - 0.055)


def post_process(*hdr_layers):
    """Sum input layers, tonemap, encode — the full post pass
    (fragment.glsl:17-26). Returns f32 in [0, 1]."""
    color = sum(torch.as_tensor(l, dtype=torch.float32) for l in hdr_layers)
    return linear_to_srgb(aces_film(color))


def to_uint8(srgb):
    """Quantize [0,1] sRGB to uint8 (the RGBA8 result texture analogue)."""
    return torch.clamp(torch.round(torch.as_tensor(srgb) * 255.0), 0, 255).to(torch.uint8)

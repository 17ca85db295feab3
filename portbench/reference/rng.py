"""Frozen copy of tpt_torch.rng: the shader's PCG random stream.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
_MUL = 747796405
_INC = 2891336453
_OUT_MUL = 277803737
_U32_TO_FLOAT = 1.0 / 4294967296.0   # 2^-32, exact in f32


def pixel_seed(x, y, frame):
    """Initial per-pixel seed ``x*1973 + y*9277 + frame*2699 | 1``
    (compute.glsl:106), as int64 in [0, 2^32).  ``frame`` is a Python int
    or a tensor."""
    x = torch.as_tensor(x).to(torch.int64)
    y = torch.as_tensor(y).to(torch.int64)
    if isinstance(frame, torch.Tensor):
        frame = frame.to(torch.int64) & MASK32
    else:
        frame = int(frame) & MASK32
    return ((x * 1973 + y * 9277 + frame * 2699) & MASK32) | 1


def pcg_hash(seed):
    """One PCG step on int64 seeds. Returns ``(word, new_seed)``, both in
    [0, 2^32)."""
    seed = (seed * _MUL + _INC) & MASK32
    shift = (seed >> 28) + 4
    word = (((seed >> shift) ^ seed) * _OUT_MUL) & MASK32
    return (word >> 22) ^ word, seed


def random_float01(seed):
    """One draw in [0, 1). Returns ``(f32 value, new_seed)``.  The direct
    int64 -> f32 cast rounds to nearest like the shader's uint -> float."""
    word, seed = pcg_hash(seed)
    return word.to(torch.float32) * _U32_TO_FLOAT, seed

"""Frozen copy of tpt_torch.env's environment table: the constant sky, the
padded faces, the block table the render path packs and its bilinear
lookup."""

from __future__ import annotations

import numpy as np
import torch

FACE_POS_X, FACE_NEG_X, FACE_POS_Y, FACE_NEG_Y, FACE_POS_Z, FACE_NEG_Z = range(6)
_INV_MA_FLOOR = float(np.float32(1e-30))


def constant_environment(color, size: int = 1, device="cpu") -> torch.Tensor:
    """A cubemap of one color — handy for tests."""
    color = torch.as_tensor(color, dtype=torch.float32, device=device)
    return color.expand(6, size, size, 3).contiguous()


def cubemap_face_uv_planar(dx, dy, dz):
    """GL cubemap face selection (OpenGL 4.6 spec table 8.19) on planar
    direction components.  Returns (face i32, s, t) with s, t in [0, 1]."""
    ax, ay, az = torch.abs(dx), torch.abs(dy), torch.abs(dz)

    x_major = (ax >= ay) & (ax >= az)
    y_major = (~x_major) & (ay >= az)

    face = torch.where(
        x_major, torch.where(dx > 0, FACE_POS_X, FACE_NEG_X),
        torch.where(y_major, torch.where(dy > 0, FACE_POS_Y, FACE_NEG_Y),
                    torch.where(dz > 0, FACE_POS_Z, FACE_NEG_Z)))

    ma = torch.where(x_major, ax, torch.where(y_major, ay, az))
    sc = torch.where(
        x_major, torch.where(dx > 0, -dz, dz),
        torch.where(y_major, dx, torch.where(dz > 0, dx, -dx)))
    tc = torch.where(
        x_major, -dy,
        torch.where(y_major, torch.where(dy > 0, dz, -dz), -dy))

    # floor in the normal f32 range: the zero-direction sentinel (no-miss
    # lanes) would otherwise give 0*inf = NaN
    inv_ma = 1.0 / torch.clamp_min(ma, _INV_MA_FLOOR)
    s = 0.5 * (sc * inv_ma + 1.0)
    t = 0.5 * (tc * inv_ma + 1.0)
    return face.to(torch.int32), s, t


def pad_faces_for_sampling(faces):
    """Pad faces to f32[6, S+2, S+2, 3] with a one-texel edge-replicated
    ring (exactly four clamp-to-edge taps)."""
    faces = torch.as_tensor(faces, dtype=torch.float32)
    size = faces.shape[1]
    idx = torch.clamp(torch.arange(-1, size + 1, device=faces.device), 0, size - 1)
    return faces[:, idx][:, :, idx]


def _bilinear_taps(size: int, direction3):
    """Face, weights and top-left padded texel of each lookup."""
    face, s, t = cubemap_face_uv_planar(direction3[0], direction3[1], direction3[2])
    x = s * size - 0.5
    y = t * size - 0.5
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    fx = x - x0f
    fy = y - y0f
    # +1 for the pad ring; x0+1 stays <= size+1, so no second clamp needed
    x0 = torch.clamp(x0f.to(torch.int32), -1, size - 1) + 1
    y0 = torch.clamp(y0f.to(torch.int32), -1, size - 1) + 1
    return face, fx, fy, x0, y0


def _lerp2(t00, t01, t10, t11, fx, fy):
    top = t00 * (1 - fx) + t01 * fx
    bot = t10 * (1 - fx) + t11 * fx
    return top * (1 - fy) + bot * fy


def pack_block_table(faces, dtype=torch.float32) -> torch.Tensor:
    """Precompute the render-path environment table: f32[6*(S+2)^2, 12].

    Row ``(face*(S+2) + y0)*(S+2) + x0`` holds the full bilinear footprint
    of the tap whose top-left padded texel is (y0, x0):
    ``[t00.rgb, t01.rgb, t10.rgb, t11.rgb]``, so a lookup is one row
    gather.  Rebuilt only when the environment changes.

    ``dtype=torch.bfloat16`` halves the row to 24 bytes: the 12 texels are
    rounded to bf16 (to nearest, ties to even) and packed in pairs into f32
    words, f32[6*(S+2)^2, 6], value ``2j`` in the low 16 bits of word ``j``
    and value ``2j + 1`` in the high 16 bits, bit for bit as
    tpt.env.pack_block_table packs them.  Opt-in: the texels keep an 8-bit
    mantissa (~0.4% relative), outside the f32 parity of the planar
    sampler."""
    padded = pad_faces_for_sampling(faces)
    pad = padded.shape[1]
    # neighbor-at-clamp: the last row/col duplicates itself; it is never
    # selected (x0+1 <= size+1), it only keeps shapes
    right = torch.cat([padded[:, :, 1:], padded[:, :, -1:]], dim=2)
    down = torch.cat([padded[:, 1:], padded[:, -1:]], dim=1)
    downright = torch.cat([down[:, :, 1:], down[:, :, -1:]], dim=2)
    blocks = torch.cat([padded, right, down, downright], dim=-1)
    blocks = blocks.reshape(6 * pad * pad, 12).contiguous()
    if dtype == torch.bfloat16:
        # little-endian: the even column of each pair lands in the low half
        return blocks.to(torch.bfloat16).view(torch.float32)
    if dtype != torch.float32:
        raise ValueError(f"dtype must be torch.float32 or torch.bfloat16, got {dtype}")
    return blocks


def env_size_from_table(table) -> int:
    """Recover the face size S from a pack_block_table output."""
    pad = int(round((table.shape[0] // 6) ** 0.5))
    return pad - 2


def sample_environment_blocked(table, direction3):
    """Bilinear cubemap lookup from a :func:`pack_block_table` table.

    ``direction3``: f32[3, *batch].  Returns f32[3, *batch].  For an f32
    table, bit-identical to :func:`sample_environment_planar` on the same
    faces (same texels, same weights, same operation order).  A bf16 table
    (6 words a row) is fetched at its narrow width and its texels are
    widened to f32 after the row fetch, exactly (a 16-bit shift); the
    blend is then the f32 table's."""
    size = env_size_from_table(table)
    pad = size + 2
    face, fx, fy, x0, y0 = _bilinear_taps(size, direction3)
    rows = ((face * pad + y0) * pad + x0).long()
    block = table[rows.reshape(-1)]
    if block.shape[1] == 6:   # bf16 pairs packed in f32 words
        block = block.view(torch.bfloat16).to(torch.float32)
    batch = rows.shape

    def channel(c):
        taps = [block[:, k].reshape(batch) for k in (c, 3 + c, 6 + c, 9 + c)]
        return _lerp2(*taps, fx, fy)

    return torch.stack([channel(0), channel(1), channel(2)])

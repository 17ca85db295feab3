"""Environment maps: cubemap storage and direction lookup (port of tpt.env).

An environment is one ``f32[6, S, S, 3]`` tensor in the GL face order
(+X, -X, +Y, -Y, +Z, -Z).  The lookup reproduces GL cubemap face selection
and bilinear filtering (magnification path), with clamp-to-edge seams by
default and the opt-in seamless pad ring of the JAX package.

The render path fetches through :func:`pack_block_table` /
:func:`sample_environment_blocked` (one 12-float row per tap); the planar
sampler is its reference and gives bit-identical values.  The opt-in bf16
table (``pack_block_table(dtype=torch.bfloat16)``) halves the row.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .vecmath import div_scalar

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


def cubemap_face_uv(direction):
    """GL cubemap face selection on [..., 3]-packed directions."""
    d = torch.as_tensor(direction, dtype=torch.float32)
    return cubemap_face_uv_planar(d[..., 0], d[..., 1], d[..., 2])


def _pad_seamless(faces):
    """Pad ring filled with the ADJACENT face's edge texels: each face's
    (s, t) grid is extended one texel beyond [0, 1], turned into a direction
    and nearest-sampled (tpt.env._pad_seamless)."""
    size = faces.shape[1]
    centers = div_scalar(
        torch.arange(size + 2, dtype=torch.float32, device=faces.device) - 1.0 + 0.5, size)
    t_grid, s_grid = torch.meshgrid(centers, centers, indexing="ij")
    sc = 2.0 * s_grid - 1.0
    tc = 2.0 * t_grid - 1.0
    one = torch.ones_like(sc)
    face_dirs = {  # face -> (dx, dy, dz); inverse of cubemap_face_uv
        FACE_POS_X: (one, -tc, -sc), FACE_NEG_X: (-one, -tc, sc),
        FACE_POS_Y: (sc, one, tc), FACE_NEG_Y: (sc, -one, -tc),
        FACE_POS_Z: (sc, -tc, one), FACE_NEG_Z: (-sc, -tc, -one)}
    out = []
    for f in range(6):
        fi, s_i, t_i = cubemap_face_uv_planar(*face_dirs[f])
        xi = torch.clamp(torch.floor(s_i * size).to(torch.int64), 0, size - 1)
        yi = torch.clamp(torch.floor(t_i * size).to(torch.int64), 0, size - 1)
        out.append(faces[fi.long(), yi, xi])
    padded = torch.stack(out)
    # interior texels stay exact (no round trip through the face math)
    padded[:, 1:-1, 1:-1] = faces
    return padded


def pad_faces_for_sampling(faces, seamless: bool = False):
    """Pad faces to f32[6, S+2, S+2, 3] with a one-texel ring:
    edge-replicate by default (exactly four clamp-to-edge taps), or the
    adjacent faces' texels with ``seamless=True``."""
    faces = torch.as_tensor(faces, dtype=torch.float32)
    if seamless:
        return _pad_seamless(faces)
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


def sample_environment_padded(padded, direction):
    """Bilinear cubemap lookup from :func:`pad_faces_for_sampling` output
    f32[6, S+2, S+2, 3].  ``direction``: [..., 3].  Returns [..., 3]."""
    padded = torch.as_tensor(padded, dtype=torch.float32)
    d = torch.as_tensor(direction, dtype=torch.float32)
    face, fx, fy, x0, y0 = _bilinear_taps(padded.shape[1] - 2, torch.movedim(d, -1, 0))
    f, x0, y0 = face.long(), x0.long(), y0.long()
    taps = [padded[f, y0 + dy, x0 + dx] for dy in (0, 1) for dx in (0, 1)]
    return _lerp2(*taps, fx[..., None], fy[..., None])


def sample_environment(faces, direction):
    """Bilinear cubemap lookup.  ``faces``: f32[6, S, S, 3] (row = t,
    col = s); ``direction``: [..., 3].  Returns [..., 3]."""
    return sample_environment_padded(pad_faces_for_sampling(faces), direction)


def sample_environment_planar(faces, direction3, seamless: bool = False):
    """Bilinear cubemap lookup in channel-first layout.

    ``faces``: f32[6, S, S, 3]; ``direction3``: f32[3, *batch].
    Returns f32[3, *batch]."""
    faces = torch.as_tensor(faces, dtype=torch.float32)
    size = faces.shape[1]
    pad = size + 2
    table = pad_faces_for_sampling(faces, seamless=seamless).reshape(-1)
    face, fx, fy, x0, y0 = _bilinear_taps(size, direction3)
    row0 = (((face * pad + y0) * pad + x0) * 3).long()
    row1 = row0 + pad * 3  # y0 + 1

    def channel(c):
        return _lerp2(table[row0 + c], table[row0 + (3 + c)],
                      table[row1 + c], table[row1 + (3 + c)], fx, fy)

    return torch.stack([channel(0), channel(1), channel(2)])


def pack_block_table(faces, dtype=torch.float32, seamless: bool = False) -> torch.Tensor:
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
    padded = pad_faces_for_sampling(faces, seamless=seamless)
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


def default_skybox(size: int = 64) -> torch.Tensor:
    """Procedural skybox (tpt.env.default_skybox, numpy): vertical sky
    gradient, a warm sun disc and a dark ground.  f32[6, S, S, 3]."""
    s = size
    uv = (np.arange(s, dtype=np.float32) + 0.5) / s * 2.0 - 1.0
    sc, tc = np.meshgrid(uv, uv, indexing="xy")  # [S, S] each; row = t
    one = np.ones_like(sc)
    dirs = np.stack([
        np.stack([one, -tc, -sc]),    # +X: sc = -z, tc = -y
        np.stack([-one, -tc, sc]),    # -X
        np.stack([sc, one, tc]),      # +Y: sc = x, tc = z
        np.stack([sc, -one, -tc]),    # -Y
        np.stack([sc, -tc, one]),     # +Z
        np.stack([-sc, -tc, -one]),   # -Z
    ])                                # [6, 3, S, S]
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    dx, dy, dz = dirs[:, 0], dirs[:, 1], dirs[:, 2]

    horizon = np.array([0.82, 0.85, 0.95], np.float32)
    zenith = np.array([0.25, 0.45, 0.85], np.float32)
    ground = np.array([0.28, 0.25, 0.22], np.float32)
    h = np.clip(dy, 0.0, 1.0)[..., None]
    sky = horizon + (zenith - horizon) * np.sqrt(h)
    sun_dir = np.array([0.35, 0.45, 0.82], np.float32)
    sun_dir /= np.linalg.norm(sun_dir)
    cosang = dx * sun_dir[0] + dy * sun_dir[1] + dz * sun_dir[2]
    sun = np.clip((cosang - 0.997) / 0.003, 0.0, 1.0)[..., None] \
        * np.array([18.0, 15.0, 9.0], np.float32)
    glow = np.clip(cosang, 0.0, 1.0)[..., None] ** 32 \
        * np.array([0.9, 0.6, 0.25], np.float32)
    below = np.clip(-dy, 0.0, 1.0)[..., None]
    color = sky * (1.0 - below) + ground * below + (sun + glow) * (1.0 - below)
    return torch.from_numpy(color.astype(np.float32))


def srgb_to_linear(rgb):
    """Inverse gamma, exact shader formula (compute.glsl:366-369)."""
    rgb = torch.as_tensor(rgb, dtype=torch.float32)
    return torch.where(rgb < 0.04045, rgb / 12.92,
                       torch.pow((rgb + 0.055) / 1.055, 2.4))


def load_cubemap_files(paths, srgb: bool = True) -> torch.Tensor:
    """Load 6 image files (+X,-X,+Y,-Y,+Z,-Z order) into f32[6,S,S,3]
    (Helper.ParallelLoadCubemapImages, src/Helper.cs:18-50)."""
    if len(paths) != 6:
        raise ValueError("a cubemap needs exactly 6 face images")
    from PIL import Image
    faces = []
    for p in paths:
        with Image.open(p) as im:
            img = np.asarray(im.convert("RGB"), np.float32) / 255.0
        if img.shape[0] != img.shape[1]:
            raise ValueError(f"cubemap face {p} is not square: {img.shape}")
        faces.append(img)
    sizes = {f.shape[0] for f in faces}
    if len(sizes) != 1:
        raise ValueError(f"cubemap faces disagree in size: {sorted(sizes)}")
    stack = torch.from_numpy(np.stack(faces))
    return srgb_to_linear(stack) if srgb else stack


def bundled_skybox() -> torch.Tensor:
    """The 6-PNG sRGB skybox (tpt_torch/assets/EnvironmentMap/, the JAX
    package's asset files copied, read as files), or
    :func:`default_skybox` where the files are missing."""
    d = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets", "EnvironmentMap")
    paths = [os.path.join(d, f"{n}.png")
             for n in ("posx", "negx", "posy", "negy", "posz", "negz")]
    if all(os.path.exists(p) for p in paths):
        return load_cubemap_files(paths)
    return default_skybox()

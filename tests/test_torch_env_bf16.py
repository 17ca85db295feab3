"""The opt-in bf16 environment table (``--env-bf16``) of the port against
tpt's: the packed table bit for bit, its lookup, the plain environment
mode of the render block with it, its wrapper checks and the CLI flag.

Bars: the table bit for bit as uint32 (both packers round to nearest even
and put the even column in the low 16 bits); the lookup at the f32
sampler's bar (rtol = atol = 1e-6, tests/test_torch_env.py), though both
widen the texels exactly and blend in the same order; the render block at
tests/test_torch_render.py's bar (rtol 1e-3, atol 1e-4)."""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpt import camera as jcam
from tpt import env as jenv
from tpt import progressive as jprog
from tpt.kernels.render import progressive_frames as jprogressive_frames
from tpt.scene import cornell_scene
from tpt_torch import cli, env as tenv, progressive as tprog
from tpt_torch.kernels import trace as K
from tpt_torch.kernels.render import progressive_frames

from test_torch_env import TOL, directions, faces
from test_torch_integrator import CORNELL_CAM, to_torch_scene
from test_torch_render import assert_image_close

torch.set_num_threads(1)
BF16 = torch.bfloat16


def packed(f, seamless=False):
    """(the port's bf16 table, tpt's), each f32[6 (S + 2)^2, 6]."""
    got = tenv.pack_block_table(torch.from_numpy(f), dtype=BF16, seamless=seamless)
    want = np.asarray(jenv.pack_block_table(jnp.asarray(f), dtype=jnp.bfloat16,
                                            seamless=seamless))
    return got, want


@pytest.mark.parametrize("seamless", [False, True])
def test_bf16_table_matches_tpt_bit_for_bit(seamless):
    # texels over a wide range, with ties at the rounding point
    f = faces() * np.float32(40.0)
    f[0, 0, 0] = np.array([1 + 2 ** -8, 1 + 3 * 2 ** -8, 3.0], np.float32)
    got, want = packed(f, seamless)
    assert got.dtype == torch.float32 and tuple(got.shape) == (6 * 10 ** 2, 6)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want.view(np.uint32))
    # word j holds texel 2j in its low half: the f32 table's values, rounded
    f32 = tenv.pack_block_table(torch.from_numpy(f), seamless=seamless)
    np.testing.assert_array_equal(got.view(BF16).float().numpy(),
                                  f32.to(BF16).float().numpy())


@pytest.mark.parametrize("seamless", [False, True])
def test_bf16_lookup_matches_tpt(seamless):
    got_table, want_table = packed(faces(), seamless)
    d = directions()
    got = tenv.sample_environment_blocked(got_table, torch.from_numpy(d))
    want = np.asarray(jenv.sample_environment_blocked(jnp.asarray(want_table), jnp.asarray(d)))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert np.isfinite(got.numpy()).all()
    # against the f32 table: the texels' rounding only (8-bit mantissa)
    f32 = tenv.sample_environment_blocked(
        tenv.pack_block_table(torch.from_numpy(faces()), seamless=seamless),
        torch.from_numpy(d))
    np.testing.assert_allclose(got.numpy(), f32.numpy(), rtol=2 ** -8, atol=1e-6)


def test_bf16_block_matches_tpt():
    """The render block in the environment mode's plain version with the
    bf16 table, against tpt.kernels.render.progressive_frames with tpt's
    bf16 table, on an environment that varies."""
    W, H = 32, 24
    f = faces(8, seed=4) * np.float32(2.0)
    js = cornell_scene().build()
    inv_p, inv_v, _ = jcam.camera_matrices(CORNELL_CAM, W, H)
    focal, ap = CORNELL_CAM.focal_length, CORNELL_CAM.aperture_diameter
    kw = dict(width=W, height=H, ray_depth=4, spp=1, n_frames=3)
    got_table, want_table = packed(f)
    want, want_rays = jprogressive_frames(
        jprog.init_accumulator(H, W), js, jnp.asarray(want_table), inv_p, inv_v,
        jnp.int32(0), jnp.float32(focal), jnp.float32(ap), **kw)
    launches = K.LAUNCHES
    got, rays = progressive_frames(tprog.init_accumulator(H, W), to_torch_scene(js), got_table,
                                   np.asarray(inv_p), np.asarray(inv_v), 0, focal, ap, **kw)
    assert K.LAUNCHES == launches                   # the CPU runs the plain version
    assert got.frame == int(want.frame) == 3
    assert abs(int(rays) - int(want_rays)) <= 0.001 * int(want_rays)
    assert_image_close(got.image, want.image, rtol=1e-3, atol=1e-4)
    # the f32 table's block differs by the texels' rounding only
    f32, _ = progressive_frames(tprog.init_accumulator(H, W), to_torch_scene(js),
                                tenv.pack_block_table(torch.from_numpy(f)), np.asarray(inv_p),
                                np.asarray(inv_v), 0, focal, ap, **kw)
    rel = float((got.image - f32.image).abs().mean() / f32.image.abs().mean())
    assert 0.0 < rel < 2 ** -8


def misaligned(t, offset_words):
    buf = torch.zeros(t.numel() + 4)
    out = buf[offset_words:offset_words + t.numel()].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("words,align", sorted(K.ENV_ROW_ALIGN.items()))
def test_wrapper_takes_each_width_at_its_own_alignment(words, align):
    """The f32 table's rows start on 16 bytes, the bf16 table's on 8: an
    f32 table 8 bytes off is refused, a bf16 one taken; 4 bytes off, both
    are refused."""
    table = tenv.pack_block_table(torch.from_numpy(faces(4)),
                                  dtype=BF16 if words == 6 else torch.float32)
    assert table.shape[1] == words
    assert K._check_env_table(table, table.device) == (4, words == 6)
    if align == 8:   # 8 bytes past a 16-byte boundary
        assert K._check_env_table(misaligned(table, 2), table.device) == (4, True)
    for offset in ((1, 2) if align == 16 else (1,)):
        with pytest.raises(ValueError, match=f"{align}-byte"):
            K._check_env_table(misaligned(table, offset), table.device)


def test_cli_render_env_bf16_cpu(tmp_path):
    out = os.path.join(tmp_path, "bf16.png")
    ckpt = os.path.join(tmp_path, "bf16.npz")
    base = ["render", "--device", "cpu", "--width", "16", "--height", "16", "--frames", "2",
            "--chunk", "2", "--ray-depth", "4", "--atmosphere-size", "16", "--isteps", "4",
            "--jsteps", "2", "--checkpoint", ckpt]
    assert cli.main(base + ["--env-bf16", "--out", out]) == 0
    with open(out, "rb") as fh:
        assert fh.read(8) == b"\x89PNG\r\n\x1a\n"
    bf16 = tprog.load_checkpoint(ckpt)
    assert bf16.frame == 2 and np.isfinite(bf16.image.numpy()).all()
    assert cli.main(base + ["--out", out]) == 0
    f32 = tprog.load_checkpoint(ckpt).image
    assert float((bf16.image - f32).abs().max()) <= 2 ** -7 * float(f32.abs().max())

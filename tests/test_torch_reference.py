"""tpt_torch.reference, the oracle renderer, against tpt.reference and the
NumPy transcription of the shader (tests/numpy_oracle.py), its vmap form,
and ``cli render --backend oracle`` against tpt.cli's.

Bars: an image agrees at rtol 1e-3 / atol 1e-4 (tests/test_torch_render.py)
with tpt's and at rtol = atol = 2e-4 (tests/test_oracle.py) with the NumPy
oracle's, on all but a stated count of pixels whose path decisions flipped
(JAX contracts a*b+c on the CPU, NumPy computes in another order; observed
0 of 1024 for each case).  The vmap form equals the batched one bit for
bit; the PNGs of the two CLIs differ by at most one level."""

import functools
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpt import camera as jcam
from tpt import cli as jcli
from tpt import reference as jref
from tpt import scene as jscene
from tpt.env import constant_environment as jconst_env
from tpt_torch import CameraConfig, cli, reference
from tpt_torch.camera import camera_matrices
from tpt_torch.config import RenderConfig
from tpt_torch.env import constant_environment
from tpt_torch.progressive import init_accumulator

import numpy_oracle as npo
from test_torch_integrator import CORNELL_CAM, to_torch_scene
from test_torch_render import assert_image_close

torch.set_num_threads(1)
ENV = (0.3, 0.45, 0.6)
SIZE, SPP = 32, 2
# scene, camera (both with depth of field), depth, frame
CASES = {"cornell": ("cornell_scene", CORNELL_CAM, 4, 3),
         "demo": ("demo_scene", CameraConfig(), 6, 1)}


@functools.lru_cache(maxsize=None)
def rendered(case):
    """(the port's image, its rays, the JAX scene, the camera matrices)."""
    name, cam, depth, frame = CASES[case]
    js = getattr(jscene, name)().build()
    ip, iv, pos = camera_matrices(cam, SIZE, SIZE)
    img, rays = reference.render_fields(
        to_torch_scene(js), constant_environment(ENV), ip, iv, pos, frame, cam.focal_length,
        cam.aperture_diameter, width=SIZE, height=SIZE, ray_depth=depth, spp=SPP)
    return img.numpy(), int(rays), js, (ip, iv, pos)


@pytest.mark.parametrize("case", list(CASES))
def test_render_fields_matches_tpt(case):
    name, cam, depth, frame = CASES[case]
    got, rays, js, _ = rendered(case)
    ip, iv, pos = jcam.camera_matrices(cam, SIZE, SIZE)
    want, want_rays = jref.render_fields(
        js, jconst_env(ENV), ip, iv, pos, jnp.int32(frame), jnp.float32(cam.focal_length),
        jnp.float32(cam.aperture_diameter), width=SIZE, height=SIZE, ray_depth=depth, spp=SPP)
    assert got.shape == (SIZE, SIZE, 3) and rays == int(want_rays)
    assert_image_close(got, want, rtol=1e-3, atol=1e-4, max_bad=2)


@pytest.mark.parametrize("case", list(CASES))
def test_render_fields_matches_numpy_oracle(case):
    name, cam, depth, frame = CASES[case]
    got, _, js, (ip, iv, pos) = rendered(case)
    color = np.asarray(ENV, np.float32)
    want = npo.render(npo.scene_from_tpt(js), lambda _d: color, ip.numpy(), iv.numpy(),
                      pos.numpy(), SIZE, SIZE, frame, depth, SPP, cam.focal_length,
                      cam.aperture_diameter)
    assert_image_close(got, want, rtol=2e-4, atol=2e-4, max_bad=2)


def test_render_fields_vmap_equals_render_fields():
    js = jscene.cornell_scene().build()
    ip, iv, pos = camera_matrices(CORNELL_CAM, 8, 8)
    args = (to_torch_scene(js), constant_environment(ENV), ip, iv, pos, 2,
            CORNELL_CAM.focal_length, CORNELL_CAM.aperture_diameter)
    kw = dict(width=8, height=8, ray_depth=4, spp=2)
    a, ra = reference.render_fields(*args, **kw)
    b, rb = reference.render_fields_vmap(*args, **kw)
    assert int(ra) == int(rb) > 0
    np.testing.assert_array_equal(a.numpy().view(np.int32), b.numpy().view(np.int32))


def test_render_progressive_accumulates_frames():
    js = jscene.cornell_scene().build()
    scene, env = to_torch_scene(js), constant_environment(ENV)
    cfg = RenderConfig(width=8, height=6, ray_depth=3, spp=1)
    state, rays = reference.render_progressive(scene, env, CORNELL_CAM, cfg,
                                               init_accumulator(6, 8), 3)
    frames = [reference.render_frame(scene, env, CORNELL_CAM, cfg, f) for f in range(3)]
    assert state.frame == 3 and rays == sum(int(r) for _, r in frames)
    mean = (frames[0][0] + frames[1][0] + frames[2][0]) / 3
    np.testing.assert_allclose(state.image.numpy(), mean.numpy(), rtol=1e-6, atol=1e-7)


def read_png(path):
    from PIL import Image
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), np.int16)


def test_cli_oracle_matches_tpt_cli(tmp_path):
    """``render --backend oracle`` at 16^2 on the CPU, the PNG against
    tpt.cli's from the same flags."""
    flags = ["--width", "16", "--height", "16", "--frames", "2", "--ray-depth", "5",
             "--env", "constant", "--backend", "oracle"]
    got, want = os.path.join(tmp_path, "port.png"), os.path.join(tmp_path, "tpt.png")
    assert cli.main(["render", "--device", "cpu", *flags, "--out", got]) == 0
    assert jcli.main(["render", "--platform", "cpu", *flags, "--out", want]) == 0
    a, b = read_png(got), read_png(want)
    assert a.shape == b.shape == (16, 16, 3)
    assert np.abs(a - b).max() <= 1

"""The port's render slice as a whole: progressive_frames against the JAX
package's, the committed golden image, checkpoints shared across the two
packages, the CLI, and the port's independence from JAX."""

import os
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpt import camera as jcam
from tpt import progressive as jprog
from tpt.env import constant_environment as jconst_env
from tpt.env import pack_block_table as jpack
from tpt.kernels.render import progressive_frames as jprogressive_frames
from tpt.scene import cornell_scene
from tpt_torch import CameraConfig, demo_scene
from tpt_torch import cli, progressive as tprog
from tpt_torch.camera import camera_matrices
from tpt_torch.config import AtmosphereConfig
from tpt_torch.env import constant_environment, pack_block_table
from tpt_torch.kernels.render import progressive_frames, render_fields
from tpt_torch.sky import compute_atmosphere

from test_torch_integrator import CORNELL_CAM, to_torch_scene

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_PATH = os.path.join(REPO, "tests", "golden", "demo_512.npz")
ENV = (0.3, 0.45, 0.6)
W, H = 32, 24


def assert_image_close(got, want, rtol, atol, max_bad=0):
    """Images agree at (rtol, atol) on all but ``max_bad`` pixels: a pixel
    whose path decisions flipped between JAX on the CPU and the port
    differs by a whole sample (tests/test_torch_integrator.py)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    bad = ~(np.abs(got - want) <= atol + rtol * np.abs(want)).all(-1)
    assert bad.sum() <= max_bad, f"{bad.sum()} of {bad.size} pixels differ"


@pytest.mark.parametrize("blocks", [(3,), (1, 1, 1)])
def test_progressive_frames_matches_jax(blocks):
    """One 3-frame block (the refill kernel's path) or three 1-frame blocks
    (the per-frame kernel's path) against the JAX package's 3-frame call."""
    js = cornell_scene().build()
    inv_p, inv_v, _ = jcam.camera_matrices(CORNELL_CAM, W, H)
    focal, ap = CORNELL_CAM.focal_length, CORNELL_CAM.aperture_diameter
    kw = dict(width=W, height=H, ray_depth=4, spp=1, n_frames=3)
    want, want_rays = jprogressive_frames(
        jprog.init_accumulator(H, W), js, jpack(jconst_env(ENV)), inv_p, inv_v,
        jnp.int32(0), jnp.float32(focal), jnp.float32(ap), **kw)
    got = tprog.init_accumulator(H, W)
    image = got.image
    scene, table = to_torch_scene(js), pack_block_table(constant_environment(ENV))
    rays = 0
    for n in blocks:
        got, r = progressive_frames(got, scene, table, np.asarray(inv_p), np.asarray(inv_v),
                                    got.frame, focal, ap, **dict(kw, n_frames=n))
        rays += int(r)
    assert got.image is image                     # updated in place
    assert got.frame == int(want.frame) == 3
    assert abs(int(rays) - int(want_rays)) <= 0.001 * int(want_rays)
    assert_image_close(got.image, want.image, rtol=1e-3, atol=1e-4)


def test_progressive_frames_n_valid_tail():
    scene = demo_scene().build()
    inv_p, inv_v, _ = camera_matrices(CameraConfig(), 16, 16)
    table = pack_block_table(constant_environment(ENV))
    kw = dict(width=16, height=16, ray_depth=13, spp=1)
    full, rays_full = progressive_frames(tprog.init_accumulator(16, 16), scene, table,
                                         inv_p, inv_v, 7, 20.0, 0.14, n_frames=2, **kw)
    tail, rays_tail = progressive_frames(tprog.init_accumulator(16, 16), scene, table,
                                         inv_p, inv_v, 7, 20.0, 0.14, n_frames=4,
                                         n_valid=2, **kw)
    assert tail.frame == full.frame == 2 and int(rays_tail) == int(rays_full)
    np.testing.assert_array_equal(tail.image.numpy(), full.image.numpy())


def test_render_frame_equals_render_fields():
    from tpt_torch.config import RenderConfig
    from tpt_torch.kernels.render import render_frame
    cam, cfg = CameraConfig(), RenderConfig(width=16, height=12, spp=2)
    env = constant_environment(ENV)
    inv_p, inv_v, pos = camera_matrices(cam, 16, 12)
    a, ra = render_frame(demo_scene().build(), env, cam, cfg, 4)
    b, rb = render_fields(demo_scene().build(), env, inv_p, inv_v, pos, 4,
                          cam.focal_length, cam.aperture_diameter, width=16, height=12,
                          ray_depth=13, spp=2)
    assert a.shape == (12, 16, 3) and int(ra) == int(rb)
    np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_golden_demo_512():
    """The committed 512^2 golden frame (tests/test_golden.py) rendered by
    the port, at the golden tolerance atol 5e-3 / rtol 2e-3.  27 of the
    262144 pixels take another path than in the JAX render (a flipped
    decision, off by up to 4.3); at most 32 may."""
    want = np.load(GOLDEN_PATH)["image"].astype(np.float32)
    cam = CameraConfig()
    inv_p, inv_v, pos = camera_matrices(cam, 512, 512)
    env = compute_atmosphere(AtmosphereConfig(size=32))
    img, rays = render_fields(demo_scene().build(), env, inv_p, inv_v, pos, 0,
                              cam.focal_length, cam.aperture_diameter,
                              width=512, height=512, ray_depth=13, spp=1)
    assert int(rays) > 512 * 512
    assert np.isfinite(img.numpy()).all()
    assert_image_close(img, want, rtol=2e-3, atol=5e-3, max_bad=32)


def test_checkpoints_cross_packages(tmp_path):
    r = np.random.default_rng(3)
    frame_a = r.random((H, W, 3)).astype(np.float32)
    frame_b = r.random((H, W, 3)).astype(np.float32)
    jstate = jprog.accumulate(jprog.init_accumulator(H, W), jnp.asarray(frame_a))
    path = os.path.join(tmp_path, "jax.npz")
    jprog.save_checkpoint(path, jstate)
    tstate = tprog.load_checkpoint(path)
    assert tstate.frame == 1
    tstate = tprog.accumulate(tstate, torch.from_numpy(frame_b))
    jstate = jprog.accumulate(jstate, jnp.asarray(frame_b))
    np.testing.assert_array_equal(tstate.image.numpy(), np.asarray(jstate.image))
    back = os.path.join(tmp_path, "torch.npz")
    tprog.save_checkpoint(back, tstate)
    jback = jprog.load_checkpoint(back)
    assert int(jback.frame) == 2
    np.testing.assert_array_equal(np.asarray(jback.image), tstate.image.numpy())
    assert tprog.samples_per_pixel(tprog.reset(tstate), 2) == 0


def test_cli_render_cpu(tmp_path):
    out = os.path.join(tmp_path, "out.png")
    ckpt = os.path.join(tmp_path, "state.npz")
    base = ["render", "--device", "cpu", "--width", "32", "--height", "32",
            "--atmosphere-size", "16", "--isteps", "8", "--jsteps", "4",
            "--chunk", "2", "--checkpoint", ckpt]
    assert cli.main(base + ["--frames", "3", "--out", out]) == 0
    with open(out, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    state = tprog.load_checkpoint(ckpt)
    assert state.frame == 3 and np.isfinite(state.image.numpy()).all()
    assert float(state.image.mean()) > 0.0
    assert cli.main(base + ["--frames", "2", "--resume", ckpt, "--out", out]) == 0
    assert tprog.load_checkpoint(ckpt).frame == 5
    # the bf16 table and the oracle backend run (tests/test_torch_env_bf16.py
    # and tests/test_torch_reference.py hold them to tpt)
    assert cli.main(base + ["--frames", "1", "--env-bf16", "--out", out]) == 0
    assert tprog.load_checkpoint(ckpt).frame == 1
    assert cli.main(base + ["--frames", "1", "--backend", "oracle", "--out", out]) == 0
    assert tprog.load_checkpoint(ckpt).frame == 1
    with pytest.raises(SystemExit):            # tpt.cli's two backends only
        cli.main(base + ["--frames", "1", "--backend", "xla", "--out", out])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["render", "--device", "cuda", "--frames", "1", "--out", out])


def test_port_imports_no_jax():
    code = ("import sys; import tpt_torch, tpt_torch.cli, tpt_torch.kernels.render, "
            "tpt_torch.kernels.trace, tpt_torch.sky, tpt_torch.reference, "
            "tpt_torch.silhouette, tpt_torch.silhouette_demo, tpt_torch.pick; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m == 'tpt' or m.startswith('tpt.')]; assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)

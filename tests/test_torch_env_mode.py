"""The trace kernel's environment mode, the block path's launch, on the CPU.

``trace_progressive(..., env_table=...)`` adds each sample's environment
term when the sample ends (``radiance + miss_thr * env(miss_dir)``) and
keeps no miss slots.  Its plain version is held here to the route it
replaces: the slot mode followed by one ``sample_environment_blocked``
fetch per slot, summed after the emission radiance (the JAX package's
order, tpt/kernels/render.py:110-113).  Seeds and ray counts must match
exactly; the sums at rtol 1e-5 / atol 1e-6, since only their order
differs.  On the card the kernel is held to this plain version bit for bit
(tests/test_torch_cuda.py, chip_smoke.py)."""

import functools

import numpy as np
import pytest
import torch

from tpt_torch import CameraConfig, demo_scene
from tpt_torch.camera import camera_matrices
from tpt_torch.config import AtmosphereConfig
from tpt_torch.env import (constant_environment, default_skybox, pack_block_table,
                           sample_environment_blocked)
from tpt_torch.kernels import trace as K
from tpt_torch.sky import compute_atmosphere

torch.set_num_threads(1)

ENVS = {
    "constant": lambda: constant_environment((0.3, 0.45, 0.6)),
    "atmosphere 32^2": lambda: compute_atmosphere(AtmosphereConfig(size=32)),
    "cubemap 8^2": lambda: default_skybox(8),
}
CASES = {
    "n_valid tail": dict(width=32, height=24, spp=1, n_frames=4, n_valid=3),
    "spp 2, no rr, center": dict(width=24, height=16, spp=2, n_frames=2, rr=False,
                                 jitter="center"),
    "row band": dict(width=32, height=32, spp=1, n_frames=3, n_rows=8, row0=20),
}


@functools.lru_cache(maxsize=None)
def env_table(name):
    return pack_block_table(ENVS[name]())


def setup(width, height):
    cam = CameraConfig()
    inv_p, inv_v, _ = camera_matrices(cam, width, height)
    return demo_scene().build(), inv_p, inv_v, cam.focal_length, cam.aperture_diameter


@pytest.mark.parametrize("env", list(ENVS))
@pytest.mark.parametrize("case", list(CASES))
def test_env_mode_matches_the_slot_route(case, env):
    kw = dict(CASES[case], ray_depth=13)
    scene, ip, iv, focal, ap = setup(kw["width"], kw["height"])
    table = env_table(env)
    launches = K.LAUNCHES
    got = K.trace_progressive(scene, ip, iv, 5, focal, ap, env_table=table, **kw)
    assert K.LAUNCHES == launches                  # the CPU runs the plain version
    assert got.miss_dir is None and got.miss_thr is None

    old = K.trace_progressive(scene, ip, iv, 5, focal, ap, **kw)
    want = old.rad_sum
    for k in range(kw.get("n_valid", kw["n_frames"]) * kw["spp"]):
        want = want + old.miss_thr[k] * sample_environment_blocked(table, old.miss_dir[k])
    np.testing.assert_array_equal(got.seed.numpy(), old.seed.numpy())
    np.testing.assert_array_equal(got.ray_count.numpy(), old.ray_count.numpy())
    np.testing.assert_allclose(got.rad_sum.numpy(), want.numpy(), rtol=1e-5, atol=1e-6)
    assert float((want - old.rad_sum).abs().max()) > 0.01   # paths do escape
    assert tuple(got.rad_sum.shape) == (3, kw.get("n_rows", kw["height"]), kw["width"])


def misaligned(t):
    """``t``'s values, contiguous, 4 bytes past a 16-byte boundary."""
    buf = torch.zeros(t.numel() + 4)
    out = buf[1:1 + t.numel()].view(t.shape)
    out.copy_(t)
    return out


BAD_TABLES = {
    "f64": (lambda t: t.double(), "contiguous f32"),
    "11 columns": (lambda t: t[:, :11].contiguous(), "contiguous f32"),
    "a face short": (lambda t: t[:-9].contiguous(), "contiguous f32"),
    "1-d": (lambda t: t.reshape(-1), "contiguous f32"),
    "not contiguous": (lambda t: t.t().contiguous().t(), "contiguous f32"),
    "another device": (lambda t: t.to("meta"), "is on meta"),
    "misaligned": (misaligned, "16-byte"),
}


@pytest.mark.parametrize("bad", list(BAD_TABLES))
def test_wrapper_refuses_a_bad_env_table(bad):
    make, match = BAD_TABLES[bad]
    scene, ip, iv, focal, ap = setup(8, 8)
    table = make(env_table("constant"))
    kw = dict(width=8, height=8, ray_depth=3, spp=1, n_frames=2)
    with pytest.raises(ValueError, match=match):
        K.trace_progressive(scene, ip, iv, 0, focal, ap, env_table=table, **kw)
    with pytest.raises(ValueError, match=match):
        K.trace_progressive_plain(scene, ip, iv, 0, focal, ap, env_table=table, **kw)


def test_env_mode_never_falls_back_off_the_cpu():
    scene, ip, iv, focal, ap = setup(8, 8)
    with pytest.raises(ValueError, match="CUDA"):
        K.trace_progressive(scene.to("meta"), ip, iv, 0, focal, ap, width=8, height=8,
                            ray_depth=3, spp=1, n_frames=2,
                            env_table=env_table("constant").to("meta"))

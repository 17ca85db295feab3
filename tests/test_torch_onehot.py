"""The one-hot gather of tpt_torch.kernels.trace.trace on the CPU: against
the Pallas kernel it replaces (pallas_trace with gather="onehot", static
counts, in interpret mode with unroll=0, as the JAX package's own tests run
it on the CPU), and against the port's own select gather.

Against the JAX package the tolerances are those of
tests/test_torch_integrator.py (see its module doc): at Cornell 24x16 and
at demo 32x24, depth 4, no pixel flips or diverges, so none may.  Between
the port's two gathers every output is equal bit for bit: both read the
winner's values by index and take t from the fold."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpt import camera as jcam
from tpt.config import CameraConfig
from tpt.kernels.trace import pallas_trace
from tpt.scene import cornell_scene, demo_scene
from tpt_torch.kernels import trace as K

from test_torch_integrator import CORNELL_CAM, assert_parity, to_torch_scene

torch.set_num_threads(1)
CASES = {"cornell": (cornell_scene, CORNELL_CAM, 24, 16, 0, 0),
         "demo": (demo_scene, CameraConfig(), 32, 24, 0, 0)}
NAMES = ("radiance", "miss_dir", "miss_thr", "ray_count", "seed")


def setup(case):
    make, cam, w, h, _, _ = CASES[case]
    js = make().build()
    inv_p, inv_v, _ = jcam.camera_matrices(cam, w, h)
    ts = to_torch_scene(js)
    return js, ts, inv_p, inv_v, cam.focal_length, cam.aperture_diameter, w, h


def assert_bits_equal(got, want):
    for name in NAMES:
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if g.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        assert torch.equal(g, w), name


@pytest.mark.parametrize("case", list(CASES))
def test_onehot_matches_pallas_onehot(case):
    js, ts, ip, iv, focal, ap, w, h = setup(case)
    max_flipped, max_diverged = CASES[case][4:]
    counts = ts.counts
    kw = dict(width=w, height=h, ray_depth=4, spp=1, counts=counts, gather="onehot")
    want = pallas_trace(js, ip, iv, jnp.int32(3), jnp.float32(focal), jnp.float32(ap),
                        unroll=0, **kw)
    launches = (K.LAUNCHES, K.ONEHOT_LAUNCHES)
    got = K.trace(ts, np.asarray(ip), np.asarray(iv), 3, focal, ap, **kw)
    assert (K.LAUNCHES, K.ONEHOT_LAUNCHES) == launches   # the CPU runs the plain version
    assert tuple(got.miss_dir.shape) == (1, 3, h, w)
    assert_parity(got, want, max_flipped, max_diverged)


@pytest.mark.parametrize("case,spp,depth,rr,jitter", [("cornell", 2, 13, True, "corner"),
                                                      ("demo", 1, 8, False, "center")])
def test_onehot_plain_equals_select_plain(case, spp, depth, rr, jitter):
    _, ts, ip, iv, focal, ap, w, h = setup(case)
    kw = dict(width=w, height=h, ray_depth=depth, spp=spp, rr=rr, jitter=jitter,
              counts=ts.counts)
    onehot = K.trace_plain(ts, ip, iv, 5, focal, ap, gather="onehot", **kw)
    select = K.trace_plain(ts, ip, iv, 5, focal, ap, gather="select", **kw)
    assert_bits_equal(onehot, select)
    band = K.trace(ts, ip, iv, 5, focal, ap, gather="onehot", n_rows=4, row0=6, **kw)
    whole = K.trace(ts, ip, iv, 5, focal, ap, gather="select", **kw)
    assert torch.equal(band.radiance, whole.radiance[:, 6:10])
    assert torch.equal(band.seed, whole.seed[6:10])


def test_gather_value_errors():
    _, ts, ip, iv, focal, ap, w, h = setup("cornell")
    kw = dict(width=w, height=h, ray_depth=2, spp=1)
    for fn in (K.trace, K.trace_plain):
        with pytest.raises(ValueError, match="gather must be 'select' or 'onehot'"):
            fn(ts, ip, iv, 0, focal, ap, gather="mxu", counts=ts.counts, **kw)
        with pytest.raises(ValueError, match="requires static counts"):
            fn(ts, ip, iv, 0, focal, ap, gather="onehot", **kw)


def test_onehot_no_fallback_off_the_cpu():
    _, ts, ip, iv, focal, ap, w, h = setup("cornell")
    with pytest.raises(ValueError, match="CUDA"):
        K.trace(ts.to("meta"), ip, iv, 0, focal, ap, width=w, height=h, ray_depth=2, spp=1,
                counts=ts.counts, gather="onehot")

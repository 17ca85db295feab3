"""tpt_torch.integrator against tpt.integrator (XLA scan and gather).

Tolerances and why:

* integers (final seeds, ray counts) fix every discrete decision.  JAX on
  the CPU contracts a*b+c into a fused multiply-add and its
  sin/cos/exp/sqrt differ from PyTorch's CPU versions by one ulp in
  0.6-10% of values, so a roll or a closest-hit near-tie can flip on a
  rare pixel: a pixel whose seed or ray count differs is "flipped";
* radiance (emission picked up along the paths) at rtol = atol = 1e-5,
  the tests/test_kernel.py bar;
* the deferred miss slots at rtol 1e-3 / atol 1e-4, the tests/test_refill.py
  bar: the same ulp differences pass through ill-conditioned steps (the
  cosine lobe's normalize of a near-zero sum, refraction near grazing,
  throughput / p with p near EPS without Russian roulette);
* a pixel that flipped or is beyond a float bar is "diverged".  Each case
  states how many pixels may flip and diverge, as absolute counts just
  above what it gives (observed flipped / diverged, of the pixels):

      trace_paths  cornell 24x16 spp 2 rr          0 / 0   of 384
      trace_paths  demo 64x64 rr corner            0 / 5   of 4096
      trace_paths  demo 64x64 no rr center         3 / 31  of 4096
      progressive  cornell 24x16 3 frames no rr    0 / 0   of 384
      progressive  demo 64x64 2 frames rr          1 / 12  of 4096
      tests/test_torch_trace.py, every case        0 / 0   of 384 or 192

  and every pixel that did not flip is within LOOSE_TOL (rtol = atol =
  5e-2) on every output, twice the largest error seen on one (0.023 in a
  miss direction, 1.4% of a miss throughput): a systematic error in the
  transport fails the counts or that bound.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tpt import camera as jcam
from tpt import scene as jscene
from tpt.config import CameraConfig
from tpt import integrator as jint
from tpt_torch import integrator as tint
from tpt_torch import scene as tscene
from tpt_torch.kernels.trace import pixel_band

torch.set_num_threads(1)

CORNELL_CAM = CameraConfig(position=(0.0, 0.5, 2.0), look_x=-90.0, look_y=-5.0,
                           focal_length=8.0, aperture_diameter=0.1)
RAD_TOL = dict(rtol=1e-5, atol=1e-5)
SLOT_TOL = dict(rtol=1e-3, atol=1e-4)
LOOSE_TOL = dict(rtol=5e-2, atol=5e-2)


def to_torch_scene(jax_scene, device="cpu"):
    return tscene.Scene.from_numpy([np.asarray(getattr(jax_scene, f))
                                    for f in tscene.FIELDS], device)


def _beyond(got, want, rtol, atol, n_lead):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    bad = ~(np.abs(got - want) <= atol + rtol * np.abs(want))
    return bad.reshape((-1,) + bad.shape[n_lead:]).any(0)


def assert_parity(got, want, max_flipped, max_diverged,
                  names=("radiance", "miss_dir", "miss_thr")):
    """``got``/``want``: TraceResult or ProgressiveTraceResult of the port
    and of the JAX package over the same pixels; at most ``max_flipped``
    pixels flipped and ``max_diverged`` diverged (see the module doc)."""
    seed_ok = np.asarray(got.seed).astype(np.uint64) == np.asarray(want.seed).astype(np.uint64)
    rays_ok = np.asarray(got.ray_count) == np.asarray(want.ray_count)
    flipped = ~(seed_ok & rays_ok)
    assert flipped.sum() <= max_flipped, f"{flipped.sum()} of {flipped.size} pixels flipped"
    diverged = flipped.copy()
    for name in names:
        tol = RAD_TOL if name in ("radiance", "rad_sum") else SLOT_TOL
        g, w = getattr(got, name), getattr(want, name)
        assert tuple(g.shape) == tuple(np.shape(w)), name
        n_lead = np.ndim(w) - flipped.ndim
        far = _beyond(g, w, n_lead=n_lead, **LOOSE_TOL) & ~flipped
        assert not far.any(), f"{name}: {far.sum()} pixels that did not flip are beyond {LOOSE_TOL}"
        diverged |= _beyond(g, w, n_lead=n_lead, **tol)
    assert diverged.sum() <= max_diverged, \
        f"{diverged.sum()} of {diverged.size} pixels diverged"


def setup(scene_name, cam_cfg, width, height):
    js = getattr(jscene, scene_name)().build()
    inv_p, inv_v, _ = jcam.camera_matrices(cam_cfg, width, height)
    jcp = jint.camera_params(inv_p, inv_v, jnp.float32(cam_cfg.focal_length),
                             jnp.float32(cam_cfg.aperture_diameter))
    jtrace = jint.compose_trace_fn(jint.make_scene_scan_fn(js),
                                   jint.make_xla_gather_fn(js))
    ts = to_torch_scene(js)
    tcp = tint.camera_params(np.asarray(inv_p), np.asarray(inv_v),
                             cam_cfg.focal_length, cam_cfg.aperture_diameter)
    px, py = pixel_band(width, height, height, 0, "cpu")
    return (jtrace, jcp), (tint.make_scene_trace_fn(ts), tcp), px, py


PER_FRAME = [
    ("cornell_scene", CORNELL_CAM, 24, 16, 2, True, "corner", 0, 0),
    ("demo_scene", CameraConfig(), 64, 64, 1, True, "corner", 4, 8),
    ("demo_scene", CameraConfig(), 64, 64, 1, False, "center", 4, 40),
]


@pytest.mark.parametrize(
    "scene_name,cam,width,height,spp,rr,jitter,max_flipped,max_diverged", PER_FRAME)
def test_trace_paths_matches_jax(scene_name, cam, width, height, spp, rr, jitter,
                                 max_flipped, max_diverged):
    (jtrace, jcp), (ttrace, tcp), px, py = setup(scene_name, cam, width, height)
    frame = 5
    want = jax.jit(lambda: jint.trace_paths(
        jtrace, jcp, jnp.asarray(px.numpy()), jnp.asarray(py.numpy()), width, height,
        jnp.int32(frame), 13, spp, jitter=jitter, russian_roulette=rr))()
    got = tint.trace_paths(ttrace, tcp, px, py, width, height, frame, 13, spp,
                           jitter=jitter, russian_roulette=rr)
    assert got.seed.dtype == torch.int64 and got.ray_count.dtype == torch.int32
    assert int(got.ray_count.sum()) > width * height
    assert_parity(got, want, max_flipped, max_diverged)


PROGRESSIVE = [
    ("cornell_scene", CORNELL_CAM, 24, 16, 1, 3, 2, False, "center", 0, 0),
    ("demo_scene", CameraConfig(), 64, 64, 1, 2, 2, True, "corner", 4, 16),
]


@pytest.mark.parametrize("scene_name,cam,width,height,spp,n_frames,n_valid,rr,jitter,"
                         "max_flipped,max_diverged", PROGRESSIVE)
def test_trace_progressive_matches_jax(scene_name, cam, width, height, spp, n_frames,
                                       n_valid, rr, jitter, max_flipped, max_diverged):
    (jtrace, jcp), (ttrace, tcp), px, py = setup(scene_name, cam, width, height)
    frame0 = 11
    want = jax.jit(lambda: jint.trace_progressive(
        jtrace, jcp, jnp.asarray(px.numpy()), jnp.asarray(py.numpy()), width, height,
        jnp.int32(frame0), 13, spp, n_frames, n_valid=jnp.int32(n_valid),
        jitter=jitter, russian_roulette=rr))()
    got = tint.trace_progressive(ttrace, tcp, px, py, width, height, frame0, 13, spp,
                                 n_frames, n_valid=n_valid, jitter=jitter,
                                 russian_roulette=rr)
    assert tuple(got.miss_dir.shape) == (n_frames * spp, 3, height, width)
    assert not got.miss_thr[n_valid * spp:].any()
    assert_parity(got, want, max_flipped, max_diverged,
                  names=("rad_sum", "miss_dir", "miss_thr"))


def test_refill_equals_per_frame_loop():
    """Within the port: the refill loop reproduces sequential trace_paths
    calls path for path — integers and miss slots exactly; the radiance sum
    adds the same samples in another grouping, so it matches at the refill
    bar."""
    _, (ttrace, tcp), px, py = setup("demo_scene", CameraConfig(), 32, 24)
    got = tint.trace_progressive(ttrace, tcp, px, py, 32, 24, 4, 13, 2, 3)
    rad = torch.zeros_like(got.rad_sum)
    rays = torch.zeros_like(got.ray_count)
    for f in range(3):
        res = tint.trace_paths(ttrace, tcp, px, py, 32, 24, 4 + f, 13, 2)
        rad, rays = rad + res.radiance, rays + res.ray_count
        for s in range(2):
            np.testing.assert_array_equal(got.miss_dir[2 * f + s], res.miss_dir[s])
            np.testing.assert_array_equal(got.miss_thr[2 * f + s], res.miss_thr[s])
    np.testing.assert_array_equal(got.seed.numpy(), res.seed.numpy())
    np.testing.assert_array_equal(got.ray_count.numpy(), rays.numpy())
    np.testing.assert_allclose(got.rad_sum, rad, **SLOT_TOL)


# the pixel that carries the 1080p training step's loss with Russian
# roulette off (demo scene, default camera, ray depth 13, 1 spp, frame 0;
# chip_smoke.py prints the pixel and its share of the loss on the card)
LOSS_PIXEL = (1524, 264)


def test_roulette_off_loss_pixel_matches_jax():
    """Without roulette a path's throughput grows by 1/p at every bounce (p
    floored at 1e-3), and the loss pixel's path escapes with a throughput
    above 1e6.  On its row's 16 pixels about it the port's transport holds
    to tpt's at this file's bars, the loss pixel not flipped and its miss
    throughput within the slot bar: the loss is the reference's transport,
    not a port fault."""
    x, y = LOSS_PIXEL
    (jtrace, jcp), (ttrace, tcp), _, _ = setup("demo_scene", CameraConfig(), 1920, 1080)
    px = torch.arange(x - 8, x + 8, dtype=torch.int32)[None]
    py = torch.full_like(px, y)
    want = jax.jit(lambda: jint.trace_paths(
        jtrace, jcp, jnp.asarray(px.numpy()), jnp.asarray(py.numpy()), 1920, 1080,
        jnp.int32(0), 13, 1, jitter="corner", russian_roulette=False))()
    got = tint.trace_paths(ttrace, tcp, px, py, 1920, 1080, 0, 13, 1, jitter="corner",
                           russian_roulette=False)
    assert_parity(got, want, 0, 0)
    thr = got.miss_thr[0, :, 0, 8]
    assert float(thr.max()) > 1e6, thr
    np.testing.assert_allclose(thr, np.asarray(want.miss_thr)[0, :, 0, 8], **SLOT_TOL)

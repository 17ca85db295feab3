"""Reverse mode of the port's transport maths against JAX's, on the CPU.

Three rules of the JAX package that the differentiable path needs:

* ``sqrt_clamped_grad``: the forward is ``sqrt`` to the bit, the derivative
  ``0.5 / sqrt(max(x, 1e-12))``, finite at 0 (tpt.vecmath);
* the camera is differentiable: the cotangents of ``primary_ray`` reach the
  20 camera/lens scalars and, through ``camera_params``, the 4x4 inverse
  matrices, while host floats still give the same rays to the bit;
* a maximum or minimum, also against a constant, gives half the cotangent to
  each side at a tie (``jnp.maximum``), where ``torch.clamp_min`` gives all
  of it to ``x``.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tpt import camera as jcam
from tpt import integrator as jint
from tpt import vecmath as jvec
from tpt.config import CameraConfig
from tpt.ops import intersect as jis
from tpt_torch import integrator as tint
from tpt_torch import vecmath as tvec
from tpt_torch.kernels.trace_grad import camera_params_from_vector, camera_vector
from tpt_torch.ops import intersect as tis

torch.set_num_threads(1)


def test_sqrt_clamped_grad_forward_bits_and_derivative():
    x = np.array([0.0, 1e-30, 1e-38, 1e-45, 1e-12, 0.25, 2.0, 3e38], np.float32)
    got = tvec.sqrt_clamped_grad(torch.tensor(x)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), np.sqrt(x).view(np.uint32))
    for v in (0.0, 1e-30, 0.25):
        t = torch.tensor(v, requires_grad=True)
        tvec.sqrt_clamped_grad(t).backward()
        want = float(jax.grad(jvec.sqrt_clamped_grad)(jnp.float32(v)))
        assert np.isfinite(t.grad.item())
        np.testing.assert_allclose(t.grad.item(), want, rtol=1e-6)


def test_ray_sphere_tangent_ray_has_a_finite_gradient():
    """A ray tangent to a sphere (disc == 0 exactly): the clamped sqrt
    derivative and the tie at max(disc, 0) give JAX's cotangents."""
    o, d, c = [0.0, 1.0, 0.0], [0.0, 0.0, 1.0], [0.0, 0.0, 5.0]

    def jt(o, d, c, r):
        t1, t2, _ = jis.ray_sphere(o[:, None], d[:, None], c[:, None], r)
        return jnp.sum(t1 + 2.0 * t2)

    want = jax.grad(jt, argnums=(0, 1, 2, 3))(*(jnp.asarray(v, jnp.float32) for v in (o, d, c)),
                                              jnp.float32(1.0))
    ts = [torch.tensor(v, requires_grad=True) for v in (o, d, c)] + [
        torch.tensor(1.0, requires_grad=True)]
    t1, t2, ok = tis.ray_sphere(ts[0][:, None], ts[1][:, None], ts[2][:, None], ts[3])
    assert bool(ok.all())
    (t1 + 2.0 * t2).sum().backward()
    for t, w in zip(ts, want):
        assert torch.isfinite(t.grad).all()
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("c", [0.0, 1e-12, 0.001, tis.FLOAT_MIN])
def test_max_const_splits_a_tie_like_jnp_maximum(c):
    x = torch.tensor([c, c + 1.0, c - 1.0], dtype=torch.float32, requires_grad=True)
    tvec.max_const(x, c).sum().backward()
    want = jax.grad(lambda v: jnp.sum(jnp.maximum(v, c)))(jnp.asarray(x.detach().numpy()))
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(want))
    assert x.grad[0].item() == 0.5 or c + 1.0 == c


def test_max3_and_slab_ties_split_like_jax():
    a = torch.tensor([[0.5], [0.5], [0.5]], requires_grad=True)
    tvec.max3(a).sum().backward()
    np.testing.assert_array_equal(a.grad.flatten().numpy(), [0.5, 0.25, 0.25])
    # a ray through a box corner region where two slabs tie
    o, d = [-1.0, -1.0, 0.5], [1.0, 1.0, 0.25]
    lo, hi = [0.0, 0.0, 0.0], [2.0, 2.0, 2.0]

    def jt(o, d, lo, hi):
        t1, t2, _ = jis.ray_cuboid(o[:, None], d[:, None], lo[:, None], hi[:, None])
        return jnp.sum(t1 + 3.0 * t2)

    want = jax.grad(jt, argnums=(0, 1, 2, 3))(*(jnp.asarray(v, jnp.float32)
                                                for v in (o, d, lo, hi)))
    ts = [torch.tensor(v, requires_grad=True) for v in (o, d, lo, hi)]
    t1, t2, _ = tis.ray_cuboid(*(t[:, None] for t in ts))
    (t1 + 3.0 * t2).sum().backward()
    for t, w in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=1e-6)


def test_normalize_floor_tie_like_jax():
    a = torch.tensor([[0.5], [0.0], [0.0]], requires_grad=True)   # dot(a, a) == eps
    tvec.normalize3(a, eps=0.25).sum().backward()
    want = jax.grad(lambda v: jnp.sum(jvec.normalize3(v, eps=np.float32(0.25))))(
        jnp.asarray([[0.5], [0.0], [0.0]], jnp.float32))
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(want), rtol=1e-6)


CAMS = {"aperture": CameraConfig(), "pinhole": CameraConfig(aperture_diameter=0.0)}


@pytest.mark.parametrize("jitter", ["corner", "center"])
@pytest.mark.parametrize("cam_name", list(CAMS))
def test_primary_ray_vjp_matches_jax(cam_name, jitter):
    cfg = CAMS[cam_name]
    w, h = 8, 6
    ip, iv, _ = jcam.camera_matrices(cfg, w, h)
    rng = np.random.default_rng(3)
    draws = [rng.uniform(0, 1, (h, w)).astype(np.float32) for _ in range(4)]
    ct_o, ct_d = (rng.normal(size=(3, h, w)).astype(np.float32) for _ in range(2))
    py, px = np.mgrid[0:h, 0:w].astype(np.float32)
    focal, ap = np.float32(cfg.focal_length), np.float32(cfg.aperture_diameter)

    def jray(ip, iv, f, a):
        cam = jint.camera_params(ip, iv, f, a)
        return jint.primary_ray(cam, jnp.asarray(px), jnp.asarray(py), w, h,
                                tuple(map(jnp.asarray, draws)), jitter)

    (jo, jd), vjp = jax.vjp(jray, ip, iv, jnp.float32(focal), jnp.float32(ap))
    want = vjp((jnp.asarray(ct_o), jnp.asarray(ct_d)))

    leaves = [torch.tensor(np.asarray(ip)).requires_grad_(True),
              torch.tensor(np.asarray(iv)).requires_grad_(True),
              torch.tensor(float(focal)).requires_grad_(True),
              torch.tensor(float(ap)).requires_grad_(True)]
    cam = tint.camera_params(*leaves)
    o, d = tint.primary_ray(cam, torch.tensor(px), torch.tensor(py), w, h,
                            tuple(map(torch.tensor, draws)), jitter)
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(d.detach().numpy(), np.asarray(jd), rtol=1e-6, atol=1e-6)
    got = torch.autograd.grad([o, d], leaves, [torch.tensor(ct_o), torch.tensor(ct_d)])
    # the focal length's cotangent is a small sum of cancelling terms (-9.6e-5,
    # 3.7e-8 apart from JAX's, which contracts FMAs on the CPU): the bar is
    # relative to the largest camera cotangent
    scale = max(float(np.abs(np.asarray(wv)).max()) for wv in want)
    for name, g, wv in zip(("inv_proj", "inv_view", "focal", "aperture"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wv), rtol=1e-4, atol=1e-5 * scale,
                                   err_msg=name)

    # the same 20 scalars through cam20: its cotangent is the matrices' entries
    cam20 = camera_vector(*leaves).detach().requires_grad_(True)
    o2, d2 = tint.primary_ray(camera_params_from_vector(cam20), torch.tensor(px),
                              torch.tensor(py), w, h, tuple(map(torch.tensor, draws)), jitter)
    (g20,) = torch.autograd.grad([o2, d2], [cam20], [torch.tensor(ct_o), torch.tensor(ct_d)])
    ip_g, iv_g = got[0].numpy(), got[1].numpy()
    want20 = ([ip_g[0, 0], ip_g[0, 1], ip_g[0, 2], ip_g[1, 0], ip_g[1, 1], ip_g[1, 2]]
              + [iv_g[r, c] for c in range(4) for r in range(3)]
              + [got[2].item(), got[3].item()])
    np.testing.assert_allclose(g20.numpy(), np.asarray(want20, np.float32), rtol=1e-6,
                               atol=1e-6)

    # host floats give the same rays to the bit
    host = tint.camera_params(np.asarray(ip), np.asarray(iv), cfg.focal_length,
                              cfg.aperture_diameter)
    o3, d3 = tint.primary_ray(host, torch.tensor(px), torch.tensor(py), w, h,
                              tuple(map(torch.tensor, draws)), jitter)
    np.testing.assert_array_equal(o3.numpy(), o.detach().numpy())
    np.testing.assert_array_equal(d3.numpy(), d.detach().numpy())

"""tpt_torch.diff against tpt.diff (tests/test_diff.py's checks), on the CPU.

The primal (the trace kernel's, the plain version here) must match the JAX
package's oracle at rtol 1e-5 / atol 1e-6 (Cornell 24x16, where no pixel
flips); the cotangents of every differentiable input (DiffInputs and the
inverse matrices) must match jax.grad through tpt.diff at the bar of
tests/test_diff.py, rtol 2e-3 / atol 2e-5, with the absolute bar raised to
2e-6 x the leaf's largest cotangent: two of the 4096 sphere-material
entries are near-zero sums of cancelling terms and came 2.27e-4 (8.0e-7 of
the leaf's 283) from JAX's, which contracts FMAs on the CPU and rounds its
transcendentals an ulp differently (tests/test_torch_integrator.py).
Finite differences check the emissive and the aperture as there."""

import numpy as np
import jax
import jax.numpy as jnp
import torch

from tpt import camera as jcam
from tpt import diff as jdiff
from tpt.env import constant_environment as jconst_env
from tpt.scene import cornell_scene
from tpt_torch.diff import DiffInputs, render_diff

from test_torch_integrator import CORNELL_CAM, to_torch_scene

torch.set_num_threads(1)
W, H, DEPTH, SPP = 24, 16, 3, 1
COUNTS = (4, 0)


def graded_env():
    env = np.zeros((6, 8, 8, 3), np.float32)
    env[..., 0] = np.linspace(0, 1, 8, dtype=np.float32)[None, :, None]
    env[..., 1] = np.linspace(0, 1, 8, dtype=np.float32)[None, None, :]
    env[..., 2] = 0.5
    return env


def setup(env=None):
    js = cornell_scene().build()
    inv_p, inv_v, _ = jcam.camera_matrices(CORNELL_CAM, W, H)
    env = np.asarray(jconst_env((0.3, 0.45, 0.6), size=4)) if env is None else env
    jd = jdiff.DiffInputs.from_scene(js, jnp.asarray(env), 8.0, 0.1)
    td = DiffInputs.from_scene(to_torch_scene(js), torch.tensor(env), 8.0, 0.1)
    return (jd, inv_p, inv_v), (td, torch.tensor(np.asarray(inv_p)),
                                torch.tensor(np.asarray(inv_v)))


def torch_render(d, ip, iv):
    return render_diff(d, ip, iv, 0, W, H, DEPTH, SPP, COUNTS)


def test_primal_matches_jax_oracle():
    (jd, jip, jiv), (td, tip, tiv) = setup()
    want = jdiff._oracle_image(jd, jip, jiv, jnp.int32(0), W, H, DEPTH, SPP, COUNTS)
    got = torch_render(td, tip, tiv)
    assert tuple(got.shape) == (H, W, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_gradients_match_jax():
    (jd, jip, jiv), (td, tip, tiv) = setup(graded_env())

    def jloss(d, ip, iv):
        return jnp.sum(jdiff._oracle_image(d, ip, iv, jnp.int32(0), W, H, DEPTH, SPP,
                                           COUNTS) ** 2)

    want = jax.grad(jloss, argnums=(0, 1, 2))(jd, jip, jiv)
    leaves = [t.clone().requires_grad_(True) for t in td]
    ip, iv = tip.clone().requires_grad_(True), tiv.clone().requires_grad_(True)
    (torch_render(DiffInputs(*leaves), ip, iv) ** 2).sum().backward()
    pairs = list(zip(DiffInputs._fields, [l.grad for l in leaves], want[0]))
    pairs += [("inv_proj", ip.grad, want[1]), ("inv_view", iv.grad, want[2])]
    for name, g, w in pairs:
        g, w = g.numpy(), np.asarray(w)
        assert np.isfinite(g).all(), name
        atol = max(2e-5, 2e-6 * float(np.abs(w).max()))
        np.testing.assert_allclose(g, w, rtol=2e-3, atol=atol, err_msg=name)
    assert float(leaves[5].grad.abs().sum()) > 0          # the environment's cotangent
    assert np.abs(leaves[0].grad.numpy()[:4]).sum() > 0   # real spheres move
    assert np.abs(leaves[0].grad.numpy()[4:]).sum() == 0  # padded slots stay zero


def test_emissive_gradient_finite_difference():
    """Emission never enters a discrete decision, so FD must match AD."""
    _, (td, tip, tiv) = setup()

    def loss(em):
        sm = td.sphere_material.clone()
        sm[3, 4] = em
        return torch_render(td._replace(sphere_material=sm), tip, tiv).sum()

    x0 = td.sphere_material[3, 4].clone().requires_grad_(True)
    loss(x0).backward()
    eps = 0.05
    with torch.no_grad():
        fd = (float(loss(x0 + eps)) - float(loss(x0 - eps))) / (2 * eps)
    np.testing.assert_allclose(x0.grad.item(), fd, rtol=2e-2)


def test_focal_aperture_gradients_finite_difference():
    """The thin-lens parameters are differentiable; the aperture's AD matches
    finite differences (a graded sky makes the environment term respond)."""
    _, (td, tip, tiv) = setup(graded_env())

    def loss(focal, aperture):
        d = td._replace(focal_length=focal, aperture_diameter=aperture)
        return (torch_render(d, tip, tiv) ** 2).sum()

    f = torch.tensor(8.0, requires_grad=True)
    a = torch.tensor(0.3, requires_grad=True)
    loss(f, a).backward()
    assert np.isfinite(f.grad.item()) and f.grad.item() != 0.0
    assert np.isfinite(a.grad.item()) and a.grad.item() != 0.0
    eps = 1e-2
    with torch.no_grad():
        fd = (float(loss(torch.tensor(8.0), torch.tensor(0.3 + eps)))
              - float(loss(torch.tensor(8.0), torch.tensor(0.3 - eps)))) / (2 * eps)
    np.testing.assert_allclose(a.grad.item(), fd, rtol=0.1)

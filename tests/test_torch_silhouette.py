"""tpt_torch.silhouette (and camera.eye_ray) against tpt.silhouette, and the
port's own forms of tests/test_silhouette.py's checks.

Bars and why:

* the geometry (eye_ray, forward_matrices, project_to_screen,
  silhouette_points) at rtol 1e-5: f32 on both sides, the same formulas;
* the boundary term and both modes of geometry_grad at 48^2, depth 2,
  n_edge 256 at rtol 1e-4, atol 1e-4 x the gradient's largest magnitude:
  the same edge rays take the same decisions, but torch's and XLA's
  transcendentals and reductions round differently (observed: 1e-10 on a
  largest entry of 6e-4);
* the analytic radius check at its 25% bar (tests/test_silhouette.py:122)
  and the finite-difference check in sign and to 35%, as there.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpt import camera as jcam
from tpt import silhouette as jsil
from tpt.materials import Material as JMaterial
from tpt.scene import SceneBuilder as JSceneBuilder
from tpt_torch import camera as tcam
from tpt_torch import silhouette as tsil
from tpt_torch.config import CameraConfig
from tpt_torch.env import constant_environment
from tpt_torch.integrator import (apply_environment, camera_params, make_scene_trace_fn,
                                  primary_ray, trace_paths)
from tpt_torch.materials import Material
from tpt_torch.scene import SceneBuilder

from test_torch_integrator import to_torch_scene

torch.set_num_threads(1)
GEOM = dict(rtol=1e-5, atol=1e-5)
CAM = CameraConfig(position=(0.0, 0.0, 6.0), look_x=-90.0, look_y=0.0, focal_length=8.0,
                   aperture_diameter=0.0)
ENV_COLOR = (0.15, 0.2, 0.3)
W = H = 96
DEPTH = 2


def sphere_scene(center=(0.0, 0.0, 0.0), radius=1.2, builder=SceneBuilder, material=Material):
    b = builder()
    b.add_sphere(center, radius, material.make(
        (0.85, 0.3, 0.2), (0, 0, 0), (0, 0, 0), 0.0, 0.0, 1.0, 0.0, 0.0))
    return b.build()


def env_faces(seed=3):
    """A cubemap that varies, so the interior term is not zero."""
    return np.random.default_rng(seed).uniform(0.05, 1.0, (6, 4, 4, 3)).astype(np.float32)


# ---- against tpt ----

def test_eye_ray_matches_tpt():
    ndc = np.random.default_rng(0).uniform(-1, 1, (5, 7, 2)).astype(np.float32)
    for cam in (CAM, CameraConfig()):
        ip, iv, pos = tcam.camera_matrices(cam, 64, 48)
        jip, jiv, jpos = jcam.camera_matrices(cam, 64, 48)
        o, d = tcam.eye_ray(ip, iv, pos, torch.from_numpy(ndc))
        jo, jd = jcam.eye_ray(jip, jiv, jpos, jnp.asarray(ndc))
        assert tuple(o.shape) == tuple(d.shape) == (5, 7, 3)
        np.testing.assert_allclose(o.numpy(), np.asarray(jo), **GEOM)
        np.testing.assert_allclose(d.numpy(), np.asarray(jd), **GEOM)


def test_projection_and_points_match_tpt():
    for cam in (CAM, CameraConfig()):
        proj, view = tsil.forward_matrices(cam, 64, 48)
        jproj, jview = jsil.forward_matrices(cam, 64, 48)
        np.testing.assert_allclose(proj.numpy(), np.asarray(jproj), **GEOM)
        np.testing.assert_allclose(view.numpy(), np.asarray(jview), **GEOM)
        pts = np.random.default_rng(1).uniform(-2, 2, (9, 3)).astype(np.float32)
        np.testing.assert_allclose(
            tsil.project_to_screen(proj, view, torch.from_numpy(pts), 64, 48).numpy(),
            np.asarray(jsil.project_to_screen(jproj, jview, jnp.asarray(pts), 64, 48)),
            rtol=1e-5, atol=1e-4)
    center = np.asarray([0.3, -0.2, -1.0], np.float32)
    eye = np.asarray(CAM.position, np.float32)
    phis = np.linspace(0.0, 2 * np.pi, 16, endpoint=False).astype(np.float32)
    for radius in (1.2, 0.4):
        got = tsil.silhouette_points(torch.from_numpy(center), radius, torch.from_numpy(eye),
                                     torch.from_numpy(phis))
        want = jsil.silhouette_points(jnp.asarray(center), radius, jnp.asarray(eye),
                                      jnp.asarray(phis))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **GEOM)


def grads_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


def grad_inputs(size=48):
    js = sphere_scene(builder=JSceneBuilder, material=JMaterial)
    rng = np.random.default_rng(2)
    rendered = rng.random((size, size, 3)).astype(np.float32)
    target = rng.random((size, size, 3)).astype(np.float32)
    return js, to_torch_scene(js), env_faces(), rendered, target


def test_sphere_silhouette_grad_matches_tpt():
    js, ts, faces, rendered, target = grad_inputs()
    kw = dict(sphere_idx=0, width=48, height=48, ray_depth=DEPTH, counts=(1, 0), n_edge=256)
    d_c, d_r = tsil.sphere_silhouette_grad(ts, CAM, torch.from_numpy(faces),
                                           torch.from_numpy(rendered),
                                           torch.from_numpy(target), 5, **kw)
    jd_c, jd_r = jsil.sphere_silhouette_grad(js, CAM, jnp.asarray(faces), jnp.asarray(rendered),
                                             jnp.asarray(target), 5, **kw)
    grads_close(np.append(d_c.numpy(), float(d_r)), np.append(np.asarray(jd_c), float(jd_r)))
    assert float(np.abs(np.asarray(jd_c)).max()) > 0


@pytest.mark.parametrize("interior", [True, False])
def test_geometry_grad_matches_tpt(interior):
    js, ts, faces, rendered, target = grad_inputs()
    kw = dict(width=48, height=48, ray_depth=DEPTH, counts=(1, 0), n_edge=256,
              interior=interior)
    got = tsil.geometry_grad(ts, CAM, torch.from_numpy(faces), torch.from_numpy(rendered),
                             torch.from_numpy(target), 5, [0], **kw)
    want = np.asarray(jsil.geometry_grad(js, CAM, jnp.asarray(faces), jnp.asarray(rendered),
                                         jnp.asarray(target), 5, [0], **kw))
    assert tuple(got.shape) == want.shape
    grads_close(got.numpy(), want)
    assert not got[1:].any()                       # rows outside the indices are zero
    boundary, _ = tsil.sphere_silhouette_grad(ts, CAM, torch.from_numpy(faces),
                                              torch.from_numpy(rendered),
                                              torch.from_numpy(target), 5, sphere_idx=0,
                                              width=48, height=48, ray_depth=DEPTH,
                                              counts=(1, 0), n_edge=256)
    inner = float((got[0, :3] - boundary).abs().max())
    assert (inner > 1e-3 * float(boundary.abs().max())) == interior


# ---- the port's own forms of tests/test_silhouette.py ----

def render(scene, frame=0, depth=DEPTH):
    ip, iv, _ = tcam.camera_matrices(CAM, W, H)
    cpar = camera_params(ip, iv, CAM.focal_length, 0.0)
    py = torch.arange(H, dtype=torch.int32)[:, None].expand(H, W)
    px = torch.arange(W, dtype=torch.int32)[None, :].expand(H, W)
    res = trace_paths(make_scene_trace_fn(scene, (1, 0)), cpar, px, py, W, H, frame, depth, 1,
                      russian_roulette=False)
    return torch.movedim(apply_environment(res, constant_environment(ENV_COLOR), 1), 0, -1)


def test_projection_matches_eye_rays():
    """project_to_screen inverts the tracer's eye-ray construction."""
    proj, view = tsil.forward_matrices(CAM, W, H)
    pts = torch.tensor([[0.5, -0.3, 0.2], [-1.0, 0.8, -1.5]])
    xy = tsil.project_to_screen(proj, view, pts, W, H)
    ip, iv, _ = tcam.camera_matrices(CAM, W, H)
    zero = xy[:, 0] * 0.0
    o, d = primary_ray(camera_params(ip, iv, CAM.focal_length, 0.0), xy[:, 0], xy[:, 1], W, H,
                       (zero, zero, zero, zero))
    for k in range(2):
        to_p = (pts[k] - o[:, k]).numpy()
        assert np.dot(to_p / np.linalg.norm(to_p), d[:, k].numpy()) > 0.99999


def test_silhouette_points_are_tangent():
    center = torch.tensor([0.3, -0.2, -1.0])
    eye = torch.tensor(CAM.position)
    p = tsil.silhouette_points(center, 1.2, eye, torch.linspace(0.0, 2 * np.pi, 17)[:-1])
    np.testing.assert_allclose(torch.linalg.vector_norm(p - center, dim=-1).numpy(), 1.2,
                               rtol=1e-5)
    np.testing.assert_allclose(((p - center) * (p - eye)).sum(-1).numpy(), 0.0, atol=1e-4)


def test_position_grad_matches_finite_difference():
    """Central finite difference of the matched-seed loss against the
    interior + boundary gradient for x: the sign and within 35%."""
    axis, delta = 0, 0.05
    scene = sphere_scene()
    target = render(sphere_scene(center=(0.25, 0.1, 0.0), radius=1.05))

    def loss_at(value):
        spr = scene.sphere_pos_radius.clone()
        spr[0, axis] = value
        img = render(dataclasses.replace(scene, sphere_pos_radius=spr))
        return float(torch.mean((img - target) ** 2))

    base = float(scene.sphere_pos_radius[0, axis])
    fd = (loss_at(base + delta) - loss_at(base - delta)) / (2 * delta)
    g = tsil.geometry_grad(scene, CAM, constant_environment(ENV_COLOR), render(scene), target, 0,
                           [0], width=W, height=H, ray_depth=DEPTH, counts=(1, 0), n_edge=1024)
    got = float(g[0, axis])
    assert np.sign(got) == np.sign(fd), (got, fd)
    assert abs(got - fd) < 0.35 * abs(fd), (got, fd)


def test_radius_grad_matches_analytic():
    """At depth 1 the image is exactly 0 inside the silhouette disc and the
    sky outside: dL/dr = 2 pi rho drho/dr sum(env^2) / (H W 3).  The
    boundary estimator lands within 25% of it."""
    r, rt = 1.2, 1.05
    scene = sphere_scene(radius=r)
    target = render(sphere_scene(radius=rt), depth=1)
    rendered = render(scene, depth=1)
    proj, view = tsil.forward_matrices(CAM, W, H)
    eye = torch.tensor(CAM.position)

    def rho_screen(rr):
        p = tsil.silhouette_points(torch.zeros(3), rr, eye,
                                   torch.linspace(0.0, 2 * np.pi, 65)[:-1])
        xy = tsil.project_to_screen(proj, view, p, W, H).numpy().astype(np.float64)
        return np.linalg.norm(xy - xy.mean(0), axis=1).mean()

    rho = rho_screen(r)
    drho = (rho_screen(r + 1e-3) - rho_screen(r - 1e-3)) / 2e-3
    want = 2 * np.pi * rho * drho * float(np.sum(np.square(ENV_COLOR))) / (H * W * 3)
    _d_c, d_r = tsil.sphere_silhouette_grad(scene, CAM, constant_environment(ENV_COLOR),
                                            rendered, target, 0, sphere_idx=0, width=W,
                                            height=H, ray_depth=1, counts=(1, 0), n_edge=2048)
    got = float(d_r)
    assert got > 0  # growing past the target radius increases the loss
    assert abs(got - want) < 0.25 * want, (got, want)


def test_boundary_term_dominates_interior_for_position():
    scene = sphere_scene()
    target = render(sphere_scene(center=(0.3, 0.0, 0.0)))
    rendered = render(scene)
    env = constant_environment(ENV_COLOR)
    g_full = tsil.geometry_grad(scene, CAM, env, rendered, target, 0, [0], width=W, height=H,
                                ray_depth=DEPTH, counts=(1, 0), n_edge=512)
    d_c, _ = tsil.sphere_silhouette_grad(scene, CAM, env, rendered, target, 0, sphere_idx=0,
                                         width=W, height=H, ray_depth=DEPTH, counts=(1, 0),
                                         n_edge=512)
    interior_x = float(g_full[0, 0]) - float(d_c[0])
    assert float(g_full[0, 0]) < 0.0   # the target sits at +x
    assert abs(float(d_c[0])) > abs(interior_x)


def test_silhouette_demo_runs_on_the_cpu():
    """A few steps of each of the demo's recoveries through its own code,
    at small sizes: finite errors in the result record, the position moved."""
    from tpt_torch import silhouette_demo
    cpu = torch.device("cpu")
    single = silhouette_demo.run_single(3, 24, 0.02, cpu, log=lambda _line: None)
    assert single["pos_err_before"] == 0.6727 and single["radius_err_before"] == 0.25
    assert single["pos_err_after"] != single["pos_err_before"]
    demo = silhouette_demo.run_demo(1, 16, 0.02, cpu, log=lambda _line: None)
    assert demo["size"] == 128 and demo["pos_err_before"] == 1.0
    assert np.isfinite([demo["pos_err_after"], single["radius_err_after"]]).all()

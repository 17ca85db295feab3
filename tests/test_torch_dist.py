"""tpt_torch.parallel against tpt.parallel: the properties of
tests/test_dist.py, each checked in one gloo world of 4 CPU ranks.

The world is started once for the module (``launch`` of
``tpt_torch.parallel.runs.run_jobs``): every job runs at its own (dp, sp)
layout and returns its assembled images, ray counts, losses and stepped
tables.  While the ranks run, the JAX package's sharded functions run on 4
of the conftest's 8 CPU devices for the layouts the port is held to
directly.  Bars: images against JAX at tests/test_torch_render.py's
(rtol 1e-3, atol 1e-4 a pixel), gradients at tests/test_torch_diff.py's
(rtol 2e-3, atol 2e-6 x the table's largest entry, at least 2e-5); between
two port runs the bars of tests/test_dist.py.
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tpt import camera as jcam
from tpt.config import CameraConfig as JCameraConfig, RenderConfig as JRenderConfig
from tpt.env import constant_environment as jconst_env
from tpt.parallel import (make_dist_renderer as jmake_dist_renderer, make_mesh as jmake_mesh,
                          make_train_step as jmake_train_step)
from tpt.scene import cornell_scene as jcornell_scene
from tpt_torch import CameraConfig, RenderConfig, cornell_scene, init_accumulator
from tpt_torch.camera import camera_matrices
from tpt_torch.env import constant_environment, pack_block_table
from tpt_torch.integrator import apply_environment_blocked
from tpt_torch.kernels.render import progressive_frames
from tpt_torch.kernels.trace import trace
from tpt_torch.parallel import (launch, make_dist_renderer, make_mesh, make_train_step,
                                trainable_filter_grads)
from tpt_torch.parallel.runs import run_jobs

from test_torch_render import assert_image_close

torch.set_num_threads(1)
ENV = (0.3, 0.45, 0.6)
CAM = dict(position=(0.0, 0.5, 2.0), look_x=-90.0, look_y=-5.0, focal_length=8.0,
           aperture_diameter=0.1)
DEMO = {"scene": "demo", "camera": {}}


def cfg(width=32, height=16, ray_depth=4, spp=1, jitter="corner"):
    return dict(width=width, height=height, ray_depth=ray_depth, spp=spp, jitter=jitter)


JOBS = {
    "dp_exact": dict(kind="render", dp=4, sp=1, cfg=cfg(), frames=[0, 1]),
    "nondivisible_sp": dict(kind="render", dp=2, sp=2, cfg=cfg(16, 11, 3)),
    "nondivisible_dp": dict(kind="render", dp=4, sp=1, cfg=cfg(16, 11, 3)),
    "sp4": dict(kind="render", dp=1, sp=4, cfg=cfg(), frames=[0, 1]),
    "descend": dict(kind="train", dp=2, sp=2, cfg=cfg(ray_depth=3), counts=(4, 0),
                    target="render", scale=[(3, 4, 7, 0.4)], steps=20, lr=20.0),
    "kernel_frame1": dict(kind="render", dp=2, sp=2, cfg=cfg(), frames=[1]),
    "oracle_frame1": dict(kind="render", dp=2, sp=2, cfg=cfg(), frames=[1], backend="oracle"),
    "center": dict(kind="render", dp=4, sp=1, cfg=cfg(32, 32, 3, 2, "center"), record=True,
                   setup={"camera": dict(CAM, aperture_diameter=0.05)}),
    "train_center": dict(kind="train", dp=2, sp=2, cfg=cfg(ray_depth=3, jitter="center"),
                         counts=(4, 5), lr=0.0, record=True),
    "rr_off_kernel": dict(kind="train", dp=2, sp=2, cfg=cfg(ray_depth=3), counts=(4, 5),
                          rr=False, lr=0.01),
    "rr_off_oracle": dict(kind="train", dp=2, sp=2, cfg=cfg(ray_depth=3), counts=(4, 5),
                          rr=False, lr=0.01, backend="oracle"),
    "demo_kernel": dict(kind="train", dp=2, sp=2, cfg=cfg(ray_depth=3), counts=(48, 7),
                        rr=False, lr=1.0, setup=DEMO),
    "demo_oracle": dict(kind="train", dp=2, sp=2, cfg=cfg(ray_depth=3), counts=(48, 7),
                        rr=False, lr=1.0, backend="oracle", setup=DEMO),
    "bands1": dict(kind="train", dp=2, sp=2, cfg=cfg(ray_depth=3), counts=(4, 5), rr=False,
                   lr=1.0, psum_bands=1),
    "bands2": dict(kind="train", dp=2, sp=2, cfg=cfg(ray_depth=3), counts=(4, 5), rr=False,
                   lr=1.0, psum_bands=2),
    "progressive_sp": dict(kind="progressive", dp=2, sp=2, cfg=cfg(128, 16, 3), n_frames=4,
                           blocks=2),
    "progressive_dp": dict(kind="progressive", dp=4, sp=1, cfg=cfg(128, 16, 3), n_frames=4,
                           blocks=2),
}


def jax_references():
    """The JAX package's sharded functions at (dp=2, sp=2) on 4 devices."""
    mesh = jmake_mesh(dp=2, sp=2, devices=jax.devices()[:4])
    cam = JCameraConfig(**CAM)
    scene = jcornell_scene().build()
    inv_p, inv_v, _ = jcam.camera_matrices(cam, 32, 16)
    env = jconst_env(ENV)
    image, rays = jmake_dist_renderer(mesh, JRenderConfig(**cfg()), backend="oracle")(
        scene, env, inv_p, inv_v, cam.focal_length, cam.aperture_diameter, 1)
    step = jmake_train_step(mesh, JRenderConfig(**cfg(ray_depth=3)), counts=(4, 5),
                            backend="oracle", russian_roulette=False)
    target = jnp.zeros((16, 32, 3), jnp.float32) + 0.25
    new, loss = step(scene, env, inv_p, inv_v, cam.focal_length, cam.aperture_diameter, 0,
                     target, 1.0)
    return {"image": np.asarray(image), "rays": int(rays), "loss": float(loss),
            "grads": (np.asarray(scene.sphere_material) - np.asarray(new.sphere_material),
                      np.asarray(scene.cuboid_material) - np.asarray(new.cuboid_material))}


@pytest.fixture(scope="module")
def world():
    setup = {"scene": "cornell", "camera": CAM, "env": ENV, "device": "cpu"}
    names = list(JOBS)
    with ThreadPoolExecutor(1) as ex:
        ranks = ex.submit(launch, run_jobs, 4, setup, [JOBS[n] for n in names], backend="gloo",
                          device="cpu", timeout=600)
        ref = jax_references()
        results = ranks.result()
    return {"jobs": dict(zip(names, results[0])), "ranks": results, "names": names, "jax": ref}


def single_frame(width, height, ray_depth, spp, frame, jitter="corner", cam=CAM):
    """The port's whole-frame render in this process: trace + the blocked
    environment fetch."""
    c = CameraConfig(**cam)
    ip, iv, _ = camera_matrices(c, width, height)
    res = trace(cornell_scene().build(), ip, iv, frame, c.focal_length, c.aperture_diameter,
                width=width, height=height, ray_depth=ray_depth, spp=spp, jitter=jitter)
    mean = apply_environment_blocked(res, pack_block_table(constant_environment(ENV)), spp)
    return torch.movedim(mean, 0, -1).numpy(), int(res.ray_count.sum())


def stepped_grads(res, lr):
    return tuple((start - res[k]) / lr for start, k in
                 zip(res["start"], ("sphere_material", "cuboid_material")))


def test_mesh_construction():
    mesh = make_mesh()
    assert mesh.shape == {"dp": 1, "sp": 1} and mesh.axis_names == ("dp", "sp")
    with pytest.raises(ValueError):
        make_mesh(dp=3, sp=2)


def test_single_process_renderer_is_the_whole_frame():
    """A world of one: the sharded renderer's collectives are identities and
    its band is the whole frame, bit for bit."""
    c = CameraConfig(**CAM)
    ip, iv, _ = camera_matrices(c, 32, 16)
    band, rays = make_dist_renderer(make_mesh(), RenderConfig(**cfg()))(
        cornell_scene().build(), constant_environment(ENV), ip, iv, c.focal_length,
        c.aperture_diameter, 0)
    want, want_rays = single_frame(32, 16, 4, 1, 0)
    np.testing.assert_array_equal(band.numpy(), want)
    assert int(rays) == want_rays


def test_dp_sharding_bit_exact(world):
    got = world["jobs"]["dp_exact"]
    for k, frame in enumerate((0, 1)):
        want, rays = single_frame(32, 16, 4, 1, frame)
        np.testing.assert_array_equal(got["images"][k], want)
        assert got["rays"][k] == rays


def test_dp_sharding_nondivisible_rows(world):
    got = world["jobs"]["nondivisible_sp"]["images"][0]
    assert got.shape == (11, 16, 3) and np.isfinite(got).all()
    want, _ = single_frame(16, 11, 3, 1, 0)
    np.testing.assert_array_equal(world["jobs"]["nondivisible_dp"]["images"][0], want)


def test_sp_sharding_reduces_variance(world):
    a, b = world["jobs"]["sp4"]["images"]
    c, d = world["jobs"]["dp_exact"]["images"]
    assert np.std(a - b) < np.std(c - d)        # 4 sample groups against 1
    assert abs(float(np.mean(a)) - float(np.mean(c))) < 0.15


def test_train_step_descends(world):
    got = world["jobs"]["descend"]
    losses = got["losses"]
    assert losses[-1] < losses[0] * 0.01, losses
    true_emissive = np.asarray(cornell_scene().build().sphere_material)[3, 4:7]
    np.testing.assert_allclose(got["sphere_material"][3, 4:7], true_emissive, rtol=0.02)
    assert got["geometry_unchanged"]


def test_kernel_and_oracle_backends_agree(world):
    k, o = world["jobs"]["kernel_frame1"], world["jobs"]["oracle_frame1"]
    np.testing.assert_allclose(k["images"][0], o["images"][0], rtol=1e-6, atol=1e-6)
    assert k["rays"] == o["rays"]


def test_dist_renderer_matches_jax(world):
    """(dp=2, sp=2), frame 1: the port's sharded image against the JAX
    package's on 4 devices, and the same ray count within 0.1%."""
    ref = world["jax"]
    for name in ("kernel_frame1", "oracle_frame1"):
        got = world["jobs"][name]
        assert_image_close(got["images"][0], ref["image"], rtol=1e-3, atol=1e-4)
        assert abs(got["rays"][0] - ref["rays"]) <= 0.001 * ref["rays"]


def test_dp_sharded_center_jitter_bit_exact(world):
    got = world["jobs"]["center"]
    want, _ = single_frame(32, 32, 3, 2, 0, "center", dict(CAM, aperture_diameter=0.05))
    np.testing.assert_array_equal(got["images"][0], want)
    k = world["names"].index("center")
    assert all(r[k]["jitters"] == ["center"] for r in world["ranks"])


def test_train_step_honors_center_jitter(world):
    assert np.isfinite(world["jobs"]["train_center"]["losses"][0])
    k = world["names"].index("train_center")
    assert all(r[k]["jitters"] == ["center"] for r in world["ranks"])


def test_train_step_rr_off_backends_agree(world):
    k, o = world["jobs"]["rr_off_kernel"], world["jobs"]["rr_off_oracle"]
    assert np.isfinite(k["losses"][0])
    np.testing.assert_allclose(k["losses"][0], o["losses"][0], rtol=1e-5)


def test_train_step_grads_kernel_vs_oracle_demo_scene(world):
    """Demo scene at counts (48, 7): with lr 1 the stepped tables carry the
    whole mesh's gradients, kernel backward against autograd."""
    k, o = world["jobs"]["demo_kernel"], world["jobs"]["demo_oracle"]
    np.testing.assert_allclose(k["losses"][0], o["losses"][0], rtol=1e-5)
    for g, w in zip(stepped_grads(k, 1.0), stepped_grads(o, 1.0)):
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, w, rtol=3e-4, atol=3e-4 * max(np.abs(w).max(), 1e-3))


def test_banded_psum_grads_match_single_psum(world):
    one, two = world["jobs"]["bands1"], world["jobs"]["bands2"]
    np.testing.assert_allclose(one["losses"][0], two["losses"][0], rtol=1e-6)
    for k in ("sphere_material", "cuboid_material"):
        np.testing.assert_allclose(two[k], one[k], rtol=1e-5, atol=1e-7)
    with pytest.raises(ValueError):   # 16 local rows not divisible by 3
        make_train_step(make_mesh(), RenderConfig(**cfg(ray_depth=3)), counts=(4, 5),
                        psum_bands=3)


def test_train_step_matches_jax(world):
    """(dp=2, sp=2), rr off, lr 1: the loss and the stepped tables' gradients
    against the JAX package's train step on 4 devices, for one and two
    gradient bands."""
    ref = world["jax"]
    for name in ("bands1", "bands2"):
        got = world["jobs"][name]
        np.testing.assert_allclose(got["losses"][0], ref["loss"], rtol=1e-5)
        for g, w in zip(stepped_grads(got, 1.0), ref["grads"]):
            atol = max(2e-5, 2e-6 * float(np.abs(w).max()))
            np.testing.assert_allclose(g, w, rtol=2e-3, atol=atol, err_msg=name)


@pytest.mark.parametrize("layout", ["progressive_sp", "progressive_dp"])
def test_dist_progressive_matches_single_process(world, layout):
    """Two 4-frame blocks against progressive_frames in one process: rays
    exact; the image bit for bit under dp, within the sum's reordering
    (rtol 1e-5, atol 1e-6) when sp shards the frames."""
    got = world["jobs"][layout]
    c = CameraConfig(**CAM)
    ip, iv, _ = camera_matrices(c, 128, 16)
    table = pack_block_table(constant_environment(ENV))
    scene = cornell_scene().build()
    acc = init_accumulator(16, 128)
    for b in range(2):
        acc, rays = progressive_frames(acc, scene, table, ip, iv, 4 * b, c.focal_length,
                                       c.aperture_diameter, width=128, height=16, ray_depth=3,
                                       spp=1, n_frames=4)
        assert got["rays"][b] == int(rays)
        if layout == "progressive_dp":
            np.testing.assert_array_equal(got["images"][b], acc.image.numpy())
        else:
            np.testing.assert_allclose(got["images"][b], acc.image.numpy(), rtol=1e-5,
                                       atol=1e-6)
    assert got["frame"] == 8


def test_launches_counted_on_each_rank(world):
    """Each rank's kernel counters moved only on the card: on the CPU every
    wrapper ran its plain version and no count moved."""
    for ranks in world["ranks"]:
        for res in ranks:
            if res is not None:
                assert not any(res["launches"].values()), res["launches"]


def test_sharded_paths_reject_bad_arguments():
    """The JAX functions' ValueErrors: an unknown backend, the kernel
    backward without counts."""
    c = RenderConfig(**cfg())
    with pytest.raises(ValueError, match="backend"):
        make_dist_renderer(make_mesh(), c, backend="xla")
    with pytest.raises(ValueError, match="backend"):
        make_train_step(make_mesh(), c, counts=(4, 0), backend="xla")
    with pytest.raises(ValueError, match="counts"):
        make_train_step(make_mesh(), c, backend="kernel")


def test_trainable_filter_grads_keeps_the_material_tables():
    s = cornell_scene().build()
    s = dataclasses.replace(s, sphere_pos_radius=s.sphere_pos_radius + 1.0)
    f = trainable_filter_grads(s)
    assert not f.sphere_pos_radius.any() and not f.cuboid_min.any() and not f.cuboid_max.any()
    assert f.sphere_material is s.sphere_material and f.cuboid_material is s.cuboid_material
    assert f.counts == (0, 0)

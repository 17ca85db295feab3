"""The frozen reference (portbench/reference/) against tpt_torch's plain
versions on the CPU, at 16^2-64^2, for both configurations: the same inputs
give the same bits.  The test imports the port; the reference does not."""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import traffic
from portbench.reference import camera as ref_camera
from portbench.reference import controller as ref_controller
from portbench.reference import env as ref_env
from portbench.reference import paths
from portbench.reference import sky as ref_sky
from portbench.reference.config import AtmosphereConfig as RefAtmosphere

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def config(name):
    with open(CONFIGS / f"{name}.json") as f:
        return json.load(f)


def port_camera(cam: dict):
    from tpt_torch.config import CameraConfig
    return CameraConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in cam.items()})


@pytest.mark.parametrize("name", ["demo", "demo-inverse"])
def test_config_scene_is_the_demo_scene(name):
    from tpt_torch.scene import demo_scene
    want = demo_scene().build("cpu").to_numpy()
    got = paths.scene_arrays(config(name)["scene"])
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("size,steps", [(8, (6, 3)), (16, (10, 4))])
def test_atmosphere_and_tables_match_the_port(size, steps):
    from tpt_torch.config import AtmosphereConfig
    from tpt_torch.env import pack_block_table
    from tpt_torch.sky import compute_atmosphere
    faces = compute_atmosphere(AtmosphereConfig(size=size, i_steps=steps[0], j_steps=steps[1]))
    ref = ref_sky.compute_atmosphere(RefAtmosphere(size=size, i_steps=steps[0],
                                                   j_steps=steps[1]))
    assert torch.equal(faces, ref)
    for dtype in (torch.float32, torch.bfloat16):
        assert torch.equal(pack_block_table(faces, dtype=dtype),
                           ref_env.pack_block_table(ref, dtype=dtype))


def test_camera_matrices_match_the_port():
    from tpt_torch.camera import camera_matrices
    for cam in (config("demo")["camera"], *config("demo-inverse")["views"].values()):
        for w, h in ((64, 48), (1920, 1080)):
            for a, b in zip(camera_matrices(port_camera(cam), w, h),
                            ref_camera.camera_matrices(paths.camera_config(cam), w, h)):
                assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))


def test_controller_matches_the_port():
    from tpt_torch.camera_controller import CameraState, process_inputs
    with open(CONFIGS.parent / "workloads" / "demo.viewer-832.json") as f:
        t = json.load(f)["traffic"]
    base = config("demo")["camera"]
    a = CameraState.from_config(port_camera(base))
    b = ref_controller.CameraState.from_config(paths.camera_config(base))
    for keys, mouse in traffic.input_stream(7, t)[:400]:
        a, ca = process_inputs(a, t["dt"], keys, mouse)
        b, cb = ref_controller.process_inputs(b, t["dt"], keys, mouse)
        assert ca == cb
        assert np.array_equal(a.position, b.position) and (a.look_x, a.look_y) == (b.look_x,
                                                                                     b.look_y)


def test_block_and_fold_match_the_port():
    """The block path: progressive_frames on the CPU (the plain environment
    mode and the fold) against the reference's block and fold."""
    from tpt_torch.camera import camera_matrices
    from tpt_torch.config import AtmosphereConfig
    from tpt_torch.env import pack_block_table
    from tpt_torch.kernels.render import progressive_frames
    from tpt_torch.progressive import init_accumulator
    from tpt_torch.scene import Scene
    from tpt_torch.sky import compute_atmosphere
    cfg = config("demo")
    render = cfg["render"]
    arrays = paths.scene_arrays(cfg["scene"])
    faces = compute_atmosphere(AtmosphereConfig(size=8, i_steps=6, j_steps=3))
    table = pack_block_table(faces)
    cam = port_camera(cfg["camera"])
    w, h, frames = 24, 16, 3
    inv_p, inv_v, _ = camera_matrices(cam, w, h)
    acc = init_accumulator(h, w)
    scene = Scene.from_numpy(arrays, "cpu")
    ref_scene = paths.make_scene(arrays, "cpu")
    for frame0 in (1_000_003, 1_000_006):
        before, n0 = acc.image.clone(), acc.frame
        acc, rays = progressive_frames(acc, scene, table, inv_p, inv_v, frame0, cam.focal_length,
                                       cam.aperture_diameter, width=w, height=h,
                                       ray_depth=render["ray_depth"], spp=render["spp"],
                                       n_frames=frames)
        rad, ref_rays, escapes = paths.block(ref_scene, table, paths.camera_config(cfg["camera"]),
                                             w, h, frame0, frames, render)
        assert int(rays) == ref_rays and 0 < escapes <= w * h * frames
        assert torch.equal(acc.image, paths.fold_block(before, n0, rad, frames, render["spp"]))


def test_viewer_draw_matches_the_port():
    """One viewer draw on the CPU (a tick, the per-frame path, the display
    image) against the reference's replay of it."""
    from tpt_torch.interactive import ViewerSession
    from tpt_torch.scene import Scene
    cfg = config("demo")
    ses = ViewerSession("demo", size=16, env_name="atmosphere", atmosphere_size=32, device="cpu")
    ses.scene = Scene.from_numpy(paths.scene_arrays(cfg["scene"]), "cpu")
    base = paths.camera_config(cfg["camera"])
    state = ref_controller.CameraState.from_config(base)
    table = ref_env.pack_block_table(paths.environment_faces(
        dict(kind="atmosphere", size=32, i_steps=30, j_steps=10, time=0.5,
             light_intensity=15.0), "cpu"))
    ref_scene = paths.make_scene(paths.scene_arrays(cfg["scene"]), "cpu")
    for keys, mouse in ((("w",), (3.0, 1.0)), ((), (-3.0, -1.0)), ((), (0.0, 0.0))):
        before = ses.acc.image.clone()
        ses.tick(1 / 60, keys, mouse)
        img = ses.render_one(1)
        state, changed = ref_controller.process_inputs(state, 1 / 60, keys, mouse)
        n0 = 0 if changed else 1
        mean, _ = paths.frame_mean(ref_scene, table, state.to_config(base), 16, 16, n0,
                                   cfg["render"])
        assert np.array_equal(img, paths.display_u8(paths.mix_frame(before, n0, mean)))


@pytest.mark.parametrize("views", [["grid", "default"], ["default"]])
def test_inverse_steps_match_the_port(views):
    """Two steps of the inverse demo on the CPU (make_renderer and
    make_inverse_step over the plain trace and its autograd) against the
    reference's steps from the same starting point."""
    from tpt_torch.env import constant_environment, pack_block_table
    from tpt_torch.optim import clipped_adam, make_inverse_step, make_renderer
    from tpt_torch.scene import Scene
    cfg = config("demo-inverse")
    r, o = cfg["render"], cfg["optimizer"]
    arrays = paths.scene_arrays(cfg["scene"])
    scene = Scene.from_numpy(arrays, "cpu")
    table = pack_block_table(constant_environment(tuple(cfg["environment"]["color"])))
    cams = [port_camera(cfg["views"][v]) for v in views]
    w, h = 16, 12
    render = make_renderer(scene, cams, width=w, height=h, ray_depth=r["ray_depth"],
                           spp=r["spp"], counts=tuple(r["counts"]), env_table=table)
    (sm0, cm0), masks = traffic.perturbed_materials(arrays, cfg["perturbation"], 11)
    opt = clipped_adam(o["lr"], total_steps=o["total_steps"], clip_norm=o["clip_norm"])
    step = make_inverse_step(render, opt, n_views=len(cams),
                             param_mask=tuple(torch.tensor(m) for m in masks))
    params = (torch.tensor(sm0), torch.tensor(cm0))
    state, losses = opt.init(params), []
    for i in range(2):
        with torch.no_grad():
            tgt = torch.stack([render(scene.sphere_material, scene.cuboid_material, i, v)
                               for v in range(len(cams))])[None]
        params, state, loss = step(params, state, i, tgt)
        losses.append(float(loss))
        if i == 0:
            first_mu = tuple(m.clone() for m in state.mu)
    ref = paths.inverse_steps(arrays, cfg, [paths.camera_config(cfg["views"][v]) for v in views],
                              w, h, (sm0, cm0), masks, 2, "cpu")
    assert losses == ref["losses"]
    for got, want in zip(first_mu, ref["grads"]):
        assert torch.equal(got / 0.1, want)   # both from the first moment: (1 - b1) g
    for p, s, d in zip(params, (sm0, cm0), ref["change"]):
        assert torch.equal(p - torch.tensor(s), d)


def test_perturbation_is_the_demos_at_seed_11():
    """The starting point at the demo's seed is the demo's (its sphere MAE
    starts at 0.2866)."""
    arrays = paths.scene_arrays(config("demo-inverse")["scene"])
    (sm0, _), (mask_s, _) = traffic.perturbed_materials(
        arrays, config("demo-inverse")["perturbation"], 11)
    mae = float(np.abs(sm0[:36, 0:3] - np.asarray(arrays[1])[:36, 0:3]).mean())
    assert round(mae, 4) == 0.2866 and mask_s.sum() == 108
    assert dataclasses.is_dataclass(paths.Scene)

"""tpt_torch.interactive against tpt.interactive: the 17 headless tests of
tests/test_interactive.py on the port's ViewerSession (the CPU, 16-32
pixels, matplotlib's Agg backend from the conftest), the session's block
render against the JAX session's (tests/test_torch_render.py's bar: rtol
1e-3, atol 1e-4, at most 2 flipped pixels, as the demo scene's render tests
allow), ``randomize_materials`` against tpt's on one generator state,
``frame_stats``, and the module's import without matplotlib.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tpt import interactive as jinteractive
from tpt.scene import demo_scene as jdemo_scene, randomize_materials as jrandomize
from tpt_torch.interactive import ViewerSession, build_parser
from tpt_torch.scene import demo_scene, randomize_materials
from tpt_torch.utils.profiling import frame_stats

from test_torch_render import assert_image_close

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def session(tmp_path_factory):
    # constant env + tiny frame: cheap on CPU
    return ViewerSession("demo", size=32, env_name="constant", device="cpu",
                         screenshot_dir=str(tmp_path_factory.mktemp("shots")))


def test_param_edits_clamp_and_reset(session):
    s = session
    s.acc = type(s.acc)(image=s.acc.image, frame=s.acc.frame + 5)
    for _ in range(20):
        s.adjust_spp(1)
    assert s.cfg.spp == 10          # Gui.cs:40 range 1-10
    for _ in range(20):
        s.adjust_spp(-1)
    assert s.cfg.spp == 1
    assert int(s.acc.frame) == 0    # every edit resets accumulation
    for _ in range(60):
        s.adjust_ray_depth(1)
    assert s.cfg.ray_depth == 50    # Gui.cs:48 range 1-50
    f0 = s.base_cam.focal_length
    s.adjust_focal(0.1)
    assert s.base_cam.focal_length == pytest.approx(f0 + 0.1)
    a0 = s.base_cam.aperture_diameter
    s.adjust_aperture(0.002)
    assert s.base_cam.aperture_diameter == pytest.approx(a0 + 0.002)


def test_mouse_look_clamps_pitch(session):
    s = session
    yaw0 = s.cam.look_x
    changed = s.tick(0.016, keys=(), mouse_delta=(50.0, 0.0))
    assert changed
    assert s.cam.look_x == pytest.approx(yaw0 + 50 * 0.1)  # sensitivity 0.1
    s.tick(0.016, mouse_delta=(0.0, -100000.0))
    assert s.cam.look_y == pytest.approx(89.999)           # Camera.cs:43-47


def test_env_toggle_and_atmosphere_recompute(session):
    s = session
    assert not s.env_is_atmosphere
    s.atmo = type(s.atmo)(size=8, i_steps=2, j_steps=2)    # keep it cheap
    s.toggle_environment()
    assert s.env_is_atmosphere
    faces_a = np.asarray(s.env_faces).copy()
    assert faces_a.shape == (6, 8, 8, 3)
    s.adjust_time(0.1)                                     # re-precompute
    assert not np.array_equal(np.asarray(s.env_faces), faces_a)
    s.toggle_environment()
    assert not s.env_is_atmosphere


def test_pick_and_edit_object(session):
    from tpt_torch.camera_controller import CameraState
    s = session
    s.cam = CameraState.from_config(s.base_cam)  # undo mouse-look test spin
    # center pixel of the default demo view hits geometry
    obj = s.pick(s.cfg.width / 2, s.cfg.height / 2)
    assert obj is not None and s.picked is not None
    pos0 = np.asarray(obj.position)
    assert s.move_picked((0.5, 0.0, 0.0))
    assert np.allclose(self_pos(s), pos0 + [0.5, 0, 0])
    # cross-clamp (Gui.cs:193,205): each edit clamps ITSELF against the
    # other parameter.  Zero refraction first so the spec edit lands whole,
    # then refr 0.9 is clamped to 1 - spec = 0.2.
    assert s.set_picked_material(refraction_chance=0.0)
    assert s.set_picked_material(specular_chance=0.8, refraction_chance=0.9)
    m = s._picked_obj().material
    assert m.specular_chance == pytest.approx(0.8)
    assert m.refraction_chance == pytest.approx(0.2)
    assert s.set_picked_material(ior=0.3)
    assert s._picked_obj().material.ior == 1.0             # IOR >= 1
    assert s.randomize_picked_material()


def self_pos(s):
    return np.asarray(s._picked_obj().position)


def test_edit_clamps_edited_param_not_the_other(session):
    # Gui.cs:190-206: the panel clamps the EDITED parameter against the
    # untouched one.  Editing spec on a refr=0.9 object must clamp the spec
    # edit to 0.1 and leave refraction at 0.9 (the constructor would have
    # rewritten refraction to 0.1 instead).
    s = session
    assert s.pick(s.cfg.width / 2, s.cfg.height / 2) is not None
    assert s.set_picked_material(specular_chance=0.0)
    assert s.set_picked_material(refraction_chance=0.9)
    assert s.set_picked_material(specular_chance=0.5)
    m = s._picked_obj().material
    assert m.specular_chance == pytest.approx(0.1)
    assert m.refraction_chance == pytest.approx(0.9)
    # slider-range clamps (Gui.cs:196-209)
    assert s.set_picked_material(ior=7.0)
    assert s._picked_obj().material.ior == pytest.approx(5.0)
    assert s.set_picked_material(specular_roughness=1.7)
    assert s._picked_obj().material.specular_roughness == pytest.approx(1.0)
    with pytest.raises(TypeError):
        s.set_picked_material(no_such_param=1.0)
    # restore a sane material for later tests
    s.set_picked_material(refraction_chance=0.0, specular_chance=0.0)


def test_set_picked_position_and_distance(session):
    s = session
    assert s.pick(s.cfg.width / 2, s.cfg.height / 2) is not None
    assert s.set_picked_position((1.0, 2.0, 3.0))
    assert np.allclose(self_pos(s), [1.0, 2.0, 3.0])
    # Gui.cs:161 distance readout = |picked.pos - camera.pos|
    expect = np.linalg.norm(np.asarray([1.0, 2.0, 3.0])
                            - np.asarray(s.cam.position))
    assert s.picked_distance == pytest.approx(expect)
    s.picked = None
    assert not s.set_picked_position((0, 0, 0))
    assert np.isnan(s.picked_distance)


def test_object_panel_drives_picked_object(session):
    # GameObjectProperties widget analogue (Gui.cs:153-218), headless
    from tpt_torch.interactive import ObjectPanel
    s = session
    panel = ObjectPanel(s)
    # nothing picked: edits are no-ops
    s.picked = None
    panel.refresh()
    assert "nothing" in panel.t_distance.get_text()
    panel.s_spec.set_val(0.7)  # guarded: no crash, no pick
    # pick, refresh, and verify the widgets mirror the object
    obj = s.pick(s.cfg.width / 2, s.cfg.height / 2)
    assert obj is not None
    panel.refresh()
    assert f"{s.picked_distance:.3f}" in panel.t_distance.get_text()
    assert panel.s_ior.val == pytest.approx(obj.material.ior)
    # slider edit -> session edit with the reference cross-clamp
    panel.s_refr.set_val(0.0)
    panel.s_spec.set_val(0.8)
    assert s._picked_obj().material.specular_chance == pytest.approx(0.8)
    panel.s_refr.set_val(0.9)  # clamped against spec -> 0.2
    assert s._picked_obj().material.refraction_chance == pytest.approx(0.2)
    assert panel.s_refr.val == pytest.approx(0.2)  # clamp echoed back
    # vec3 text boxes (InputFloat3 / DragFloat3 analogues)
    panel.t_albedo.set_val("0.1, 0.2, 0.3")
    assert s._picked_obj().material.albedo == pytest.approx((0.1, 0.2, 0.3))
    panel.t_position.set_val("4, 5, 6")
    assert np.allclose(self_pos(s), [4, 5, 6])
    panel.t_emissive.set_val("not a number")  # ignored, no crash
    assert s._picked_obj().material.emissive == pytest.approx((0.0, 0.0, 0.0))
    s.reload_scene()


def test_frame_stats_window():
    from tpt_torch.interactive import FrameStats
    st = FrameStats(now=100.0)
    st.note_update()
    st.note_frames(30, spp=2)
    assert not st.sample(100.5)      # window not rolled yet
    assert st.sample(101.0)
    assert st.fps == pytest.approx(30.0)
    assert st.ups == pytest.approx(1.0)
    assert st.sps == pytest.approx(60.0)  # Gui.cs:37: FPS * SPP
    assert st.sample(102.0)          # empty second -> zeros
    assert st.fps == 0.0


def test_render_one_fused_frames(session):
    # render_one(n_frames=k) folds k frames in one program (the production
    # fused path) and keeps the host frame mirror in sync
    s = session
    s.invalidate()
    s.render_one(n_frames=3)
    assert int(s.acc.frame) == 3
    assert s.samples_per_pixel == 3 * s.cfg.spp
    disp = s.render_one()
    assert int(s.acc.frame) == 4
    assert disp.shape == (s.cfg.height, s.cfg.width, 3)


def test_randomize_grid_and_scene_rebuild(session):
    s = session
    mats0 = np.asarray(s.scene.sphere_material).copy()
    assert s.randomize_grid_materials(5) == 5
    assert not np.array_equal(np.asarray(s.scene.sphere_material), mats0)


def test_reload_scene_discards_edits(session):
    # 'R' re-runs LoadScene and resets (src/MainWindow.cs:109-123)
    s = session
    s.pick(s.cfg.width / 2, s.cfg.height / 2)
    s.randomize_grid_materials(8)
    s.acc = type(s.acc)(image=s.acc.image, frame=s.acc.frame + 3)
    s.reload_scene()
    assert s.picked is None
    assert int(s.acc.frame) == 0
    from tpt_torch.cli import _build_scene
    fresh = np.asarray(_build_scene("demo").build().sphere_material)
    np.testing.assert_array_equal(np.asarray(s.scene.sphere_material), fresh)


def test_set_size_reallocates_and_resets(session):
    # resize semantics (src/MainWindow.cs:270-283, PathTracer.cs:131-137)
    s = session
    s.acc = type(s.acc)(image=s.acc.image, frame=s.acc.frame + 3)
    s.set_size(48, 24)
    assert s.cfg.width == 48 and s.cfg.height == 24
    assert s.acc.image.shape == (24, 48, 3)
    assert int(s.acc.frame) == 0
    disp = s.render_one()
    assert disp.shape == (24, 48, 3)
    s.set_size(32, 32)  # restore for other tests


def test_f_number_stat(session):
    # Gui.cs:67: f-number = focal / aperture
    s = session
    assert s.f_number == pytest.approx(
        s.base_cam.focal_length / s.base_cam.aperture_diameter)


def _click(button):
    """Click a matplotlib Button through its real widget event path
    (press+release MouseEvents at the button axes' pixel center), so the
    on_clicked wiring itself is what the test exercises."""
    from matplotlib.backend_bases import MouseButton, MouseEvent
    fig = button.ax.figure
    fig.canvas.draw()  # realize the layout so bbox coords are valid
    bbox = button.ax.bbox
    x = bbox.x0 + bbox.width / 2
    y = bbox.y0 + bbox.height / 2
    for name in ("button_press_event", "button_release_event"):
        MouseEvent(name, fig.canvas, x, y, MouseButton.LEFT)._process()


def test_control_panel_drives_session(session, tmp_path):
    # the ImGui-panel analogue: Slider.set_val fires the same callback a
    # drag does, so the panel is testable headless under Agg (set in
    # tests/conftest.py)
    from tpt_torch.interactive import ControlPanel
    s = session
    panel = ControlPanel(s)
    panel.s_spp.set_val(7)
    assert s.cfg.spp == 7
    panel.s_depth.set_val(21)
    assert s.cfg.ray_depth == 21
    panel.s_focal.set_val(12.5)
    assert s.base_cam.focal_length == pytest.approx(12.5)
    panel.s_aperture.set_val(0.05)
    assert s.base_cam.aperture_diameter == pytest.approx(0.05)
    assert int(s.acc.frame) == 0  # every control resets accumulation
    # atmosphere sliders update config (cheap: session env is constant)
    panel.s_time.set_val(0.25)
    assert s.atmo.time == pytest.approx(0.25)
    panel.s_isteps.set_val(5)
    assert s.atmo.i_steps == 5
    # resolution combo slider (Gui.cs:93-112); env is constant here so no
    # precompute runs, only the config updates
    panel.s_size.set_val(1)
    assert s.atmo.size == 64
    # buttons, driven through the widget event path (press+release)
    was = s.env_is_atmosphere
    s.atmo = type(s.atmo)(size=8, i_steps=2, j_steps=2)
    _click(panel.b_env)
    assert s.env_is_atmosphere == (not was)
    _click(panel.b_env)
    assert s.env_is_atmosphere == was
    n_before = len(list(tmp_path.glob("*.png")))
    s.screenshot_dir = str(tmp_path)
    _click(panel.b_shot)
    assert len(list(tmp_path.glob("*.png"))) == n_before + 1
    mats = np.asarray(s.scene.sphere_material).copy()
    _click(panel.b_rand)
    assert not np.array_equal(np.asarray(s.scene.sphere_material), mats)
    _click(panel.b_reload)
    # restore defaults for other tests
    panel.s_spp.set_val(1)
    panel.s_depth.set_val(13)
    panel.s_focal.set_val(20.0)
    panel.s_aperture.set_val(0.14)


def test_atmosphere_size_combo(session):
    # the reference's EnvironmentMap resolution combo {32..2048}
    # (Gui.cs:93-112): set_atmosphere_size reallocates + re-precomputes
    s = session
    s.atmo = type(s.atmo)(size=32, i_steps=2, j_steps=2)
    was_atmo = s.env_is_atmosphere
    if not was_atmo:
        s.toggle_environment()
    s.set_atmosphere_size(64)
    assert s.atmo.size == 64
    assert np.asarray(s.env_faces).shape == (6, 64, 64, 3)
    s.adjust_atmosphere_size(-1)
    assert s.atmo.size == 32
    assert np.asarray(s.env_faces).shape == (6, 32, 32, 3)
    s.adjust_atmosphere_size(-1)          # clamped at the combo's bottom
    assert s.atmo.size == 32
    with pytest.raises(ValueError):
        s.set_atmosphere_size(100)
    if not was_atmo:
        s.toggle_environment()


def test_default_skybox_is_directional(tmp_path_factory):
    # with no --cubemap-files the 'e' toggle must show a real (non-constant)
    # environment, like the reference's bundled 6-PNG skybox
    # (src/MainWindow.cs:177-187)
    from tpt_torch.env import default_skybox
    faces = np.asarray(default_skybox(16))
    assert faces.shape == (6, 16, 16, 3)
    assert np.all(np.isfinite(faces)) and np.all(faces >= 0)
    assert faces.std() > 0.05             # non-constant
    # +Y looks up (sky-ish blue: b > r), -Y looks down (ground: r >= b)
    up = faces[2].mean(axis=(0, 1))
    down = faces[3].mean(axis=(0, 1))
    assert up[2] > up[0]
    assert down[0] >= down[2]
    # the viewer uses it as the no-flags default
    ses = ViewerSession("demo", size=32, env_name="skybox", device="cpu",
                        screenshot_dir=str(tmp_path_factory.mktemp("shots2")))
    assert np.asarray(ses.env_faces).std() > 0.05


def test_render_and_screenshot(session):
    s = session
    disp = s.render_one()
    assert disp.shape == (32, 32, 3)
    assert np.isfinite(disp).all() and disp.max() > 0
    assert int(s.acc.frame) == 1
    path = s.screenshot()
    assert path.endswith(f"Samples_{s.samples_per_pixel}.png")
    import os
    assert os.path.exists(path)


def test_render_one_matches_the_jax_session(tmp_path):
    """A 3-frame block (one launch of the environment mode on the card; its
    plain version here) against tpt's session at 16^2 with the bundled
    skybox."""
    ours = ViewerSession("demo", size=16, env_name="constant", device="cpu",
                         screenshot_dir=str(tmp_path))
    theirs = jinteractive.ViewerSession("demo", size=16, env_name="constant",
                                        screenshot_dir=str(tmp_path))
    np.testing.assert_allclose(ours.env_faces.numpy(), np.asarray(theirs.env_faces),
                               rtol=1e-6, atol=1e-7)     # tests/test_torch_env.py's bar
    got, want = ours.render_one(n_frames=3), theirs.render_one(n_frames=3)
    assert ours.acc.frame == int(theirs.acc.frame) == 3
    assert got.dtype == np.uint8 and got.shape == want.shape == (16, 16, 3)
    assert_image_close(ours.acc.image.numpy(), np.asarray(theirs.acc.image), rtol=1e-3,
                       atol=1e-4, max_bad=2)
    close = (np.abs(got.astype(int) - np.asarray(want).astype(int)) <= 1).all(-1)
    assert (~close).sum() <= 2


def test_randomize_materials_matches_tpt():
    ours, theirs = demo_scene(), jdemo_scene()
    assert randomize_materials(ours, 10, rng=np.random.default_rng(5)) == \
        jrandomize(theirs, 10, rng=np.random.default_rng(5)) == 10
    np.testing.assert_array_equal(ours.build().sphere_material.numpy(),
                                  np.asarray(theirs.build().sphere_material))


def test_frame_stats_reports_rates_of_the_work(session):
    stats = frame_stats(lambda: session.acc.image, rays=1000, n=3)
    assert set(stats) == {"ms_per_frame", "mrays_per_s"}
    assert stats["ms_per_frame"] > 0
    sec = stats["ms_per_frame"] / 1e3
    assert stats["mrays_per_s"] == pytest.approx(1000 / sec / 1e6)


def test_viewer_defaults_to_the_card_and_imports_without_matplotlib():
    assert build_parser().parse_args([]).device == "cuda"
    code = ("import sys; sys.modules['matplotlib'] = None; import tpt_torch.interactive as i; "
            "assert i.ViewerSession and 'matplotlib' not in [m for m in sys.modules "
            "if sys.modules[m] is not None]; print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr

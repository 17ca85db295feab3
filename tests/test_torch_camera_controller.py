"""tpt_torch.camera_controller against tpt.camera_controller: the three
controller tests of tests/test_host_tools.py, and the two controllers bit
for bit over a seeded input sequence."""

import numpy as np

from tpt import camera_controller as jcc
from tpt.config import CameraConfig as JCameraConfig
from tpt_torch.camera_controller import CameraState, process_inputs
from tpt_torch.config import CameraConfig


def test_controller_yaw_pitch_clamp():
    s = CameraState.from_config(CameraConfig())
    s2, changed = process_inputs(s, 0.016, mouse_delta=(100.0, -30.0))
    assert changed
    assert s2.look_x == s.look_x + 100 * 0.1
    assert s2.look_y == s.look_y + 30 * 0.1
    # pitch clamp at +-90 (src/Camera.cs:46-47)
    s3 = s2
    for _ in range(200):
        s3, _ = process_inputs(s3, 0.016, mouse_delta=(0.0, -100.0))
    assert s3.look_y == 89.999


def test_controller_motion_and_damping():
    cam = CameraConfig(position=(0, 0, 0), look_x=-90.0, look_y=0.0)
    s = CameraState.from_config(cam)
    s1, changed = process_inputs(s, 0.1, keys=["w"])
    assert changed
    assert s1.position[2] < 0  # moved along -z (view dir)
    s2 = s1
    for _ in range(200):      # released keys: velocity decays toward zero
        s2, _ = process_inputs(s2, 0.1)
    np.testing.assert_allclose(s2.velocity, 0.0, atol=1e-3)
    s3, changed = process_inputs(s2, 0.1)
    assert not changed        # an idle controller reports no change


def test_controller_shift_faster():
    cam = CameraConfig(position=(0, 0, 0), look_x=-90.0, look_y=0.0)
    s = CameraState.from_config(cam)
    plain, _ = process_inputs(s, 0.1, keys=["w"])
    fast, _ = process_inputs(s, 0.1, keys=["w", "shift"])
    assert abs(fast.position[2]) > abs(plain.position[2]) * 3


def test_controller_bit_equal_to_tpt_over_a_seeded_sequence():
    rng = np.random.default_rng(2024)
    keys = ["w", "a", "s", "d", "shift", "ctrl"]
    ours = CameraState.from_config(CameraConfig())
    theirs = jcc.CameraState.from_config(JCameraConfig())
    for _ in range(300):
        held = [k for k in keys if rng.random() < 0.3]
        mouse = tuple(float(v) for v in rng.normal(scale=20.0, size=2)) \
            if rng.random() < 0.5 else (0.0, 0.0)
        dt = float(rng.uniform(0.001, 0.1))
        ours, changed = process_inputs(ours, dt, held, mouse)
        theirs, want_changed = jcc.process_inputs(theirs, dt, held, mouse)
        assert changed == want_changed
        for name in ("position", "velocity", "up"):
            np.testing.assert_array_equal(getattr(ours, name), getattr(theirs, name))
        assert (ours.look_x, ours.look_y) == (theirs.look_x, theirs.look_y)
    np.testing.assert_array_equal(ours.view_dir, theirs.view_dir)
    assert ours.to_config(CameraConfig()).position == theirs.to_config(JCameraConfig()).position

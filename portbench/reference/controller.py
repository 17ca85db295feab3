"""Frozen copy of tpt_torch.camera_controller: Camera.ProcessInputs physics.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterable, Tuple

import numpy as np

from .config import CameraConfig


@dataclasses.dataclass
class CameraState:
    position: np.ndarray
    look_x: float          # yaw degrees
    look_y: float          # pitch degrees
    up: np.ndarray
    velocity: np.ndarray
    movement_speed: float = 10.0
    mouse_sensitivity: float = 0.1

    @staticmethod
    def from_config(cam: CameraConfig) -> "CameraState":
        return CameraState(position=np.asarray(cam.position, np.float32),
                           look_x=float(cam.look_x), look_y=float(cam.look_y),
                           up=np.asarray(cam.up, np.float32),
                           velocity=np.zeros(3, np.float32))

    @property
    def view_dir(self) -> np.ndarray:
        lx = math.radians(self.look_x)
        ly = math.radians(self.look_y)
        return np.array([math.cos(lx) * math.cos(ly),
                         math.sin(ly),
                         math.sin(lx) * math.cos(ly)], np.float32)

    def to_config(self, base: CameraConfig) -> CameraConfig:
        return dataclasses.replace(base, position=tuple(map(float, self.position)),
                                   look_x=self.look_x, look_y=self.look_y)


def process_inputs(state: CameraState, dt: float,
                   keys: Iterable[str] = (),
                   mouse_delta: Tuple[float, float] = (0.0, 0.0)
                   ) -> Tuple[CameraState, bool]:
    """One input tick. ``keys``: subset of {'w','a','s','d','shift','ctrl'};
    ``mouse_delta``: (dx, dy) pixels. Returns (new_state, frame_changed)."""
    keys = set(keys)
    s = dataclasses.replace(state, position=state.position.copy(),
                            velocity=state.velocity.copy())
    frame_changed = False

    dx, dy = mouse_delta
    if dx or dy:
        frame_changed = True
    s.look_x += dx * s.mouse_sensitivity
    s.look_y -= dy * s.mouse_sensitivity
    if s.look_y >= 90:
        s.look_y = 89.999
    if s.look_y <= -90:
        s.look_y = -89.999

    view = s.view_dir
    accel = np.zeros(3, np.float32)
    if "w" in keys:
        accel += view
    if "s" in keys:
        accel -= view
    strafe = np.cross(view, s.up)
    norm = np.linalg.norm(strafe)
    if norm > 0:
        strafe = strafe / norm
    if "d" in keys:
        accel += strafe
    if "a" in keys:
        accel -= strafe

    if "shift" in keys:
        s.velocity += accel * 5.0
    elif "ctrl" in keys:
        s.velocity += accel * 0.35
    else:
        s.velocity += accel
    if accel.any() or s.velocity.any():
        frame_changed = True

    if float(s.velocity @ s.velocity) < 0.01:
        s.velocity[:] = 0.0
    s.velocity *= 0.95
    s.velocity += accel * dt
    s.position += s.velocity * dt
    return s, frame_changed

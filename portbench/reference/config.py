"""Frozen copy of tpt_torch.config's constants and the camera and
atmosphere settings the reference reads."""

from __future__ import annotations

import dataclasses
from typing import Tuple

MAX_SPHERES = 256
MAX_CUBOIDS = 64
HOST_EPSILON = 0.005
KERNEL_EPSILON = 0.001
FOV_DEGREES = 103.0
NEAR_PLANE = HOST_EPSILON
FAR_PLANE = 1000.0


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    position: Tuple[float, float, float] = (-17.14, 3.53, -8.62)
    look_x: float = -32.2
    look_y: float = 0.8
    up: Tuple[float, float, float] = (0.0, 1.0, 0.0)
    fov_degrees: float = FOV_DEGREES
    focal_length: float = 20.0
    aperture_diameter: float = 0.14


@dataclasses.dataclass(frozen=True)
class AtmosphereConfig:
    size: int = 256
    i_steps: int = 50
    j_steps: int = 15
    time: float = 0.5
    light_intensity: float = 15.0

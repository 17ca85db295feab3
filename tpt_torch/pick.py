"""CPU-side ray picking, the object-selection path of the reference GUI
(port of tpt.pick, which is NumPy-only: the same code against the port's
scene objects; matrices may be numpy arrays or CPU tensors).

Mirrors MainWindow.RayTrace (src/MainWindow.cs:302-318) + Gui.Update's
window-coords-to-NDC conversion (src/Render/Gui.cs:223-262): build the eye
ray through the cursor and linearly scan all host-side objects with the same
``t2 > 0 && t1 < tMin`` rule as the device kernel, returning the picked
object.  Pure NumPy — this is host tooling, not a hot path.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np

from .scene import SceneBuilder, SceneObject, SphereObject, CuboidObject

FLOAT_MAX = np.float32(3.4028235e38)


def _intersect_sphere(o, d, center, radius):
    oc = o - center
    b = float(d @ oc)
    c = float(oc @ oc) - radius * radius
    disc = b * b - c
    if disc < 0:
        return None
    sq = math.sqrt(disc)
    return -b - sq, -b + sq


def _intersect_cuboid(o, d, mn, mx):
    with np.errstate(divide="ignore", invalid="ignore"):
        t0s = (mn - o) / d
        t1s = (mx - o) / d
    tsm = np.minimum(t0s, t1s)
    tbg = np.maximum(t0s, t1s)
    t1 = float(np.max(tsm))
    t2 = float(np.min(tbg))
    if t1 <= t2:
        return t1, t2
    return None


def intersect_object(obj: SceneObject, origin, direction):
    """IntersectsRay dispatch (src/GameObjects/BaseGameObject.cs:10)."""
    if isinstance(obj, SphereObject):
        return _intersect_sphere(origin, direction,
                                 np.asarray(obj.position, np.float32),
                                 float(obj.radius))
    return _intersect_cuboid(origin, direction, obj.aabb_min, obj.aabb_max)


def pick_ray(builder: SceneBuilder, origin, direction
             ) -> Tuple[Optional[SceneObject], float, float]:
    """Closest object along a ray, reference scan semantics.
    Returns (object_or_None, t1, t2)."""
    origin = np.asarray(origin, np.float32)
    direction = np.asarray(direction, np.float32)
    t_min = float(FLOAT_MAX)
    best = (None, 0.0, 0.0)
    for obj in builder.objects:
        r = intersect_object(obj, origin, direction)
        if r is None:
            continue
        t1, t2 = r
        if t2 > 0 and t1 < t_min:
            t_min = t2 if t1 < 0 else t1
            best = (obj, t1, t2)
    return best


def pick_pixel(builder: SceneBuilder, inv_proj, inv_view, view_pos,
               window_x: float, window_y: float, width: int, height: int
               ) -> Tuple[Optional[SceneObject], float, float]:
    """Pick via window coordinates (y measured from the top, like the
    reference's mouse coords — Gui.cs:229-230 flips to NDC)."""
    ndc_x = window_x / width * 2.0 - 1.0
    ndc_y = (height - window_y) / height * 2.0 - 1.0
    inv_proj = np.asarray(inv_proj, np.float32)
    inv_view = np.asarray(inv_view, np.float32)
    eye = inv_proj @ np.array([ndc_x, ndc_y, -1.0, 0.0], np.float32)
    eye[2], eye[3] = -1.0, 0.0
    d = (inv_view @ eye)[:3]
    d = d / np.linalg.norm(d)
    return pick_ray(builder, np.asarray(view_pos, np.float32), d)

"""Frozen copy of tpt_torch.camera: the view and projection matrices.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .config import CameraConfig, NEAR_PLANE, FAR_PLANE

F32 = torch.float32


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=F32)


def normalize(v, dim=-1):
    return v / torch.linalg.vector_norm(v, dim=dim, keepdim=True)


def _projection_terms(fov_degrees, near, far):
    f = 1.0 / torch.tan(torch.deg2rad(_f32(fov_degrees)) / 2.0)
    return f, _f32(near), _f32(far), _f32(0.0)


def perspective(fov_degrees, aspect, near=NEAR_PLANE, far=FAR_PLANE):
    """Standard GL perspective projection (column-vector convention;
    OpenTK Matrix4.CreatePerspectiveFieldOfView, src/MainWindow.cs:278)."""
    f, near, far, z = _projection_terms(fov_degrees, near, far)
    return torch.stack([
        torch.stack([f / _f32(aspect), z, z, z]),
        torch.stack([z, f, z, z]),
        torch.stack([z, z, (far + near) / (near - far), 2 * far * near / (near - far)]),
        torch.stack([z, z, _f32(-1.0), z]),
    ])


def look_at(eye, target, up):
    """Standard GL lookAt view matrix (column-vector convention)."""
    eye = _f32(eye)
    f = normalize(_f32(target) - eye)
    s = normalize(torch.linalg.cross(f, _f32(up)))
    u = torch.linalg.cross(s, f)
    rot = torch.stack([s, u, -f])                      # rows
    trans = -rot @ eye
    m = torch.cat([rot, trans[:, None]], dim=1)
    return torch.cat([m, _f32([[0, 0, 0, 1]])], dim=0)


def inverse_look_at(eye, target, up):
    """Closed-form inverse of :func:`look_at`: columns are (right, up', -fwd, eye)."""
    eye = _f32(eye)
    f = normalize(_f32(target) - eye)
    s = normalize(torch.linalg.cross(f, _f32(up)))
    u = torch.linalg.cross(s, f)
    rot_t = torch.stack([s, u, -f], dim=1)            # columns
    m = torch.cat([rot_t, eye[:, None]], dim=1)
    return torch.cat([m, _f32([[0, 0, 0, 1]])], dim=0)


def inverse_perspective(fov_degrees, aspect, near=NEAR_PLANE, far=FAR_PLANE):
    """Closed-form inverse of :func:`perspective`."""
    f, near, far, z = _projection_terms(fov_degrees, near, far)
    d = 2 * far * near / (near - far)
    c = (far + near) / (near - far)
    return torch.stack([
        torch.stack([_f32(aspect) / f, z, z, z]),
        torch.stack([z, 1 / f, z, z]),
        torch.stack([z, z, z, _f32(-1.0)]),
        torch.stack([z, z, 1 / d, c / d]),
    ])


def view_direction(look_x_degrees, look_y_degrees):
    """Yaw/pitch to view direction (reference: src/Camera.cs:21-23,49-51)."""
    lx = torch.deg2rad(_f32(look_x_degrees))
    ly = torch.deg2rad(_f32(look_y_degrees))
    return torch.stack([torch.cos(lx) * torch.cos(ly), torch.sin(ly),
                        torch.sin(lx) * torch.cos(ly)])


def camera_matrices(cam: CameraConfig, width: int, height: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(inv_projection, inv_view, view_pos), f32 on the CPU — the BasicData
    UBO analogue (reference: src/MainWindow.cs:131-132,278-279)."""
    pos = _f32(cam.position)
    vdir = view_direction(cam.look_x, cam.look_y)
    inv_view = inverse_look_at(pos, pos + vdir, cam.up)
    inv_proj = inverse_perspective(cam.fov_degrees, width / float(height))
    return inv_proj, inv_view, pos


def eye_ray(inv_proj, inv_view, view_pos, ndc):
    """World-space eye ray through NDC point(s).

    ``ndc``: [..., 2]. Returns (origin [..., 3], direction [..., 3])."""
    ndc = _f32(ndc)
    x, y = ndc[..., 0], ndc[..., 1]
    # inv_proj @ (x, y, -1, 0), then force zw = (-1, 0):
    ex = inv_proj[0, 0] * x + inv_proj[0, 1] * y - inv_proj[0, 2]
    ey = inv_proj[1, 0] * x + inv_proj[1, 1] * y - inv_proj[1, 2]
    ez = torch.full_like(ex, -1.0)
    # (inv_view @ (ex, ey, -1, 0)).xyz
    d = (inv_view[:3, 0] * ex[..., None]
         + inv_view[:3, 1] * ey[..., None]
         + inv_view[:3, 2] * ez[..., None])
    d = normalize(d)
    origin = torch.broadcast_to(_f32(view_pos), d.shape)
    return origin, d


def pixel_ndc(x, y, width, height, jitter_x, jitter_y):
    """NDC of pixel (x, y) with sub-pixel jitter in [0,1)^2 added to the
    pixel's lower-left corner (compute.glsl:113-114).  y is bottom-up (GL)."""
    u = (_f32(x) + jitter_x) / width * 2.0 - 1.0
    v = (_f32(y) + jitter_y) / height * 2.0 - 1.0
    return torch.stack([u, v], dim=-1)

"""The backward kernel's wrapper, its plain PyTorch version, and
``trace_diff``, the differentiable trace (port of tpt.kernels.trace_grad).

``trace_diff`` is a ``torch.autograd.Function`` over two differentiable
inputs, both built from the caller's tensors by differentiable torch ops:

  * ``table = build_attr_table(scene, counts)``, f32[128, 24] — autograd
    maps its cotangent back to the ``Scene`` leaves;
  * ``cam20``, the 20 camera scalars in the order of the TPU kernel
    (:func:`camera_vector`) — autograd maps its cotangent back to the 4x4
    inverse matrices, the focal length and the aperture.

Its forward is the trace kernel of tpt_torch.kernels.trace at one frame;
its backward is :func:`trace_grad`, which launches the hand-written CUDA
kernel tpt_torch/csrc/trace_grad.cu (replacing pallas_trace_grad) for CUDA
tensors and runs :func:`trace_grad_plain` — autograd through the plain
integrator — for CPU tensors.  There is no fallback from the device to the
plain version.  ``GRAD_LAUNCHES`` counts launches of the backward kernel.

The finite filter of the TPU wrapper is kept: non-finite cotangent entries
(measure-zero events such as an axis-parallel ray on a cuboid winner) are
zeroed, and their count is returned as a device tensor, so reading it is
the caller's choice of when to synchronise.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Tuple

import torch

from ..config import MAX_CUBOIDS, MAX_SPHERES
from ..integrator import (ATTR_COLS, ATTR_ROWS, CameraParams, TraceResult,
                          build_attr_table, make_scene_scan_fn, make_table_trace_fn,
                          trace_paths)
from .trace import pixel_band, trace

N_CAM = 20  # ip00 ip01 ip02 ip10 ip11 ip12, right, up, backward, eye, focal, aperture
ABLATE_MODES = ("none", "nocam", "nostores", "nodtbl", "norev", "primalonly")

GRAD_LAUNCHES = 0
LAST_ZEROED = None  # n_zeroed of the last backward of trace_diff (a device tensor)


class GradResult(NamedTuple):
    d_table: torch.Tensor   # f32[128, 24], row-major like build_attr_table
    d_cam: torch.Tensor     # f32[20], cam20 order
    n_zeroed: torch.Tensor  # i64 scalar on the device: entries the finite filter zeroed


def camera_vector(inv_proj, inv_view, focal_length, aperture_diameter,
                  device=None) -> torch.Tensor:
    """The 20 camera scalars f32[20] in the TPU kernel's order
    (tpt/kernels/trace_grad.py:491-501): six inverse-projection entries,
    the inverse view's columns right, up, backward and eye, the focal
    length and the aperture.  Differentiable in every tensor argument."""
    ip = torch.as_tensor(inv_proj, dtype=torch.float32)
    iv = torch.as_tensor(inv_view, dtype=torch.float32, device=ip.device)
    device = ip.device if device is None else torch.device(device)
    parts = [ip[0, 0], ip[0, 1], ip[0, 2], ip[1, 0], ip[1, 1], ip[1, 2]]
    parts += [iv[r, c] for c in range(4) for r in range(3)]
    parts += [torch.as_tensor(x, dtype=torch.float32).reshape(()).to(ip.device)
              for x in (focal_length, aperture_diameter)]
    return torch.stack(parts).to(device)  # one copy to the device


def camera_params_from_vector(cam20: torch.Tensor) -> CameraParams:
    """CameraParams whose entries are 0-d views of ``cam20``."""
    c = [cam20[k] for k in range(N_CAM)]
    return CameraParams(ip00=c[0], ip01=c[1], ip02=c[2], ip10=c[3], ip11=c[4], ip12=c[5],
                        right=tuple(c[6:9]), up=tuple(c[9:12]), backward=tuple(c[12:15]),
                        eye=tuple(c[15:18]), focal_length=c[18], aperture_diameter=c[19])


def _check_args(counts, jitter: str, spp: int, ray_depth: int, ablate: str = "none"):
    ns, nc = counts
    if not (0 <= ns <= MAX_SPHERES and 0 <= nc <= MAX_CUBOIDS and ns + nc <= ATTR_ROWS):
        raise ValueError(f"counts out of range: {(ns, nc)} (ns + nc <= {ATTR_ROWS})")
    if jitter not in ("corner", "center"):
        raise ValueError(f"jitter must be 'corner' or 'center', got {jitter!r}")
    if spp < 1 or not 0 <= ray_depth <= 50:
        raise ValueError(f"need spp >= 1 and 0 <= ray_depth <= 50, got {spp}, {ray_depth}")
    if ablate not in ABLATE_MODES:
        raise ValueError(f"ablate must be one of {ABLATE_MODES}, got {ablate!r}")


def finite_filter(d_table: torch.Tensor, d_cam: torch.Tensor) -> GradResult:
    """Zero non-finite cotangent entries and count them (tpt wrapper,
    trace_grad.py:556-574).  A count above ~24 (one poisoned table column)
    points at a bug, not at measure-zero noise."""
    bad_t, bad_c = ~torch.isfinite(d_table), ~torch.isfinite(d_cam)
    n_zeroed = bad_t.sum() + bad_c.sum()
    return GradResult(torch.where(bad_t, 0.0, d_table), torch.where(bad_c, 0.0, d_cam),
                      n_zeroed)


def trace_grad_plain(scene, table, cam20, frame, g_rad, g_missd, g_misst, *,
                     width: int, height: int, ray_depth: int, spp: int,
                     counts: Tuple[int, int], n_rows: int | None = None, row0: int = 0,
                     jitter: str = "corner", rr: bool = True,
                     band_rows: int | None = None) -> GradResult:
    """Plain version of :func:`trace_grad`: autograd through
    tpt_torch.integrator.trace_paths with the table trace (detached scan,
    then table_hit_trace) over leaves ``(table, cam20)``, pulling back
    ``(g_rad, g_missd, g_misst)``, then the finite filter.  Runs on the
    tensors' device.  Its memory grows with the pixels times the bounces:
    ``band_rows`` traces the frame in bands of that many rows and sums
    them before the filter (the cotangent is a sum over pixels)."""
    _check_args(counts, jitter, spp, ray_depth)
    n_rows = height if n_rows is None else n_rows
    band_rows = n_rows if band_rows is None else band_rows
    g_rad = g_rad.reshape(3, n_rows, width)
    g_missd, g_misst = (g.reshape(spp, 3, n_rows, width) for g in (g_missd, g_misst))
    d_table = d_cam = 0
    for r in range(0, n_rows, band_rows):
        n = min(band_rows, n_rows - r)
        dt, dc = _plain_band(scene, table, cam20, frame, g_rad[:, r:r + n],
                             g_missd[:, :, r:r + n], g_misst[:, :, r:r + n], width, height,
                             ray_depth, spp, counts, n, row0 + r, jitter, rr)
        d_table, d_cam = d_table + dt, d_cam + dc
    return finite_filter(d_table, d_cam)


def _plain_band(scene, table, cam20, frame, g_rad, g_missd, g_misst, width, height,
                ray_depth, spp, counts, n_rows, row0, jitter, rr):
    px, py = pixel_band(width, height, n_rows, row0, table.device)
    table_l = table.detach().requires_grad_(True)
    cam_l = cam20.detach().requires_grad_(True)
    with torch.enable_grad():
        trace_fn = make_table_trace_fn(make_scene_scan_fn(scene, counts), table_l, counts[0])
        res = trace_paths(trace_fn, camera_params_from_vector(cam_l), px, py, width, height,
                          int(frame), ray_depth, spp, jitter=jitter, russian_roulette=rr)
        obj = ((res.radiance * g_rad.reshape(res.radiance.shape)).sum()
               + (res.miss_dir * g_missd.reshape(res.miss_dir.shape)).sum()
               + (res.miss_thr * g_misst.reshape(res.miss_thr.shape)).sum())
        d_table, d_cam = torch.autograd.grad(obj, (table_l, cam_l), allow_unused=True)
    d_table = torch.zeros_like(table_l) if d_table is None else d_table
    d_cam = torch.zeros_like(cam_l) if d_cam is None else d_cam
    return d_table, d_cam


def _launch(scene, table, cam20, frame, g_rad, g_missd, g_misst, *, width, height,
            ray_depth, spp, counts, n_rows, row0, jitter, rr, half_stores,
            ablate) -> GradResult:
    global GRAD_LAUNCHES
    from ._build import load_library

    device = table.device
    if device.type != "cuda":
        raise ValueError(f"the backward kernel runs on CUDA tensors, got {device}")
    npix = n_rows * width
    expect = {
        "scene.sphere_pos_radius": (scene.sphere_pos_radius, (MAX_SPHERES, 4)),
        "scene.cuboid_min": (scene.cuboid_min, (MAX_CUBOIDS, 3)),
        "scene.cuboid_max": (scene.cuboid_max, (MAX_CUBOIDS, 3)),
        "table": (table, (ATTR_ROWS, ATTR_COLS)),
        "cam20": (cam20, (N_CAM,)),
        "g_rad": (g_rad, (3, npix)),
        "g_missd": (g_missd, (spp, 3, npix)),
        "g_misst": (g_misst, (spp, 3, npix)),
    }
    args = {}
    for name, (t, shape) in expect.items():
        if t.device != device or t.dtype != torch.float32 or t.numel() != math.prod(shape):
            raise ValueError(f"{name} must be f32{list(shape)} on {device}, got "
                             f"{t.dtype}{list(t.shape)} on {t.device}")
        args[name] = t.detach().contiguous()
    d_table = torch.zeros((ATTR_ROWS, ATTR_COLS), dtype=torch.float32, device=device)
    d_cam = torch.zeros((N_CAM,), dtype=torch.float32, device=device)

    lib = load_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.tpt_trace_grad(
            args["scene.sphere_pos_radius"].data_ptr(), args["scene.cuboid_min"].data_ptr(),
            args["scene.cuboid_max"].data_ptr(), args["table"].data_ptr(),
            counts[0], counts[1], args["cam20"].data_ptr(), int(frame), width, height,
            n_rows, int(row0), spp, ray_depth, int(jitter == "center"), int(bool(rr)),
            int(bool(half_stores)), ABLATE_MODES.index(ablate), args["g_rad"].data_ptr(),
            args["g_missd"].data_ptr(), args["g_misst"].data_ptr(), d_table.data_ptr(),
            d_cam.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"tpt_trace_grad launch failed: CUDA error {err}")
    GRAD_LAUNCHES += 1
    return finite_filter(d_table, d_cam)


def trace_grad(scene, table, cam20, frame, g_rad, g_missd, g_misst, *,
               width: int, height: int, ray_depth: int, spp: int,
               counts: Tuple[int, int], n_rows: int | None = None, row0: int = 0,
               jitter: str = "corner", rr: bool = True, half_stores: bool = False,
               ablate: str = "none") -> GradResult:
    """Cotangents of one traced frame's differentiable outputs
    (counterpart of pallas_trace_grad).

    ``scene``: the Scene the frame was traced from (its geometry drives the
    closest-hit fold); ``table``: build_attr_table(scene, counts);
    ``cam20``: :func:`camera_vector`.  ``g_rad``: f32[3, n_rows, width];
    ``g_missd``/``g_misst``: f32[spp, 3, n_rows, width].  Returns
    :class:`GradResult` after the finite filter.  ``half_stores`` and
    ``ablate`` are the TPU kernel's options (CUDA only; ``ablate`` other
    than "none" is a timing probe whose results mean nothing)."""
    _check_args(counts, jitter, spp, ray_depth, ablate)
    n_rows = height if n_rows is None else n_rows
    if table.device.type == "cpu":
        if ablate != "none":
            raise ValueError("ablate is a probe of the CUDA kernel")
        return trace_grad_plain(scene, table, cam20, frame, g_rad, g_missd, g_misst,
                                width=width, height=height, ray_depth=ray_depth, spp=spp,
                                counts=counts, n_rows=n_rows, row0=row0, jitter=jitter,
                                rr=rr)
    return _launch(scene, table, cam20, frame, g_rad, g_missd, g_misst, width=width,
                   height=height, ray_depth=ray_depth, spp=spp, counts=counts,
                   n_rows=n_rows, row0=row0, jitter=jitter, rr=rr,
                   half_stores=half_stores, ablate=ablate)


class _TraceDiff(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, cam20, scene, inv_proj, inv_view, frame, focal_length,
                aperture_diameter, cfg):
        res = trace(scene, inv_proj, inv_view, frame, focal_length, aperture_diameter,
                    width=cfg["width"], height=cfg["height"], ray_depth=cfg["ray_depth"],
                    spp=cfg["spp"], counts=cfg["counts"], n_rows=cfg["n_rows"],
                    row0=cfg["row0"], jitter=cfg["jitter"], rr=cfg["rr"])
        ctx.save_for_backward(table, cam20)
        ctx.scene, ctx.frame, ctx.cfg = scene, frame, cfg
        ctx.mark_non_differentiable(res.ray_count, res.seed)
        return res.radiance, res.miss_dir, res.miss_thr, res.ray_count, res.seed

    @staticmethod
    def backward(ctx, g_rad, g_missd, g_misst, _g_rays, _g_seed):
        table, cam20 = ctx.saved_tensors
        out = trace_grad(ctx.scene, table, cam20, ctx.frame, g_rad.contiguous(),
                         g_missd.contiguous(), g_misst.contiguous(), **ctx.cfg)
        global LAST_ZEROED
        LAST_ZEROED = out.n_zeroed
        return out.d_table, out.d_cam, None, None, None, None, None, None, None


def trace_diff(scene, inv_proj, inv_view, frame, focal_length, aperture_diameter,
               row0: int = 0, *, width: int, height: int, ray_depth: int, spp: int,
               counts: Tuple[int, int], n_rows: int | None = None,
               jitter: str = "corner", rr: bool = True) -> TraceResult:
    """Differentiable trace of one frame (counterpart of tpt's trace_diff):
    the kernel forward, the backward kernel in reverse mode.

    Returns the TraceResult of tpt_torch.kernels.trace.trace, reverse-mode
    differentiable with respect to the scene's float leaves, the inverse
    matrices, the focal length and the aperture (whichever of them require
    grad); ``ray_count`` and ``seed`` carry no gradient.  Compose with
    tpt_torch.integrator.apply_environment_blocked for a differentiable
    frame (the environment's cotangent comes from autograd through the
    gather).  ``row0``/``n_rows`` select a pixel-row band."""
    _check_args(counts, jitter, spp, ray_depth)
    table = build_attr_table(scene, counts)
    cam20 = camera_vector(inv_proj, inv_view, focal_length, aperture_diameter,
                          device=table.device)
    detach = lambda x: x.detach() if isinstance(x, torch.Tensor) else x
    fwd_scene = dataclasses.replace(scene, **{f.name: detach(getattr(scene, f.name))
                                              for f in dataclasses.fields(scene)})
    cfg = dict(width=width, height=height, ray_depth=ray_depth, spp=spp, counts=tuple(counts),
               n_rows=height if n_rows is None else n_rows, row0=int(row0), jitter=jitter,
               rr=rr)
    rad, miss_dir, miss_thr, rays, seed = _TraceDiff.apply(
        table, cam20, fwd_scene, detach(inv_proj), detach(inv_view), int(frame),
        float(detach(focal_length)), float(detach(aperture_diameter)), cfg)
    return TraceResult(radiance=rad, miss_dir=miss_dir, miss_thr=miss_thr, ray_count=rays,
                       seed=seed)

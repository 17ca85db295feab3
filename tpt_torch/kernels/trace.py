"""The trace kernel's wrappers and their plain PyTorch versions.

One CUDA kernel (tpt_torch/csrc/trace.cu) replaces the TPU kernels of the
JAX package's forward trace:

  * :func:`trace_progressive` — tpt.kernels.trace.pallas_trace_progressive,
    the refill kernel: ``n_frames`` progressive frames in one launch;
  * :func:`trace` — tpt.kernels.trace.pallas_trace, one frame; the same
    kernel at ``n_frames=1`` with the outputs renamed.  Both of its winner
    gathers are ported: ``gather="select"`` (the default) reads the
    winner's scene rows, ``gather="onehot"`` its row of the attribute table
    (tpt_torch.integrator.build_attr_table), the form whose TPU kernel
    takes the row with a one-hot matrix product.  The two give the same
    bits; the one-hot form launches the kernel's table mode through an
    entry point of its own.

Dispatch follows the tensors: for a scene on the CPU the wrappers run
:func:`trace_progressive_plain` / :func:`trace_plain`; for a scene on a
CUDA device they launch the kernel or raise.  There is no fallback from
the device to the plain version.  ``LAUNCHES`` counts kernel launches, so
a run can show that its main path went through the kernel;
``ONEHOT_LAUNCHES`` counts those of them made in the table mode.

Keyword arguments are those of the JAX wrappers.  ``counts`` (static
primitive counts there) is accepted and bounds the scan like the scene's
own counts; the kernel reads the counts at run time, so one build serves
any scene.  Seeds come back as int64 tensors holding uint32 values
(tpt_torch.rng).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..config import MAX_CUBOIDS, MAX_SPHERES
from ..integrator import (ATTR_ROWS, ProgressiveTraceResult, TraceResult, build_attr_table,
                          camera_params, make_onehot_gather_trace_fn, make_scene_scan_fn,
                          make_scene_trace_fn, trace_paths)
from ..integrator import trace_progressive as _integrator_trace_progressive

LAUNCHES = 0
ONEHOT_LAUNCHES = 0
GATHERS = ("select", "onehot")

_SCENE_SHAPES = {
    "sphere_pos_radius": (MAX_SPHERES, 4),
    "sphere_material": (MAX_SPHERES, 16),
    "cuboid_min": (MAX_CUBOIDS, 3),
    "cuboid_max": (MAX_CUBOIDS, 3),
    "cuboid_material": (MAX_CUBOIDS, 16),
}


def _check_args(jitter: str, spp: int, ray_depth: int, n_frames: int, n_valid: int):
    if jitter not in ("corner", "center"):
        raise ValueError(f"jitter must be 'corner' or 'center', got {jitter!r}")
    if spp < 1 or ray_depth < 0:
        raise ValueError(f"need spp >= 1 and ray_depth >= 0, got {spp}, {ray_depth}")
    if not 0 <= n_valid <= n_frames:
        raise ValueError(f"n_valid must be in [0, n_frames={n_frames}], got {n_valid}")


def _check_gather(gather: str, counts):
    """The TPU wrapper's two checks (tpt/kernels/trace.py:323-326)."""
    if gather not in GATHERS:
        raise ValueError(f"gather must be 'select' or 'onehot', got {gather!r}")
    if gather == "onehot" and counts is None:
        raise ValueError("gather='onehot' requires static counts")


def pixel_band(width: int, height: int, n_rows: int, row0: int, device):
    """Pixel coordinates (px, py) i32[n_rows, width] of the row band that
    starts at traced row ``row0``; rows past the image clamp to the last
    one, as in the TPU wrappers."""
    flat = torch.arange(n_rows * width, dtype=torch.int32, device=device)
    px = (flat % width).reshape(n_rows, width)
    py = torch.clamp_max(flat // width + int(row0), height - 1).reshape(n_rows, width)
    return px, py


def trace_plain(scene, inv_proj, inv_view, frame, focal_length, aperture_diameter,
                *, width: int, height: int, ray_depth: int, spp: int,
                counts: Tuple[int, int] | None = None, n_rows: int | None = None,
                row0: int = 0, jitter: str = "corner", rr: bool = True,
                gather: str = "select") -> TraceResult:
    """Plain version of :func:`trace`: tpt_torch.integrator.trace_paths over
    the pixel band, on the scene's device, with the select gather or the
    one-hot form's table read (make_onehot_gather_trace_fn)."""
    _check_gather(gather, counts)
    _check_args(jitter, spp, ray_depth, 1, 1)
    n_rows = height if n_rows is None else n_rows
    px, py = pixel_band(width, height, n_rows, row0, scene.device)
    cam = camera_params(inv_proj, inv_view, focal_length, aperture_diameter)
    if gather == "onehot":
        trace_fn = make_onehot_gather_trace_fn(make_scene_scan_fn(scene, counts),
                                               build_attr_table(scene, counts), counts[0])
    else:
        trace_fn = make_scene_trace_fn(scene, counts)
    return trace_paths(trace_fn, cam, px, py, width, height, int(frame), ray_depth, spp,
                       jitter=jitter, russian_roulette=rr)


def trace_progressive_plain(scene, inv_proj, inv_view, frame0, focal_length,
                            aperture_diameter, *, width: int, height: int,
                            ray_depth: int, spp: int, n_frames: int,
                            n_valid: int | None = None,
                            counts: Tuple[int, int] | None = None,
                            n_rows: int | None = None, row0: int = 0,
                            jitter: str = "corner",
                            rr: bool = True) -> ProgressiveTraceResult:
    """Plain version of :func:`trace_progressive`: the lane-queue loop of
    tpt_torch.integrator.trace_progressive over the pixel band."""
    n_valid = n_frames if n_valid is None else int(n_valid)
    _check_args(jitter, spp, ray_depth, n_frames, n_valid)
    n_rows = height if n_rows is None else n_rows
    px, py = pixel_band(width, height, n_rows, row0, scene.device)
    cam = camera_params(inv_proj, inv_view, focal_length, aperture_diameter)
    return _integrator_trace_progressive(
        make_scene_trace_fn(scene, counts), cam, px, py, width, height, int(frame0),
        ray_depth, spp, n_frames, n_valid=n_valid, jitter=jitter, russian_roulette=rr)


def _camera_vector(inv_proj, inv_view, focal_length, aperture_diameter) -> torch.Tensor:
    """f32[34] on the host: inv_proj and inv_view row-major, focal length,
    aperture diameter (the TPU kernel's packed SMEM camera)."""
    return torch.cat([
        torch.as_tensor(inv_proj, dtype=torch.float32).detach().cpu().reshape(16),
        torch.as_tensor(inv_view, dtype=torch.float32).detach().cpu().reshape(16),
        torch.tensor([float(focal_length), float(aperture_diameter)], dtype=torch.float32),
    ]).contiguous()


def _launch(scene, inv_proj, inv_view, frame0, focal_length, aperture_diameter, *,
            width, height, ray_depth, spp, n_frames, n_valid, counts, n_rows, row0,
            jitter, rr, gather="select") -> ProgressiveTraceResult:
    global LAUNCHES, ONEHOT_LAUNCHES
    from ._build import load_library

    device = scene.device
    if device.type != "cuda":
        raise ValueError(f"the trace kernel runs on CUDA tensors, got {device}")
    for name, shape in _SCENE_SHAPES.items():
        t = getattr(scene, name)
        if t.device != device or t.dtype != torch.float32 or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"scene.{name} must be a contiguous f32{list(shape)} on "
                             f"{device}, got {t.dtype}{list(t.shape)} on {t.device}")
    ns, nc = counts if counts is not None else scene.counts
    if not (0 <= ns <= MAX_SPHERES and 0 <= nc <= MAX_CUBOIDS):
        raise ValueError(f"counts out of range: {(ns, nc)}")
    if width <= 0 or height <= 0 or n_rows <= 0:
        raise ValueError(f"empty band: width={width} height={height} n_rows={n_rows}")
    if gather == "onehot":
        if ns + nc > ATTR_ROWS:
            raise ValueError(f"the attribute table holds <= {ATTR_ROWS} primitives, "
                             f"got {ns}+{nc}")
        table = build_attr_table(scene, (ns, nc)).detach().contiguous()

    n_slots = n_frames * spp
    f32 = dict(dtype=torch.float32, device=device)
    rad_sum = torch.empty((3, n_rows, width), **f32)
    miss_dir = torch.empty((n_slots, 3, n_rows, width), **f32)
    miss_thr = torch.empty((n_slots, 3, n_rows, width), **f32)
    ray_count = torch.empty((n_rows, width), dtype=torch.int32, device=device)
    seed = torch.empty((n_rows, width), dtype=torch.int64, device=device)
    cam = _camera_vector(inv_proj, inv_view, focal_length, aperture_diameter)

    lib = load_library()
    outs = (rad_sum.data_ptr(), miss_dir.data_ptr(), miss_thr.data_ptr(),
            ray_count.data_ptr(), seed.data_ptr())
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        if gather == "onehot":
            entry = "tpt_trace_onehot"
            err = lib.tpt_trace_onehot(
                scene.sphere_pos_radius.data_ptr(), scene.cuboid_min.data_ptr(),
                scene.cuboid_max.data_ptr(), table.data_ptr(), ns, nc, cam.data_ptr(),
                width, height, n_rows, int(row0), int(frame0), spp, ray_depth,
                int(jitter == "center"), int(bool(rr)), *outs, stream)
        else:
            entry = "tpt_trace_progressive"
            err = lib.tpt_trace_progressive(
                scene.sphere_pos_radius.data_ptr(), scene.sphere_material.data_ptr(),
                scene.cuboid_min.data_ptr(), scene.cuboid_max.data_ptr(),
                scene.cuboid_material.data_ptr(), ns, nc, cam.data_ptr(),
                width, height, n_rows, int(row0), int(frame0), n_frames, n_valid, spp,
                ray_depth, int(jitter == "center"), int(bool(rr)), *outs, stream)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {err}")
    LAUNCHES += 1
    ONEHOT_LAUNCHES += int(gather == "onehot")
    return ProgressiveTraceResult(rad_sum=rad_sum, miss_dir=miss_dir, miss_thr=miss_thr,
                                  ray_count=ray_count, seed=seed)


def trace_progressive(scene, inv_proj, inv_view, frame0, focal_length, aperture_diameter,
                      *, width: int, height: int, ray_depth: int, spp: int,
                      n_frames: int, n_valid: int | None = None,
                      counts: Tuple[int, int] | None = None, n_rows: int | None = None,
                      row0: int = 0, jitter: str = "corner",
                      rr: bool = True) -> ProgressiveTraceResult:
    """Trace ``n_frames`` consecutive progressive frames in one launch
    (counterpart of pallas_trace_progressive).

    Returns rad_sum f32[3, n_rows, width], miss_dir / miss_thr
    f32[n_frames*spp, 3, n_rows, width], ray_count i32 and seed i64
    [n_rows, width].  Frames ``>= n_valid`` are skipped and their slots are
    zero.  Row-band mode: ``n_rows`` rows from traced row ``row0``."""
    kwargs = dict(width=width, height=height, ray_depth=ray_depth, spp=spp,
                  n_frames=n_frames, counts=counts, row0=row0, jitter=jitter, rr=rr)
    if scene.device.type == "cpu":
        return trace_progressive_plain(scene, inv_proj, inv_view, frame0, focal_length,
                                       aperture_diameter, n_valid=n_valid,
                                       n_rows=n_rows, **kwargs)
    n_valid = n_frames if n_valid is None else int(n_valid)
    _check_args(jitter, spp, ray_depth, n_frames, n_valid)
    return _launch(scene, inv_proj, inv_view, frame0, focal_length, aperture_diameter,
                   n_valid=n_valid, n_rows=height if n_rows is None else n_rows, **kwargs)


def trace(scene, inv_proj, inv_view, frame, focal_length, aperture_diameter,
          *, width: int, height: int, ray_depth: int, spp: int,
          counts: Tuple[int, int] | None = None, n_rows: int | None = None,
          row0: int = 0, jitter: str = "corner", rr: bool = True,
          gather: str = "select") -> TraceResult:
    """Trace one frame (counterpart of pallas_trace, either gather).

    ``gather="onehot"`` needs ``counts`` (static counts in the TPU wrapper)
    and reads the winners from build_attr_table(scene, counts); its results
    are those of ``gather="select"``, bit for bit.  Returns radiance
    f32[3, n_rows, width] summed over spp, miss_dir / miss_thr
    f32[spp, 3, n_rows, width], ray_count i32 and seed i64."""
    _check_gather(gather, counts)
    kwargs = dict(width=width, height=height, ray_depth=ray_depth, spp=spp,
                  counts=counts, row0=row0, jitter=jitter, rr=rr, gather=gather)
    if scene.device.type == "cpu":
        return trace_plain(scene, inv_proj, inv_view, frame, focal_length,
                           aperture_diameter, n_rows=n_rows, **kwargs)
    _check_args(jitter, spp, ray_depth, 1, 1)
    res = _launch(scene, inv_proj, inv_view, frame, focal_length, aperture_diameter,
                  n_frames=1, n_valid=1, n_rows=height if n_rows is None else n_rows,
                  **kwargs)
    return TraceResult(radiance=res.rad_sum, miss_dir=res.miss_dir,
                       miss_thr=res.miss_thr, ray_count=res.ray_count, seed=res.seed)

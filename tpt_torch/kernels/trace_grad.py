"""The backward kernels' wrapper, its plain PyTorch version, and
``trace_diff``, the differentiable trace (port of tpt.kernels.trace_grad).

``trace_diff`` is a ``torch.autograd.Function`` over two differentiable
inputs, both built from the caller's tensors by differentiable torch ops:

  * ``table = build_attr_table(scene, counts)``, f32[128, 24] — autograd
    maps its cotangent back to the ``Scene`` leaves;
  * ``cam20``, the 20 camera scalars in the order of the TPU kernel
    (:func:`camera_vector`) — autograd maps its cotangent back to the 4x4
    inverse matrices, the focal length and the aperture.

Its forward is the trace kernel of tpt_torch.kernels.trace at one frame;
its backward is :func:`trace_grad`, which for CUDA tensors launches the two
hand-written CUDA kernels that replace pallas_trace_grad, and for CPU
tensors runs :func:`trace_grad_plain` — autograd through the plain
integrator.  There is no fallback from the device to the plain version.

The two kernels share a tape in device memory (tpt_torch/csrc/grad.cuh):
``trace_grad_tape_kernel`` (csrc/trace_grad.cu) runs the forward sweep and
writes each live bounce's input carry (10 words; with ``half_stores`` only
at even bounces) and decision code (1 word), and each (pixel, sample)
item's live-bounce count; ``trace_grad_adjoint_kernel``
(csrc/trace_grad_adjoint.cu) reads it back in the reverse sweep, runs the
camera adjoint, reduces, applies the finite filter and writes the result.
The tape takes :func:`tape_bytes` — 4 x pixels x spp x (10 x slots +
ray_depth + 1) bytes, slots = ray_depth (or half of it), about 1.19 GB at
1080p, depth 13, 1 spp — from the caching allocator (``torch.empty``,
never zeroed).  A launch whose tape would pass ``TAPE_BYTES_MAX`` runs the
two kernels over row chunks (:func:`row_chunks`) that reuse one tape; the
adjoint kernel of each chunk adds to per-block partials in a workspace made
once per (device, stream), and the last chunk's merges them.  The finite
filter of the TPU wrapper is kept inside the merge: non-finite cotangent
entries (measure-zero events such as an axis-parallel ray on a cuboid
winner) are zeroed, and their count is returned as a device tensor, so
reading it is the caller's choice of when to synchronise.

Both kernels come from dynamic builds (tpt_torch.kernels._build), one
library each, built together at first use (:func:`libraries`).  The tape
kernel built for a scene's static counts, as the JAX backward always
folds them, was slower on the H100 (PERF.md section 6, the static-count
builds).  The adjoint kernel reads the winners from the tape.

``GRAD_LAUNCHES`` counts backward calls on the card (one per
:func:`trace_grad`), ``TAPE_LAUNCHES`` and ``ADJOINT_LAUNCHES`` each
kernel's launches (one per row chunk).  Each call of :func:`trace_grad` is
the span ``trace_grad.launch`` (tpt_torch.utils.profiling).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import NamedTuple, Tuple

import torch

from ..config import MAX_CUBOIDS, MAX_SPHERES
from ..integrator import (ATTR_COLS, ATTR_ROWS, CameraParams, TraceResult,
                          build_attr_table, make_scene_scan_fn, make_table_trace_fn,
                          trace_paths)
from ..utils import profiling
from . import _build
from .trace import forward_key, forward_library, pixel_band, trace, warp_segments

SOURCES = ("trace_grad.cu", "trace_grad_adjoint.cu")   # the tape kernel's, the adjoint's
N_CAM = 20  # ip00 ip01 ip02 ip10 ip11 ip12, right, up, backward, eye, focal, aperture
ABLATE_MODES = ("none", "nocam", "nostores", "nodtbl", "norev", "primalonly")

# The ablate modes (timing probes of the TPU kernel) as the phases they turn
# off (csrc/grad.cuh kFlag*): nostores keeps no carries on the tape (the
# reverse sweep replays the first bounce's carry), norev runs no reverse
# sweep, primalonly replays each bounce without its adjoint, nocam skips the
# camera adjoint, nodtbl the table accumulation.
STORES, REVERSE, ADJOINT, CAMERA, TABLE = 1, 2, 4, 8, 16
ALL_PHASES = STORES | REVERSE | ADJOINT | CAMERA | TABLE
ABLATE_FLAGS = {"none": ALL_PHASES, "nocam": ALL_PHASES & ~CAMERA,
                "nostores": ALL_PHASES & ~STORES, "nodtbl": ALL_PHASES & ~TABLE,
                "norev": ALL_PHASES & ~REVERSE, "primalonly": ALL_PHASES & ~ADJOINT}

CARRY_WORDS = 10                 # o, d, thr, seed (csrc/grad.cuh)
TAPE_BYTES_MAX = 2 << 30         # the most tape one launch of the pair takes
OUT_WORDS = ATTR_ROWS * ATTR_COLS + N_CAM + 2   # d_table, d_cam, n_zeroed (i64)

GRAD_LAUNCHES = 0
TAPE_LAUNCHES = 0
ADJOINT_LAUNCHES = 0
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
    for x in (focal_length, aperture_diameter):
        x = torch.as_tensor(x, dtype=torch.float32).reshape(())
        if x.device != ip.device:   # a copy between the host and the device synchronises
            with profiling.sync("camera_scalar", x.device, ip.device):
                x = x.to(ip.device)
        parts.append(x)
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


def carry_slots(ray_depth: int, half_stores: bool) -> int:
    """Carries a (pixel, sample) item keeps: every bounce's, or with
    ``half_stores`` the even bounces' (csrc/grad.cuh carry_slots)."""
    return (ray_depth + 1) // 2 if half_stores else ray_depth


def tape_bytes(width: int, n_rows: int, spp: int, ray_depth: int,
               half_stores: bool = False) -> int:
    """Bytes of the tape for an n_rows x width band: the carries, the
    decision codes and the live-bounce counts, 4 bytes a word."""
    words = CARRY_WORDS * carry_slots(ray_depth, half_stores) + ray_depth + 1
    return 4 * n_rows * width * spp * words


def row_chunks(n_rows: int, width: int, spp: int, ray_depth: int,
               half_stores: bool = False) -> list:
    """(first row, rows) of the chunks a launch runs in, each chunk's tape
    at most ``TAPE_BYTES_MAX`` (at least one row a chunk)."""
    per_row = tape_bytes(width, 1, spp, ray_depth, half_stores)
    rows = max(1, min(n_rows, TAPE_BYTES_MAX // per_row))
    return [(r, min(rows, n_rows - r)) for r in range(0, n_rows, rows)]


def lane_efficiency(ray_count: torch.Tensor) -> float:
    """The lane efficiency of a reverse sweep that gives each thread one
    pixel's path: the sum of the per-pixel path lengths ``ray_count`` over
    32 x the sum, over each 32 consecutive pixels (a warp; the last one
    padded with zeros), of their longest path."""
    total, warp_max = (int(x) for x in warp_segments(ray_count))
    return total / (32.0 * warp_max) if total else 1.0


_WORKSPACES = {}   # (device index, stream) -> (workspace, grid)


@functools.lru_cache(maxsize=None)
def libraries():
    """The tape kernel's and the adjoint kernel's libraries (SOURCES),
    dynamic builds, built together at first use."""
    _build.build_all((src, None) for src in SOURCES)
    return tuple(_build.library(src) for src in SOURCES)


@functools.lru_cache(maxsize=None)
def diff_libraries(counts: Tuple[int, int]):
    """The libraries of a :func:`trace_diff` call with ``counts`` on the
    card: the trace.cu build its one-frame forward takes
    (kernels.trace.forward_library) and :func:`libraries`, the three built
    together at first use."""
    key = forward_key(counts, False, 1)
    _build.build_all([("trace.cu", key)] + [(src, None) for src in SOURCES])
    return (forward_library(counts, False, 1),) + libraries()


def _workspace(device: torch.device, stream: int):
    """The adjoint kernel's workspace for one (device, stream): the
    per-block partials and two counters, zeroed once when made (the kernel
    leaves the counters 0), and the persistent grid it was sized for."""
    key = (device.index, stream)
    if key not in _WORKSPACES:
        words, per_sm, grid = ctypes.c_int64(), ctypes.c_int(), ctypes.c_int()
        err = libraries()[1].tpt_trace_grad_adjoint_layout(
            ctypes.byref(words), ctypes.byref(per_sm), ctypes.byref(grid))
        if err != 0 or grid.value <= 0:
            raise RuntimeError(f"tpt_trace_grad_adjoint_layout failed: CUDA error {err}")
        _WORKSPACES[key] = (torch.zeros(words.value, dtype=torch.float32, device=device),
                            grid.value)
    return _WORKSPACES[key]


def _device_inputs(device, scene, table, cam20, cotangents, npix: int, spp: int) -> dict:
    """The kernels' inputs as contiguous f32 tensors on ``device`` (a CUDA
    device), by name; ``cotangents`` (g_rad, g_missd, g_misst) may be None
    (the tape alone).  Raises ValueError naming the first wrong tensor."""
    expect = {
        "scene.sphere_pos_radius": (scene.sphere_pos_radius, (MAX_SPHERES, 4)),
        "scene.cuboid_min": (scene.cuboid_min, (MAX_CUBOIDS, 3)),
        "scene.cuboid_max": (scene.cuboid_max, (MAX_CUBOIDS, 3)),
        "table": (table, (ATTR_ROWS, ATTR_COLS)),
        "cam20": (cam20, (N_CAM,)),
    }
    if cotangents is not None:
        for name, t, shape in zip(("g_rad", "g_missd", "g_misst"), cotangents,
                                  ((3, npix), (spp, 3, npix), (spp, 3, npix))):
            expect[name] = (t, shape)
    args = {}
    for name, (t, shape) in expect.items():
        if t.device != device or t.dtype != torch.float32 or t.numel() != math.prod(shape):
            raise ValueError(f"{name} must be f32{list(shape)} on {device}, got "
                             f"{t.dtype}{list(t.shape)} on {t.device}")
        args[name] = t.detach().contiguous()
    return args


def _tape_words(pixels: int, spp: int, ray_depth: int, half_stores: bool):
    """The words of the tape's (carries, codes, counts) for ``pixels`` pixels."""
    return (spp * carry_slots(ray_depth, half_stores) * CARRY_WORDS * pixels,
            spp * ray_depth * pixels, spp * pixels)


def _empty_tape(device, words):
    """(carries, codes, counts) of the given sizes, unzeroed."""
    return tuple(torch.empty(n, dtype=dt, device=device)
                 for n, dt in zip(words, (torch.float32, torch.int32, torch.int32)))


def _launch_tape(args, counts, band, tape, stream):
    """One launch of the tape kernel; ``band`` holds its 11 int arguments
    from the frame to the ablate flags."""
    global TAPE_LAUNCHES
    err = libraries()[0].tpt_trace_grad_tape(
        args["scene.sphere_pos_radius"].data_ptr(), args["scene.cuboid_min"].data_ptr(),
        args["scene.cuboid_max"].data_ptr(), args["table"].data_ptr(), counts[0], counts[1],
        args["cam20"].data_ptr(), *band, *(t.data_ptr() for t in tape), stream)
    if err != 0:
        raise RuntimeError(f"tpt_trace_grad_tape launch failed: CUDA error {err}")
    TAPE_LAUNCHES += 1


def _band_ints(frame, width, height, rows, row0, spp, ray_depth, jitter, rr, half_stores,
               ablate):
    return (int(frame), width, height, rows, int(row0), spp, ray_depth, int(jitter == "center"),
            int(bool(rr)), int(bool(half_stores)), ABLATE_FLAGS[ablate])


def _cuda_device(table) -> torch.device:
    if table.device.type != "cuda":
        raise ValueError(f"the backward kernels run on CUDA tensors, got {table.device}")
    return table.device


def _launch(scene, table, cam20, frame, g_rad, g_missd, g_misst, *, width, height,
            ray_depth, spp, counts, n_rows, row0, jitter, rr, half_stores,
            ablate) -> GradResult:
    global GRAD_LAUNCHES, ADJOINT_LAUNCHES
    device = _cuda_device(table)
    npix = n_rows * width
    args = _device_inputs(device, scene, table, cam20, (g_rad, g_missd, g_misst), npix, spp)
    chunks = row_chunks(n_rows, width, spp, ray_depth, half_stores)
    out = torch.empty(OUT_WORDS, dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        work, grid = _workspace(device, stream)
        tape = _empty_tape(device, _tape_words(max(rows for _, rows in chunks) * width, spp,
                                               ray_depth, half_stores))
        for k, (r, rows) in enumerate(chunks):
            band = _band_ints(frame, width, height, rows, row0 + r, spp, ray_depth, jitter, rr,
                              half_stores, ablate)
            _launch_tape(args, counts, band, tape, stream)
            first = 4 * r * width   # bytes to the chunk's first pixel
            err = libraries()[1].tpt_trace_grad_adjoint(
                args["table"].data_ptr(), counts[0], counts[1], args["cam20"].data_ptr(), *band,
                *(t.data_ptr() for t in tape), args["g_rad"].data_ptr() + first,
                args["g_missd"].data_ptr() + first, args["g_misst"].data_ptr() + first, npix,
                int(k == 0), int(k == len(chunks) - 1), grid, work.data_ptr(), out.data_ptr(),
                stream)
            if err != 0:
                raise RuntimeError(f"tpt_trace_grad_adjoint launch failed: CUDA error {err}")
            ADJOINT_LAUNCHES += 1
    GRAD_LAUNCHES += 1
    n_table = ATTR_ROWS * ATTR_COLS
    return GradResult(out[:n_table].view(ATTR_ROWS, ATTR_COLS), out[n_table:n_table + N_CAM],
                      out[n_table + N_CAM:].view(torch.int64).reshape(()))


def _tape_counts(scene, table, cam20, frame, *, width: int, height: int, ray_depth: int,
                spp: int, counts: Tuple[int, int], n_rows: int | None = None, row0: int = 0,
                jitter: str = "corner", rr: bool = True, tape: bool = False):
    """The tape kernel alone over one band (CUDA tensors only): each (pixel,
    sample) item's live bounces, i32[spp, n_rows, width].  Their sum over
    the samples is the forward kernel's ``ray_count`` exactly when the tape
    kernel took the forward kernel's decisions.  ``tape=True`` returns the
    whole tape (carries, codes, counts) instead."""
    _check_args(counts, jitter, spp, ray_depth)
    n_rows = height if n_rows is None else n_rows
    device = _cuda_device(table)
    args = _device_inputs(device, scene, table, cam20, None, n_rows * width, spp)
    if tape_bytes(width, n_rows, spp, ray_depth) > TAPE_BYTES_MAX:
        raise ValueError(f"the band's tape passes TAPE_BYTES_MAX ({TAPE_BYTES_MAX} bytes)")
    words = _empty_tape(device, _tape_words(n_rows * width, spp, ray_depth, False))
    with torch.cuda.device(device):
        _launch_tape(args, counts, _band_ints(frame, width, height, n_rows, row0, spp,
                                              ray_depth, jitter, rr, False, "none"),
                     words, torch.cuda.current_stream(device).cuda_stream)
    return words if tape else words[2].view(spp, n_rows, width)


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
    with profiling.span("trace_grad.launch"):
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


_GEOMETRY = ("sphere_pos_radius", "cuboid_min", "cuboid_max")   # what the fold reads


class _TraceDiff(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, cam20, scene, inv_proj, inv_view, frame, focal_length,
                aperture_diameter, cfg):
        res = trace(scene, inv_proj, inv_view, frame, focal_length, aperture_diameter,
                    width=cfg["width"], height=cfg["height"], ray_depth=cfg["ray_depth"],
                    spp=cfg["spp"], counts=cfg["counts"], n_rows=cfg["n_rows"],
                    row0=cfg["row0"], jitter=cfg["jitter"], rr=cfg["rr"])
        # the geometry too goes through save_for_backward, so that an in-place
        # edit of it before the backward raises instead of giving a wrong
        # gradient
        ctx.save_for_backward(table, cam20, *(getattr(scene, n) for n in _GEOMETRY))
        ctx.scene, ctx.frame, ctx.cfg = scene, frame, cfg
        ctx.mark_non_differentiable(res.ray_count, res.seed)
        return res.radiance, res.miss_dir, res.miss_thr, res.ray_count, res.seed

    @staticmethod
    def backward(ctx, g_rad, g_missd, g_misst, _g_rays, _g_seed):
        table, cam20, *geometry = ctx.saved_tensors
        scene = dataclasses.replace(ctx.scene, **dict(zip(_GEOMETRY, geometry)))
        out = trace_grad(scene, table, cam20, ctx.frame, g_rad.contiguous(),
                         g_missd.contiguous(), g_misst.contiguous(), **ctx.cfg)
        global LAST_ZEROED
        LAST_ZEROED = out.n_zeroed
        return out.d_table, out.d_cam, None, None, None, None, None, None, None


def trace_diff(scene, inv_proj, inv_view, frame, focal_length, aperture_diameter,
               row0: int = 0, *, width: int, height: int, ray_depth: int, spp: int,
               counts: Tuple[int, int], n_rows: int | None = None,
               jitter: str = "corner", rr: bool = True,
               cam20: torch.Tensor | None = None) -> TraceResult:
    """Differentiable trace of one frame (counterpart of tpt's trace_diff):
    the kernel forward, the backward kernel in reverse mode.

    Returns the TraceResult of tpt_torch.kernels.trace.trace, reverse-mode
    differentiable with respect to the scene's float leaves, the inverse
    matrices, the focal length and the aperture (whichever of them require
    grad); ``ray_count`` and ``seed`` carry no gradient.  Compose with
    tpt_torch.integrator.apply_environment_blocked for a differentiable
    frame (the environment's cotangent comes from autograd through the
    gather).  ``row0``/``n_rows`` select a pixel-row band.

    ``cam20``: None, or the camera arguments' :func:`camera_vector` on the
    device, built once for a camera that is not differentiated: the call
    then does not build it (from host scalars, copies that wait for the
    device) and takes the camera as a constant, so ValueError if a camera
    argument requires grad."""
    _check_args(counts, jitter, spp, ray_depth)
    table = build_attr_table(scene, counts)
    if table.device.type == "cuda":
        diff_libraries(tuple(counts))
    if cam20 is None:
        cam20 = camera_vector(inv_proj, inv_view, focal_length, aperture_diameter,
                              device=table.device)
    elif any(isinstance(x, torch.Tensor) and x.requires_grad
             for x in (inv_proj, inv_view, focal_length, aperture_diameter)):
        raise ValueError("a prebuilt cam20 is a constant: no camera argument may require grad")
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

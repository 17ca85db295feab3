"""The trace kernel's wrappers and their plain PyTorch versions.

One CUDA kernel (tpt_torch/csrc/trace.cu) replaces the TPU kernels of the
JAX package's forward trace:

  * :func:`trace_progressive` — tpt.kernels.trace.pallas_trace_progressive,
    the refill kernel: ``n_frames`` progressive frames in one launch.  With
    ``env_table`` (a tpt_torch.env.pack_block_table table) it launches the
    kernel's environment mode, which looks the environment up when a path
    escapes and adds it to ``rad_sum``, and writes no miss slots: the block
    path of tpt_torch.kernels.render.progressive_frames.  The table may be
    the f32 one or the opt-in bf16 one (``--env-bf16``), each read by its
    own instantiation of the mode;
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
``ONEHOT_LAUNCHES`` and ``ENV_LAUNCHES`` count those of them made in the
table mode and in the environment mode, ``ENV_BF16_LAUNCHES`` those of the
environment mode with a bf16 table.

Keyword arguments are those of the JAX wrappers.  ``counts`` bounds the
scan in place of the scene's own counts.  The kernel's library
(tpt_torch.kernels._build) is built dynamic, reading the counts at run
time and serving any scene, or for given counts, which it has as
compile-time constants, as tpt's accelerator path compiles its kernels
for a scene's static counts.  The two give the same bits.  On a CUDA
device a launch takes the build the card measured faster for it
(:func:`forward_key`): an environment-mode block with given ``counts``
(the render and viewer paths) the build for those counts, every other
launch the dynamic build.  A build is made at its first use; one that
fails raises, and nothing falls back to another build or to the plain
version.  ``BUILD_LAUNCHES`` counts launches by build key (``None`` for
the dynamic build, ``(n_spheres, n_cuboids)`` for one built for counts).
Seeds come back as int64 tensors holding uint32 values
(tpt_torch.rng).

Each call of :func:`trace_progressive` and :func:`trace` is the span
``trace.launch`` (tpt_torch.utils.profiling).  While the profiler records,
it also counts, by path (``env`` for environment-mode launches,
``progressive`` for the other refill launches, ``select`` or ``onehot`` for
one frame), the traced segments ``trace.<path>.segments`` and
``trace.<path>.warp_max_segments``, the sum over each warp (32 consecutive
pixels of the band, the last warp padded) of the loop iterations it ran:
lane efficiency is ``segments / (32 warp_max_segments)``, kept on the
device.  The select and table modes run one pixel a lane, so a warp's
iterations are its longest path, :func:`warp_segments` of the ray counts,
as tpt_torch.kernels.trace_grad.lane_efficiency computes it.  The
environment mode on the card pools a warp's (pixel, frame) items among its
lanes (csrc/trace.cu), and its launches under the profiler return each
warp's iterations, which give its ``warp_max_segments`` there; on the CPU
the plain version's one-pixel-a-lane loop gives :func:`warp_segments`.
At one frame of one sample the two are the same.
"""

from __future__ import annotations

import collections
from typing import Tuple

import torch

from ..config import MAX_CUBOIDS, MAX_SPHERES
from ..env import env_size_from_table
from ..integrator import (ATTR_ROWS, ProgressiveTraceResult, TraceResult, build_attr_table,
                          camera_params, make_onehot_gather_trace_fn, make_scene_scan_fn,
                          make_scene_trace_fn, trace_paths)
from ..integrator import trace_progressive as _integrator_trace_progressive
from ..utils import profiling
from ._build import build_key, library

LAUNCHES = 0
ONEHOT_LAUNCHES = 0
ENV_LAUNCHES = 0
ENV_BF16_LAUNCHES = 0
BUILD_LAUNCHES = collections.Counter()   # build key -> launches (module docstring)
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


# a pack_block_table row's words -> the boundary its rows start on: the
# kernel reads an f32 row (48 bytes) as three 16-byte loads and a bf16 row
# (24 bytes, 12 bf16 values packed in pairs) as three 8-byte loads
ENV_ROW_ALIGN = {12: 16, 6: 8}


def _check_env_table(env_table, device) -> Tuple[int, bool]:
    """(face size S, whether the table is bf16) of a pack_block_table
    table, or ValueError unless it is a contiguous f32[6 (S + 2)^2, 12]
    on a 16-byte boundary, or its bf16 form f32[6 (S + 2)^2, 6] on an
    8-byte boundary, on ``device``."""
    t = env_table
    size = env_size_from_table(t) if t.dim() == 2 and t.shape[0] >= 6 else 0
    if (t.dtype != torch.float32 or t.dim() != 2 or t.shape[1] not in ENV_ROW_ALIGN
            or size < 1 or t.shape[0] != 6 * (size + 2) ** 2 or not t.is_contiguous()):
        raise ValueError(f"env_table must be a contiguous f32[6 (S + 2)^2, 12] or its bf16 "
                         f"form f32[6 (S + 2)^2, 6] (pack_block_table), got "
                         f"{t.dtype}{list(t.shape)}")
    if t.device != device:
        raise ValueError(f"env_table is on {t.device}, the scene on {device}")
    align = ENV_ROW_ALIGN[t.shape[1]]
    if t.data_ptr() % align != 0:
        raise ValueError(f"env_table with {t.shape[1]}-word rows must start on a {align}-byte "
                         f"boundary")
    return size, t.shape[1] == 6


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
                            jitter: str = "corner", rr: bool = True,
                            env_table: torch.Tensor | None = None) -> ProgressiveTraceResult:
    """Plain version of :func:`trace_progressive`: the lane-queue loop of
    tpt_torch.integrator.trace_progressive over the pixel band, with the
    environment added at each sample's end when ``env_table`` is given."""
    n_valid = n_frames if n_valid is None else int(n_valid)
    _check_args(jitter, spp, ray_depth, n_frames, n_valid)
    if env_table is not None:
        _check_env_table(env_table, scene.device)
    n_rows = height if n_rows is None else n_rows
    px, py = pixel_band(width, height, n_rows, row0, scene.device)
    cam = camera_params(inv_proj, inv_view, focal_length, aperture_diameter)
    return _integrator_trace_progressive(
        make_scene_trace_fn(scene, counts), cam, px, py, width, height, int(frame0),
        ray_depth, spp, n_frames, n_valid=n_valid, jitter=jitter, russian_roulette=rr,
        env_table=env_table)


def _host_matrix(m) -> torch.Tensor:
    """A 4x4 matrix as f32[16] on the host (from a CUDA device, a
    synchronising copy)."""
    t = torch.as_tensor(m, dtype=torch.float32).detach()
    with profiling.sync("camera_matrix", t.device):
        return t.cpu().reshape(16)


def _camera_vector(inv_proj, inv_view, focal_length, aperture_diameter) -> torch.Tensor:
    """f32[34] on the host: inv_proj and inv_view row-major, focal length,
    aperture diameter (the TPU kernel's packed SMEM camera)."""
    return torch.cat([
        _host_matrix(inv_proj), _host_matrix(inv_view),
        torch.tensor([float(focal_length), float(aperture_diameter)], dtype=torch.float32),
    ]).contiguous()


def n_warps(n_pixels: int) -> int:
    """The warps of a launch over ``n_pixels`` pixels, one thread a pixel."""
    return -(-int(n_pixels) // 32)


def warp_segments(ray_count: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the traced segments, the sum over each warp, 32 consecutive pixels
    with the last one padded with zeros, of its longest path) of integer
    per-pixel path lengths, as int64 tensors on their device (no sync)."""
    n = ray_count.detach().reshape(-1)
    if n.numel() % 32:
        n = torch.cat([n, n.new_zeros(-n.numel() % 32)])
    return n.sum(dtype=torch.int64), n.view(-1, 32).amax(dim=1).sum(dtype=torch.int64)


def _count_lanes(path: str, ray_count: torch.Tensor, warp_iters: torch.Tensor | None = None):
    """Add a launch's segments and warp iterations to the counters of
    ``path`` (module docstring): the kernel's ``warp_iters`` where it wrote
    them, else :func:`warp_segments`."""
    segments, warp_max = warp_segments(ray_count) if warp_iters is None else (
        ray_count.sum(dtype=torch.int64), warp_iters.sum(dtype=torch.int64))
    profiling.count(f"trace.{path}.segments", segments)
    profiling.count(f"trace.{path}.warp_max_segments", warp_max)


# the fewest frames a launch must trace for the build for its counts to pay
BLOCK_FRAMES = 2


def forward_key(counts, env_mode: bool, n_frames: int):
    """The key (_build.build_key) of the trace.cu build a launch takes on
    the card, by what the card measured (PERF.md section 6, the
    static-count builds; NVIDIA H100): with given ``counts`` the
    environment mode ran 3.0-3.7% faster through the build for them than
    through the dynamic build at 2 to 30 frames a launch at 1080p, while
    its one-frame launch ran 2.2% slower, as did the select gather's.  So
    an environment-mode launch of at least BLOCK_FRAMES frames with given
    counts takes the build for them, every other launch the dynamic one."""
    return build_key(counts if env_mode and n_frames >= BLOCK_FRAMES else None)


def forward_library(counts, env_mode: bool, n_frames: int):
    """The trace.cu library a launch takes on the card (:func:`forward_key`)."""
    return library("trace.cu", forward_key(counts, env_mode, n_frames))


def _launch(scene, inv_proj, inv_view, frame0, focal_length, aperture_diameter, *,
            width, height, ray_depth, spp, n_frames, n_valid, counts, n_rows, row0,
            jitter, rr, gather="select", env_table=None, lib=None,
            warp_iters=None) -> ProgressiveTraceResult:
    """One launch of the kernel from ``lib`` (a trace.cu _build.library;
    by default :func:`forward_library`'s).  ``warp_iters``: with
    ``env_table``, None or a contiguous i32[ceil(n_rows width / 32)] on the
    device, which gets each warp's loop iterations."""
    global LAUNCHES, ONEHOT_LAUNCHES, ENV_LAUNCHES, ENV_BF16_LAUNCHES
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
    if env_table is not None:
        env_size, env_bf16 = _check_env_table(env_table, device)
    if warp_iters is not None and (
            env_table is None or warp_iters.device != device or warp_iters.dtype != torch.int32
            or tuple(warp_iters.shape) != (n_warps(n_rows * width),)
            or not warp_iters.is_contiguous()):
        raise ValueError(f"warp_iters, which only the environment mode writes, must be a "
                         f"contiguous i32[{n_warps(n_rows * width)}] on {device}, got "
                         f"{warp_iters.dtype}{list(warp_iters.shape)} on {warp_iters.device}")

    f32 = dict(dtype=torch.float32, device=device)
    rad_sum = torch.empty((3, n_rows, width), **f32)
    ray_count = torch.empty((n_rows, width), dtype=torch.int32, device=device)
    seed = torch.empty((n_rows, width), dtype=torch.int64, device=device)
    miss_dir = miss_thr = None
    if env_table is None:
        miss_dir = torch.empty((n_frames * spp, 3, n_rows, width), **f32)
        miss_thr = torch.empty_like(miss_dir)
    cam = _camera_vector(inv_proj, inv_view, focal_length, aperture_diameter)

    if lib is None:
        lib = forward_library(counts, env_table is not None, n_frames)
    scene_ptrs = (scene.sphere_pos_radius.data_ptr(), scene.sphere_material.data_ptr(),
                  scene.cuboid_min.data_ptr(), scene.cuboid_max.data_ptr(),
                  scene.cuboid_material.data_ptr())
    band = (width, height, n_rows, int(row0), int(frame0), n_frames, n_valid, spp, ray_depth,
            int(jitter == "center"), int(bool(rr)))
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        if env_table is not None:
            entry = "tpt_trace_progressive_env" + ("_bf16" if env_bf16 else "")
            err = getattr(lib, entry)(
                *scene_ptrs, ns, nc, cam.data_ptr(), *band, env_table.data_ptr(), env_size,
                rad_sum.data_ptr(), ray_count.data_ptr(), seed.data_ptr(),
                None if warp_iters is None else warp_iters.data_ptr(), stream)
        elif gather == "onehot":
            entry = "tpt_trace_onehot"
            err = lib.tpt_trace_onehot(
                scene.sphere_pos_radius.data_ptr(), scene.cuboid_min.data_ptr(),
                scene.cuboid_max.data_ptr(), table.data_ptr(), ns, nc, cam.data_ptr(),
                width, height, n_rows, int(row0), int(frame0), spp, ray_depth,
                int(jitter == "center"), int(bool(rr)), rad_sum.data_ptr(),
                miss_dir.data_ptr(), miss_thr.data_ptr(), ray_count.data_ptr(),
                seed.data_ptr(), stream)
        else:
            entry = "tpt_trace_progressive"
            err = lib.tpt_trace_progressive(
                *scene_ptrs, ns, nc, cam.data_ptr(), *band, rad_sum.data_ptr(),
                miss_dir.data_ptr(), miss_thr.data_ptr(), ray_count.data_ptr(),
                seed.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {err}")
    LAUNCHES += 1
    ONEHOT_LAUNCHES += int(gather == "onehot")
    ENV_LAUNCHES += int(env_table is not None)
    ENV_BF16_LAUNCHES += int(env_table is not None and env_bf16)
    BUILD_LAUNCHES[lib.key] += 1
    return ProgressiveTraceResult(rad_sum=rad_sum, miss_dir=miss_dir, miss_thr=miss_thr,
                                  ray_count=ray_count, seed=seed)


def trace_progressive(scene, inv_proj, inv_view, frame0, focal_length, aperture_diameter,
                      *, width: int, height: int, ray_depth: int, spp: int,
                      n_frames: int, n_valid: int | None = None,
                      counts: Tuple[int, int] | None = None, n_rows: int | None = None,
                      row0: int = 0, jitter: str = "corner", rr: bool = True,
                      env_table: torch.Tensor | None = None) -> ProgressiveTraceResult:
    """Trace ``n_frames`` consecutive progressive frames in one launch
    (counterpart of pallas_trace_progressive).

    Returns rad_sum f32[3, n_rows, width], miss_dir / miss_thr
    f32[n_frames*spp, 3, n_rows, width], ray_count i32 and seed i64
    [n_rows, width].  Frames ``>= n_valid`` are skipped and their slots are
    zero.  Row-band mode: ``n_rows`` rows from traced row ``row0``.

    ``env_table``: a contiguous pack_block_table table on the scene's
    device, f32 on a 16-byte boundary or bf16 on an 8-byte boundary (else
    ``ValueError``).  Each sample then
    adds ``radiance + miss_thr * sample_environment_blocked(env_table,
    miss_dir)`` to ``rad_sum`` when it ends, and miss_dir / miss_thr are
    None.  ``counts``: the module docstring."""
    kwargs = dict(width=width, height=height, ray_depth=ray_depth, spp=spp,
                  n_frames=n_frames, counts=counts, row0=row0, jitter=jitter, rr=rr,
                  env_table=env_table)
    warp_iters = None
    with profiling.span("trace.launch"):
        if scene.device.type == "cpu":
            res = trace_progressive_plain(scene, inv_proj, inv_view, frame0, focal_length,
                                          aperture_diameter, n_valid=n_valid,
                                          n_rows=n_rows, **kwargs)
        else:
            n_valid = n_frames if n_valid is None else int(n_valid)
            _check_args(jitter, spp, ray_depth, n_frames, n_valid)
            n_rows = height if n_rows is None else n_rows
            if env_table is not None and profiling.enabled():
                warp_iters = torch.empty(n_warps(n_rows * width), dtype=torch.int32,
                                         device=scene.device)
            res = _launch(scene, inv_proj, inv_view, frame0, focal_length, aperture_diameter,
                          n_valid=n_valid, n_rows=n_rows, warp_iters=warp_iters, **kwargs)
    if profiling.enabled():
        _count_lanes("env" if env_table is not None else "progressive", res.ray_count,
                     warp_iters)
    return res


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
    f32[spp, 3, n_rows, width], ray_count i32 and seed i64.  ``counts``:
    the module docstring."""
    _check_gather(gather, counts)
    kwargs = dict(width=width, height=height, ray_depth=ray_depth, spp=spp,
                  counts=counts, row0=row0, jitter=jitter, rr=rr, gather=gather)
    with profiling.span("trace.launch"):
        if scene.device.type == "cpu":
            res = trace_plain(scene, inv_proj, inv_view, frame, focal_length,
                              aperture_diameter, n_rows=n_rows, **kwargs)
        else:
            _check_args(jitter, spp, ray_depth, 1, 1)
            res = _launch(scene, inv_proj, inv_view, frame, focal_length, aperture_diameter,
                          n_frames=1, n_valid=1, n_rows=height if n_rows is None else n_rows,
                          **kwargs)
            res = TraceResult(radiance=res.rad_sum, miss_dir=res.miss_dir,
                              miss_thr=res.miss_thr, ray_count=res.ray_count, seed=res.seed)
    if profiling.enabled():
        _count_lanes(gather, res.ray_count)
    return res

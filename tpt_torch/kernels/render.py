"""Frame renderer on the kernel path: trace kernel + environment fetch +
accumulator fold (port of tpt.kernels.render).

The transport is tpt_torch.kernels.trace, which launches the CUDA kernel
for a scene on a CUDA device and runs the plain integrator for a scene on
the CPU.  On the block path (``progressive_frames`` with ``n_frames > 1``)
the kernel also fetches the environment, when a path escapes; the
per-frame path fetches it with plain torch ops from the kernel's miss
slots, as the JAX package does with plain XLA.  The block fold is plain
torch ops.  A block is the span ``render.block``, its fold ``render.fold``
(tpt_torch.utils.profiling).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..camera import camera_matrices
from ..config import CameraConfig, RenderConfig
from ..integrator import apply_environment, apply_environment_blocked
from ..progressive import AccumulatorState
from ..utils.profiling import span, sync
from ..vecmath import div_scalar
from .trace import trace, trace_progressive


def kernel_counts(scene, device, configured: Tuple[int, int] | None = None):
    """The counts a render hands the trace kernel, chosen as the JAX package
    chooses them (tpt/cli.py:154-158, tpt/interactive.py:340-344): the
    configured counts, else the scene's own on a CUDA device (where a
    block's environment-mode launch then takes the kernel built for them,
    kernels.trace.forward_library), else None (on the CPU the plain scan
    reads the scene's counts)."""
    if configured is not None:
        return tuple(configured)
    if torch.device(device).type == "cuda":
        return tuple(int(c) for c in scene.counts)
    return None


def render_fields(scene, env_faces, inv_proj, inv_view, view_pos, frame,
                  focal_length, aperture_diameter,
                  *, width: int, height: int, ray_depth: int, spp: int,
                  counts: Tuple[int, int] | None = None,
                  jitter: str = "corner") -> Tuple[torch.Tensor, torch.Tensor]:
    """One frame's mean radiance. Returns (image f32[H, W, 3], rays i64)."""
    del view_pos  # the kernel derives it from inv_view's translation column
    res = trace(scene, inv_proj, inv_view, frame, focal_length, aperture_diameter,
                width=width, height=height, ray_depth=ray_depth, spp=spp,
                counts=counts, jitter=jitter)
    mean = apply_environment(res, env_faces, spp)
    return torch.movedim(mean, 0, -1), res.ray_count.sum()


def render_frame(scene, env_faces, camera: CameraConfig, cfg: RenderConfig,
                 frame: int) -> Tuple[torch.Tensor, torch.Tensor]:
    inv_proj, inv_view, pos = camera_matrices(camera, cfg.width, cfg.height)
    return render_fields(
        scene, env_faces, inv_proj, inv_view, pos, frame,
        camera.focal_length, camera.aperture_diameter,
        width=cfg.width, height=cfg.height, ray_depth=cfg.ray_depth,
        spp=cfg.spp, counts=cfg.static_counts, jitter=cfg.jitter)


def progressive_frames(accum: AccumulatorState, scene, env_table,
                       inv_proj, inv_view, frame0: int, focal_length,
                       aperture_diameter,
                       *, width: int, height: int, ray_depth: int, spp: int,
                       counts: Tuple[int, int] | None = None,
                       n_frames: int = 1, n_valid: int | None = None,
                       jitter: str = "corner"
                       ) -> Tuple[AccumulatorState, torch.Tensor]:
    """Fold ``n_frames`` consecutive progressive frames into the accumulator,
    updating ``accum.image`` in place.  Returns (accum, traced segments).

    * ``n_frames > 1``: one launch of the refill kernel in its environment
      mode traces the whole block and adds each sample's environment term as
      the sample ends, and the block folds in as one running-mean step
      ``acc' = (n0*acc + sum_f frame_f) / max(n0 + F, 1)``
      (tpt/kernels/render.py:110-119, same operation order).  The JAX
      package sums the emission radiance first and then the slots' terms
      in slot order; this sums them sample by sample, so the two differ in
      the last bits of the sum only.
    * ``n_frames == 1``: one launch of the per-frame kernel, the blocked env
      fetch and the reference's per-frame mix ``acc + (mean - acc) / (n + 1)``.

    ``env_table``: pack_block_table(faces) output.  ``n_valid``: frames
    ``k >= n_valid`` contribute nothing (no accumulation, no frame advance,
    no ray count), so a partial tail chunk keeps the block size.
    """
    n_valid = n_frames if n_valid is None else int(n_valid)
    frame0 = int(frame0)
    kwargs = dict(width=width, height=height, ray_depth=ray_depth, spp=spp,
                  counts=counts, jitter=jitter)

    if n_frames > 1:
        with span("render.block"):
            res = trace_progressive(scene, inv_proj, inv_view, frame0, focal_length,
                                    aperture_diameter, n_frames=n_frames, n_valid=n_valid,
                                    env_table=env_table, **kwargs)
            with span("render.fold"):
                total = div_scalar(torch.movedim(res.rad_sum, 0, -1), spp)
                n0 = np.float32(accum.frame)
                denom = max(n0 + np.float32(n_valid), np.float32(1.0))
                accum.image.mul_(float(n0)).add_(total)
                with sync("fold_denominator", accum.image.device):
                    denom = torch.tensor(denom, device=accum.image.device)
                accum.image.div_(denom)
                accum.frame += n_valid
                rays = res.ray_count.sum()
        return accum, rays

    if n_valid == 0:
        return accum, torch.zeros((), dtype=torch.int64, device=accum.image.device)
    res = trace(scene, inv_proj, inv_view, frame0, focal_length, aperture_diameter,
                **kwargs)
    mean = torch.movedim(apply_environment_blocked(res, env_table, spp), 0, -1)
    w = np.float32(1.0) / (np.float32(accum.frame) + np.float32(1.0))
    accum.image.add_((mean - accum.image).mul_(float(w)))
    accum.frame += 1
    return accum, res.ray_count.sum()

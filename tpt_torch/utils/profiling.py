"""Frame timing with the work it represents (port of
tpt.utils.profiling.frame_stats).

The reference's only GPU timing is a TimerQuery around the atmosphere pass
(src/Render/Objects/TimerQuery.cs); its frame rate lives in the window
title.  :func:`frame_stats` times a thunk on the host clock, synchronising
the thunk's CUDA device, and reports the frame time, the traced segments a
second and two rates derived from work counts.

The work counts are the JAX package's estimates for the demo scene, counts
of work, not rates of any chip: a traced segment is about 2300 float
operations (a 55-primitive closest-hit scan at ~30 each, the winner's
fetch, the BSDF and the random draws), and a pixel moves about 56 bytes of
per-pixel state (radiance, miss direction and throughput, counts and seed,
pixel coordinates, the accumulator's read-modify-write).  The trace
kernel's operations bound is chip_smoke.py's count (``trace_bound``).
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch

FLOPS_PER_SEGMENT_DEMO = 2300.0   # float operations a traced segment (see above)
BYTES_PER_PIXEL = 56.0            # bytes of per-pixel state a frame moves (see above)


def _wait(value):
    """Synchronise the CUDA devices of the tensors in ``value`` (a tensor or
    a tuple or list of them); other values need no wait."""
    values = value if isinstance(value, (tuple, list)) else (value,)
    for device in {v.device for v in values if isinstance(v, torch.Tensor)}:
        if device.type == "cuda":
            torch.cuda.synchronize(device)


def frame_stats(thunk: Callable[[], object], rays: int, pixels: int, n: int = 5,
                flops_per_segment: float = FLOPS_PER_SEGMENT_DEMO) -> dict:
    """Time ``thunk``: one warm call, then the median of ``n`` calls, each
    synchronised on the CUDA devices of the tensors it returns (a tensor or
    a tuple of them; host values need no wait).

    Returns ms_per_frame, mrays_per_s (``rays`` traced segments a call),
    est_gflops (``rays * flops_per_segment`` a call) and hbm_gb_per_s
    (``pixels * BYTES_PER_PIXEL`` a call): rates of work counts over the
    measured time, on whatever device ran the thunk."""
    _wait(thunk())
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        _wait(thunk())
        ts.append(time.perf_counter() - t0)
    sec = float(np.median(ts))
    return {"ms_per_frame": sec * 1e3,
            "mrays_per_s": rays / sec / 1e6,
            "est_gflops": rays * flops_per_segment / sec / 1e9,
            "hbm_gb_per_s": pixels * BYTES_PER_PIXEL / sec / 1e9}

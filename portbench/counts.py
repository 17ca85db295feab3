"""Frozen work counts of the port's trace kernels, for the roofline shares.

A copy of chip_smoke.py's OPS_*, bound, scene_bytes, trace_bound and
grad_kernel_bounds, kept with the benchmark so that a change to the
program cannot change the yardstick.  The counts are lower bounds: a
transcendental counts as one operation, the adjoint as 3 x the primal, and
every traced segment tests every live primitive (no acceleration
structure).  A change of algorithm needs a recount in a benchmark change.
"""

from __future__ import annotations

# Peak rates of one H100 SXM (NVIDIA's data sheet: dense fp32 outside the
# tensor cores, HBM3), at its full 700 W power limit.
PEAK_FP32_FLOPS, PEAK_BYTES_PER_S = 67e12, 3.35e12

# Float operations of the trace kernels, counted from csrc/common.cuh and
# csrc/trace.cu: one per add, multiply, divide, compare, min / max, sqrt,
# exp, sin or cos (the random stream's integer work not counted).  A sphere
# test of the fold is 24, a cuboid's slab test 27; a bounce past the fold
# about 110; a sample's camera ray about 80.  The backward's reverse sweep
# replays each bounce and runs its adjoint, counted as 3 x the primal; the
# camera adjoint likewise.
OPS_SPHERE, OPS_CUBOID, OPS_BOUNCE, OPS_CAMERA, ADJOINT = 24, 27, 110, 80, 3
# The environment mode's float operations at one escape (the face, the
# coordinates, the taps, three channels' bilinear blend, radiance +
# throughput x environment).
OPS_ENV = 54


def bound(ops: float, nbytes: float):
    """(bound_ms, bound_by): the larger of the operations over the fp32
    peak and the bytes over the memory rate."""
    t_ops, t_bytes = ops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def scene_bytes(counts, table: bool) -> int:
    """The live scene rows a trace kernel reads: the fold's geometry and the
    material lanes (select) or the attribute table's rows (table mode)."""
    ns, nc = counts
    geometry = 4 * (4 * ns + 6 * nc)
    return geometry + 4 * (24 * (ns + nc) if table else 14 * (ns + nc))


def trace_bound(segments: int, samples: int, pixels: int, slots: int, counts, table=False,
                env_bytes=None, escapes=0):
    """Bound of a forward launch: every traced segment's fold over the live
    primitives and bounce, every sample's camera ray; the scene read once,
    per pixel the radiance, 2 x slots miss vectors, the ray count and the
    seed written once.  The environment mode (``env_bytes``, its table's
    size, given; no slots) also reads the table once and adds OPS_ENV for
    each of the ``escapes`` samples that looked it up."""
    ns, nc = counts
    ops = segments * (OPS_SPHERE * ns + OPS_CUBOID * nc + OPS_BOUNCE) + samples * OPS_CAMERA
    nbytes = scene_bytes(counts, table) + pixels * (12 + 2 * slots * 12 + 4 + 8)
    if env_bytes is not None:
        ops += escapes * OPS_ENV
        nbytes += env_bytes
    return bound(ops, nbytes)


def grad_kernel_bounds(segments: int, samples: int, pixels: int, spp: int, counts):
    """The backward's least work split between its two kernels: the tape
    kernel's forward sweep (fold, bounce, camera ray; it reads the geometry,
    the table and the camera), and the adjoint kernel's replay and adjoint
    of each bounce and the camera adjoint (it reads the table, the camera
    and the cotangents and writes d_table and d_cam).  The tape between them
    is the implementation's and is not counted.
    {"tape": (ms, by), "adjoint": (ms, by)}."""
    ns, nc = counts
    table_cam = 4 * (128 * 24 + 20)
    return {"tape": bound(segments * (OPS_SPHERE * ns + OPS_CUBOID * nc + OPS_BOUNCE)
                          + samples * OPS_CAMERA, 4 * (4 * ns + 6 * nc) + table_cam),
            "adjoint": bound(segments * (1 + ADJOINT) * OPS_BOUNCE
                             + samples * ADJOINT * OPS_CAMERA,
                             2 * table_cam + pixels * 4 * (3 + 6 * spp))}

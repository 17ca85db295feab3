"""Smoke run of the PyTorch port (tpt_torch) on one CUDA card.

Builds the CUDA kernels from tpt_torch/csrc (one nvcc per library, all in
parallel: every source dynamic, and trace.cu for the demo scene's counts),
holds each against its plain PyTorch version on the card, and drives the
port's two paths through their entry points:

  * the render path: the progressive render of the demo scene at
    1920x1080, ray depth 13, 1 spp, thin-lens depth of field, the 256^2
    atmosphere, in 30-frame blocks, through ``tpt_torch.cli render``: one
    launch of the forward kernel a block, in its environment mode and
    through the rolled build for the demo scene's counts (48, 7) (the
    dynamic build held bit for bit to its plain version at 256^2 and at the
    1080p block, beside the slot mode's check), the block's time through
    both builds in turns, its peak allocation below the miss slots' size,
    and the per-frame and block lane efficiencies; then the same
    mode with the opt-in bf16 table (``--env-bf16``), bit for bit against
    its plain version at 256^2 and at the 1080p block, its time beside the
    f32 table's in turns through the build its path takes, the two images'
    mean relative difference and its ptxas report, and
    ``cli render --env-bf16``;
  * the oracle renderer: ``cli render --backend oracle`` at 1920x1080,
    depth 13, 2 frames, no kernel launch, each frame held to the kernel's
    per-frame launch; ``cli sky`` and ``cli pick``;
  * the silhouette gradients: ``tpt_torch.silhouette_demo --scene single``
    and ``--scene demo`` (200 steps each), which must pass their own
    recovery bars, their images from the forward kernel;
  * the training path: ``tpt_torch.inverse_demo`` (512x512, ray depth 8,
    two views, fixed-depth transport, clipped Adam, 200 steps); then the
    backward's two kernels (the tape kernel and the adjoint kernel)
    against the plain backward at five shapes and in the four row
    bands of the 1080p frame, the tape's live-bounce counts against the
    forward kernel's ray counts, each kernel's time, occupancy and ptxas
    report;
  * the one-hot gather: ``trace(..., gather="onehot")`` at the four
    one-frame shapes, bit for bit against the select kernel and against
    its plain version;
  * the static counts: trace.cu's (48, 7) build bit for bit against the
    dynamic build in every forward mode at the 1080p block and frame, then
    the block (both tables), the select frame and the environment mode at
    1-16 frames a launch timed in turns, with each build's ptxas report,
    blocks per SM and SASS size; the paths other than the
    render, bf16 and viewer paths take the dynamic build, and the script
    checks that;
  * the sharded paths of ``tpt_torch.parallel`` in one gloo world of 4
    ranks on the card (1920x1080, depth 13, the 256^2 atmosphere): the
    frame renderer at (dp=4, sp=1) and (dp=2, sp=2) bit for bit against
    one process, the 30-frame block (two in a row) against
    ``progressive_frames``, the train step at (dp=2, sp=1) and (2, 2),
    roulette on and off, one and two gradient bands, SGD and one clipped
    Adam step, against a world of one; a world of one on NCCL and
    ``tpt_torch.parallel.dryrun(4)``; the times of ranks sharing one card
    are contention, not scaling;
  * the viewer's session (``tpt_torch.interactive.ViewerSession``) at
    1080p: two 30-frame draws bit for bit against ``progressive_frames``,
    a reset, a pick, a screenshot, ms a draw; the native bridge, whether it
    built, and its std140 pack and PCG chain against the Python versions;
  * the backward-design probes through ``tpt_torch.bwd_probes``, then each
    probe's kernel against its plain version and one PyTorch call for the
    same function, at the harness's GRID = 100 and at a 1080p-sized 1013:
    a call's time (CUDA events), its host time (the host clock around 200
    calls with no synchronise inside), the kernel's device time
    (torch.profiler), the device operations a call makes (a stream capture
    of one call; exactly one, the kernel, or the script fails), and the
    kernel's device time with a cold L2 (the calls rotate through input
    copies four times the L2), the one to hold against the bound; the
    redesigned gather's cold time at GRID 1013 on a line of its own.

Every phase prints one line; any failure raises and the script exits
non-zero without printing a result.

    python3 chip_smoke.py

The second-to-last line is a JSON object with each kernel's launch count
on the paths, its error against the plain version, its time against the
plain version's and one PyTorch call's, and its bound (the least time an
H100 SXM could take for the same work), for the forward kernel the block's
lane efficiency and for the probe kernels the host time a call; the last
line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

WIDTH, HEIGHT, DEPTH, BLOCK = 1920, 1080, 13, 30
# the demo scene's counts, and the key of trace.cu's build for them
# (tpt_torch.kernels._build), which the environment-mode launches of the
# render, bf16 and viewer paths take (kernels.trace.forward_library); every
# other launch takes the dynamic build
DEMO = (48, 7)
# the pixel that carries the 1080p step's loss without Russian roulette
# (tests/test_torch_integrator.py LOSS_PIXEL holds its path to tpt's)
LOSS_PIXEL = (1524, 264)
REPO = os.path.dirname(os.path.abspath(__file__))
TRAIN_STEPS, TRAIN_VIEWS = 200, 2
PROBE_GRIDS = (100, 1013)   # the harness's, and 1013 x 16 x 128 = 2,074,624 (~1080p)

# Peak rates of one H100 SXM (NVIDIA's data sheet, dense fp32 outside the
# tensor cores, HBM3) for the bounds.
PEAK_FP32_FLOPS, PEAK_BYTES_PER_S = 67e12, 3.35e12

# Float operations of the trace kernels, counted from csrc/common.cuh and
# csrc/trace.cu: one per add, multiply, divide, compare, min / max, sqrt,
# exp, sin or cos (the random stream's integer work not counted).  A sphere
# test of the fold (closest_hit) is 24, a cuboid's slab test 27; a bounce
# past the fold (hit point, a sphere's normal, Fresnel, the diffuse lobe,
# the draws' conversions, the throughput and roulette updates) about 110;
# a sample's camera ray about 80.  The backward's reverse sweep replays each
# bounce and runs its adjoint, counted as 3 x the primal, reverse mode's
# usual ratio; the camera adjoint likewise.  Lower counts only lower the
# bound, which is the least time the card could take.
OPS_SPHERE, OPS_CUBOID, OPS_BOUNCE, OPS_CAMERA, ADJOINT = 24, 27, 110, 80, 3
# The environment mode's float operations at one escape (csrc/trace.cu
# environment() and its caller), each path's least: the face's 3 compares,
# max and 1 / ma (2), s and t (6), the taps' position (4), floors (2),
# fractions and their complements (4), three channels' bilinear blend (27)
# and radiance + throughput x environment (6).  Sign flips, the integer
# clamps and the row's index are not counted.
OPS_ENV = 54
OPS_P4 = 33   # p4's f(x) + f'(x) g per element, counted from csrc/probes.cu


def frame_cases():
    """(view name, CameraConfig, width, height, ray depth, spp, rr, jitter)
    of the one-frame comparisons: the train_bench step's 1080p frame, a
    256^2 case, and the inverse demo's launches (512^2, depth 8, rr off,
    its two views)."""
    from tpt_torch import CameraConfig
    from tpt_torch.inverse_demo import GRID_CAM, RAY_DEPTH

    cam = CameraConfig()
    return (("default", cam, WIDTH, HEIGHT, DEPTH, 1, True, "corner"),
            ("default", cam, 256, 256, DEPTH, 2, False, "center"),
            ("grid", GRID_CAM, 512, 512, RAY_DEPTH, 1, False, "corner"),
            ("default", cam, 512, 512, RAY_DEPTH, 1, False, "corner"))


def phase(name, msg):
    print(f"[{name}] {msg}", flush=True)


def build_name(key) -> str:
    return "dynamic" if key is None else f"counts {key}"


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


def escaped_samples(miss_dir) -> int:
    """The samples whose path escaped, of a slot-mode launch's miss_dir
    f32[F * spp, 3, H, W]: an escape stores its unit direction, any other
    end (and a masked frame) leaves the slot zero."""
    return int(miss_dir.ne(0).any(dim=1).sum())


def grad_bound(segments: int, samples: int, pixels: int, spp: int, counts):
    """Bound of a backward launch: the forward sweep (fold and bounce), the
    reverse sweep's replay and adjoint of each bounce, each sample's camera
    ray and its adjoint; the cotangents (3 + 6 x spp floats a pixel), the
    geometry, the table and the camera read once, d_table and d_cam written."""
    ns, nc = counts
    ops = (segments * (OPS_SPHERE * ns + OPS_CUBOID * nc + (2 + ADJOINT) * OPS_BOUNCE)
           + samples * (1 + ADJOINT) * OPS_CAMERA)
    nbytes = 4 * (4 * ns + 6 * nc) + 2 * 4 * (128 * 24 + 20) + pixels * 4 * (3 + 6 * spp)
    return bound(ops, nbytes)


def grad_kernel_bounds(segments: int, samples: int, pixels: int, spp: int, counts):
    """:func:`grad_bound`'s work split between the two backward kernels:
    the tape kernel's forward sweep (fold, bounce, camera ray; it reads the
    geometry, the table and the camera), and the adjoint kernel's replay
    and adjoint of each bounce and the camera adjoint (it reads the table,
    the camera and the cotangents and writes d_table and d_cam).  The tape
    between them is the implementation's, not the function's, and is not
    counted.  {"tape": (ms, by), "adjoint": (ms, by)}."""
    ns, nc = counts
    table_cam = 4 * (128 * 24 + 20)
    return {"tape": bound(segments * (OPS_SPHERE * ns + OPS_CUBOID * nc + OPS_BOUNCE)
                          + samples * OPS_CAMERA, 4 * (4 * ns + 6 * nc) + table_cam),
            "adjoint": bound(segments * (1 + ADJOINT) * OPS_BOUNCE
                             + samples * ADJOINT * OPS_CAMERA,
                             2 * table_cam + pixels * 4 * (3 + 6 * spp))}


def ptxas_report(log: str) -> dict:
    """{kernel: "R registers, S/L bytes spill stores/loads, F bytes stack"}
    from nvcc's -Xptxas -v output, by entry function (a template by its
    arguments: kernel<false,true>, kernel<2>)."""
    import re
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            short = re.search(r"([a-z_]+_kernel)(I(?:L\w\d+E)+E)?", m.group(1))
            name = short.group(1)
            if short.group(2):
                args = re.findall(r"L(\w)(\d+)E", short.group(2))
                name += "<" + ",".join(("false", "true")[int(v)] if t == "b" else v
                                       for t, v in args) + ">"
            out[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[name]["stack"], out[name]["stores"], out[name]["loads"] = m.groups()
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = m.group(1)
    return {k: (f"{v.get('registers', '?')} registers, {v.get('stores', '?')}/"
                f"{v.get('loads', '?')} bytes spill stores/loads, {v.get('stack', '?')} bytes "
                f"stack") for k, v in out.items()}


def sass_sizes(library) -> dict:
    """{kernel: SASS instructions} of each entry function in a built
    library (cuobjdump -sass; names as ptxas_report gives them), empty when
    the toolkit has no cuobjdump."""
    import re
    from tpt_torch.kernels import _build
    tool = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    if not os.access(tool, os.X_OK):
        return {}
    out = subprocess.run([tool, "-sass", str(library)], capture_output=True, text=True,
                         check=True, timeout=120).stdout
    sizes, name = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = next(iter(ptxas_report(f"Compiling entry function '{m.group(1)}'")))
            sizes[name] = 0
        elif name and re.match(r"\s+/\*[0-9a-f]{4,}\*/", line):
            sizes[name] += 1
    return sizes


def assert_bits_equal(got, want, what,
                      names=("radiance", "miss_dir", "miss_thr", "ray_count", "seed")):
    """The outputs ``names`` of two results equal bit for bit (all five of
    a TraceResult by default)."""
    for name in names:
        g, w = getattr(got, name), getattr(want, name)
        if g.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        if g.shape != w.shape or not torch.equal(g, w):
            raise AssertionError(f"{what}: {name} differs")


def gpu_name_and_power() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warm_up: bool = True) -> float:
    """Mean device time of ``fn`` over ``reps`` runs, by CUDA events, after
    one warm-up run (which takes the outputs' first allocation) unless the
    caller has just run ``fn``."""
    if warm_up:
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare_per_frame(got, want, max_flipped=1e-4, tol=1e-5):
    """Integers equal on all but ``max_flipped`` of the pixels; floats at
    rtol = atol = ``tol`` on the others.  Returns (flipped, max abs err)."""
    flipped = (got.seed != want.seed) | (got.ray_count != want.ray_count)
    n_flipped = int(flipped.sum())
    if n_flipped > max_flipped * flipped.numel():
        raise AssertionError(f"{n_flipped} pixels differ in seed or ray count")
    ok = ~flipped
    err = 0.0
    for name in ("radiance", "miss_dir", "miss_thr"):
        g, w = getattr(got, name)[..., ok], getattr(want, name)[..., ok]
        torch.testing.assert_close(g, w, rtol=tol, atol=tol, msg=name)
        err = max(err, float((g - w).abs().max()))
    return n_flipped, err


def compare_refill(got, want):
    """Integers exact; floats at rtol 1e-3, atol 1e-4 (tests/test_refill.py).
    Returns the max abs error."""
    for name in ("seed", "ray_count"):
        if not torch.equal(getattr(got, name), getattr(want, name)):
            raise AssertionError(f"refill {name} differs from the plain version")
    err = 0.0
    for name in ("rad_sum", "miss_dir", "miss_thr"):
        g, w = getattr(got, name), getattr(want, name)
        torch.testing.assert_close(g, w, rtol=1e-3, atol=1e-4, msg=name)
        err = max(err, float((g - w).abs().max()))
    return err


CAM_LEAVES = {"inv_proj": slice(0, 6), "inv_view": slice(6, 18), "focal": slice(18, 19),
              "aperture": slice(19, 20)}


def grad_groups(res, counts):
    """The cotangent entries by the scale they are held at: each of the 24
    table lanes over the sphere rows and over the cuboid rows, the padded
    rows, and each camera leaf of cam20."""
    from tpt_torch.integrator import ATTR_COLS
    ns, nc = counts
    groups = {}
    for kind, rows in (("sphere", slice(0, ns)), ("cuboid", slice(ns, ns + nc))):
        for col in range(ATTR_COLS):
            groups[f"{kind} lane {col}"] = res.d_table[rows, col]
    groups["padding"] = res.d_table[ns + nc:].reshape(-1)
    groups.update({name: res.d_cam[idx] for name, idx in CAM_LEAVES.items()})
    return groups


def compare_grads(got, want, counts, rtol=1e-3, floor=1e-3):
    """Each group of :func:`grad_groups` within rtol and atol = rtol x its
    scale: the group's largest magnitude in the plain version, floored at
    ``floor`` x the largest of its table or camera.  The floor is for
    groups whose exact value is 0 and whose entries are sums of cancelling
    terms: under Russian roulette the lobe probability cancels from the
    throughput (thr / p / max(thr / p)), so the specular- and
    refraction-chance lanes are rounding noise, as is the focal length
    under a pinhole.  Returns ({group: (max abs err, largest magnitude)},
    {"table": floor, "camera": floor}, [failed groups])."""
    g_groups, w_groups = grad_groups(got, counts), grad_groups(want, counts)
    floors = {"table": floor * float(want.d_table.abs().max()),
              "camera": floor * float(want.d_cam.abs().max())}
    errs, failed = {}, []
    for name, w in w_groups.items():
        d = (g_groups[name] - w).abs()
        big = float(w.abs().max()) if w.numel() else 0.0
        scale = max(big, floors["camera" if name in CAM_LEAVES else "table"], 1e-30)
        err = float(d.max()) if w.numel() else 0.0
        errs[name] = (err, big)
        if not bool((d <= rtol * scale + rtol * w.abs()).all()):
            failed.append(f"{name}: max abs err {err:.3g}, largest {big:.3g}")
    return errs, floors, failed


def fmt_grads(errs, floors):
    """Per family, the worst error relative to its scale, and each group's
    largest magnitude."""
    fams = {"sphere lanes": [k for k in errs if k.startswith("sphere")],
            "cuboid lanes": [k for k in errs if k.startswith("cuboid")],
            "padding": ["padding"], "camera": list(CAM_LEAVES)}
    out = []
    for fam, keys in fams.items():
        fl = floors["camera" if fam == "camera" else "table"]
        ratio = {k: errs[k][0] / max(errs[k][1], fl, 1e-30) for k in keys}
        worst = max(keys, key=ratio.get)
        big = " ".join(f"{errs[k][1]:.3g}" for k in keys)
        out.append(f"{fam}: worst err/scale {ratio[worst]:.3g} ({worst}), floor {fl:.3g}, "
                   f"largest [{big}]")
    return "; ".join(out)


def grad_phases(dev, card, K, G):
    """The backward kernel against its plain version, and its time split.
    Returns (max abs err, {"ms", "plain_ms", "bound_ms", "bound_by"} at
    1080p)."""
    from tpt_torch import CameraConfig, demo_scene
    from tpt_torch.camera import camera_matrices
    from tpt_torch.integrator import build_attr_table

    scene = demo_scene().build(dev)
    counts = scene.counts
    table = build_attr_table(scene, counts)
    cam = CameraConfig()
    gen = torch.Generator(device=dev).manual_seed(7)
    failed = []

    def inputs(c, w, h, spp):
        ip, iv, _ = camera_matrices(c, w, h)
        cam20 = G.camera_vector(ip, iv, c.focal_length, c.aperture_diameter, device=dev)
        cots = [torch.randn(shape, generator=gen, device=dev)
                for shape in ((3, h, w), (spp, 3, h, w), (spp, 3, h, w))]
        return cam20, cots

    def check(what, got, want):
        errs, floors, bad = compare_grads(got, want, counts)
        failed.extend(f"{what}, {b}" for b in bad)
        return fmt_grads(errs, floors), max(err for err, _ in errs.values())

    def same_paths(c, frame, kw, what):
        """The tape kernel's live-bounce counts, summed over the samples,
        equal the forward kernel's ray counts: it took the same decisions."""
        ip, iv, _ = camera_matrices(c, kw["width"], kw["height"])
        cam20 = G.camera_vector(ip, iv, c.focal_length, c.aperture_diameter, device=dev)
        rays = K.trace(scene, ip, iv, frame, c.focal_length, c.aperture_diameter, **kw).ray_count
        tape = G._tape_counts(scene, table, cam20, frame, **kw).sum(0)
        if not torch.equal(tape, rays.reshape(tape.shape)):
            failed.append(f"{what}: tape counts differ from the forward kernel's ray counts at "
                          f"{int((tape != rays.reshape(tape.shape)).sum())} pixels")
        return rays

    max_err = 0.0
    cases = (("default", cam, 256, 256, DEPTH, 1, True, "corner"),) + frame_cases()[1:]
    for i, (view, c, w, h, depth, spp, rr, jitter) in enumerate(cases):
        cam20, cots = inputs(c, w, h, spp)
        kw = dict(width=w, height=h, ray_depth=depth, spp=spp, counts=counts, rr=rr,
                  jitter=jitter)
        what = f"{w}x{h} {view} view depth {depth} spp {spp} rr {rr} {jitter}"
        got = G.trace_grad(scene, table, cam20, 3, *cots, **kw)
        want = G.trace_grad_plain(scene, table, cam20, 3, *cots, **kw)
        summary, err = check(what, got, want)
        max_err = max(max_err, err)
        same_paths(c, 3, kw, what)
        line = (f"{what}: {summary}; zeroed {int(got.n_zeroed)} (kernels) / "
                f"{int(want.n_zeroed)} (plain); tape counts == forward ray counts")
        if i == 0:
            half = G.trace_grad(scene, table, cam20, 3, *cots, half_stores=True, **kw)
            again = G.trace_grad(scene, table, cam20, 3, *cots, **kw)
            half_summary, _ = check(f"{what} half_stores", half, got)
            rep = max(float((again.d_table - got.d_table).abs().max()),
                      float((again.d_cam - got.d_cam).abs().max()))
            line += (f"; half_stores vs full: {half_summary}; two launches differ by at "
                     f"most {rep:.3g}")
        phase("grad", line)

    # the training step's launch: 1080p, spp 1, Russian roulette on; the plain
    # version runs in row bands (the cotangent is a sum over pixels)
    cam20, cots = inputs(cam, WIDTH, HEIGHT, 1)
    kw = dict(width=WIDTH, height=HEIGHT, ray_depth=DEPTH, spp=1, counts=counts, rr=True)
    band = HEIGHT // 4

    def run():
        return G.trace_grad(scene, table, cam20, 0, *cots, **kw)

    def run_plain():
        return G.trace_grad_plain(scene, table, cam20, 0, *cots, band_rows=band, **kw)

    what = f"{WIDTH}x{HEIGHT} spp 1 rr True corner"
    got, want = run(), run_plain()
    summary, err = check(what, got, want)
    max_err = max(max_err, err)
    # the backward's forward sweep traces the segments of the forward frame
    rays = same_paths(cam, 0, kw, what)
    segments = int(rays.sum())
    times = {"ms": cuda_ms(run, 5), "plain_ms": cuda_ms(run_plain, 1, warm_up=False)}
    times["bound_ms"], times["bound_by"] = grad_bound(segments, WIDTH * HEIGHT,
                                                      WIDTH * HEIGHT, 1, counts)
    phase("grad", f"{what}: {summary}; zeroed {int(got.n_zeroed)} (kernels) / "
          f"{int(want.n_zeroed)} (plain, {HEIGHT // band} bands); tape counts == forward ray "
          f"counts; both kernels {times['ms']:.2f} ms, plain {times['plain_ms']:.1f} ms, bound "
          f"{times['bound_ms']:.4f} ms ({times['bound_by']}, {segments} segments; the tape's "
          f"{G.tape_bytes(WIDTH, HEIGHT, 1, DEPTH) / 1e9:.3f} GB not counted) ({card})")

    # the same launch shape cut into its row bands, each launched and filtered
    # alone: a non-finite camera cotangent (one axis-parallel pixel zeroes all
    # 20 in the whole frame) poisons only its own band, so the other bands
    # hold the camera adjoint at this shape
    cam_bands = []
    for r in range(0, HEIGHT, band):
        sub = [cots[0][:, r:r + band], cots[1][:, :, r:r + band], cots[2][:, :, r:r + band]]
        bkw = dict(kw, n_rows=band, row0=r)
        got = G.trace_grad(scene, table, cam20, 0, *sub, **bkw)
        want = G.trace_grad_plain(scene, table, cam20, 0, *sub, **bkw)
        summary, err = check(f"{what} rows {r}:{r + band}", got, want)
        max_err = max(max_err, err)
        if bool(want.d_cam.ne(0).any()):
            cam_bands.append(r)
        phase("grad", f"{what} rows {r}:{r + band}: {summary}; zeroed "
              f"{int(got.n_zeroed)} (kernel) / {int(want.n_zeroed)} (plain)")
    if not cam_bands:
        failed.append(f"{what}: the camera cotangent is zero in every row band")
    if failed:
        raise AssertionError("backward kernel vs plain: " + "; ".join(failed))

    split = {mode: cuda_ms(lambda: G.trace_grad(scene, table, cam20, 0, *cots, ablate=mode,
                                                **kw), 3)
             for mode in G.ABLATE_MODES}
    phase("grad-split", f"{WIDTH}x{HEIGHT} ms of both kernels by ablate mode: "
          + ", ".join(f"{m} {v:.2f}" for m, v in split.items())
          + f"; forward sweep and camera (norev) {split['norev']:.2f}, stores "
          f"{split['none'] - split['nostores']:.2f}, reverse sweep "
          f"{split['none'] - split['norev']:.2f}, camera adjoint "
          f"{split['none'] - split['nocam']:.2f}, table accumulation "
          f"{split['none'] - split['nodtbl']:.2f} ({card})")

    # each kernel apart: its device time (torch.profiler; should the profiler
    # lose every event, CUDA events around the tape kernel alone, and the
    # pair's time less that for the adjoint), its blocks per SM (the
    # occupancy API), its share of the plain version and of the bound
    per = {k: {"ms": device_profile(run, f"trace_grad_{k}_kernel", reps=5), "by": "profiler"}
           for k in ("tape", "adjoint")}
    if None in (per["tape"]["ms"], per["adjoint"]["ms"]):
        tape_ms = cuda_ms(lambda: G._tape_counts(scene, table, cam20, 0, **kw), 5)
        per = {"tape": {"ms": tape_ms, "by": "CUDA events"},
               "adjoint": {"ms": times["ms"] - tape_ms, "by": "CUDA events, pair less tape"}}
    per_sm = grad_blocks_per_sm()
    plain = plain_split_ms(G, scene, table, cam20, cots, kw, band)
    bounds = grad_kernel_bounds(segments, WIDTH * HEIGHT, WIDTH * HEIGHT, 1, counts)
    for kernel in per:
        per[kernel].update(plain_ms=plain[kernel], bound_ms=bounds[kernel][0],
                           bound_by=bounds[kernel][1], blocks_per_sm=per_sm[kernel])
    effs = {}
    for view, c, w, h, depth, spp, rr, jitter in frame_cases():
        ip, iv, _ = camera_matrices(c, w, h)
        effs[f"{w}x{h} {view}"] = G.lane_efficiency(
            K.trace(scene, ip, iv, 0, c.focal_length, c.aperture_diameter, width=w, height=h,
                    ray_depth=depth, spp=spp, rr=rr, jitter=jitter).ray_count)
    tape_gb = G.tape_bytes(WIDTH, HEIGHT, 1, DEPTH) / 1e9
    phase("grad-split", f"{WIDTH}x{HEIGHT}: tape kernel {per['tape']['ms']:.3f} ms by "
          f"{per['tape']['by']} ({per_sm['tape']} blocks/SM; plain forward with its graph "
          f"{plain['tape']:.1f} ms; bound {bounds['tape'][0]:.4f} ms, {bounds['tape'][1]}), "
          f"adjoint kernel {per['adjoint']['ms']:.3f} ms by {per['adjoint']['by']} "
          f"({per_sm['adjoint']} blocks/SM, grid {per_sm['grid']}; plain reverse sweep "
          f"{plain['adjoint']:.1f} ms; bound {bounds['adjoint'][0]:.4f} ms, "
          f"{bounds['adjoint'][1]}); the tape "
          f"{tape_gb:.3f} GB (not in the bound); lane efficiency of a thread-per-pixel reverse "
          f"sweep (forward ray counts by warp of 32 pixels): "
          + ", ".join(f"{k} {v:.3f}" for k, v in effs.items()) + f" ({card})")
    times["kernels"] = per
    return max_err, times


def trace_blocks_per_sm(lib=None):
    """Blocks per SM of the forward kernel's select, table, environment and
    bf16-environment instantiations, by the occupancy API (the layout
    entry), in ``lib`` (a loaded trace.cu library; the dynamic one by
    default)."""
    from tpt_torch.kernels import _build
    blocks = (ctypes.c_int * 4)()
    if (lib or _build.library("trace.cu")).tpt_trace_layout(blocks) != 0:
        raise AssertionError("the trace kernel's layout entry failed")
    return list(blocks)


def grad_blocks_per_sm():
    """{"tape", "adjoint": blocks per SM by the occupancy API, "grid": the
    adjoint kernel's persistent grid} from the layout entries of the
    dynamic builds."""
    from tpt_torch.kernels.trace_grad import libraries
    tape_lib, adjoint_lib = libraries()
    tape, adj, grid, words = ctypes.c_int(), ctypes.c_int(), ctypes.c_int(), ctypes.c_int64()
    if (tape_lib.tpt_trace_grad_tape_layout(ctypes.byref(tape)) != 0
            or adjoint_lib.tpt_trace_grad_adjoint_layout(ctypes.byref(words), ctypes.byref(adj),
                                                         ctypes.byref(grid)) != 0):
        raise AssertionError("the backward kernels' layout entries failed")
    return {"tape": tape.value, "adjoint": adj.value, "grid": grid.value}


def plain_split_ms(G, scene, table, cam20, cots, kw, band):
    """The plain version's time (CUDA events) split as the two kernels split
    the work: the forward of trace_paths with autograd's graph, which keeps
    what the tape keeps, and autograd's reverse sweep, in row bands as
    ``trace_grad_plain`` runs them.  {"tape": ms, "adjoint": ms}."""
    from tpt_torch.integrator import make_scene_scan_fn, make_table_trace_fn, trace_paths
    from tpt_torch.kernels.trace import pixel_band
    width, height, spp = kw["width"], kw["height"], kw["spp"]
    out = {"tape": 0.0, "adjoint": 0.0}
    for r in range(0, height, band):
        px, py = pixel_band(width, height, band, r, table.device)
        table_l = table.detach().requires_grad_(True)
        cam_l = cam20.detach().requires_grad_(True)
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        torch.cuda.synchronize()
        marks[0].record()
        with torch.enable_grad():
            trace_fn = make_table_trace_fn(make_scene_scan_fn(scene, kw["counts"]), table_l,
                                           kw["counts"][0])
            res = trace_paths(trace_fn, G.camera_params_from_vector(cam_l), px, py, width,
                              height, 0, kw["ray_depth"], spp, jitter=kw.get("jitter", "corner"),
                              russian_roulette=kw["rr"])
            obj = ((res.radiance * cots[0][:, r:r + band].reshape(res.radiance.shape)).sum()
                   + (res.miss_dir * cots[1][:, :, r:r + band].reshape(res.miss_dir.shape)).sum()
                   + (res.miss_thr * cots[2][:, :, r:r + band].reshape(res.miss_thr.shape)).sum())
            marks[1].record()
            torch.autograd.grad(obj, (table_l, cam_l), allow_unused=True)
        marks[2].record()
        torch.cuda.synchronize()
        out["tape"] += marks[0].elapsed_time(marks[1])
        out["adjoint"] += marks[1].elapsed_time(marks[2])
    return out


def train_phases(dev, card, K, G):
    """The training path through its entry point.  Returns the path's
    launches of the trace kernel and {"tape", "adjoint": each backward
    kernel's}."""
    from tpt_torch import inverse_demo

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "inverse_demo.json")
        K.LAUNCHES, G.GRAD_LAUNCHES, G.TAPE_LAUNCHES, G.ADJOINT_LAUNCHES = 0, 0, 0, 0
        K.BUILD_LAUNCHES.clear()
        t0 = time.perf_counter()
        rc = inverse_demo.main(["--steps", str(TRAIN_STEPS), "--size", "512x512",
                                "--device", "cuda", "--out", out])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, grad_launches = K.LAUNCHES, G.GRAD_LAUNCHES
        pair = {"tape": G.TAPE_LAUNCHES, "adjoint": G.ADJOINT_LAUNCHES}
        builds = dict(K.BUILD_LAUNCHES)
        with open(out) as f:
            res = json.load(f)
        pngs = sorted(n for n in os.listdir(tmp) if n.endswith(".png"))
    want = TRAIN_STEPS * TRAIN_VIEWS
    if rc != 0 or grad_launches != want or launches < want or min(pair.values()) < want:
        raise AssertionError(f"inverse_demo: rc {rc}, {grad_launches} backward calls "
                             f"(want {want}), {pair} backward kernel launches, {launches} trace "
                             f"launches")
    if builds != {None: launches}:
        raise AssertionError(f"inverse_demo: trace kernel launches by build {builds} (want "
                             f"all through the dynamic build)")
    if not (np.isfinite(res["loss_last"]) and np.isfinite(res["loss_final_median"])
            and res["sphere_param_mae_after"] < 0.5 * res["sphere_param_mae_before"]
            and len(pngs) == 3):
        raise AssertionError(f"inverse_demo did not converge: {res}, {pngs}")
    phase("train", f"inverse_demo 512x512 depth 8, 2 views, {TRAIN_STEPS} steps: "
          f"{launches} trace kernel launches, {grad_launches} backward calls ({pair['tape']} "
          f"tape / {pair['adjoint']} adjoint kernel launches, all through the dynamic "
          f"build), {wall:.1f} s wall, "
          f"loss {res['loss_first']:.5f} -> median {res['loss_final_median']:.5f}, sphere "
          f"MAE {res['sphere_param_mae_before']} -> {res['sphere_param_mae_after']}, "
          f"emissive MAE {res['cuboid_param_mae_before']} -> {res['cuboid_param_mae_after']}")
    return launches, pair


def loss_pixel_phase(dev, card, K, faces):
    """Which pixel carries the 1080p training step's loss with Russian
    roulette off: the frame of the dist-train step (the demo scene, the
    default camera, depth 13, 1 spp, frame 0, the 256^2 atmosphere, loss
    mean((img - 0.25)^2)) through the forward kernel, each pixel's squared
    error, the largest one's share of the loss, beside the loss with
    roulette on.  The pixel must be LOSS_PIXEL, whose path
    tests/test_torch_integrator.py holds to tpt's transport on the CPU."""
    from tpt_torch import CameraConfig, demo_scene
    from tpt_torch.camera import camera_matrices
    from tpt_torch.env import pack_block_table
    from tpt_torch.integrator import apply_environment_blocked

    scene, cam = demo_scene().build(dev), CameraConfig()
    ip, iv, _ = camera_matrices(cam, WIDTH, HEIGHT)
    table = pack_block_table(faces)
    losses = {}
    for rr in (True, False):
        res = K.trace(scene, ip, iv, 0, cam.focal_length, cam.aperture_diameter, width=WIDTH,
                      height=HEIGHT, ray_depth=DEPTH, spp=1, counts=DEMO, rr=rr)
        img = torch.movedim(apply_environment_blocked(res, table, 1), 0, -1)
        se = ((img - 0.25) ** 2).sum(-1)
        losses[rr] = float(se.sum()) / (WIDTH * HEIGHT * 3)
    top = int(torch.argmax(se))
    y, x = divmod(top, WIDTH)
    share = float(se.view(-1)[top].double() / se.double().sum())
    thr = float(res.miss_thr[0, :, y, x].max())
    if (x, y) != LOSS_PIXEL or not np.isfinite(losses[False]):
        raise AssertionError(f"roulette-off loss {losses[False]}: its largest pixel is "
                             f"{(x, y)}, not {LOSS_PIXEL}")
    phase("loss-pixel", f"{WIDTH}x{HEIGHT} depth {DEPTH} frame 0, loss mean((img - 0.25)^2): "
          f"roulette off {losses[False]:.7g}, on {losses[True]:.7g}; pixel {(x, y)} carries "
          f"{share:.4f} of the roulette-off loss, {int(res.ray_count[y, x])} bounces, miss "
          f"throughput {thr:.7g} ({card})")


def onehot_phases(dev, card, K):
    """The one-hot gather's path: ``trace(..., gather="onehot")`` at the
    four one-frame shapes (its launches counted), then each result against
    the select kernel and the plain one-hot version, bit for bit in all five
    outputs, and the 1080p frame's time beside the select kernel's, in
    turns.  Returns (launches, {"ms", "select_ms", "plain_ms", "bound_ms",
    "bound_by"})."""
    from tpt_torch import demo_scene
    from tpt_torch.camera import camera_matrices

    scene = demo_scene().build(dev)
    counts = scene.counts
    cases = []
    K.ONEHOT_LAUNCHES = 0
    for view, c, w, h, depth, spp, rr, jitter in frame_cases():
        ip, iv, _ = camera_matrices(c, w, h)
        args = (scene, ip, iv, 5, c.focal_length, c.aperture_diameter)
        kw = dict(width=w, height=h, ray_depth=depth, spp=spp, rr=rr, jitter=jitter,
                  counts=counts)
        what = f"{w}x{h} {view} view depth {depth} spp {spp} rr {rr} {jitter}"
        cases.append((what, args, kw, K.trace(*args, gather="onehot", **kw)))
    torch.cuda.synchronize()
    launches = K.ONEHOT_LAUNCHES
    if launches != len(cases):
        raise AssertionError(f"onehot: {launches} table-mode launches (want {len(cases)})")

    times = {}
    for what, args, kw, got in cases:
        assert_bits_equal(got, K.trace(*args, **kw), f"onehot {what} vs the select kernel")
        assert_bits_equal(got, K.trace_plain(*args, gather="onehot", **kw),
                          f"onehot {what} vs its plain version")
        line = f"{what}: all five outputs bit-equal to the select kernel and the plain version"
        if kw["width"] == WIDTH:
            onehot = lambda: K.trace(*args, gather="onehot", **kw)
            select = lambda: K.trace(*args, **kw)
            turns = [cuda_ms(select, 20), cuda_ms(onehot, 20), cuda_ms(onehot, 20),
                     cuda_ms(select, 20)]
            times["select_ms"], times["ms"] = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
            times["plain_ms"] = cuda_ms(lambda: K.trace_plain(*args, gather="onehot", **kw), 1,
                                        warm_up=False)
            pixels, segments = kw["width"] * kw["height"], int(got.ray_count.sum())
            times["bound_ms"], times["bound_by"] = trace_bound(
                segments, pixels * kw["spp"], pixels, kw["spp"], counts, table=True)
            line += (f"; per 1080p frame onehot {turns[1]:.3f} / {turns[2]:.3f} ms, select "
                     f"{turns[0]:.3f} / {turns[3]:.3f} ms (select, onehot, onehot, select), "
                     f"plain {times['plain_ms']:.1f} ms, bound {times['bound_ms']:.4f} ms "
                     f"({times['bound_by']}, {segments} segments) ({card})")
        phase("onehot", line)
    return launches, times


def static_counts_phase(dev, card, K, faces):
    """trace.cu's build for the demo scene's counts against the dynamic
    build on the card, each library handed to the private launcher: each
    of the 1080p 30-frame block's modes (environment with the f32 and with
    the bf16 table, slots) and the 1080p frame's select and table gathers,
    bit for bit; then the block (both tables) and the select frame timed in
    turns with CUDA events (dynamic, counts, counts, dynamic), and the
    environment mode at 1 to 16 frames a launch likewise; each build's
    ptxas report, blocks per SM and SASS size.  Returns
    {"ms": {item: {build: [turns]}}, "reports": {build: report}}."""
    from tpt_torch import CameraConfig, demo_scene
    from tpt_torch.camera import camera_matrices
    from tpt_torch.env import pack_block_table
    from tpt_torch.kernels import _build

    scene, cam = demo_scene().build(dev), CameraConfig()
    if scene.counts != DEMO:
        raise AssertionError(f"the demo scene's counts are {scene.counts}, not {DEMO}")
    focal, ap = cam.focal_length, cam.aperture_diameter
    ip, iv, _ = camera_matrices(cam, WIDTH, HEIGHT)
    tables = {"f32": pack_block_table(faces),
              "bf16": pack_block_table(faces, dtype=torch.bfloat16)}
    frame_kw = dict(width=WIDTH, height=HEIGHT, ray_depth=DEPTH, spp=1, counts=DEMO)
    band = dict(n_rows=HEIGHT, row0=0, jitter="corner", rr=True)
    keys = {"dynamic": None, build_name(DEMO): DEMO}
    libs = {b: _build.library("trace.cu", k) for b, k in keys.items()}
    path_build = build_name(DEMO)

    def block(table, n_frames=BLOCK):
        return lambda lib: K._launch(scene, ip, iv, 0, focal, ap, n_frames=n_frames,
                                     n_valid=n_frames, env_table=table, lib=lib, **band,
                                     **frame_kw)

    def frame(gather):
        return lambda lib: K._launch(scene, ip, iv, 5, focal, ap, n_frames=1, n_valid=1,
                                     gather=gather, lib=lib, **band, **frame_kw)

    checks = {"block, environment mode, f32 table": block(tables["f32"]),
              "block, environment mode, bf16 table": block(tables["bf16"]),
              "block, slot mode": block(None),
              "frame, select gather": frame("select"),
              "frame, table gather": frame("onehot")}
    for what, fn in checks.items():
        want = fn(libs["dynamic"])
        assert_bits_equal(fn(libs[path_build]), want, f"static counts, {what}",
                          [n for n, v in want._asdict().items() if v is not None])
        del want
    torch.cuda.synchronize()
    phase("static-counts", f"trace.cu's build for {DEMO} bit-equal to the dynamic build at "
          f"{WIDTH}x{HEIGHT} depth {DEPTH}: " + ", ".join(checks) + f" ({card})")

    order = ("dynamic", path_build, path_build, "dynamic")
    timed = {"block": (block(tables["f32"]), 3), "block, bf16 table": (block(tables["bf16"]), 3),
             "select frame": (frame("select"), 20)}
    ms = {}
    for item, (fn, reps) in timed.items():
        turns = [cuda_ms(lambda: fn(libs[build]), reps) for build in order]
        ms[item] = {b: [t for o, t in zip(order, turns) if o == b] for b in keys}
        phase("static-counts", f"{item} ms in turns ({', '.join(order)}): "
              + ", ".join(f"{t:.3f}" for t in turns) + f" ({card})")
    # the environment mode by frames a launch, where the rule of
    # kernels.trace.forward_library (BLOCK_FRAMES) draws its line
    sweep = {}
    for n in (1, 2, 4, 8, 16):
        fn = block(tables["f32"], n)
        sweep[n] = [cuda_ms(lambda: fn(libs[build]), max(3, 60 // n)) for build in order]
    ms["environment mode by frames"] = sweep
    phase("static-counts", f"environment mode by frames a launch, ms in turns "
          f"({', '.join(order)}): " + "; ".join(f"{n} frames " + ", ".join(
              f"{t:.3f}" for t in v) for n, v in sweep.items()) + f" ({card})")

    reports = {}
    for build, lib in libs.items():
        ptxas, sass = ptxas_report(lib.log), sass_sizes(lib.path)
        reports[build] = {"ptxas": ptxas, "blocks_per_sm": trace_blocks_per_sm(lib),
                          "sass": sass}
        phase("static-counts", f"{build}: " + "; ".join(f"{k} {v}" for k, v in ptxas.items())
              + "; blocks per SM (select, table, environment, bf16 environment): "
              + ", ".join(map(str, reports[build]["blocks_per_sm"])) + "; SASS instructions "
              + (", ".join(f"{k} {v}" for k, v in sass.items()) or "not measured"))
    return {"ms": ms, "reports": reports}


def static_entries(static, kernel: str, item: str, slot: int) -> dict:
    """The kernels-line keys of one forward kernel's two builds: each
    build's mean time of ``item``, ptxas report, blocks per SM (``slot`` of
    the layout list) and SASS size."""
    mean = lambda v: sum(v) / len(v)
    return {"builds": {b: {"ms": mean(static["ms"][item][b]), "ptxas": r["ptxas"].get(kernel),
                           "blocks_per_sm": r["blocks_per_sm"][slot],
                           "sass_instructions": r["sass"].get(kernel)}
                       for b, r in static["reports"].items()}}


def env_bf16_phases(dev, card, K, scene, faces, escapes):
    """The environment mode with the bf16 table (``--env-bf16``): bit for
    bit against its plain version at the 256^2 tail and at the 30-frame
    1080p block, the block's time beside the f32 table's in turns through
    the build its path takes (trace.cu for the demo scene's counts), the mean
    relative difference of the two blocks' images (tpt's measure,
    benchmarks/exp_env_bf16.py), the instantiation's ptxas report and blocks
    per SM; then its path, ``cli render --env-bf16``, with the counts set to
    0 just before it.  Returns the kernels-line entry."""
    from tpt_torch import CameraConfig, cli
    from tpt_torch.camera import camera_matrices
    from tpt_torch.env import pack_block_table
    from tpt_torch.kernels import _build

    cam = CameraConfig()
    focal, ap = cam.focal_length, cam.aperture_diameter
    f32_table, table = pack_block_table(faces), pack_block_table(faces, dtype=torch.bfloat16)
    env_out = ("rad_sum", "ray_count", "seed")
    ip, iv, _ = camera_matrices(cam, 256, 256)
    kw = dict(width=256, height=256, ray_depth=DEPTH, spp=1, n_frames=4, n_valid=3)
    assert_bits_equal(K.trace_progressive(scene, ip, iv, 7, focal, ap, env_table=table, **kw),
                      K.trace_progressive_plain(scene, ip, iv, 7, focal, ap, env_table=table,
                                                **kw),
                      "bf16 environment mode at 256^2", env_out)

    ip, iv, _ = camera_matrices(cam, WIDTH, HEIGHT)
    kw = dict(width=WIDTH, height=HEIGHT, ray_depth=DEPTH, spp=1, n_frames=BLOCK,
              counts=scene.counts)

    def run(t):
        return K.trace_progressive(scene, ip, iv, 0, focal, ap, env_table=t, **kw)

    got = run(table)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    want = K.trace_progressive_plain(scene, ip, iv, 0, focal, ap, env_table=table, **kw)
    end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end)
    assert_bits_equal(got, want, "bf16 environment mode, 1080p block", env_out)
    del want
    f32 = run(f32_table)
    if not torch.equal(got.ray_count, f32.ray_count):
        raise AssertionError("bf16 environment mode, 1080p block: ray counts differ from the "
                             "f32 table's")
    # tpt's measure: |bf16 - f32| / max(|f32|, 1e-3), the mean over the image
    img, img_f32 = got.rad_sum / BLOCK, f32.rad_sum / BLOCK
    rel = float(((img - img_f32).abs() / img_f32.abs().clamp_min(1e-3)).mean())
    pixels, segments = WIDTH * HEIGHT, int(got.ray_count.sum())
    del got, f32, img, img_f32
    turns = [cuda_ms(lambda: run(f32_table), 3), cuda_ms(lambda: run(table), 3),
             cuda_ms(lambda: run(table), 3), cuda_ms(lambda: run(f32_table), 3)]
    table_bytes = table.numel() * table.element_size()
    bound_ms, bound_by = trace_bound(segments, pixels * BLOCK, pixels, 0, scene.counts,
                                     env_bytes=table_bytes, escapes=escapes)
    name = "trace_progressive_kernel<false,true,true>"
    lib = _build.library("trace.cu", DEMO)
    ptxas = ptxas_report(lib.log).get(name)
    per_sm = trace_blocks_per_sm(lib)[3]
    phase("env-bf16", f"the bf16 table ({table_bytes} bytes, the f32 table's "
          f"{f32_table.numel() * 4}): 256x256 4 frames (n_valid 3) and the {WIDTH}x{HEIGHT} "
          f"{BLOCK}-frame block bit-equal to the plain version, ray counts equal to the f32 "
          f"table's; through the {build_name(DEMO)} build: block f32 {turns[0]:.3f} / "
          f"bf16 {turns[1]:.3f} / bf16 {turns[2]:.3f} / f32 "
          f"{turns[3]:.3f} ms in turns, plain {plain_ms:.1f} ms, bound {bound_ms:.3f} ms "
          f"({bound_by}); mean relative image difference to the f32 table's {rel:.3g}; "
          f"{name}: {ptxas}, {per_sm} blocks/SM ({card})")

    with tempfile.TemporaryDirectory() as tmp:
        png = os.path.join(tmp, "bf16.png")
        K.LAUNCHES, K.ENV_LAUNCHES, K.ENV_BF16_LAUNCHES = 0, 0, 0
        K.BUILD_LAUNCHES.clear()
        rc = cli.main(["render", "--device", "cuda", "--width", str(WIDTH), "--height",
                       str(HEIGHT), "--frames", str(2 * BLOCK), "--chunk", str(BLOCK),
                       "--env-bf16", "--out", png])
        torch.cuda.synchronize()
        launches = (K.LAUNCHES, K.ENV_LAUNCHES, K.ENV_BF16_LAUNCHES)
        if rc != 0 or launches != (2, 2, 2) or os.path.getsize(png) == 0 \
                or dict(K.BUILD_LAUNCHES) != {DEMO: 2}:
            raise AssertionError(f"cli render --env-bf16: rc {rc}, launches (all, environment, "
                                 f"bf16) {launches} (want 2 each), by build "
                                 f"{dict(K.BUILD_LAUNCHES)}")
    phase("env-bf16", f"cli render --env-bf16 {WIDTH}x{HEIGHT} {2 * BLOCK} frames: {launches[2]} "
          f"kernel launches, all in the bf16 environment mode, through the "
          f"{build_name(DEMO)} build")
    return {"name": f"{name} (--env-bf16)", "route": "cuda",
            "source": "tpt_torch/csrc/trace.cu", "replaces": "tpt/kernels/trace.py:519",
            "launches": launches[2], "max_abs_err": 0.0, "ms": (turns[1] + turns[2]) / 2,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None, "f32_table_ms": (turns[0] + turns[3]) / 2,
            "mean_rel_image_diff": rel, "ptxas": ptxas, "blocks_per_sm": per_sm,
            "build": build_name(DEMO)}


def oracle_phase(dev, card, K):
    """``cli render --backend oracle`` at 1920x1080, depth 13, spp 1, 2
    frames: the plain renderer, no kernel launch; each frame it rendered
    (recorded around tpt_torch.reference.render_frame) is held to the
    kernel's per-frame launch at the same frame and inputs
    (tpt_torch.kernels.render.render_frame) at compare_per_frame's bar: at
    most 1e-4 of the pixels off, the others within rtol = atol = 1e-5."""
    from tpt_torch import cli, reference
    from tpt_torch.kernels.render import render_frame

    frames = []
    plain = reference.render_frame

    def recording(scene, env_faces, camera, cfg, frame):
        image, rays = plain(scene, env_faces, camera, cfg, frame)
        frames.append((scene, env_faces, camera, cfg, frame, image.clone(), int(rays)))
        return image, rays

    with tempfile.TemporaryDirectory() as tmp:
        png = os.path.join(tmp, "oracle.png")
        reference.render_frame = recording
        try:
            K.LAUNCHES = 0
            t0 = time.perf_counter()
            rc = cli.main(["render", "--device", "cuda", "--backend", "oracle", "--width",
                           str(WIDTH), "--height", str(HEIGHT), "--ray-depth", str(DEPTH),
                           "--spp", "1", "--frames", "2", "--out", png])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = K.LAUNCHES
        finally:
            reference.render_frame = plain
        if rc != 0 or len(frames) != 2 or launches != 0 or os.path.getsize(png) == 0:
            raise AssertionError(f"cli render --backend oracle: rc {rc}, {len(frames)} frames, "
                                 f"{launches} kernel launches (want 2 frames, none)")
    lines = []
    for scene, env_faces, camera, cfg, frame, image, rays in frames:
        want, want_rays = render_frame(scene, env_faces, camera, cfg, frame)
        off = ~((image - want).abs() <= 1e-5 + 1e-5 * want.abs()).all(-1)
        n_off = int(off.sum())
        if n_off > 1e-4 * off.numel() or not bool(torch.isfinite(image).all()):
            raise AssertionError(f"oracle frame {frame}: {n_off} pixels off the kernel's")
        lines.append(f"frame {frame}: {n_off} of {off.numel()} pixels off the kernel's frame, "
                     f"rays {rays} (kernel {int(want_rays)})")
    phase("oracle", f"cli render --backend oracle {WIDTH}x{HEIGHT} depth {DEPTH} spp 1, 2 "
          f"frames: {launches} kernel launches, {wall:.2f} s wall incl. the atmosphere; "
          + "; ".join(lines) + f" ({card})")


def silhouette_phases(dev, card, K):
    """``python -m tpt_torch.silhouette_demo`` on the card, ``--scene
    single`` and ``--scene demo`` at their defaults (200 steps): each must
    exit 0 through its own assertion, its rendered and target images from
    the forward kernel.  Returns the forward kernel's launches."""
    from tpt_torch import silhouette_demo

    total = 0
    for scene_name, want in (("single", 201), ("demo", 400)):
        with tempfile.TemporaryDirectory() as tmp:
            out = os.path.join(tmp, "silhouette.json")
            K.LAUNCHES = 0
            t0 = time.perf_counter()
            rc = silhouette_demo.main(["--scene", scene_name, "--device", "cuda", "--out", out])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = K.LAUNCHES
            with open(out) as f:
                res = json.load(f)
        if rc != 0 or launches != want:
            raise AssertionError(f"silhouette_demo --scene {scene_name}: rc {rc}, {launches} "
                                 f"forward kernel launches (want {want})")
        errs = ", ".join(f"{k} {res[k]}" for k in res if k.endswith(("_before", "_after")))
        phase("silhouette", f"silhouette_demo --scene {scene_name} {res['size']}^2 "
              f"{res['steps']} steps: rc {rc}, {launches} forward kernel launches, {errs}, "
              f"{wall:.1f} s wall ({card})")
        total += launches
    return total


def cli_tools_phase(dev, card):
    """``cli sky`` at its defaults and ``cli pick --x 416 --y 416`` on the
    card, each exiting 0; the pick must name an object."""
    import contextlib
    import io
    from tpt_torch import cli

    with tempfile.TemporaryDirectory() as tmp:
        png = os.path.join(tmp, "sky.png")
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            rc_sky = cli.main(["sky", "--device", "cuda", "--out", png])
        sky_ok = rc_sky == 0 and os.path.getsize(png) > 0
    sky = text.getvalue().strip().splitlines()
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        rc_pick = cli.main(["pick", "--device", "cuda", "--x", "416", "--y", "416"])
    pick = text.getvalue().strip().splitlines()
    if not sky_ok or rc_pick != 0 or not pick or "picked: nothing" in pick[0]:
        raise AssertionError(f"cli sky rc {rc_sky}: {sky}; cli pick rc {rc_pick}: {pick}")
    phase("cli", f"sky: {sky[0]}; pick --x 416 --y 416: {pick[0]} ({card})")


def probe_bound(name: str, n: int, rows: int, cols: int):
    """Bound of one probe call on n elements (see probes.cu): a gather reads
    idx and the table and writes n floats; a scatter reads idx and g (p5
    only its last tile) and writes its table; p2 and p4 read x (= g) and
    write n floats.  The bytes move at the HBM rate, so the kernel time to
    hold against it is the cold-L2 one (:func:`cold_device_ms`): a warm L2
    serves them faster than the bound."""
    from tpt_torch.kernels import probes as P
    table_bytes = P.R * P.K * 4
    if name in ("p1", "p3"):
        return bound(0, n * 8 + table_bytes)
    if name == "p2":
        return bound(n, n * 8)
    if name == "p4":
        return bound(n * OPS_P4, n * 8)
    if name == "p5":
        tile = P.TR * P.L
        return bound(tile, tile * 8 + rows * cols * 4)
    return bound(n * (2 if name == "p6" else 1), n * 8 + rows * cols * 4)


def probe_library_calls(idx, table, g):
    """One PyTorch call per probe for the same function (timed as a
    yardstick only; the port never calls them on the CUDA path); p4 has
    none."""
    from tpt_torch.kernels import probes as P
    flat_idx, flat_g = idx.reshape(-1).long(), g.reshape(-1)
    tail_idx, tail_g = idx[-P.TR:].reshape(-1).long(), g[-P.TR:].reshape(-1)
    acc = torch.zeros(P.R, dtype=torch.float32, device=g.device)
    sums = lambda: acc.index_add_(0, flat_idx, flat_g)
    return {"p1": lambda: table[idx, 0], "p3": lambda: table[idx, 0],
            "p1t": sums, "p7": sums, "p8": sums,
            "p5": lambda: torch.bincount(tail_idx, weights=tail_g, minlength=P.P5_ROWS),
            "p6": lambda: (torch.bincount(flat_idx, weights=flat_g, minlength=P.R),
                           torch.bincount(flat_idx, minlength=P.R)),
            "p2": lambda: g * 2, "p4": None}



def check_probe(name: str, got, want) -> float:
    """The probe bars: p1, p2, p3 and p6's columns 1-31 exact; the sums at
    rtol 1e-5, atol 1e-5 x the largest magnitude (atomics reorder them); p4
    at rtol 1e-5, atol 1e-6 (libm's tanh and exp).  Returns the max abs err."""
    err = float((got - want).abs().max())
    if name in ("p1", "p2", "p3"):
        ok = torch.equal(got, want)
    elif name == "p4":
        ok = torch.allclose(got, want, rtol=1e-5, atol=1e-6)
    elif name == "p6":
        ok = torch.equal(got[:, 1:], want[:, 1:]) and torch.allclose(
            got[:, 0], want[:, 0], rtol=1e-5, atol=1e-5 * float(want[:, 0].abs().max()))
    else:
        ok = torch.allclose(got, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))
    if not ok:
        raise AssertionError(f"probe {name}: kernel vs plain beyond its bar (max abs err {err:.3g})")
    return err


def profiled(run, kernel: str, calls: int):
    """torch.profiler around ``run()``, which makes ``calls`` calls: (every
    device operation, those whose name holds ``kernel``).  The profiler now
    and then hands back a trace with device events missing, at times in
    several traces in a row, so a trace with fewer than ``calls`` such
    kernels is taken again, up to six times in all."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(6):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        ops = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        mine = [e for e in ops if kernel in e.name]
        if len(mine) >= calls:
            break
    return ops, mine


def mean_ms(events):
    """The mean device ms of ``events``, None when there are none."""
    return sum(e.device_time_total for e in events) / len(events) / 1e3 if events else None


def device_profile(fn, kernel: str, reps: int = 10):
    """The mean device ms of the CUDA kernels whose name holds ``kernel``
    over ``reps`` calls of ``fn`` after one warm-up call (torch.profiler),
    None when the profiler saw none."""
    fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(reps):
            fn()

    return mean_ms(profiled(run, kernel, reps)[1])


# CUgraphNodeType of the CUDA driver API, by value
GRAPH_NODE_TYPES = ("kernel", "memcpy", "memset", "host", "graph", "empty", "wait_event",
                    "event_record", "ext_semas_signal", "ext_semas_wait", "mem_alloc",
                    "mem_free", "batch_mem_op", "conditional")


class KernelNodeParams(ctypes.Structure):
    """CUDA_KERNEL_NODE_PARAMS_v2 of the CUDA driver API."""
    _fields_ = [("func", ctypes.c_void_p), ("grid", ctypes.c_uint * 3),
                ("block", ctypes.c_uint * 3), ("shared_bytes", ctypes.c_uint),
                ("params", ctypes.c_void_p), ("extra", ctypes.c_void_p),
                ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]


def captured_ops(fn) -> list:
    """The device operations that one call of ``fn`` enqueues, read by
    capturing the call on a side stream into a CUDA graph (driver API) that
    is never launched: one "kind name" string per graph node, the name that
    of a kernel node's function.  Unlike a profiler trace this loses no
    event.  One call of ``fn`` on the side stream comes first, so that what
    a wrapper makes once per stream (a workspace) is made outside the
    capture.  A call that synchronises or copies from pageable memory
    invalidates the capture, and that raises."""
    cu = ctypes.CDLL("libcuda.so.1")

    def check(rc, what):
        if rc != 0:
            raise AssertionError(f"{what}: CUDA driver error {rc}")

    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        fn()
    side.synchronize()
    handle, graph = ctypes.c_void_p(side.cuda_stream), ctypes.c_void_p()
    with torch.cuda.stream(side):
        check(cu.cuStreamBeginCapture_v2(handle, 2), "cuStreamBeginCapture")   # relaxed mode
        try:
            fn()
        finally:
            check(cu.cuStreamEndCapture(handle, ctypes.byref(graph)), "cuStreamEndCapture")
    try:
        n = ctypes.c_size_t()
        check(cu.cuGraphGetNodes(graph, None, ctypes.byref(n)), "cuGraphGetNodes")
        nodes = (ctypes.c_void_p * n.value)()
        check(cu.cuGraphGetNodes(graph, nodes, ctypes.byref(n)), "cuGraphGetNodes")
        ops = []
        for node in nodes:
            kind = ctypes.c_int()
            check(cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)),
                  "cuGraphNodeGetType")
            name = (GRAPH_NODE_TYPES[kind.value] if kind.value < len(GRAPH_NODE_TYPES)
                    else f"node type {kind.value}")
            if kind.value == 0:
                params, text = KernelNodeParams(), ctypes.c_char_p()
                check(cu.cuGraphKernelNodeGetParams_v2(ctypes.c_void_p(node),
                                                       ctypes.byref(params)),
                      "cuGraphKernelNodeGetParams")
                for get_name, ptr in ((cu.cuFuncGetName, params.func),
                                      (cu.cuKernelGetName, params.kern),
                                      (cu.cuKernelGetName, params.func)):
                    if ptr and get_name(ctypes.byref(text), ctypes.c_void_p(ptr)) == 0:
                        name = f"kernel {text.value.decode()}"
                        break
            ops.append(name)
        return ops
    finally:
        cu.cuGraphDestroy(graph)


L2_BYTES = 50 << 20   # the H100's L2


def cold_device_ms(fn, inputs, kernel: str):
    """``fn``'s kernel time when its bytes come from and go to HBM, as the
    bound assumes: torch.profiler over calls that rotate through copies of
    ``inputs`` and keep each output until its copy comes round again, so
    what one call reads and writes is four times the L2 away from its next
    use, and on average each call writes back one output.  The mean device
    ms of the CUDA kernels whose name holds ``kernel`` over one round after
    a warm round, None when the profiler saw none."""
    per_copy = sum(t.numel() * t.element_size() for t in inputs)
    copies = [tuple(t.clone() for t in inputs) for _ in range(-(-4 * L2_BYTES // per_copy))]
    outs = [fn(*c) for c in copies]
    torch.cuda.synchronize()

    def run():
        for i, c in enumerate(copies):
            outs[i] = fn(*c)

    return mean_ms(profiled(run, kernel, len(copies))[1])


def host_ms(fn, reps: int = 200) -> float:
    """Host time per call of ``fn``: time.perf_counter around ``reps``
    calls with no synchronise inside (the device drained before and
    after)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e3


def probe_path():
    """The probes' path through ``tpt_torch.bwd_probes``, every count set
    to 0 first: each probe must launch its kernel.  Returns the launches."""
    from tpt_torch import bwd_probes
    from tpt_torch.kernels import probes as P

    for name in P.PROBES:
        P.PROBE_LAUNCHES[name] = 0
    rc = bwd_probes.main([])
    torch.cuda.synchronize()
    launches = dict(P.PROBE_LAUNCHES)
    if rc != 0 or not all(launches.values()):
        raise AssertionError(f"bwd_probes: rc {rc}, launches {launches}")
    phase("probes", f"python -m tpt_torch.bwd_probes: rc {rc}, kernel launches {launches}")
    return launches


def probe_timings(dev, card):
    """Each probe's kernel against its plain version at GRID 100 and 1013,
    and its times: a call (CUDA events), the host's share of a call
    (:func:`host_ms`), the kernel's own device time and the device
    operations a call makes (torch.profiler), the kernel's time with its
    bytes from and to HBM (:func:`cold_device_ms`), the plain
    version's and the library call's times, and the bound.  For the
    scatter it also reports whether a second call gave the same bits: the
    order of a warp's colliding shared-memory atomics is the hardware's, so
    that is an observation, not a bar.  Returns {probe: {grid: record}}."""
    from tpt_torch import bwd_probes
    from tpt_torch.kernels import probes as P

    per = {name: {} for name in P.PROBES}
    us = lambda v: "not measured" if v is None else f"{v * 1e3:.1f} us"
    for grid in PROBE_GRIDS:
        inputs = bwd_probes.make_inputs(grid, dev)
        n = inputs[2].numel()
        library = probe_library_calls(*inputs)
        reps = 50 if grid == PROBE_GRIDS[0] else 20
        for name in P.PROBES:
            fn, plain = getattr(P, name), getattr(P, f"{name}_plain")
            got, want = fn(*inputs), plain(*inputs)
            torch.cuda.synchronize()
            err = check_probe(name, got, want)
            rows, cols = P.output_shape(name, inputs[2].shape[0])
            b_ms, b_by = probe_bound(name, n, rows, cols)
            call = lambda: fn(*inputs)
            dev_ms = device_profile(call, P.KERNEL_OF[name])
            cold_ms = cold_device_ms(fn, inputs, P.KERNEL_OF[name])
            ops = captured_ops(call)
            rec = {"max_abs_err": err, "ms": cuda_ms(call, reps), "host_ms": host_ms(call),
                   "device_ms": dev_ms, "device_cold_ms": cold_ms, "device_ops": ops,
                   "plain_ms": cuda_ms(lambda: plain(*inputs), 5),
                   "library_ms": (cuda_ms(library[name], reps) if library[name] else None),
                   "library_host_ms": (host_ms(library[name]) if library[name] else None),
                   "bound_ms": b_ms, "bound_by": b_by}
            repeat = ""
            if name in P.SCATTER:
                again = fn(*inputs)
                rec["repeat_bit_equal"] = torch.equal(again.view(torch.int32),
                                                      got.view(torch.int32))
                repeat = f"; a second call bit-equal: {rec['repeat_bit_equal']}"
            per[name][grid] = rec
            share = ("not measured" if cold_ms is None else f"{b_ms / cold_ms:.0%} of the bound")
            phase("probes", f"{name} ({P.KERNEL_OF[name]}) GRID {grid}, {n} elements: max abs "
                  f"err {err:.3g}{repeat}; kernel {us(rec['ms'])} a call, {us(rec['host_ms'])} "
                  f"of host time a call, {us(dev_ms)} in the kernel (torch.profiler; {len(ops)} "
                  f"device operations a call, by stream capture: {', '.join(ops)}), "
                  f"{us(cold_ms)} with a "
                  f"cold L2 ({share}), plain {us(rec['plain_ms'])}, "
                  f"library {'none' if rec['library_ms'] is None else us(rec['library_ms'])} a "
                  f"call, {us(rec['library_host_ms'])} of host time; bound "
                  f"{b_ms * 1e3:.2f} us ({b_by}) ({card})")
    return per


def probe_phases(dev, card):
    """The probes' path (:func:`probe_path`), then :func:`probe_timings`;
    every probe call must make exactly one device operation, its kernel
    (no memset, no copy), read by :func:`captured_ops`.  Returns the
    kernels-line entries of the three probe kernels: launches from the
    path, the other numbers those of each kernel's first probe at GRID 100,
    and every probe's numbers under "probes"."""
    from tpt_torch.kernels import probes as P

    launches = probe_path()
    per = probe_timings(dev, card)
    extra = {f"{name} GRID {grid}": rec["device_ops"] for name in P.PROBES
             for grid, rec in per[name].items() if len(rec["device_ops"]) != 1
             or not rec["device_ops"][0].startswith("kernel ")
             or P.KERNEL_OF[name] not in rec["device_ops"][0]}
    if extra:
        raise AssertionError(f"probe calls that make other device operations than their one "
                             f"kernel: {extra}")
    us = lambda v: "not measured" if v is None else f"{v * 1e3:.2f} us"
    for name in ("p1", "p3"):
        rec = per[name][PROBE_GRIDS[1]]
        cold, b_ms = rec["device_cold_ms"], rec["bound_ms"]
        phase("probes", f"the redesigned gather, {name} GRID {PROBE_GRIDS[1]}: exact against its "
              f"plain version, {len(rec['device_ops'])} device operation a call, "
              f"{us(cold)} with a cold L2 against its {us(b_ms)} bytes bound ("
              + ("not measured" if cold is None else f"{b_ms / cold:.0%}")
              + f"), {us(rec['device_ms'])} warm; library table[idx, 0] "
              f"{us(rec['library_ms'])} a call ({card})")

    entries = []
    for kernel in ("probe_gather_kernel", "probe_scatter_kernel", "probe_elementwise_kernel"):
        names = [n for n in P.PROBES if P.KERNEL_OF[n] == kernel]
        first = per[names[0]][PROBE_GRIDS[0]]
        entries.append({
            "name": kernel, "route": "cuda", "source": "tpt_torch/csrc/probes.cu",
            "replaces": f"benchmarks/exp_bwd_probes.py:{PROBE_LINES[names[0]]}",
            "launches": sum(launches[n] for n in names),
            "max_abs_err": max(r["max_abs_err"] for n in names for r in per[n].values()),
            "ms": first["ms"], "plain_ms": first["plain_ms"], "bound_ms": first["bound_ms"],
            "bound_by": first["bound_by"], "library_ms": first["library_ms"],
            "host_ms": first["host_ms"],
            "at": f"{names[0]}, GRID {PROBE_GRIDS[0]}",
            "probes": {n: {str(g): r for g, r in per[n].items()} for n in names}})
    return entries


# the line of each Pallas probe's definition in benchmarks/exp_bwd_probes.py
DIST_RANKS = 4   # ranks sharing the one card in the dist phases


def table_groups(sphere, cuboid, counts):
    """The material tables' gradient entries by lane: each of the 16
    material lanes over the live sphere rows and over the live cuboid rows,
    and the padded rows."""
    ns, nc = counts
    groups = {f"sphere lane {c}": sphere[:ns, c] for c in range(sphere.shape[1])}
    groups.update({f"cuboid lane {c}": cuboid[:nc, c] for c in range(cuboid.shape[1])})
    groups["padding"] = torch.cat([sphere[ns:].reshape(-1), cuboid[nc:].reshape(-1)])
    return groups


def compare_tables(got, want, counts, rtol=1e-3, floor=1e-3):
    """compare_grads' bar on the material tables' gradients: each lane
    within rtol and atol = rtol x its scale (its largest magnitude in
    ``want``, floored at ``floor`` x the tables' largest).  Returns (the
    worst error over scale, [lanes beyond the bar])."""
    g_groups, w_groups = table_groups(*got, counts), table_groups(*want, counts)
    top = max(float(w.abs().max()) for w in want)
    worst, failed = 0.0, []
    for name, w in w_groups.items():
        d = (g_groups[name] - w).abs()
        scale = max(float(w.abs().max()) if w.numel() else 0.0, floor * top, 1e-30)
        if not bool((d <= rtol * scale + rtol * w.abs()).all()):
            failed.append(f"{name}: max abs err {float(d.max()):.3g}, scale {scale:.3g}")
        worst = max(worst, float(d.max()) / scale if d.numel() else 0.0)
    return worst, failed


def compare_adam(got, want, sgd_step, rtol=1e-3, floor=1e-3):
    """One clipped-Adam step's update against the world of one's, on the
    entries whose gradient (``sgd_step``, the same world's SGD step) is
    above ``floor`` x the tables' largest: a first Adam step is about lr x
    the gradient's sign, which rounding noise flips where the gradient is
    near 0.  Returns the worst relative error there."""
    top = max(float(t.abs().max()) for t in sgd_step)
    worst = 0.0
    for g, w, ref in zip(got, want, sgd_step):
        live = ref.abs() > floor * top
        d = (g - w).abs()[live]
        if not bool((d <= rtol * w.abs()[live]).all()):
            raise AssertionError(f"Adam step: max abs err {float(d.max()):.3g}")
        worst = max(worst, float((d / w.abs()[live]).max()) if d.numel() else 0.0)
    return worst


def wall_ms(fn, reps: int) -> float:
    """Host-clock ms of one ``fn()`` over ``reps`` calls after a warm one,
    synchronised at both ends (the dist runs' own clock)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def sum_launches(results, job: int, name: str) -> int:
    return sum(r[job]["launches"][name] for r in results if r[job] is not None)


def dist_phases(dev, card, faces):
    """The sharded paths of tpt_torch.parallel in one gloo world of 4
    ranks, all on cuda:0 (the kernels built once, by this process), held to
    this process's single-device runs: dist-render, dist-progressive,
    dist-train.  Each rank zeroes its kernel counters just before it drives
    a job and reads them just after.  The times are four processes sharing
    one card's SMs: contention, not scaling.  Returns the forward kernel's
    and each backward kernel's launches on these paths."""
    from tpt_torch import CameraConfig, RenderConfig, demo_scene
    from tpt_torch.camera import camera_matrices
    from tpt_torch.env import pack_block_table
    from tpt_torch.integrator import apply_environment_blocked
    from tpt_torch.kernels import trace as K
    from tpt_torch.kernels import trace_grad
    from tpt_torch.kernels.render import progressive_frames
    from tpt_torch.optim import clipped_adam
    from tpt_torch.parallel import launch, make_dist_renderer, make_mesh, make_train_step
    from tpt_torch.parallel.runs import run_jobs
    from tpt_torch.progressive import init_accumulator

    frame_cfg = dict(width=WIDTH, height=HEIGHT, ray_depth=DEPTH, spp=1)
    layouts = ((4, 1), (2, 2))
    train_layouts = ((2, 1), (2, 2))
    jobs = [dict(kind="render", dp=dp, sp=sp, cfg=frame_cfg, frames=[0], reps=5)
            for dp, sp in layouts]
    jobs += [dict(kind="progressive", dp=dp, sp=sp, cfg=frame_cfg, n_frames=BLOCK, blocks=2,
                  reps=3) for dp, sp in layouts]
    train = [dict(kind="train", dp=dp, sp=sp, cfg=frame_cfg, counts=(48, 7), rr=rr,
                  psum_bands=bands, lr=0.1, reps=5 if rr and bands == 1 else 0)
             for dp, sp in train_layouts for rr in (True, False) for bands in (1, 2)]
    train.append(dict(kind="train", dp=2, sp=2, cfg=frame_cfg, counts=(48, 7), rr=True,
                      adam=0.01))
    jobs += train
    setup = {"scene": "demo", "camera": {}, "env": faces.cpu().numpy(), "device": "cuda"}
    t0 = time.perf_counter()
    results = launch(run_jobs, DIST_RANKS, setup, jobs, backend="gloo", device="cuda:0",
                     timeout=600)
    wall = time.perf_counter() - t0
    first = results[0]

    scene, cam, cfg = demo_scene().build(dev), CameraConfig(), RenderConfig(**frame_cfg)
    focal, ap = cam.focal_length, cam.aperture_diameter
    ip, iv, _ = camera_matrices(cam, WIDTH, HEIGHT)
    table = pack_block_table(faces)
    fwd = sum(sum_launches(results, j, "LAUNCHES") for j in range(len(jobs)))
    tape = sum(sum_launches(results, j, "TAPE_LAUNCHES") for j in range(len(jobs)))
    adjoint = sum(sum_launches(results, j, "ADJOINT_LAUNCHES") for j in range(len(jobs)))

    # dist-render: (4, 1) against one whole-frame trace + the blocked fetch;
    # (2, 2) against groups 0 and 1 rendered here and averaged
    res = K.trace(scene, ip, iv, 0, focal, ap, **frame_cfg)
    whole = torch.movedim(apply_environment_blocked(res, table, 1), 0, -1)
    groups2 = make_dist_renderer(make_mesh(), cfg, n_sample_groups=2)
    want2, rays2 = groups2(scene, faces, ip, iv, focal, ap, 0)
    single = make_dist_renderer(make_mesh(), cfg)
    single_ms = wall_ms(lambda: single(scene, faces, ip, iv, focal, ap, 0), 5)
    parts = []
    for j, ((dp, sp), want, rays) in enumerate(zip(layouts, (whole, want2),
                                                   (int(res.ray_count.sum()), int(rays2)))):
        got = torch.from_numpy(first[j]["images"][0]).to(dev)
        if not torch.equal(got.view(torch.int32), want.contiguous().view(torch.int32)) \
                or first[j]["rays"][0] != rays:
            raise AssertionError(f"dist-render dp={dp} sp={sp}: the image or the ray count "
                                 f"({first[j]['rays'][0]} against {rays}) differs")
        if sum_launches(results, j, "LAUNCHES") != DIST_RANKS:
            raise AssertionError(f"dist-render dp={dp} sp={sp}: "
                                 f"{sum_launches(results, j, 'LAUNCHES')} kernel launches")
        parts.append(f"dp={dp} sp={sp}: bit-equal, rays {rays}, {first[j]['ms']:.2f} ms a frame")
    phase("dist-render", f"{WIDTH}x{HEIGHT} depth {DEPTH} spp 1 DoF, 256^2 atmosphere, "
          f"{DIST_RANKS} gloo ranks on cuda:0 ({wall:.1f} s for the world's phases): "
          + "; ".join(parts) + f"; one process {single_ms:.2f} ms a frame; the ranks share one "
          f"card, so these are contention, not scaling ({card})")

    # dist-progressive: two blocks against progressive_frames in one process
    acc = init_accumulator(HEIGHT, WIDTH, dev)
    blocks = []
    for b in range(2):
        acc, rays = progressive_frames(acc, scene, table, ip, iv, b * BLOCK, focal, ap,
                                       width=WIDTH, height=HEIGHT, ray_depth=DEPTH, spp=1,
                                       n_frames=BLOCK)
        blocks.append((acc.image.clone(), int(rays)))
    spare = init_accumulator(HEIGHT, WIDTH, dev)
    block_ms = wall_ms(lambda: progressive_frames(
        spare, scene, table, ip, iv, 0, focal, ap, width=WIDTH, height=HEIGHT, ray_depth=DEPTH,
        spp=1, n_frames=BLOCK), 3)
    parts = []
    for j, (dp, sp) in enumerate(layouts, start=len(layouts)):
        err = 0.0
        for b, (want, rays) in enumerate(blocks):
            got = torch.from_numpy(first[j]["images"][b]).to(dev)
            if first[j]["rays"][b] != rays:
                raise AssertionError(f"dist-progressive dp={dp} sp={sp} block {b}: rays "
                                     f"{first[j]['rays'][b]} against {rays}")
            if sp == 1 and not torch.equal(got.view(torch.int32), want.view(torch.int32)):
                raise AssertionError(f"dist-progressive dp={dp} block {b}: not bit-equal")
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
            err = max(err, float((got - want).abs().max()))
        if sum_launches(results, j, "ENV_LAUNCHES") != 2 * DIST_RANKS:
            raise AssertionError(f"dist-progressive dp={dp} sp={sp}: "
                                 f"{sum_launches(results, j, 'ENV_LAUNCHES')} environment-mode "
                                 f"launches (want {2 * DIST_RANKS})")
        parts.append(f"dp={dp} sp={sp}: {'bit-equal' if sp == 1 else f'max abs err {err:.3g}'}, "
                     f"rays exact, {first[j]['ms']:.2f} ms a block")
    phase("dist-progressive", f"{WIDTH}x{HEIGHT} {BLOCK}-frame blocks x 2, {DIST_RANKS} gloo "
          f"ranks on cuda:0: " + "; ".join(parts) + f"; one process {block_ms:.2f} ms a block "
          f"(ranks sharing one card: contention, not scaling) ({card})")

    # dist-train: each step against a world of one with the same sample
    # groups and the same row bands (psum_bands = dp x the job's bands), so
    # that both make the same backward launches.  trace_grad's finite filter
    # zeroes a non-finite table entry per launch, so another split into
    # bands is another result wherever a pixel's cotangent is not finite
    # (the whole-frame line below counts those entries)
    target = torch.full((HEIGHT, WIDTH, 3), 0.25, device=dev)
    args = (faces, ip, iv, focal, ap, 0, target)

    def single_step(groups, rr, bands, adam=None):
        opt = clipped_adam(lr=adam) if adam else None
        step = make_train_step(make_mesh(), cfg, n_sample_groups=groups, counts=(48, 7),
                               russian_roulette=rr, optimizer=opt, psum_bands=bands)
        state = opt.init((scene.sphere_material, scene.cuboid_material)) if opt else 0.1
        new_scene, *rest = step(scene, *args, state)
        return ((scene.sphere_material - new_scene.sphere_material,
                 scene.cuboid_material - new_scene.cuboid_material), float(rest[-1]), step)

    singles, parts = {}, []
    for j, job in enumerate(train, start=2 * len(layouts)):
        groups, rr, adam = job["sp"], job["rr"], job.get("adam")
        bands = job["dp"] * job.get("psum_bands", 1)
        key = (groups, rr, bands, adam)
        if key not in singles:
            singles[key] = single_step(groups, rr, bands, adam)
        want, want_loss, _ = singles[key]
        got = first[j]
        got_step = tuple(torch.from_numpy(s - g).to(dev) for s, g in
                         zip(got["start"], (got["sphere_material"], got["cuboid_material"])))
        if abs(got["losses"][0] - want_loss) > 1e-5 * abs(want_loss):
            raise AssertionError(f"dist-train {job}: loss {got['losses'][0]} against "
                                 f"{want_loss}")
        if adam:
            worst = compare_adam(got_step, want, singles[(groups, rr, bands, None)][0])
        else:   # an SGD step is lr x the gradient
            worst, failed = compare_tables(tuple(t / 0.1 for t in got_step),
                                           tuple(t / 0.1 for t in want), (48, 7))
            if failed:
                raise AssertionError(f"dist-train {job}: " + "; ".join(failed))
        tapes = sum_launches(results, j, "TAPE_LAUNCHES")
        if tapes != job["dp"] * job["sp"] * job.get("psum_bands", 1):
            raise AssertionError(f"dist-train {job}: {tapes} tape kernel launches")
        keys = {k for r in results if r[j] is not None
                for k in r[j]["launches"]["BUILD_LAUNCHES"]}
        if keys != {None}:
            raise AssertionError(f"dist-train {job}: trace kernel builds {keys} (want the "
                                 f"dynamic build alone)")
        what = "Adam" if adam else f"rr {'on' if rr else 'off'} bands {job['psum_bands']}"
        parts.append(f"dp={job['dp']} sp={job['sp']} {what}: loss {got['losses'][0]:.6f}, "
                     f"worst err/scale {worst:.2g}"
                     + (f", {got['ms']:.2f} ms a step" if got.get("ms") else ""))
    single_ms, off = {}, []
    for groups in (1, 2):
        whole, whole_loss, step = single_step(groups, True, 1)
        zeroed = int(trace_grad.LAST_ZEROED)   # the whole frame's last launch
        single_ms[groups] = wall_ms(lambda: step(scene, *args, 0.1), 5)
        banded = singles[(groups, True, 2, None)][0]
        _, failed = compare_tables(tuple(t / 0.1 for t in whole),
                                   tuple(t / 0.1 for t in banded), (48, 7))
        off.append(f"{groups} group{'s' if groups > 1 else ''}: {len(failed)} lanes beyond the "
                   f"bar ({', '.join(f.split(':')[0] for f in failed) or 'none'}), the whole "
                   f"frame's launch zeroed {zeroed} entries")
    phase("dist-train", f"make_train_step(backend='kernel') {WIDTH}x{HEIGHT} depth {DEPTH} spp "
          f"1 counts (48, 7), SGD lr 0.1, {DIST_RANKS} gloo ranks on cuda:0, each held to a "
          f"world of one with the same groups and row bands (loss rtol 1e-5, tables' "
          f"gradients at rtol 1e-3, floor 1e-3; every launch through the dynamic "
          f"build): " + "; ".join(parts) + "; one process "
          + ", ".join(f"{ms:.2f} ms a step ({g} group{'s' if g > 1 else ''}, whole frame)"
                      for g, ms in single_ms.items())
          + f" (ranks sharing one card: contention, not scaling) ({card})")
    phase("dist-train", "the whole-frame world of one (psum_bands=1) against the same in two "
          "row bands, rr on: " + "; ".join(off) + " (trace_grad's finite filter zeroes a "
          "non-finite entry per launch)")
    return fwd, {"tape": tape, "adjoint": adjoint}


def nccl_phase(dev, card):
    """A world of one on the NCCL backend: the sharded renderer at 1080p
    equals the single process bit for bit and an all-reduce of a CUDA
    tensor runs through NCCL; then ``tpt_torch.parallel.dryrun(4)`` (gloo,
    cuda:0).  Returns the forward kernel's launches."""
    import contextlib
    import io
    from tpt_torch import CameraConfig, demo_scene
    from tpt_torch.camera import camera_matrices
    from tpt_torch.env import constant_environment, pack_block_table
    from tpt_torch.integrator import apply_environment_blocked
    from tpt_torch.kernels import trace as K
    from tpt_torch.parallel import dryrun, launch
    from tpt_torch.parallel.runs import run_jobs

    env = (0.3, 0.45, 0.6)
    frame_cfg = dict(width=WIDTH, height=HEIGHT, ray_depth=DEPTH, spp=1)
    jobs = [dict(kind="render", dp=1, sp=1, cfg=frame_cfg, frames=[0]),
            dict(kind="all_reduce", dp=1, sp=1, cfg=frame_cfg)]
    (got, reduced), = launch(run_jobs, 1, {"scene": "demo", "camera": {}, "env": env,
                                           "device": "cuda"}, jobs, backend="nccl",
                             device="cuda:0", timeout=300)
    scene, cam = demo_scene().build(dev), CameraConfig()
    ip, iv, _ = camera_matrices(cam, WIDTH, HEIGHT)
    res = K.trace(scene, ip, iv, 0, cam.focal_length, cam.aperture_diameter, **frame_cfg)
    want = torch.movedim(apply_environment_blocked(
        res, pack_block_table(constant_environment(env, device=dev)), 1), 0, -1)
    image = torch.from_numpy(got["images"][0]).to(dev)
    if not torch.equal(image.view(torch.int32), want.contiguous().view(torch.int32)) \
            or got["rays"][0] != int(res.ray_count.sum()) or got["launches"]["LAUNCHES"] != 1:
        raise AssertionError("dist-nccl: the world of one differs from the single process")
    if reduced["backend"] != "nccl" or reduced["sum"] != [1.0] * 4 \
            or not reduced["device"].startswith("cuda"):
        raise AssertionError(f"dist-nccl: all_reduce {reduced}")
    text = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(text):
        dryrun(DIST_RANKS, device="cuda:0", backend="gloo")
    dry = text.getvalue().strip().splitlines()
    phase("dist-nccl", f"world of one, NCCL: make_dist_renderer {WIDTH}x{HEIGHT} bit-equal to "
          f"the single process, 1 kernel launch; all_reduce of a {reduced['device']} tensor "
          f"through {reduced['backend']}; dryrun({DIST_RANKS}) on cuda:0 (gloo), "
          f"{time.perf_counter() - t0:.1f} s: " + " | ".join(dry))
    return got["launches"]["LAUNCHES"]


def viewer_phase(dev, card, K):
    """The viewer's session on the card at 1080p: two 30-frame draws held
    bit for bit to progressive_frames called directly, a held key resets
    the accumulation, a pick at the window centre names what ``cli pick``
    names, a screenshot; ms a draw (FrameStats) and frame_stats of one
    frame.  Returns the forward kernel's launches of the two draws."""
    import contextlib
    import io
    from tpt_torch import cli
    from tpt_torch.camera import camera_matrices
    from tpt_torch.interactive import FrameStats, ViewerSession
    from tpt_torch.kernels.render import progressive_frames
    from tpt_torch.progressive import init_accumulator
    from tpt_torch.utils.profiling import frame_stats

    with tempfile.TemporaryDirectory() as tmp:
        ses = ViewerSession(size=256, device="cuda", screenshot_dir=tmp)
        ses.set_size(WIDTH, HEIGHT)
        cam = ses.cam.to_config(ses.base_cam)
        ip, iv, _ = camera_matrices(cam, WIDTH, HEIGHT)
        want = init_accumulator(HEIGHT, WIDTH, dev)
        launches, spec = 0, 0
        for b in range(2):
            K.ENV_LAUNCHES = 0
            K.BUILD_LAUNCHES.clear()
            disp = ses.render_one(BLOCK)
            launches += K.ENV_LAUNCHES
            spec += K.BUILD_LAUNCHES[DEMO]
            want, rays = progressive_frames(want, ses.scene, ses.env_table, ip, iv, b * BLOCK,
                                            cam.focal_length, cam.aperture_diameter,
                                            width=WIDTH, height=HEIGHT,
                                            ray_depth=ses.cfg.ray_depth, spp=ses.cfg.spp,
                                            n_frames=BLOCK)
            if not torch.equal(ses.acc.image.view(torch.int32), want.image.view(torch.int32)):
                raise AssertionError(f"viewer: draw {b} differs from progressive_frames")
        if launches != 2 or spec != 2 or disp.shape != (HEIGHT, WIDTH, 3) \
                or disp.dtype != np.uint8:
            raise AssertionError(f"viewer: {launches} environment-mode launches in two draws, "
                                 f"{spec} through the {build_name(DEMO)} build (want 2, "
                                 f"2), display {disp.shape} {disp.dtype}")
        shot = ses.screenshot()
        if not os.path.getsize(shot) > 0:
            raise AssertionError("viewer: empty screenshot")
        obj = ses.pick(WIDTH / 2, HEIGHT / 2)
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            cli.main(["pick", "--device", "cuda", "--x", "416", "--y", "416"])
        pick = text.getvalue().strip().splitlines()[0]
        if obj is None or f"object #{ses.builder.objects.index(obj)} " not in pick:
            raise AssertionError(f"viewer: picked {obj} at the centre, cli pick says {pick}")
        if not ses.tick(0.016, keys=("w",)) or ses.acc.frame != 0 or ses.samples_per_pixel:
            raise AssertionError("viewer: a held key did not reset the accumulation")
        stats = FrameStats(time.time())
        t0 = time.time()
        while time.time() - t0 < 1.0:
            ses.render_one(1)
            stats.note_frames(1, ses.cfg.spp)
        stats.sample(time.time())
        _, one = progressive_frames(init_accumulator(HEIGHT, WIDTH, dev), ses.scene,
                                    ses.env_table, ip, iv, 0, cam.focal_length,
                                    cam.aperture_diameter, width=WIDTH, height=HEIGHT,
                                    ray_depth=ses.cfg.ray_depth, spp=ses.cfg.spp)
        fs = frame_stats(lambda: ses.render_one(1), rays=int(one))
    phase("viewer", f"ViewerSession(size=256, device='cuda') -> set_size({WIDTH}, {HEIGHT}); "
          f"render_one({BLOCK}) twice through the {build_name(DEMO)} build, "
          f"bit-equal to progressive_frames without counts, the dynamic build ({launches} "
          f"environment-mode launches); a held key resets; the centre "
          f"pick names {pick.split(' at ')[0].replace('picked: ', '')}, as cli pick; screenshot "
          f"{os.path.basename(shot)}; one-frame draws {1e3 / max(stats.fps, 1e-9):.2f} ms "
          f"(FrameStats, {stats.fps:.1f} draws/s incl. the uint8 copy); frame_stats "
          f"{fs['ms_per_frame']:.2f} ms a frame, {fs['mrays_per_s']:.1f} Mrays/s ({card})")
    return launches


def native_phase():
    """The native bridge: whether g++ and zlib built the library here, and
    where they did, its std140 pack and PCG chain bit for bit against the
    Python versions."""
    from tpt_torch import demo_scene, native_bridge
    from tpt_torch.scene import pack_std140

    if not native_bridge.native_available():
        phase("native", f"native library not built ({native_bridge.build_error()}); the "
              f"Python versions run")
        return
    scene = demo_scene().build()
    if native_bridge.pack_std140_native(scene).tobytes() != pack_std140(scene).tobytes():
        raise AssertionError("native: pack_std140 differs from the Python version")
    for seed in (1, 12345, 0xDEADBEEF):
        if native_bridge.pcg_floats_native(seed, 64).tobytes() != \
                native_bridge.pcg_floats(seed, 64).tobytes():
            raise AssertionError(f"native: the PCG chain from {seed} differs")
    phase("native", f"built {os.path.relpath(native_bridge.library_path(), REPO)}: "
          f"pack_std140 and the PCG chain (3 seeds x 64 draws) bit-equal to the Python versions")


PROBE_LINES = {"p1": 46, "p1t": 57, "p2": 73, "p3": 82, "p4": 94, "p5": 109, "p6": 126,
               "p7": 148, "p8": 168}


def main() -> int:
    # ---- 1. device ----
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    dev = torch.device("cuda")
    sys.path.insert(0, REPO)
    from tpt_torch import CameraConfig, demo_scene
    from tpt_torch.camera import camera_matrices
    from tpt_torch.kernels import _build
    from tpt_torch.kernels import trace as K
    from tpt_torch.kernels import trace_grad as G

    card = gpu_name_and_power()
    print(card, flush=True)
    phase("device", f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)} sm_{''.join(map(str, torch.cuda.get_device_capability(0)))} "
          f"count {torch.cuda.device_count()}")

    # ---- 2. build: every library a phase uses, all nvcc runs at once ----
    t0 = time.perf_counter()
    wanted = [(src, None) for src in _build.SOURCES] + [("trace.cu", DEMO)]
    before = {pair for pair in wanted if _build.library_path(*pair).exists()}
    built = _build.build_all(wanted)
    for src, key in built:
        _build.library(src, key)
    wall = time.perf_counter() - t0
    phase("build", f"{wall:.2f} s for {len(built)} libraries -> "
          f"{', '.join(os.path.relpath(p, REPO) for p, _ in built.values())}; ptxas: "
          + "; ".join(f"{k} {v}" for _, log in built.values()
                      for k, v in ptxas_report(log).items()))
    phase("build", "nvcc seconds: " + "; ".join(
        f"{src} {build_name(key)} "
        + ("built before" if (src, key) in before else f"{_build.build_seconds(path):.2f} s")
        for (src, key), (path, _) in built.items()))
    per_sm = trace_blocks_per_sm()
    phase("trace-build", "csrc/trace.cu ptxas: " + "; ".join(
        f"{k} {v}" for k, v in ptxas_report(built["trace.cu", None][1]).items())
        + "; blocks per SM (select, table, environment, bf16 environment): "
        + ", ".join(map(str, per_sm)))

    scene = demo_scene().build(dev)
    cam = CameraConfig()
    focal, ap = cam.focal_length, cam.aperture_diameter

    # ---- 3. per-frame kernel vs plain ----
    max_err = 0.0
    times = {}
    for view, c, w, h, depth, spp, rr, jitter in frame_cases():
        ip, iv, _ = camera_matrices(c, w, h)
        kw = dict(width=w, height=h, ray_depth=depth, spp=spp, rr=rr, jitter=jitter)
        got = K.trace(scene, ip, iv, 5, c.focal_length, c.aperture_diameter, **kw)
        want = K.trace_plain(scene, ip, iv, 5, c.focal_length, c.aperture_diameter, **kw)
        torch.cuda.synchronize()
        n_flipped, err = compare_per_frame(got, want)
        max_err = max(max_err, err)
        line = (f"{w}x{h} {view} view depth {depth} spp {spp} rr {rr} {jitter}: {n_flipped} "
                f"pixels flipped, max abs err {err:.3g}")
        if w == WIDTH:
            times["per_frame_ms"] = cuda_ms(lambda: K.trace(scene, ip, iv, 5, focal, ap, **kw), 20)
            times["per_frame_plain_ms"] = cuda_ms(
                lambda: K.trace_plain(scene, ip, iv, 5, focal, ap, **kw), 3)
            times["per_frame_lane_efficiency"] = G.lane_efficiency(got.ray_count)
            line += (f"; kernel {times['per_frame_ms']:.3f} ms, plain "
                     f"{times['per_frame_plain_ms']:.1f} ms per frame ({card}); lane "
                     f"efficiency {times['per_frame_lane_efficiency']:.4f}")
        phase("per-frame", line)

    # ---- 4. refill kernel vs plain: the slot mode, then the environment mode ----
    from tpt_torch.config import AtmosphereConfig
    from tpt_torch.env import pack_block_table
    from tpt_torch.sky import compute_atmosphere
    faces = compute_atmosphere(AtmosphereConfig(size=256), dev)
    table = pack_block_table(faces)
    env_out = ("rad_sum", "ray_count", "seed")
    ip, iv, _ = camera_matrices(cam, 256, 256)
    kw = dict(width=256, height=256, ray_depth=DEPTH, spp=1, n_frames=4, n_valid=3)
    got = K.trace_progressive(scene, ip, iv, 7, focal, ap, **kw)
    err_tail = compare_refill(got, K.trace_progressive_plain(scene, ip, iv, 7, focal, ap, **kw))
    if got.miss_dir[3].any() or got.miss_thr[3].any():
        raise AssertionError("slot of the masked frame is not zero")
    got = K.trace_progressive(scene, ip, iv, 7, focal, ap, env_table=table, **kw)
    assert_bits_equal(got, K.trace_progressive_plain(scene, ip, iv, 7, focal, ap,
                                                     env_table=table, **kw),
                      "environment mode at 256^2", env_out)
    # the launch the main path makes: a 30-frame 1080p block from frame 0, in
    # the slot mode and in the environment mode
    ip, iv, _ = camera_matrices(cam, WIDTH, HEIGHT)
    kw = dict(width=WIDTH, height=HEIGHT, ray_depth=DEPTH, spp=1, n_frames=BLOCK)
    got = K.trace_progressive(scene, ip, iv, 0, focal, ap, **kw)
    err_block = compare_refill(got, K.trace_progressive_plain(scene, ip, iv, 0, focal, ap, **kw))
    max_err = max(max_err, err_tail, err_block)
    times["slot_block_ms"] = cuda_ms(
        lambda: K.trace_progressive(scene, ip, iv, 0, focal, ap, **kw), 3)
    # the environment changes no decision, so the environment mode's launch
    # at these inputs looks it up for exactly the slot mode's escapes
    slot_rays, escapes = got.ray_count, escaped_samples(got.miss_dir)
    del got

    def run():
        return K.trace_progressive(scene, ip, iv, 0, focal, ap, env_table=table, **kw)

    def run_plain():
        return K.trace_progressive_plain(scene, ip, iv, 0, focal, ap, env_table=table, **kw)

    got = run()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    want = run_plain()
    end.record()
    torch.cuda.synchronize()
    times["block_plain_ms"] = start.elapsed_time(end)
    assert_bits_equal(got, want, "environment mode, 1080p block", env_out)
    del want
    if not torch.equal(got.ray_count, slot_rays):
        raise AssertionError("environment mode, 1080p block: ray counts differ from the "
                             "slot mode's")
    times["block_ms"] = cuda_ms(run, 3)
    pixels, segments = WIDTH * HEIGHT, int(got.ray_count.sum())
    times["bound_ms"], times["bound_by"] = trace_bound(
        segments, pixels * BLOCK, pixels, 0, scene.counts,
        env_bytes=table.numel() * table.element_size(), escapes=escapes)
    # the pooled queue's lane efficiency: the segments over 32 x the warps'
    # loop iterations, which a launch at the same inputs writes
    iters = torch.empty(K.n_warps(pixels), dtype=torch.int32, device=dev)
    again = K._launch(scene, ip, iv, 0, focal, ap, n_valid=BLOCK, counts=None, n_rows=HEIGHT,
                      row0=0, jitter="corner", rr=True, env_table=table, warp_iters=iters, **kw)
    if not torch.equal(again.ray_count, got.ray_count):
        raise AssertionError("environment mode, 1080p block: a second launch gave other ray "
                             "counts")
    del again
    times["lane_efficiency"] = segments / (32.0 * int(iters.sum()))
    times["per_lane_lane_efficiency"] = G.lane_efficiency(got.ray_count)
    phase("refill", f"slot mode: 256x256 4 frames (n_valid 3) and the {WIDTH}x{HEIGHT} "
          f"{BLOCK}-frame block: integers exact, max abs err {err_tail:.3g} / {err_block:.3g} "
          f"(floats within rtol 1e-3 atol 1e-4); environment mode (256^2 atmosphere): both "
          f"bit-equal to the plain version; {WIDTH}x{HEIGHT} {BLOCK}-frame block: environment "
          f"mode {times['block_ms']:.2f} ms, slot mode {times['slot_block_ms']:.2f} ms, plain "
          f"{times['block_plain_ms']:.1f} ms, bound {times['bound_ms']:.3f} ms "
          f"({times['bound_by']}, {segments} segments, {escapes} escapes) ({card})")
    phase("refill", f"lane efficiency (a warp's segments over 32 x its loop iterations): "
          f"{WIDTH}x{HEIGHT} frame {times['per_frame_lane_efficiency']:.4f}, {BLOCK}-frame "
          f"block {times['lane_efficiency']:.4f} pooled (one pixel a lane would give "
          f"{times['per_lane_lane_efficiency']:.4f})")
    bf16_entry = env_bf16_phases(dev, card, K, scene, faces, escapes)

    # ---- 5. golden image through the kernel ----
    from tpt_torch.kernels.render import kernel_counts, progressive_frames, render_fields
    gip, giv, gpos = camera_matrices(cam, 512, 512)
    img, _ = render_fields(scene, compute_atmosphere(AtmosphereConfig(size=32), dev),
                           gip, giv, gpos, 0, focal, ap, width=512, height=512,
                           ray_depth=DEPTH, spp=1)
    golden = np.load(os.path.join(REPO, "tests", "golden", "demo_512.npz"))["image"]
    golden = golden.astype(np.float32)
    img = img.cpu().numpy()
    off = ~(np.abs(img - golden) <= 5e-3 + 2e-3 * np.abs(golden)).all(-1)
    if not np.isfinite(img).all() or off.mean() > 1e-3:
        raise AssertionError(f"golden 512^2: {int(off.sum())} pixels off")
    phase("golden", f"512x512 demo frame vs tests/golden/demo_512.npz: {int(off.sum())} "
          f"of {off.size} pixels beyond atol 5e-3 rtol 2e-3")

    # ---- 6. the main path through its entry point ----
    from tpt_torch import cli
    from tpt_torch.progressive import load_checkpoint
    with tempfile.TemporaryDirectory() as tmp:
        png, ckpt = os.path.join(tmp, "smoke.png"), os.path.join(tmp, "smoke.npz")
        K.LAUNCHES, K.ENV_LAUNCHES = 0, 0
        K.BUILD_LAUNCHES.clear()
        t0 = time.perf_counter()
        rc = cli.main(["render", "--device", "cuda", "--width", str(WIDTH),
                       "--height", str(HEIGHT), "--frames", str(3 * BLOCK),
                       "--chunk", str(BLOCK), "--out", png, "--checkpoint", ckpt])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, env_launches = K.LAUNCHES, K.ENV_LAUNCHES
        main_builds = dict(K.BUILD_LAUNCHES)
        if rc != 0 or launches != 3 or env_launches != 3:
            raise AssertionError(f"cli render: rc {rc}, {launches} kernel launches, "
                                 f"{env_launches} in the environment mode (want 3, 3)")
        if main_builds != {DEMO: 3}:
            raise AssertionError(f"cli render: launches by build {main_builds} (want all 3 "
                                 f"through the build for the scene's counts {DEMO})")
        state = load_checkpoint(ckpt, dev)
        if not (os.path.getsize(png) > 0 and state.frame == 3 * BLOCK
                and tuple(state.image.shape) == (HEIGHT, WIDTH, 3)
                and bool(torch.isfinite(state.image).all()) and float(state.image.mean()) > 0):
            raise AssertionError("cli render: bad accumulator or PNG")
    phase("main-path", f"cli render {WIDTH}x{HEIGHT} {3 * BLOCK} frames in {BLOCK}-frame "
          f"blocks: {launches} kernel launches, all in the environment mode and through the "
          f"{build_name(DEMO)} build, {wall:.2f} s "
          f"wall incl. the atmosphere, accumulator finite, mean "
          f"{float(state.image.mean()):.4f}")

    # steady state: blocks of progressive_frames after a warm-up block, 3 at
    # a time in turns through the build the main path launches (the scene's
    # counts) and through the dynamic build (no counts)
    frame = state.frame

    def block(counts):
        nonlocal frame
        _, rays = progressive_frames(state, scene, table, ip, iv, frame, focal, ap,
                                     width=WIDTH, height=HEIGHT, ray_depth=DEPTH, spp=1,
                                     counts=counts, n_frames=BLOCK)
        frame += BLOCK
        return rays

    def three_blocks(counts):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        rays = [block(counts) for _ in range(3)]
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / 3
        return ms, int(sum(int(r) for r in rays)) / (3 * ms * 1e-3) / 1e6

    path_counts = kernel_counts(scene, dev)
    block(path_counts)
    block(None)
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    through = {}
    for counts in (path_counts, None, None, path_counts):
        through.setdefault(counts, []).append(three_blocks(counts))
    block_bytes = torch.cuda.max_memory_allocated(dev) - resident
    slot_bytes = 2 * BLOCK * 3 * WIDTH * HEIGHT * 4
    if block_bytes >= slot_bytes:
        raise AssertionError(f"a block allocated {block_bytes} bytes: miss slots are "
                             f"{slot_bytes}")
    for counts, key in ((path_counts, DEMO), (None, None)):
        ms_block, mrays = (sum(v) / 2 for v in zip(*through[counts]))
        phase("throughput", f"{build_name(key)} build: {ms_block:.2f} ms per {BLOCK}-frame "
              f"block, {mrays:.1f} Mrays/s (traced segments / s; 3 blocks at a time in turns "
              f"{build_name(DEMO)}, dynamic, dynamic, {build_name(DEMO)}) on "
              f"{card}")
    phase("throughput", f"a block's peak allocation {block_bytes} bytes above the {resident} "
          f"resident (the miss slots would be {slot_bytes})")

    # the oracle renderer, the host tools and the silhouette demos through
    # their entry points
    oracle_phase(dev, card, K)
    cli_tools_phase(dev, card)
    silhouette_launches = silhouette_phases(dev, card, K)

    # the training path first, before torch.profiler first runs (the grad
    # phase's per-kernel times), so its wall clock is taken as it was before
    # the grad phase used the profiler
    train_launches, grad_launches = train_phases(dev, card, K, G)
    loss_pixel_phase(dev, card, K, faces)
    grad_err, grad_times = grad_phases(dev, card, K, G)

    onehot_launches, onehot_times = onehot_phases(dev, card, K)
    static = static_counts_phase(dev, card, K, faces)
    probe_kernels = probe_phases(dev, card)

    # the sharded paths in worlds of ranks on this card, then the viewer and
    # the native bridge
    dist_launches, dist_grad_launches = dist_phases(dev, card, faces)
    dist_launches += nccl_phase(dev, card)
    viewer_launches = viewer_phase(dev, card, K)
    native_phase()

    # one kernel serves both forward TPU kernels (pallas_trace_progressive at
    # :519 and pallas_trace at :298), in two builds.  The dynamic build's
    # entry: its times those of a 30-frame 1080p block in the environment
    # mode without counts, its launches those of the paths that take it (the
    # training path, the silhouette demos, the sharded paths, every rank's),
    # its lane efficiency that of the block.  The build for the demo scene's
    # counts: the launches of the render path and the viewer's draws, its
    # times the same block's in the static-counts turns, beside every
    # build's.  The backward kernels' launches are those of the training
    # path and the sharded train step, all through the dynamic build.
    # The table mode (the one-hot gather) is timed per 1080p frame, the
    # bf16 environment mode per block through the build its path takes,
    # each with its own path's launches.  No one PyTorch call computes a
    # trace or its backward: library_ms is null.
    env = "trace_progressive_kernel<false,true,false>"
    print(json.dumps({"kernels": [{
        "name": "trace_progressive_kernel",
        "route": "cuda",
        "source": "tpt_torch/csrc/trace.cu",
        "replaces": "tpt/kernels/trace.py:519",
        "launches": train_launches + silhouette_launches + dist_launches,
        "max_abs_err": max_err,
        "ms": times["block_ms"],
        "plain_ms": times["block_plain_ms"],
        "bound_ms": times["bound_ms"],
        "bound_by": times["bound_by"],
        "library_ms": None,
        "lane_efficiency": times["lane_efficiency"],
        "build": "dynamic",
    }, {
        "name": f"{env} ({build_name(DEMO)})",
        "route": "cuda",
        "source": "tpt_torch/csrc/trace.cu",
        "replaces": "tpt/kernels/trace.py:519",
        "launches": main_builds[DEMO] + viewer_launches,
        "max_abs_err": max_err,
        "ms": sum(static["ms"]["block"][build_name(DEMO)]) / 2,
        "plain_ms": times["block_plain_ms"],
        "bound_ms": times["bound_ms"],
        "bound_by": times["bound_by"],
        "library_ms": None,
        "build": build_name(DEMO),
        **static_entries(static, env, "block", 2),
    }, {
        "name": "trace_progressive_kernel<true,false,false> (gather=onehot)",
        "route": "cuda",
        "source": "tpt_torch/csrc/trace.cu",
        "replaces": "tpt/kernels/trace.py:226",
        "launches": onehot_launches,
        "max_abs_err": 0.0,
        "ms": onehot_times["ms"],
        "plain_ms": onehot_times["plain_ms"],
        "bound_ms": onehot_times["bound_ms"],
        "bound_by": onehot_times["bound_by"],
        "library_ms": None,
        "select_ms": onehot_times["select_ms"],
        "build": "dynamic",
    }, bf16_entry] + [{
        "name": f"trace_grad_{kernel}_kernel",
        "route": "cuda",
        "source": f"tpt_torch/csrc/{source}",
        "replaces": "tpt/kernels/trace_grad.py:446",
        "launches": grad_launches[kernel] + dist_grad_launches[kernel],
        "max_abs_err": grad_err,
        "ms": grad_times["kernels"][kernel]["ms"],
        "plain_ms": grad_times["kernels"][kernel]["plain_ms"],
        "bound_ms": grad_times["kernels"][kernel]["bound_ms"],
        "bound_by": grad_times["kernels"][kernel]["bound_by"],
        "library_ms": None,
        "blocks_per_sm": grad_times["kernels"][kernel]["blocks_per_sm"],
        "pair_ms": grad_times["ms"],
        "build": "dynamic",
    } for kernel, source in (("tape", "trace_grad.cu"), ("adjoint", "trace_grad_adjoint.cu"))]
        + probe_kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

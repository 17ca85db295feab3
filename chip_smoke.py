"""Smoke run of the PyTorch port (tpt_torch) on one CUDA card.

Builds the CUDA kernels from tpt_torch/csrc (one nvcc per source, in
parallel), holds each against its plain PyTorch version on the card, and
drives the port's two paths through their entry points:

  * the render path: the progressive render of the demo scene at
    1920x1080, ray depth 13, 1 spp, thin-lens depth of field, the 256^2
    atmosphere, in 30-frame blocks, through ``tpt_torch.cli render``;
  * the training path: ``tpt_torch.inverse_demo`` (512x512, ray depth 8,
    two views, fixed-depth transport, clipped Adam, 200 steps), then 20
    timed steps of the 1080p training step of benchmarks/train_bench.py;
  * the one-hot gather: ``trace(..., gather="onehot")`` at the four
    one-frame shapes, bit for bit against the select kernel and against
    its plain version;
  * the backward-design probes through ``tpt_torch.bwd_probes``, then each
    probe's kernel against its plain version and one PyTorch call for the
    same function, at the harness's GRID = 100 and at a 1080p-sized 1013.

Every phase prints one line; any failure raises and the script exits
non-zero without printing a result.

    python3 chip_smoke.py

The second-to-last line is a JSON object with each kernel's launch count
on the paths, its error against the plain version, its time against the
plain version's and one PyTorch call's, and its bound (the least time an
H100 SXM could take for the same work); the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

WIDTH, HEIGHT, DEPTH, BLOCK = 1920, 1080, 13, 30
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


def trace_bound(segments: int, samples: int, pixels: int, slots: int, counts, table=False):
    """Bound of a forward launch: every traced segment's fold over the live
    primitives and bounce, every sample's camera ray; the scene read once,
    per pixel the radiance, 2 x slots miss vectors, the ray count and the
    seed written once."""
    ns, nc = counts
    ops = segments * (OPS_SPHERE * ns + OPS_CUBOID * nc + OPS_BOUNCE) + samples * OPS_CAMERA
    nbytes = scene_bytes(counts, table) + pixels * (12 + 2 * slots * 12 + 4 + 8)
    return bound(ops, nbytes)


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


def assert_bits_equal(got, want, what):
    """All five outputs of two TraceResults equal bit for bit."""
    for name in ("radiance", "miss_dir", "miss_thr", "ray_count", "seed"):
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
        line = (f"{what}: {summary}; zeroed {int(got.n_zeroed)} (kernel) / "
                f"{int(want.n_zeroed)} (plain)")
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
    times = {"ms": cuda_ms(run, 5), "plain_ms": cuda_ms(run_plain, 1, warm_up=False)}
    # the backward's forward sweep traces the segments of the forward frame
    ip, iv, _ = camera_matrices(cam, WIDTH, HEIGHT)
    segments = int(K.trace(scene, ip, iv, 0, cam.focal_length, cam.aperture_diameter,
                           **kw).ray_count.sum())
    times["bound_ms"], times["bound_by"] = grad_bound(segments, WIDTH * HEIGHT,
                                                      WIDTH * HEIGHT, 1, counts)
    phase("grad", f"{what}: {summary}; zeroed {int(got.n_zeroed)} (kernel) / "
          f"{int(want.n_zeroed)} (plain, {HEIGHT // band} bands); kernel {times['ms']:.2f} ms, "
          f"plain {times['plain_ms']:.1f} ms, bound {times['bound_ms']:.4f} ms "
          f"({times['bound_by']}, {segments} segments) ({card})")

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
    phase("grad-split", f"{WIDTH}x{HEIGHT} kernel ms by ablate mode: "
          + ", ".join(f"{m} {v:.2f}" for m, v in split.items())
          + f"; forward sweep and camera (norev) {split['norev']:.2f}, stores "
          f"{split['none'] - split['nostores']:.2f}, reverse sweep "
          f"{split['none'] - split['norev']:.2f}, camera adjoint "
          f"{split['none'] - split['nocam']:.2f}, table accumulation "
          f"{split['none'] - split['nodtbl']:.2f} ({card})")
    return max_err, times


def train_phases(dev, card, K, G):
    """The training path through its entry point, then the 1080p training
    step's time.  Returns the path's launches of (the trace kernel, the
    backward kernel)."""
    from tpt_torch import inverse_demo
    from tpt_torch.profile_block import make_train_bench_step

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "inverse_demo.json")
        K.LAUNCHES, G.GRAD_LAUNCHES = 0, 0
        t0 = time.perf_counter()
        rc = inverse_demo.main(["--steps", str(TRAIN_STEPS), "--size", "512x512",
                                "--device", "cuda", "--out", out])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, grad_launches = K.LAUNCHES, G.GRAD_LAUNCHES
        with open(out) as f:
            res = json.load(f)
        pngs = sorted(n for n in os.listdir(tmp) if n.endswith(".png"))
    want = TRAIN_STEPS * TRAIN_VIEWS
    if rc != 0 or grad_launches != want or launches < want:
        raise AssertionError(f"inverse_demo: rc {rc}, {grad_launches} backward launches "
                             f"(want {want}), {launches} trace launches")
    if not (np.isfinite(res["loss_last"]) and np.isfinite(res["loss_final_median"])
            and res["sphere_param_mae_after"] < 0.5 * res["sphere_param_mae_before"]
            and len(pngs) == 3):
        raise AssertionError(f"inverse_demo did not converge: {res}, {pngs}")
    phase("train", f"inverse_demo 512x512 depth 8, 2 views, {TRAIN_STEPS} steps: "
          f"{launches} trace / {grad_launches} backward kernel launches, {wall:.1f} s wall, "
          f"loss {res['loss_first']:.5f} -> median {res['loss_final_median']:.5f}, sphere "
          f"MAE {res['sphere_param_mae_before']} -> {res['sphere_param_mae_after']}, "
          f"emissive MAE {res['cuboid_param_mae_before']} -> {res['cuboid_param_mae_after']}")

    step = make_train_bench_step(WIDTH, HEIGHT, dev)
    loss = step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        loss = step()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / 20 * 1e3
    if not bool(torch.isfinite(loss)):
        raise AssertionError("train step: loss is not finite")
    phase("train", f"train_bench step {WIDTH}x{HEIGHT} depth {DEPTH} spp 1 rr, SGD: "
          f"{ms:.2f} ms per step over 20 steps (host clock, synchronised), loss "
          f"{float(loss):.5f} ({card})")
    return launches, grad_launches


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


def probe_bound(name: str, n: int, rows: int, cols: int):
    """Bound of one probe call on n elements (see probes.cu): a gather reads
    idx and the table and writes n floats; a scatter reads idx and g (p5
    only its last tile) and writes its table; p2 and p4 read x (= g) and
    write n floats."""
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


def device_ms(fn, kernel: str, reps: int = 10):
    """Mean device time per call of ``fn`` in the CUDA kernels whose name
    holds ``kernel``, from torch.profiler (the wrapper's host time left
    out); None when the profiler saw no such kernel."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.device_time_total for e in prof.key_averages() if kernel in e.key)
    return us / reps / 1e3 if us else None


def probe_phases(dev, card):
    """The probes' path through ``tpt_torch.bwd_probes`` (every probe must
    launch its kernel), then each probe's kernel against its plain version
    and its library call at GRID 100 and 1013, with the kernel's own device
    time beside the call's.  Returns the kernels-line
    entries of the three probe kernels: launches from the path, the other
    numbers those of each kernel's first probe at GRID 100, and every
    probe's numbers under "probes"."""
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

    per = {name: {} for name in P.PROBES}
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
            rec = {"max_abs_err": err, "ms": cuda_ms(lambda: fn(*inputs), reps),
                   "plain_ms": cuda_ms(lambda: plain(*inputs), 5),
                   "library_ms": (cuda_ms(library[name], reps) if library[name] else None),
                   "bound_ms": b_ms, "bound_by": b_by,
                   "device_ms": device_ms(lambda: fn(*inputs), P.KERNEL_OF[name])}
            per[name][grid] = rec
            us = lambda v: "not measured" if v is None else f"{v * 1e3:.1f} us"
            phase("probes", f"{name} ({P.KERNEL_OF[name]}) GRID {grid}, {n} elements: max abs "
                  f"err {err:.3g}; kernel {us(rec['ms'])} a call ({us(rec['device_ms'])} of it "
                  f"in the kernel, by torch.profiler), plain {us(rec['plain_ms'])}, library "
                  f"{'none' if rec['library_ms'] is None else us(rec['library_ms'])}, bound "
                  f"{b_ms * 1e3:.2f} us ({b_by}) ({card})")

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
            "at": f"{names[0]}, GRID {PROBE_GRIDS[0]}",
            "probes": {n: {str(g): r for g, r in per[n].items()} for n in names}})
    return entries


# the line of each Pallas probe's definition in benchmarks/exp_bwd_probes.py
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

    # ---- 2. build ----
    t0 = time.perf_counter()
    paths, log = _build.ensure_built()
    _build.load_library()
    ptxas = [ln.strip() for ln in log.splitlines()
             if ln.startswith("==") or "registers" in ln or "spill" in ln]
    phase("build", f"{time.perf_counter() - t0:.2f} s -> "
          f"{', '.join(os.path.relpath(p, REPO) for p in paths.values())} {' | '.join(ptxas)}")

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
            line += (f"; kernel {times['per_frame_ms']:.3f} ms, plain "
                     f"{times['per_frame_plain_ms']:.1f} ms per frame ({card})")
        phase("per-frame", line)

    # ---- 4. refill kernel vs plain ----
    ip, iv, _ = camera_matrices(cam, 256, 256)
    kw = dict(width=256, height=256, ray_depth=DEPTH, spp=1, n_frames=4, n_valid=3)
    got = K.trace_progressive(scene, ip, iv, 7, focal, ap, **kw)
    err_tail = compare_refill(got, K.trace_progressive_plain(scene, ip, iv, 7, focal, ap, **kw))
    if got.miss_dir[3].any() or got.miss_thr[3].any():
        raise AssertionError("slot of the masked frame is not zero")
    # the launch the main path makes: a 30-frame 1080p block from frame 0
    ip, iv, _ = camera_matrices(cam, WIDTH, HEIGHT)
    kw = dict(width=WIDTH, height=HEIGHT, ray_depth=DEPTH, spp=1, n_frames=BLOCK)

    def run():
        return K.trace_progressive(scene, ip, iv, 0, focal, ap, **kw)

    def run_plain():
        return K.trace_progressive_plain(scene, ip, iv, 0, focal, ap, **kw)

    got = run()
    err_block = compare_refill(got, run_plain())
    max_err = max(max_err, err_tail, err_block)
    times["block_ms"] = cuda_ms(run, 3)
    times["block_plain_ms"] = cuda_ms(run_plain, 1, warm_up=False)
    pixels = WIDTH * HEIGHT
    times["bound_ms"], times["bound_by"] = trace_bound(
        int(got.ray_count.sum()), pixels * BLOCK, pixels, BLOCK, scene.counts)
    phase("refill", f"256x256 4 frames (n_valid 3): integers exact, max abs err "
          f"{err_tail:.3g}; {WIDTH}x{HEIGHT} {BLOCK}-frame block: integers exact, max abs "
          f"err {err_block:.3g} (floats within rtol 1e-3 atol 1e-4); kernel "
          f"{times['block_ms']:.2f} ms, plain {times['block_plain_ms']:.1f} ms, bound "
          f"{times['bound_ms']:.3f} ms ({times['bound_by']}, {int(got.ray_count.sum())} "
          f"segments) ({card})")

    # ---- 5. golden image through the kernel ----
    from tpt_torch.config import AtmosphereConfig
    from tpt_torch.kernels.render import progressive_frames, render_fields
    from tpt_torch.sky import compute_atmosphere
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
        K.LAUNCHES = 0
        t0 = time.perf_counter()
        rc = cli.main(["render", "--device", "cuda", "--width", str(WIDTH),
                       "--height", str(HEIGHT), "--frames", str(3 * BLOCK),
                       "--chunk", str(BLOCK), "--out", png, "--checkpoint", ckpt])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = K.LAUNCHES
        if rc != 0 or launches != 3:
            raise AssertionError(f"cli render: rc {rc}, {launches} kernel launches (want 3)")
        state = load_checkpoint(ckpt, dev)
        if not (os.path.getsize(png) > 0 and state.frame == 3 * BLOCK
                and tuple(state.image.shape) == (HEIGHT, WIDTH, 3)
                and bool(torch.isfinite(state.image).all()) and float(state.image.mean()) > 0):
            raise AssertionError("cli render: bad accumulator or PNG")
    phase("main-path", f"cli render {WIDTH}x{HEIGHT} {3 * BLOCK} frames in {BLOCK}-frame "
          f"blocks: {launches} kernel launches, {wall:.2f} s wall incl. the atmosphere, "
          f"accumulator finite, mean {float(state.image.mean()):.4f}")

    # steady state: 3 more blocks of progressive_frames after one warm-up block
    from tpt_torch.env import pack_block_table
    table = pack_block_table(compute_atmosphere(AtmosphereConfig(size=256), dev))
    frame = state.frame

    def block():
        nonlocal frame
        _, rays = progressive_frames(state, scene, table, ip, iv, frame, focal, ap,
                                     width=WIDTH, height=HEIGHT, ray_depth=DEPTH, spp=1,
                                     n_frames=BLOCK)
        frame += BLOCK
        return rays

    block()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    rays = [block() for _ in range(3)]
    end.record()
    torch.cuda.synchronize()
    ms_block = start.elapsed_time(end) / 3
    segments = int(sum(int(r) for r in rays))
    mrays = segments / (3 * ms_block * 1e-3) / 1e6
    phase("throughput", f"{ms_block:.2f} ms per {BLOCK}-frame block, {mrays:.1f} Mrays/s "
          f"(traced segments / s) on {card}")

    grad_err, grad_times = grad_phases(dev, card, K, G)
    train_launches, grad_launches = train_phases(dev, card, K, G)

    onehot_launches, onehot_times = onehot_phases(dev, card, K)
    probe_kernels = probe_phases(dev, card)

    # one kernel serves both forward TPU kernels (pallas_trace_progressive at
    # :519 and pallas_trace at :298); its times are those of a 30-frame 1080p
    # block, its launches those of the render path and the training path.
    # Its table mode (the one-hot gather) is timed per 1080p frame.  No one
    # PyTorch call computes a trace or its backward: library_ms is null.
    print(json.dumps({"kernels": [{
        "name": "trace_progressive_kernel",
        "route": "cuda",
        "source": "tpt_torch/csrc/trace.cu",
        "replaces": "tpt/kernels/trace.py:519",
        "launches": launches + train_launches,
        "max_abs_err": max_err,
        "ms": times["block_ms"],
        "plain_ms": times["block_plain_ms"],
        "bound_ms": times["bound_ms"],
        "bound_by": times["bound_by"],
        "library_ms": None,
    }, {
        "name": "trace_progressive_kernel<true> (gather=onehot)",
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
    }, {
        "name": "trace_grad_kernel",
        "route": "cuda",
        "source": "tpt_torch/csrc/trace_grad.cu",
        "replaces": "tpt/kernels/trace_grad.py:446",
        "launches": grad_launches,
        "max_abs_err": grad_err,
        "ms": grad_times["ms"],
        "plain_ms": grad_times["plain_ms"],
        "bound_ms": grad_times["bound_ms"],
        "bound_by": grad_times["bound_by"],
        "library_ms": None,
    }] + probe_kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

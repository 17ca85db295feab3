"""Smoke run of the PyTorch port (tpt_torch) on one CUDA card.

Builds the CUDA kernels from tpt_torch/csrc (one nvcc per source, in
parallel), holds each against its plain PyTorch version on the card, and
drives the port's two paths through their entry points:

  * the render path: the progressive render of the demo scene at
    1920x1080, ray depth 13, 1 spp, thin-lens depth of field, the 256^2
    atmosphere, in 30-frame blocks, through ``tpt_torch.cli render``;
  * the training path: ``tpt_torch.inverse_demo`` (512x512, ray depth 8,
    two views, fixed-depth transport, clipped Adam, 200 steps), then 20
    timed steps of the 1080p training step of benchmarks/train_bench.py.

Every phase prints one line; any failure raises and the script exits
non-zero without printing a result.

    python3 chip_smoke.py

The second-to-last line is a JSON object with each kernel's launch count
on the paths, its error against the plain version and its time against the
plain version's; the last line is {"ok": true, "device": {...}}.
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


def grad_phases(dev, card, G):
    """The backward kernel against its plain version, and its time split.
    Returns (max abs err, {"ms", "plain_ms"} at 1080p)."""
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
    phase("grad", f"{what}: {summary}; zeroed {int(got.n_zeroed)} (kernel) / "
          f"{int(want.n_zeroed)} (plain, {HEIGHT // band} bands); kernel {times['ms']:.2f} ms, "
          f"plain {times['plain_ms']:.1f} ms ({card})")

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

    err_block = compare_refill(run(), run_plain())
    max_err = max(max_err, err_tail, err_block)
    times["block_ms"] = cuda_ms(run, 3)
    times["block_plain_ms"] = cuda_ms(run_plain, 1, warm_up=False)
    phase("refill", f"256x256 4 frames (n_valid 3): integers exact, max abs err "
          f"{err_tail:.3g}; {WIDTH}x{HEIGHT} {BLOCK}-frame block: integers exact, max abs "
          f"err {err_block:.3g} (floats within rtol 1e-3 atol 1e-4); kernel "
          f"{times['block_ms']:.2f} ms, plain {times['block_plain_ms']:.1f} ms ({card})")

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

    grad_err, grad_times = grad_phases(dev, card, G)
    train_launches, grad_launches = train_phases(dev, card, K, G)

    # one kernel serves both forward TPU kernels (pallas_trace_progressive at
    # :519 and pallas_trace at :298); its times are those of a 30-frame 1080p
    # block, its launches those of the render path and the training path
    print(json.dumps({"kernels": [{
        "name": "trace_progressive_kernel",
        "route": "cuda",
        "source": "tpt_torch/csrc/trace.cu",
        "replaces": "tpt/kernels/trace.py:519",
        "launches": launches + train_launches,
        "max_abs_err": max_err,
        "ms": times["block_ms"],
        "plain_ms": times["block_plain_ms"],
    }, {
        "name": "trace_grad_kernel",
        "route": "cuda",
        "source": "tpt_torch/csrc/trace_grad.cu",
        "replaces": "tpt/kernels/trace_grad.py:446",
        "launches": grad_launches,
        "max_abs_err": grad_err,
        "ms": grad_times["ms"],
        "plain_ms": grad_times["plain_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

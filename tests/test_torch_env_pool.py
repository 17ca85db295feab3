"""The environment mode's warp-pooled queue on the card (``cuda`` marker).

The environment-mode trace kernel (csrc/trace.cu, trace_pooled) lets a
warp's lanes take each other's (pixel, frame) items and folds every pixel's
samples in sample order in shared memory, so its rad_sum, ray counts and
seeds must be the plain route's bits (kernels.trace.trace_progressive_plain)
in every build and table, whatever the frames, samples and band.  Its warp
iterations, the denominator of ``lane_efficiency.offline``, must cover each
warp's segments and equal the per-lane schedule's longest path at one item a
pixel.  Every test skips without a device; on a GPU host:
``python -m pytest tests/test_torch_env_pool.py -q --noconftest``.
"""

import pytest
import torch

from tpt_torch import CameraConfig, demo_scene
from tpt_torch.camera import camera_matrices
from tpt_torch.env import pack_block_table
from tpt_torch.kernels import trace as K

pytestmark = pytest.mark.cuda

COUNTS = (48, 7)
BUILDS = {"dynamic": None, "(48, 7)": COUNTS}
# (width, height) and the launch; widths that are not multiples of 32 make
# warps span two rows and leave the grid's last warp partly masked
CASES = {
    "37x29, 2 frames": ((37, 29), dict(n_frames=2)),
    "64x64, 8 frames": ((64, 64), dict(n_frames=8)),
    "40x24, 30 frames": ((40, 24), dict(n_frames=30)),
    "48x48, 5 of 8 frames": ((48, 48), dict(n_frames=8, n_valid=5)),
    "50x20, 6 frames, spp 2, no rr, center": ((50, 20), dict(n_frames=6, spp=2, rr=False,
                                                             jitter="center")),
    "16x16, 0 of 4 frames": ((16, 16), dict(n_frames=4, n_valid=0)),
    "128^2, rows 70-93, 8 frames": ((128, 128), dict(n_frames=8, n_rows=24, row0=70)),
    "1920x1080, rows 517-519, 8 frames": ((1920, 1080), dict(n_frames=8, n_rows=3, row0=517)),
}


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def tables():
    """The 32^2 atmosphere's table, f32 and bf16."""
    from tpt_torch.config import AtmosphereConfig
    from tpt_torch.sky import compute_atmosphere
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    faces = compute_atmosphere(AtmosphereConfig(size=32), torch.device("cuda"))
    return {"f32": pack_block_table(faces),
            "bf16": pack_block_table(faces, dtype=torch.bfloat16)}


def camera(width, height):
    cam = CameraConfig()
    inv_p, inv_v, _ = camera_matrices(cam, width, height)
    return inv_p, inv_v, cam.focal_length, cam.aperture_diameter


def launch(scene, size, table, build, frame0=7, **kw):
    """(the kernel's result through ``build``, its warp iterations, the
    launch's keywords for the plain route)."""
    from tpt_torch.kernels import _build
    width, height = size
    inv_p, inv_v, focal, ap = camera(width, height)
    kw = dict(dict(spp=1, n_valid=kw["n_frames"], n_rows=height, row0=0, jitter="corner",
                   rr=True), **kw)
    kw.update(width=width, height=height, ray_depth=13, counts=COUNTS, env_table=table)
    iters = torch.full((K.n_warps(kw["n_rows"] * width),), -1, dtype=torch.int32,
                       device=scene.device)
    res = K._launch(scene, inv_p, inv_v, frame0, focal, ap,
                    lib=_build.library("trace.cu", build), warp_iters=iters, **kw)
    torch.cuda.synchronize()
    return res, iters, (inv_p, inv_v, frame0, focal, ap), kw


def as_bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("table", ["f32", "bf16"])
@pytest.mark.parametrize("build", list(BUILDS))
def test_pooled_env_kernel_equals_the_plain_route(device, tables, build, table, case):
    scene = demo_scene().build(device)
    size, kw = CASES[case]
    got, iters, args, kw = launch(scene, size, tables[table], BUILDS[build], **kw)
    assert got.miss_dir is None and got.miss_thr is None
    want = K.trace_progressive_plain(scene, *args, **kw)
    for name in ("rad_sum", "ray_count", "seed"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.shape == w.shape and torch.equal(as_bits(g), as_bits(w)), name
    assert bool((iters >= 0).all())


def per_warp(ray_count):
    n = ray_count.reshape(-1).to(torch.int64)
    return torch.cat([n, n.new_zeros(-n.numel() % 32)]).view(-1, 32)


@pytest.mark.parametrize("build", list(BUILDS))
def test_warp_iterations_cover_the_segments_and_match_one_item_a_lane(device, tables, build):
    """Every warp's iterations are at least its segments over 32, and at
    one frame of one sample, where the pool is the per-lane schedule, they
    equal the warp's longest path (kernels.trace.warp_segments)."""
    scene = demo_scene().build(device)
    for size, kw in ((37, 29), dict(n_frames=8)), ((50, 20), dict(n_frames=6, spp=2)), \
            ((40, 24), dict(n_frames=30)):
        got, iters, _, _ = launch(scene, size, tables["f32"], BUILDS[build], **kw)
        least = -(-per_warp(got.ray_count).sum(dim=1) // 32)
        assert bool((iters.to(torch.int64) >= least).all()), size
    for size in ((37, 29), (64, 64)):
        got, iters, _, _ = launch(scene, size, tables["f32"], BUILDS[build], n_frames=1)
        assert torch.equal(iters.to(torch.int64), per_warp(got.ray_count).amax(dim=1))
        assert int(iters.sum()) == int(K.warp_segments(got.ray_count)[1])


def test_the_counters_read_the_pools_iterations(device, tables, monkeypatch):
    """Under the profiler (switched on here by its check alone, so no
    profiler session runs), an environment-mode launch counts the kernel's
    warp iterations as ``trace.env.warp_max_segments``, and a select launch
    keeps warp_segments."""
    from tpt_torch.utils import profiling
    scene = demo_scene().build(device)
    inv_p, inv_v, focal, ap = camera(48, 40)
    kw = dict(width=48, height=40, ray_depth=13, spp=1, counts=COUNTS)
    monkeypatch.setattr(profiling, "_enabled", lambda: True)
    profiling.reset()
    res = K.trace_progressive(scene, inv_p, inv_v, 3, focal, ap, n_frames=8,
                              env_table=tables["f32"], **kw)
    _, iters, _, _ = launch(scene, (48, 40), tables["f32"], COUNTS, frame0=3, n_frames=8)
    one = K.trace(scene, inv_p, inv_v, 3, focal, ap, **kw)
    c = profiling.counters()
    profiling.reset()
    assert c["trace.env.segments"] == int(res.ray_count.sum())
    assert c["trace.env.warp_max_segments"] == int(iters.sum())
    assert c["trace.select.warp_max_segments"] == int(K.warp_segments(one.ray_count)[1])


def test_a_1080p_block_keeps_its_lanes_busy(device):
    """The offline cell's launch, one 8-frame 1080p block of the demo scene
    under the 256^2 atmosphere through the (48, 7) build: lane efficiency,
    the segments over 32 x the warps' iterations, above 0.85 (the per-lane
    loop gave 0.766 there)."""
    from tpt_torch.config import AtmosphereConfig
    from tpt_torch.sky import compute_atmosphere
    scene = demo_scene().build(device)
    table = pack_block_table(compute_atmosphere(AtmosphereConfig(size=256), device))
    got, iters, _, _ = launch(scene, (1920, 1080), table, COUNTS, frame0=0, n_frames=8)
    eff = int(got.ray_count.sum()) / (32.0 * int(iters.sum()))
    assert 0.85 < eff <= 1.0, eff


def test_warp_iters_must_fit_the_launch(device, tables):
    """The wrapper refuses a warp-iteration buffer the kernel would write
    past, and one given to a launch that has no environment mode."""
    scene = demo_scene().build(device)
    inv_p, inv_v, focal, ap = camera(40, 24)
    kw = dict(width=40, height=24, ray_depth=13, spp=1, n_frames=2, n_valid=2, counts=COUNTS,
              n_rows=24, row0=0, jitter="corner", rr=True)
    good = torch.empty(K.n_warps(40 * 24), dtype=torch.int32, device=device)
    for bad, env in ((good[:-1], tables["f32"]), (good.long(), tables["f32"]),
                     (good.cpu(), tables["f32"]), (good, None)):
        with pytest.raises(ValueError, match="warp_iters"):
            K._launch(scene, inv_p, inv_v, 0, focal, ap, env_table=env, warp_iters=bad, **kw)

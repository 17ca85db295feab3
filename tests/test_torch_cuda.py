"""The CUDA trace kernel against its plain PyTorch version, on the card.

Needs a CUDA device and nvcc (the kernel is built from tpt_torch/csrc at
first use); every test is skipped without a device.  Run on a GPU host:
``python -m pytest tests/test_torch_cuda.py -q``.

Both sides run the same operations in the same order in f32 with no FMA
contraction (the parity policy of tpt_torch/csrc/trace.cu), so integer
outputs must match exactly (the per-frame kernel may differ on 0.01% of
pixels) and floats at 1e-5 (per frame) or rtol 1e-3 / atol 1e-4 (refill,
the tests/test_refill.py bar); the environment mode, the slot modes and the
table mode are also held bit for bit."""

import pytest
import torch

from tpt_torch import CameraConfig, demo_scene
from tpt_torch.camera import camera_matrices
from tpt_torch.env import constant_environment, pack_block_table
from tpt_torch.kernels import trace as K
from tpt_torch.kernels.render import progressive_frames
from tpt_torch.progressive import init_accumulator

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


def setup(device, size):
    cam = CameraConfig()
    inv_p, inv_v, _ = camera_matrices(cam, size, size)
    return demo_scene().build(device), inv_p, inv_v, cam.focal_length, cam.aperture_diameter


@pytest.mark.parametrize("spp,rr,jitter", [(1, True, "corner"), (2, False, "center")])
def test_trace_kernel_matches_plain(device, spp, rr, jitter):
    args = setup(device, 128)
    kw = dict(width=128, height=128, ray_depth=13, spp=spp, rr=rr, jitter=jitter)
    launches = K.LAUNCHES
    got = K.trace(*args[:3], 5, *args[3:], **kw)
    torch.cuda.synchronize()
    assert K.LAUNCHES == launches + 1
    want = K.trace_plain(*args[:3], 5, *args[3:], **kw)
    flipped = (got.seed != want.seed) | (got.ray_count != want.ray_count)
    assert flipped.float().mean().item() <= 1e-4
    ok = ~flipped
    for name in ("radiance", "miss_dir", "miss_thr"):
        g, w = getattr(got, name), getattr(want, name)
        torch.testing.assert_close(g[..., ok], w[..., ok], rtol=1e-5, atol=1e-5)


def test_refill_kernel_matches_plain(device):
    args = setup(device, 64)
    kw = dict(width=64, height=64, ray_depth=13, spp=1, n_frames=4, n_valid=3)
    got = K.trace_progressive(*args[:3], 7, *args[3:], **kw)
    want = K.trace_progressive_plain(*args[:3], 7, *args[3:], **kw)
    torch.testing.assert_close(got.seed, want.seed, rtol=0, atol=0)
    torch.testing.assert_close(got.ray_count, want.ray_count, rtol=0, atol=0)
    for name in ("rad_sum", "miss_dir", "miss_thr"):
        torch.testing.assert_close(getattr(got, name), getattr(want, name),
                                   rtol=1e-3, atol=1e-4)
    assert not got.miss_dir[3:].any() and not got.miss_thr[3:].any()


def atmosphere_table(device, size=256):
    from tpt_torch.config import AtmosphereConfig
    from tpt_torch.sky import compute_atmosphere
    return pack_block_table(compute_atmosphere(AtmosphereConfig(size=size), device))


def assert_bits(got, want, names):
    for name in names:
        g, w = getattr(got, name), getattr(want, name)
        if g.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        assert g.shape == w.shape and torch.equal(g, w), name


ENV_CASES = {
    "64^2 tail": (64, dict(spp=1, n_frames=4, n_valid=3)),
    "128^2 spp 2, no rr, center": (128, dict(spp=2, n_frames=3, rr=False, jitter="center")),
    "128^2 band": (128, dict(spp=1, n_frames=3, n_rows=40, row0=70)),
}


@pytest.mark.parametrize("case", list(ENV_CASES))
def test_env_kernel_matches_plain_bit_for_bit(device, case):
    """The environment mode (the block path's launch) against its plain
    version: rad_sum, ray counts and seeds bit for bit, since both add
    radiance + throughput x environment per sample in the same order."""
    size, kw = ENV_CASES[case]
    args = setup(device, size)
    table = atmosphere_table(device)
    kw = dict(kw, width=size, height=size, ray_depth=13)
    launches = (K.LAUNCHES, K.ENV_LAUNCHES)
    got = K.trace_progressive(*args[:3], 7, *args[3:], env_table=table, **kw)
    torch.cuda.synchronize()
    assert (K.LAUNCHES, K.ENV_LAUNCHES) == (launches[0] + 1, launches[1] + 1)
    assert got.miss_dir is None and got.miss_thr is None
    want = K.trace_progressive_plain(*args[:3], 7, *args[3:], env_table=table, **kw)
    assert_bits(got, want, ("rad_sum", "ray_count", "seed"))


def test_slot_modes_stay_bit_equal(device):
    """The refill loop in the slot mode, per frame and per block, against
    the plain versions bit for bit in every output."""
    args = setup(device, 128)
    kw = dict(width=128, height=128, ray_depth=13)
    for spp, rr, jitter in ((1, True, "corner"), (2, False, "center")):
        one = dict(kw, spp=spp, rr=rr, jitter=jitter)
        assert_bits(K.trace(*args[:3], 5, *args[3:], **one),
                    K.trace_plain(*args[:3], 5, *args[3:], **one),
                    ("radiance", "miss_dir", "miss_thr", "ray_count", "seed"))
    block = dict(kw, spp=1, n_frames=4, n_valid=3)
    assert_bits(K.trace_progressive(*args[:3], 7, *args[3:], **block),
                K.trace_progressive_plain(*args[:3], 7, *args[3:], **block),
                ("rad_sum", "miss_dir", "miss_thr", "ray_count", "seed"))


def test_progressive_frames_launches_refill_kernel(device):
    """A block is one launch, in the environment mode, and allocates no
    miss slots."""
    scene, inv_p, inv_v, focal, ap = setup(device, 128)
    table = pack_block_table(constant_environment((0.7, 0.8, 1.0), device=device))
    acc = init_accumulator(128, 128, device)
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    launches = (K.LAUNCHES, K.ENV_LAUNCHES)
    acc, rays = progressive_frames(acc, scene, table, inv_p, inv_v, 0, focal, ap, width=128,
                                   height=128, ray_depth=13, spp=1, n_frames=8, n_valid=7)
    torch.cuda.synchronize()
    assert (K.LAUNCHES, K.ENV_LAUNCHES) == (launches[0] + 1, launches[1] + 1)
    assert torch.cuda.max_memory_allocated(device) - resident < 2 * 8 * 3 * 128 * 128 * 4
    assert acc.frame == 7 and int(rays) > 7 * 128 * 128
    assert torch.isfinite(acc.image).all() and acc.image.mean().item() > 0


def test_wrapper_rejects_bad_inputs(device):
    scene, inv_p, inv_v, focal, ap = setup(device, 16)
    bad = scene.to(device)
    bad.sphere_material = bad.sphere_material.double()
    with pytest.raises(ValueError, match="sphere_material"):
        K.trace(bad, inv_p, inv_v, 0, focal, ap, width=16, height=16, ray_depth=3, spp=1)
    table = pack_block_table(constant_environment((0.7, 0.8, 1.0), device=device))
    shifted = torch.empty(table.numel() + 4, device=device)[1:1 + table.numel()].view(table.shape)
    for t, match in ((shifted, "16-byte"), (table.cpu(), "is on cpu")):
        with pytest.raises(ValueError, match=match):
            K.trace_progressive(scene, inv_p, inv_v, 0, focal, ap, width=16, height=16,
                                ray_depth=3, spp=1, n_frames=2, env_table=t)


def test_trace_layout_gives_blocks_per_sm(device):
    import ctypes
    from tpt_torch.kernels import _build
    blocks = (ctypes.c_int * 4)()   # select, table, environment, bf16 environment
    assert _build.library("trace.cu").tpt_trace_layout(blocks) == 0
    assert all(1 <= b <= 16 for b in blocks), list(blocks)


def test_specialised_build_equals_the_dynamic_build(device):
    """trace.cu built for the demo scene's counts (48, 7) against the
    dynamic build, each library handed to the private launcher: every
    forward mode (select, table, slots, f32 and bf16 environment) bit for
    bit.  Through the wrappers, only the environment mode's block with
    counts takes the build for them."""
    from tpt_torch.kernels import _build
    scene, inv_p, inv_v, focal, ap = setup(device, 48)
    counts = scene.counts
    faces = constant_environment((0.7, 0.8, 1.0), device=device)
    tables = (pack_block_table(faces), pack_block_table(faces, dtype=torch.bfloat16))
    kw = dict(width=48, height=48, ray_depth=13, spp=2, counts=counts)
    band = dict(n_rows=48, row0=0, jitter="corner", rr=True)

    def run(lib):
        args = (scene, inv_p, inv_v, 5, focal, ap)
        out = [K._launch(*args, n_frames=1, n_valid=1, lib=lib, **band, **kw),
               K._launch(*args, n_frames=1, n_valid=1, gather="onehot", lib=lib, **band, **kw),
               K._launch(*args, n_frames=3, n_valid=2, lib=lib, **band, **kw)]
        out += [K._launch(*args, n_frames=3, n_valid=3, env_table=t, lib=lib, **band, **kw)
                for t in tables]
        torch.cuda.synchronize()
        return out

    spec = run(_build.library("trace.cu", counts))
    dyn = run(_build.library("trace.cu"))
    for got, want in zip(spec, dyn):
        for name, g in got._asdict().items():
            w = getattr(want, name)
            assert (g is None) == (w is None), name
            if g is not None:
                assert torch.equal(g.view(torch.int32) if g.dtype == torch.float32 else g,
                                   w.view(torch.int32) if w.dtype == torch.float32 else w), name
    K.BUILD_LAUNCHES.clear()
    args = (scene, inv_p, inv_v, 5, focal, ap)
    K.trace(*args, **kw)
    K.trace_progressive(*args, n_frames=3, **kw)
    K.trace_progressive(*args, n_frames=3, env_table=tables[0], **kw)
    K.trace_progressive(*args, n_frames=3, env_table=tables[0], **{**kw, "counts": None})
    K.trace_progressive(*args, n_frames=1, env_table=tables[0], **kw)
    assert dict(K.BUILD_LAUNCHES) == {None: 4, counts: 1}


def test_specialised_library_refuses_other_counts(device):
    """trace.cu built for (4, 0) returns cudaErrorInvalidValue, and
    launches nothing, for the demo scene's (48, 7); the checks come before
    any pointer is read, so null pointers do here."""
    from tpt_torch.kernels import _build
    lib = _build.library("trace.cu", (4, 0))
    assert lib.key == (4, 0) and not hasattr(lib, "tpt_trace_grad_tape")
    band = (48, 48, 48, 0, 0, 1, 1, 1, 13, 0, 1)   # width .. russian_roulette
    table = pack_block_table(constant_environment((0.7, 0.8, 1.0), device=device))
    assert lib.tpt_trace_progressive(*[None] * 5, 48, 7, None, *band, *[None] * 5, None) == 1
    assert lib.tpt_trace_progressive_env(*[None] * 5, 48, 7, None, *band, table.data_ptr(), 1,
                                         *[None] * 4, None) == 1
    assert lib.tpt_trace_onehot(*[None] * 4, 48, 7, None, *band[:4], 0, 1, 13, 0, 1,
                                *[None] * 5, None) == 1
    torch.cuda.synchronize()


def grad_setup(device, size, spp, seed=5):
    from tpt_torch.integrator import build_attr_table
    from tpt_torch.kernels.trace_grad import camera_vector
    scene, inv_p, inv_v, focal, ap = setup(device, size)
    rng = torch.Generator().manual_seed(seed)
    g = [torch.randn(shape, generator=rng).to(device)
         for shape in ((3, size, size), (spp, 3, size, size), (spp, 3, size, size))]
    counts = scene.counts
    return (scene, build_attr_table(scene, counts), camera_vector(inv_p, inv_v, focal, ap,
                                                                    device=device), *g), counts


def assert_grads_close(got, want, counts):
    """rtol 1e-3 and atol 1e-3 x the group's largest magnitude, per group:
    each table lane over the sphere rows and over the cuboid rows, the
    padded rows, and each camera leaf (inverse projection, inverse view,
    focal length, aperture).  The scale is floored at 1e-3 of the table's
    or the camera's largest, for groups whose exact value is 0 and whose
    entries are rounding noise of cancelling terms (the lobe-chance lanes
    under Russian roulette, the focal length under a pinhole; chip_smoke.py
    says why)."""
    ns, nc = counts
    groups = {"padding": (got.d_table[ns + nc:], want.d_table[ns + nc:])}
    for kind, rows in (("sphere", slice(0, ns)), ("cuboid", slice(ns, ns + nc))):
        for col in range(got.d_table.shape[1]):
            groups[f"{kind} lane {col}"] = (got.d_table[rows, col], want.d_table[rows, col])
    cam = {"inv_proj": slice(0, 6), "inv_view": slice(6, 18), "focal": slice(18, 19),
           "aperture": slice(19, 20)}
    for name, idx in cam.items():
        groups[name] = (got.d_cam[idx], want.d_cam[idx])
    floors = {"table": 1e-3 * float(want.d_table.abs().max()),
              "camera": 1e-3 * float(want.d_cam.abs().max())}
    for name, (g, w) in groups.items():
        if w.numel() == 0:   # no padded rows when all 128 are live
            continue
        scale = max(float(w.abs().max()), floors["camera" if name in cam else "table"], 1e-6)
        torch.testing.assert_close(g, w, rtol=1e-3, atol=1e-3 * scale, msg=name)


@pytest.mark.parametrize("spp,rr,jitter", [(1, True, "corner"), (2, False, "center")])
def test_grad_kernel_matches_plain(device, spp, rr, jitter):
    from tpt_torch.kernels import trace_grad as G
    args, counts = grad_setup(device, 64, spp)
    kw = dict(width=64, height=64, ray_depth=13, spp=spp, counts=counts, rr=rr, jitter=jitter)
    launches = G.GRAD_LAUNCHES
    got = G.trace_grad(args[0], args[1], args[2], 3, *args[3:], **kw)
    torch.cuda.synchronize()
    assert G.GRAD_LAUNCHES == launches + 1
    want = G.trace_grad_plain(args[0], args[1], args[2], 3, *args[3:], **kw)
    assert_grads_close(got, want, counts)
    half = G.trace_grad(args[0], args[1], args[2], 3, *args[3:], half_stores=True, **kw)
    assert_grads_close(half, got, counts)


def test_grad_kernel_ablate_modes_run(device):
    from tpt_torch.kernels import trace_grad as G
    args, counts = grad_setup(device, 32, 1)
    for mode in G.ABLATE_MODES:
        out = G.trace_grad(args[0], args[1], args[2], 0, *args[3:], width=32, height=32,
                           ray_depth=13, spp=1, counts=counts, ablate=mode)
        torch.cuda.synchronize()
        assert out.d_table.shape == (128, 24) and out.d_cam.shape == (20,)


def test_grad_wrapper_rejects_bad_inputs(device):
    from tpt_torch.kernels import trace_grad as G
    args, counts = grad_setup(device, 16, 1)
    kw = dict(width=16, height=16, ray_depth=3, spp=1)
    with pytest.raises(ValueError, match="counts"):
        G.trace_grad(args[0], args[1], args[2], 0, *args[3:], counts=(100, 29), **kw)
    with pytest.raises(ValueError, match="table"):
        G.trace_grad(args[0], args[1].double(), args[2], 0, *args[3:], counts=counts, **kw)
    with pytest.raises(ValueError, match="g_rad"):
        G.trace_grad(args[0], args[1], args[2], 0, args[3].cpu(), *args[4:], counts=counts, **kw)


def grad_inputs(device, scene, cam, w, h, spp, n_rows=None, seed=5, inv_proj=None):
    """(scene, table, cam20, g_rad, g_missd, g_misst) for an n_rows x w band
    of a w x h frame, the cotangents from a seeded generator."""
    from tpt_torch.integrator import build_attr_table
    from tpt_torch.kernels.trace_grad import camera_vector
    inv_p, inv_v, _ = camera_matrices(cam, w, h)
    inv_p = inv_p if inv_proj is None else inv_proj
    n_rows = h if n_rows is None else n_rows
    rng = torch.Generator().manual_seed(seed)
    g = [torch.randn(shape, generator=rng).to(device)
         for shape in ((3, n_rows, w), (spp, 3, n_rows, w), (spp, 3, n_rows, w))]
    return (scene, build_attr_table(scene, scene.counts),
            camera_vector(inv_p, inv_v, cam.focal_length, cam.aperture_diameter, device=device),
            *g)


def full_table_scene(device):
    """The demo scene with 52 more spheres and 21 more cuboids inside its
    room: 100 spheres and 28 cuboids, all 128 rows of the attribute table
    live."""
    import numpy as np
    from tpt_torch.materials import Material
    b = demo_scene()
    rng = np.random.default_rng(3)

    def material(k):
        return Material.make(albedo=rng.uniform(0.2, 0.9, 3), emissive=(0.0, 0.0, 0.0),
                             absorbance=rng.uniform(0.0, 0.5, 3),
                             specular_chance=rng.uniform(0.0, 0.6),
                             specular_roughness=rng.uniform(0.0, 1.0), ior=1.5,
                             refraction_chance=rng.uniform(0.0, 0.4) if k % 3 == 0 else 0.0,
                             refraction_roughness=rng.uniform(0.0, 0.5))

    for k in range(52):
        b.add_sphere(rng.uniform((-11.0, -10.0, -8.0), (11.0, 8.0, 4.0)),
                     rng.uniform(0.4, 1.2), material(k))
    for k in range(21):
        b.add_cuboid(rng.uniform((-11.0, -10.0, -8.0), (11.0, 8.0, 4.0)),
                     rng.uniform(0.5, 2.0, 3), material(k))
    scene = b.build(device)
    assert scene.counts == (100, 28)
    return scene


# (scene, width, height, ray depth, spp, rr, jitter, n_rows, row0, half_stores)
GRAD_PAIR_CASES = {
    "depth50": ("demo", 32, 32, 50, 1, False, "corner", None, 0, False),
    "rows128": ("full", 48, 48, 13, 1, True, "corner", None, 0, False),
    "spp3": ("demo", 32, 32, 13, 3, True, "center", None, 0, False),
    "band": ("demo", 64, 64, 13, 2, True, "corner", 16, 24, False),
    "half_stores": ("demo", 48, 48, 13, 2, True, "corner", None, 0, True),
}


@pytest.mark.parametrize("case", list(GRAD_PAIR_CASES))
def test_grad_pair_matches_plain(device, case):
    """The tape and adjoint kernels against trace_grad_plain: the tape at
    its deepest (ray depth 50, rr off, in a closed room), all 128 table rows
    live, 3 spp, a band with row0 > 0, and half_stores (also against the
    full tape)."""
    from tpt_torch.kernels import trace_grad as G
    name, w, h, depth, spp, rr, jitter, n_rows, row0, half = GRAD_PAIR_CASES[case]
    scene = full_table_scene(device) if name == "full" else demo_scene().build(device)
    args = grad_inputs(device, scene, CameraConfig(), w, h, spp, n_rows)
    kw = dict(width=w, height=h, ray_depth=depth, spp=spp, counts=scene.counts, rr=rr,
              jitter=jitter, n_rows=n_rows, row0=row0)
    launches = (G.GRAD_LAUNCHES, G.TAPE_LAUNCHES, G.ADJOINT_LAUNCHES)
    got = G.trace_grad(*args[:3], 3, *args[3:], half_stores=half, **kw)
    torch.cuda.synchronize()
    assert (G.GRAD_LAUNCHES, G.TAPE_LAUNCHES, G.ADJOINT_LAUNCHES) == tuple(
        n + 1 for n in launches)
    want = G.trace_grad_plain(*args[:3], 3, *args[3:], **kw)
    assert_grads_close(got, want, scene.counts)
    assert int(got.n_zeroed) == int(want.n_zeroed)
    if half:
        assert_grads_close(got, G.trace_grad(*args[:3], 3, *args[3:], **kw), scene.counts)


@pytest.mark.parametrize("spp,rr,jitter", [(1, True, "corner"), (3, False, "center")])
def test_tape_takes_the_forward_decisions(device, spp, rr, jitter):
    """The tape kernel's live-bounce counts, summed over the samples, are the
    forward kernel's ray counts pixel for pixel: its decisions are the
    forward kernel's."""
    from tpt_torch.kernels import trace_grad as G
    scene, inv_p, inv_v, focal, ap = setup(device, 64)
    kw = dict(width=64, height=64, ray_depth=13, spp=spp, rr=rr, jitter=jitter,
              counts=scene.counts)
    args = grad_inputs(device, scene, CameraConfig(), 64, 64, spp)
    n = G._tape_counts(*args[:3], 5, **kw)
    rays = K.trace(scene, inv_p, inv_v, 5, focal, ap, **kw).ray_count
    assert n.shape == (spp, 64, 64) and torch.equal(n.sum(0), rays.reshape(64, 64))


def test_grad_pair_in_row_chunks(device, monkeypatch):
    """A TAPE_BYTES_MAX of five rows' tape runs one call as seven chunks of
    both kernels, which add into one result: within the bars of the
    one-chunk result and of the plain version."""
    from tpt_torch.kernels import trace_grad as G
    scene = demo_scene().build(device)
    args = grad_inputs(device, scene, CameraConfig(), 32, 32, 2)
    kw = dict(width=32, height=32, ray_depth=13, spp=2, counts=scene.counts)
    whole = G.trace_grad(*args[:3], 3, *args[3:], **kw)
    monkeypatch.setattr(G, "TAPE_BYTES_MAX", G.tape_bytes(32, 5, 2, 13))
    assert len(G.row_chunks(32, 32, 2, 13)) == 7
    launches = (G.TAPE_LAUNCHES, G.ADJOINT_LAUNCHES)
    got = G.trace_grad(*args[:3], 3, *args[3:], **kw)
    torch.cuda.synchronize()
    assert (G.TAPE_LAUNCHES, G.ADJOINT_LAUNCHES) == (launches[0] + 7, launches[1] + 7)
    assert_grads_close(got, whole, scene.counts)
    assert_grads_close(got, G.trace_grad_plain(*args[:3], 3, *args[3:], **kw), scene.counts)


def test_grad_pair_back_to_back(device):
    """50 calls in a row on one stream, each within the bars: the last block
    of every call leaves the workspace's queue and counter at 0."""
    from tpt_torch.kernels import trace_grad as G
    scene = demo_scene().build(device)
    args = grad_inputs(device, scene, CameraConfig(), 32, 32, 1)
    kw = dict(width=32, height=32, ray_depth=13, spp=1, counts=scene.counts)
    outs = [G.trace_grad(*args[:3], 3, *args[3:], **kw) for _ in range(50)]
    torch.cuda.synchronize()
    want = G.trace_grad_plain(*args[:3], 3, *args[3:], **kw)
    for got in outs:
        assert_grads_close(got, want, scene.counts)


def test_grad_pair_on_two_streams(device):
    """Calls on the default stream and on a side stream, interleaved, each
    with its own workspace; every call within the bars."""
    from tpt_torch.kernels import trace_grad as G
    scene = demo_scene().build(device)
    args = grad_inputs(device, scene, CameraConfig(), 48, 48, 1)
    kw = dict(width=48, height=48, ray_depth=13, spp=1, counts=scene.counts)
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    outs = []
    for _ in range(4):
        outs.append(G.trace_grad(*args[:3], 3, *args[3:], **kw))
        with torch.cuda.stream(side):
            outs.append(G.trace_grad(*args[:3], 3, *args[3:], **kw))
    torch.cuda.synchronize()
    assert len(G._WORKSPACES) >= 2
    want = G.trace_grad_plain(*args[:3], 3, *args[3:], **kw)
    for got in outs:
        assert_grads_close(got, want, scene.counts)


def test_grad_pair_zeroes_what_plain_zeroes(device):
    """A pinhole looking along +x (its right column is +z) and an inverse
    projection whose first row is zero make every primary ray's z direction
    exactly 0: a cuboid winner's slab test divides by it, and the adjoint
    gives NaN where the plain version does.  The finite filter zeroes the
    same number of entries in both, and the rest agree within the bars."""
    from tpt_torch.kernels import trace_grad as G
    scene = demo_scene().build(device)
    cam = CameraConfig(position=(-10.0, 0.0, 0.0), look_x=0.0, look_y=0.0,
                       aperture_diameter=0.0)
    inv_p, _, _ = camera_matrices(cam, 24, 24)
    inv_p = torch.as_tensor(inv_p).clone()
    inv_p[0] = 0.0
    args = grad_inputs(device, scene, cam, 24, 24, 1, inv_proj=inv_p)
    kw = dict(width=24, height=24, ray_depth=4, spp=1, counts=scene.counts, rr=False)
    got = G.trace_grad(*args[:3], 0, *args[3:], **kw)
    want = G.trace_grad_plain(*args[:3], 0, *args[3:], **kw)
    assert int(want.n_zeroed) > 0 and int(got.n_zeroed) == int(want.n_zeroed)
    assert_grads_close(got, want, scene.counts)


def test_trace_diff_backward_launches_grad_kernel(device):
    from tpt_torch.kernels import trace_grad as G
    from tpt_torch.integrator import apply_environment_blocked
    scene, inv_p, inv_v, focal, ap = setup(device, 32)
    scene.sphere_material.requires_grad_(True)
    table = pack_block_table(constant_environment((0.7, 0.8, 1.0), device=device))
    launches = (K.LAUNCHES, G.GRAD_LAUNCHES)
    res = G.trace_diff(scene, inv_p, inv_v, 0, focal, ap, width=32, height=32, ray_depth=8,
                       spp=1, counts=scene.counts, rr=False)
    apply_environment_blocked(res, table, 1).square().mean().backward()
    assert (K.LAUNCHES, G.GRAD_LAUNCHES) == (launches[0] + 1, launches[1] + 1)
    assert torch.isfinite(scene.sphere_material.grad).all()
    assert scene.sphere_material.grad[:48, :3].abs().sum() > 0


def test_render_diff_runs_both_kernels(device):
    """tpt_torch.diff.render_diff on the card: the trace kernel forward, the
    backward kernel in reverse mode, the environment's cotangent through
    autograd."""
    from tpt_torch.diff import DiffInputs, render_diff
    from tpt_torch.kernels import trace_grad as G
    scene, inv_p, inv_v, focal, ap = setup(device, 32)
    env = torch.full((6, 8, 8, 3), 0.5, device=device)
    leaves = [t.clone().requires_grad_(True)
              for t in DiffInputs.from_scene(scene, env, focal, ap)]
    launches = (K.LAUNCHES, G.GRAD_LAUNCHES)
    img = render_diff(DiffInputs(*leaves), inv_p, inv_v, 0, 32, 32, 8, 1, scene.counts)
    assert tuple(img.shape) == (32, 32, 3)
    img.square().mean().backward()
    assert (K.LAUNCHES, G.GRAD_LAUNCHES) == (launches[0] + 1, launches[1] + 1)
    assert all(bool(torch.isfinite(l.grad).all()) for l in leaves)
    assert leaves[5].grad.abs().sum() > 0   # the environment's cotangent


def assert_bits_equal(got, want):
    for name in ("radiance", "miss_dir", "miss_thr", "ray_count", "seed"):
        g, w = getattr(got, name), getattr(want, name)
        if g.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        assert torch.equal(g, w), name


@pytest.mark.parametrize("spp,rr,jitter", [(1, True, "corner"), (2, False, "center")])
def test_onehot_kernel_matches_select_and_plain(device, spp, rr, jitter):
    """The one-hot gather's table mode against the select kernel and against
    its plain version, bit for bit in all five outputs."""
    scene, inv_p, inv_v, focal, ap = setup(device, 96)
    kw = dict(width=96, height=96, ray_depth=13, spp=spp, rr=rr, jitter=jitter,
              counts=scene.counts)
    launches = (K.LAUNCHES, K.ONEHOT_LAUNCHES)
    got = K.trace(scene, inv_p, inv_v, 5, focal, ap, gather="onehot", **kw)
    torch.cuda.synchronize()
    assert (K.LAUNCHES, K.ONEHOT_LAUNCHES) == (launches[0] + 1, launches[1] + 1)
    assert_bits_equal(got, K.trace(scene, inv_p, inv_v, 5, focal, ap, **kw))
    assert_bits_equal(got, K.trace_plain(scene, inv_p, inv_v, 5, focal, ap, gather="onehot",
                                         **kw))


def assert_probe_close(name, got, want):
    """The bars of tests/test_torch_probes.py: p1, p2, p3 and p6's columns
    1-31 exact; the sums at rtol 1e-5, atol 1e-5 x the largest magnitude;
    p4 at rtol 1e-5, atol 1e-6."""
    if name in ("p1", "p2", "p3"):
        assert torch.equal(got, want), name
    elif name == "p4":
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6, msg=name)
    elif name == "p6":
        assert torch.equal(got[:, 1:], want[:, 1:]), name
        torch.testing.assert_close(got[:, 0], want[:, 0], rtol=1e-5,
                                   atol=1e-5 * float(want[:, 0].abs().max()), msg=name)
    else:
        torch.testing.assert_close(got, want, rtol=1e-5,
                                   atol=1e-5 * float(want.abs().max()), msg=name)


@pytest.mark.parametrize("grid", [100, 1013])
def test_probe_kernels_match_plain(device, grid):
    """Each probe's kernel against its plain version, under the bars of
    tests/test_torch_probes.py, at the harness's GRID = 100 and at 1013
    (one element per 1080p pixel)."""
    from tpt_torch.bwd_probes import make_inputs
    from tpt_torch.kernels import probes as P
    inputs = make_inputs(grid, device)
    for name in P.PROBES:
        launches = P.PROBE_LAUNCHES[name]
        got = getattr(P, name)(*inputs)
        torch.cuda.synchronize()
        assert P.PROBE_LAUNCHES[name] == launches + 1, name
        assert_probe_close(name, got, getattr(P, f"{name}_plain")(*inputs))


SCATTER_PROBES = ("p1t", "p5", "p6", "p7", "p8")


def test_scatter_back_to_back_resets_its_counter(device):
    """50 calls in a row on one stream, each within its bar: the last block
    of every launch leaves the workspace's counter at 0 for the next."""
    from tpt_torch.bwd_probes import make_inputs
    from tpt_torch.kernels import probes as P
    inputs = make_inputs(100, device)
    want = {name: getattr(P, f"{name}_plain")(*inputs) for name in SCATTER_PROBES}
    outs = [(name, getattr(P, name)(*inputs)) for _ in range(10) for name in SCATTER_PROBES]
    torch.cuda.synchronize()
    for name, got in outs:
        assert_probe_close(name, got, want[name])


def test_scatter_on_two_streams(device):
    """Calls on the default stream and on a side stream, interleaved, each
    with its own workspace; every call within the bar."""
    from tpt_torch.bwd_probes import make_inputs
    from tpt_torch.kernels import probes as P
    inputs = make_inputs(1013, device)
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    outs = []
    for _ in range(4):
        outs.append(P.p1t(*inputs))
        with torch.cuda.stream(side):
            outs.append(P.p1t(*inputs))
    torch.cuda.synchronize()
    want = P.p1t_plain(*inputs)
    assert len(P._WORKSPACES) >= 2
    for got in outs:
        assert_probe_close("p1t", got, want)


@pytest.mark.parametrize("grid", [100, 1013])
def test_scatter_repeats_its_counts_exactly(device, grid):
    """Two calls of each scatter probe, each within its bar; p6's counts
    (u32 atomics) equal the plain version's and each other's.  The sums'
    last bits are not held equal: the merge runs in block order, but CUDA
    does not fix the order of a warp's colliding shared-memory atomics
    (chip_smoke.py reports whether two calls gave the same bits)."""
    from tpt_torch.bwd_probes import make_inputs
    from tpt_torch.kernels import probes as P
    inputs = make_inputs(grid, device)
    for name in SCATTER_PROBES:
        want = getattr(P, f"{name}_plain")(*inputs)
        a, b = getattr(P, name)(*inputs), getattr(P, name)(*inputs)
        assert_probe_close(name, a, want)
        assert_probe_close(name, b, want)
        if name == "p6":
            assert torch.equal(a[:, 1], b[:, 1]) and torch.equal(a[:, 1], want[:, 1])


def test_scatter_layout_comes_from_the_source(device):
    """The workspace's size and ColWeights' size are csrc/probes.cu's: the
    workspace holds a 2 x 128-word partial for each block of the grid (one
    block per SM) and the counter, and the ctypes ColWeights has the C
    struct's size."""
    import ctypes
    from tpt_torch.kernels import _build
    from tpt_torch.kernels import probes as P
    words, weights_bytes = ctypes.c_int64(), ctypes.c_int64()
    assert _build.library("probes.cu").tpt_probe_scatter_layout(
        ctypes.byref(words), ctypes.byref(weights_bytes)) == 0
    assert weights_bytes.value == ctypes.sizeof(_build.ColWeights) == 2 * 4 * _build.MAX_COLS
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    assert (words.value - 1) % (2 * P.R) == 0 and words.value > 2 * P.R * sms
    work = P._workspace(torch.cuda.current_device(), torch.cuda.current_stream().cuda_stream)
    assert work.numel() == words.value and int(work[-1]) == 0


def test_probe_calls_capture_as_their_one_kernel(device):
    """chip_smoke.captured_ops reads each probe call as one node, its
    kernel; a call with a zero fill beside it as two; a call that
    synchronises invalidates the capture and raises."""
    import chip_smoke
    from tpt_torch.bwd_probes import make_inputs
    from tpt_torch.kernels import probes as P
    inputs = make_inputs(4, device)
    for name in P.PROBES:
        ops = chip_smoke.captured_ops(lambda: getattr(P, name)(*inputs))
        assert len(ops) == 1 and ops[0].startswith("kernel ") and P.KERNEL_OF[name] in ops[0]
    assert len(chip_smoke.captured_ops(lambda: (torch.zeros(64, device=device),
                                                 P.p2(*inputs)))) == 2
    with pytest.raises(Exception):
        chip_smoke.captured_ops(lambda: float(P.p2(*inputs).sum()))


def test_probe_wrappers_reject_bad_inputs(device):
    from tpt_torch.bwd_probes import make_inputs
    from tpt_torch.kernels import probes as P
    idx, table, g = make_inputs(2, device)
    with pytest.raises(ValueError, match="idx"):
        P.p1(idx.long(), table, g)
    with pytest.raises(ValueError, match="table"):
        P.p1t(idx, table.cpu(), g)


def test_probe_wrappers_reject_misaligned_inputs(device):
    """A contiguous input 4 bytes off a 16-byte boundary (a flat view
    offset by one element) raises before the 16-byte loads, never faults."""
    from tpt_torch.bwd_probes import make_inputs
    from tpt_torch.kernels import probes as P
    idx, table, g = make_inputs(2, device)

    def shifted(t):
        flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=device)
        view = flat[1:].view(t.shape)
        view.copy_(t)
        assert view.is_contiguous() and view.data_ptr() % 16 == 4
        return view

    launches = dict(P.PROBE_LAUNCHES)
    for name in ("p2", "p4") + SCATTER_PROBES:
        with pytest.raises(ValueError, match="16-byte"):
            getattr(P, name)(idx, table, shifted(g))
    for name in SCATTER_PROBES:
        with pytest.raises(ValueError, match="16-byte"):
            getattr(P, name)(shifted(idx), table, g)
    torch.cuda.synchronize()
    assert P.PROBE_LAUNCHES == launches


def test_bwd_probes_main_launches_every_probe(device, capsys):
    from tpt_torch import bwd_probes
    from tpt_torch.kernels import probes as P
    before = dict(P.PROBE_LAUNCHES)
    assert bwd_probes.main([]) == 0
    assert all(P.PROBE_LAUNCHES[n] == before[n] + 4 for n in P.PROBES)   # 1 warm-up + 3 timed
    assert capsys.readouterr().out.count(": OK ") == len(P.PROBES)


@pytest.mark.parametrize("grid", [100, 1013])
def test_gather_kernel_equals_plain_exactly(device, grid):
    """The gather (probes p1, p3) over the grid-strided int4 loop, with rows
    outside the table among the indices (0 there, the one-hot product's
    value), equal to its plain version and to the one-hot product."""
    from tpt_torch.bwd_probes import make_inputs
    from tpt_torch.kernels import probes as P
    idx, table, g = make_inputs(grid, device)
    idx = idx.clone()
    idx.view(-1)[::97] = -1
    idx.view(-1)[5::101] = P.R
    launches = P.PROBE_LAUNCHES["p1"]
    got = P.p1(idx, table, g)
    torch.cuda.synchronize()
    assert P.PROBE_LAUNCHES["p1"] == launches + 1
    inside = (idx >= 0) & (idx < P.R)
    want = torch.where(inside, P.p1_plain(idx.clamp(0, P.R - 1), table, g), 0.0)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert not got[~inside].any() and inside.sum() < idx.numel()


def test_gather_refuses_misaligned_or_short_inputs(device):
    """The wrapper raises for an idx off a 16-byte boundary and for fewer
    rows than a tile; the entry point refuses (cudaErrorInvalidValue, 1)
    an element count that is not a multiple of 4 and an unaligned idx or
    out, and launches nothing."""
    from tpt_torch.bwd_probes import make_inputs
    from tpt_torch.kernels import _build
    from tpt_torch.kernels import probes as P
    idx, table, g = make_inputs(2, device)
    flat = torch.empty(idx.numel() + 4, dtype=idx.dtype, device=device)
    shifted = flat[1:1 + idx.numel()].view(idx.shape)
    shifted.copy_(idx)
    launches = P.PROBE_LAUNCHES["p1"]
    with pytest.raises(ValueError, match="16-byte"):
        P.p1(shifted, table, g)
    with pytest.raises(ValueError, match="tile"):
        P.p1(idx[:8], table, g[:8])
    lib = _build.library("probes.cu")
    out = torch.empty_like(g)
    stream = torch.cuda.current_stream().cuda_stream
    for i, o, n in ((idx.data_ptr(), out.data_ptr(), g.numel() - 2),
                    (shifted.data_ptr(), out.data_ptr(), g.numel()),
                    (idx.data_ptr(), out.data_ptr() + 4, g.numel() - 4)):
        assert lib.tpt_probe_gather(i, table.data_ptr(), P.K, 0, n, o, stream) == 1
    torch.cuda.synchronize()
    assert P.PROBE_LAUNCHES["p1"] == launches


def test_bf16_env_kernel_matches_plain_bit_for_bit(device):
    """The environment mode with the bf16 table (--env-bf16) against its
    plain version at 64^2 x 4 frames: rad_sum, ray counts and seeds bit for
    bit; its ray counts are the f32 table's (the table changes no
    decision)."""
    args = setup(device, 64)
    from tpt_torch.config import AtmosphereConfig
    from tpt_torch.sky import compute_atmosphere
    faces = compute_atmosphere(AtmosphereConfig(size=64), device)
    table = pack_block_table(faces, dtype=torch.bfloat16)
    assert table.shape[1] == 6
    kw = dict(width=64, height=64, ray_depth=13, spp=1, n_frames=4)
    launches = (K.ENV_LAUNCHES, K.ENV_BF16_LAUNCHES)
    got = K.trace_progressive(*args[:3], 7, *args[3:], env_table=table, **kw)
    torch.cuda.synchronize()
    assert (K.ENV_LAUNCHES, K.ENV_BF16_LAUNCHES) == (launches[0] + 1, launches[1] + 1)
    want = K.trace_progressive_plain(*args[:3], 7, *args[3:], env_table=table, **kw)
    assert_bits(got, want, ("rad_sum", "ray_count", "seed"))
    f32 = K.trace_progressive(*args[:3], 7, *args[3:], env_table=pack_block_table(faces), **kw)
    assert torch.equal(got.ray_count, f32.ray_count)
    rel = float((got.rad_sum - f32.rad_sum).abs().mean() / f32.rad_sum.abs().mean())
    assert 0.0 < rel < 2 ** -8


def _world(n_ranks, jobs, backend, device):
    """Run tpt_torch.parallel.runs.run_jobs on ``n_ranks`` local ranks of the
    card, the kernels built once here first."""
    from tpt_torch.kernels import _build
    from tpt_torch.parallel import launch
    from tpt_torch.parallel.runs import run_jobs
    _build.build_all((src, None) for src in _build.SOURCES)
    setup = {"scene": "demo", "camera": {}, "env": (0.3, 0.45, 0.6), "device": "cuda"}
    return launch(run_jobs, n_ranks, setup, jobs, backend=backend, device=device, timeout=300)


def _whole_frame(device, width, height):
    from tpt_torch.integrator import apply_environment_blocked
    cam = CameraConfig()
    inv_p, inv_v, _ = camera_matrices(cam, width, height)
    res = K.trace(demo_scene().build(device), inv_p, inv_v, 0, cam.focal_length,
                  cam.aperture_diameter, width=width, height=height, ray_depth=13, spp=1)
    table = pack_block_table(constant_environment((0.3, 0.45, 0.6), device=device))
    return torch.movedim(apply_environment_blocked(res, table, 1), 0, -1), res


@pytest.mark.parametrize("n_ranks,backend", [(2, "gloo"), (1, "nccl")])
def test_dist_band_render_equals_the_whole_frame(device, n_ranks, backend):
    """Two gloo ranks sharing cuda:0 (dp=2), or a world of one on NCCL: the
    assembled image equals one whole-frame trace + the blocked fetch bit for
    bit, and each rank launched the kernel once."""
    job = dict(kind="render", dp=n_ranks, sp=1, cfg=dict(width=256, height=144, ray_depth=13,
                                                         spp=1), frames=[0])
    ranks = _world(n_ranks, [job, dict(job, kind="all_reduce")], backend, "cuda:0")
    want, res = _whole_frame(device, 256, 144)
    got = torch.from_numpy(ranks[0][0]["images"][0]).to(device)
    assert torch.equal(got.view(torch.int32), want.contiguous().view(torch.int32))
    assert ranks[0][0]["rays"][0] == int(res.ray_count.sum())
    assert [r[0]["launches"]["LAUNCHES"] for r in ranks] == [1] * n_ranks
    assert ranks[0][1]["backend"] == backend and ranks[0][1]["sum"] == \
        [float(sum(range(1, n_ranks + 1)))] * 4


def test_viewer_render_one_matches_progressive_frames(device, tmp_path):
    from tpt_torch.interactive import ViewerSession
    ses = ViewerSession(size=96, env_name="constant", device="cuda",
                        screenshot_dir=str(tmp_path))
    cam = ses.cam.to_config(ses.base_cam)
    inv_p, inv_v, _ = camera_matrices(cam, 96, 96)
    want = init_accumulator(96, 96, device)
    for b, n in enumerate((8, 8, 1)):
        launches = K.LAUNCHES
        disp = ses.render_one(n)
        assert K.LAUNCHES == launches + 1
        want, _ = progressive_frames(want, ses.scene, ses.env_table, inv_p, inv_v, 8 * b,
                                     cam.focal_length, cam.aperture_diameter, width=96,
                                     height=96, ray_depth=13, spp=1, n_frames=n)
        assert torch.equal(ses.acc.image.view(torch.int32), want.image.view(torch.int32))
    assert disp.shape == (96, 96, 3) and disp.dtype.name == "uint8"

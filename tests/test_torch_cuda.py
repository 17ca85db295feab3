"""The CUDA trace kernel against its plain PyTorch version, on the card.

Needs a CUDA device and nvcc (the kernel is built from tpt_torch/csrc at
first use); every test is skipped without a device.  Run on a GPU host:
``python -m pytest tests/test_torch_cuda.py -q``.

Both sides run the same operations in the same order in f32 with no FMA
contraction (the parity policy of tpt_torch/csrc/trace.cu), so integer
outputs must match exactly (the per-frame kernel may differ on 0.01% of
pixels) and floats at 1e-5 (per frame) or rtol 1e-3 / atol 1e-4 (refill,
the tests/test_refill.py bar)."""

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


def test_progressive_frames_launches_refill_kernel(device):
    scene, inv_p, inv_v, focal, ap = setup(device, 64)
    table = pack_block_table(constant_environment((0.7, 0.8, 1.0), device=device))
    launches = K.LAUNCHES
    acc, rays = progressive_frames(init_accumulator(64, 64, device), scene, table,
                                   inv_p, inv_v, 0, focal, ap, width=64, height=64,
                                   ray_depth=13, spp=1, n_frames=5, n_valid=4)
    assert K.LAUNCHES == launches + 1 and acc.frame == 4 and int(rays) > 4 * 64 * 64
    assert torch.isfinite(acc.image).all() and acc.image.mean().item() > 0


def test_wrapper_rejects_bad_inputs(device):
    scene, inv_p, inv_v, focal, ap = setup(device, 16)
    bad = scene.to(device)
    bad.sphere_material = bad.sphere_material.double()
    with pytest.raises(ValueError, match="sphere_material"):
        K.trace(bad, inv_p, inv_v, 0, focal, ap, width=16, height=16, ray_depth=3, spp=1)


def test_profile_block_splits_the_block(device):
    from tpt_torch.profile_block import profile_blocks
    summary, rows = profile_blocks(64, 64, 3, 1)
    assert summary["trace_kernel_ms_per_block"] > 0 and summary["segments_per_block"] > 0
    assert 0.0 <= summary["idle_share"] < 1.0 and rows


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


def test_profile_block_splits_a_train_step(device):
    from tpt_torch.profile_block import profile_train_steps
    summary, rows = profile_train_steps(64, 64, 2)
    assert summary["forward_kernel_ms_per_step"] > 0 and summary["backward_kernel_ms_per_step"] > 0
    assert summary["optimizer_ms_per_step"] >= 0 and 0.0 <= summary["idle_share"] < 1.0 and rows


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


def test_probe_kernels_match_plain(device):
    """Each probe's kernel against its plain version, under the bars of
    tests/test_torch_probes.py, at the harness's GRID = 100."""
    from tpt_torch.bwd_probes import make_inputs
    from tpt_torch.kernels import probes as P
    inputs = make_inputs(100, device)
    for name in P.PROBES:
        launches = P.PROBE_LAUNCHES[name]
        got = getattr(P, name)(*inputs)
        torch.cuda.synchronize()
        assert P.PROBE_LAUNCHES[name] == launches + 1, name
        want = getattr(P, f"{name}_plain")(*inputs)
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


def test_probe_wrappers_reject_bad_inputs(device):
    from tpt_torch.bwd_probes import make_inputs
    from tpt_torch.kernels import probes as P
    idx, table, g = make_inputs(2, device)
    with pytest.raises(ValueError, match="idx"):
        P.p1(idx.long(), table, g)
    with pytest.raises(ValueError, match="table"):
        P.p1t(idx, table.cpu(), g)


def test_bwd_probes_main_launches_every_probe(device, capsys):
    from tpt_torch import bwd_probes
    from tpt_torch.kernels import probes as P
    before = dict(P.PROBE_LAUNCHES)
    assert bwd_probes.main([]) == 0
    assert all(P.PROBE_LAUNCHES[n] == before[n] + 4 for n in P.PROBES)   # 1 warm-up + 3 timed
    assert capsys.readouterr().out.count(": OK ") == len(P.PROBES)

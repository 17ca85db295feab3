"""A training step with no host-device synchronisation, and the same bits.

On the CPU: vecmath.div_scalar divides by a fill on the device whose bits
are those of a ``torch.tensor(s, dtype=f32)`` divisor, true division and
all, on f32 inputs with subnormals, infinities and NaN; and
optim.make_renderer's render, which hands trace_diff each view's backward
camera built once on the device (``cam20=``), gives the image and both
material tables' gradients bit for bit as trace_diff building it per call.

On a CUDA card (``cuda`` marker; ``python -m pytest
tests/test_torch_step_syncs.py -q --noconftest -m cuda``): two 256^2
make_inverse_step steps with their target renders run under
``torch.cuda.set_sync_debug_mode("error")``, and their parameters are those
of the per-call camera path bit for bit.  The adjoint kernel's float
atomics within a block keep the card's order (csrc/trace_grad_adjoint.cu),
so two calls may differ in the last bits: the sync-free path is handed the
per-call path's backward results, after its own launch, and its backward
inputs are held to the per-call path's bit for bit.
"""

import math

import pytest
import torch

from tpt_torch import optim
from tpt_torch.camera import camera_matrices
from tpt_torch.config import CameraConfig
from tpt_torch.env import constant_environment, pack_block_table
from tpt_torch.inverse_demo import GRID_CAM
from tpt_torch.kernels import trace_grad as G
from tpt_torch.scene import demo_scene
from tpt_torch.vecmath import div_scalar

torch.set_num_threads(1)
DIVISORS = [1, 3, 7, 0.1, 1e-3, 2 ** 24 + 1, 1920]


def bits(t: torch.Tensor) -> torch.Tensor:
    return t.detach().contiguous().view(torch.int32)


def special_f32() -> torch.Tensor:
    """f32 inputs across the range: zeros, subnormals, the normal range's
    ends, infinities, NaN, and 4096 values of random sign, mantissa and
    exponent."""
    tiny = torch.finfo(torch.float32).tiny
    fixed = torch.tensor([0.0, -0.0, 1.0, -1.0, 1e-45, -1e-45, 5e-39, -3e-40, tiny, -tiny,
                          3.4e38, -3.4e38, math.inf, -math.inf, math.nan, 16777217.0, 0.1,
                          1920.0], dtype=torch.float32)
    gen = torch.Generator().manual_seed(5)
    mant = torch.rand(4096, generator=gen) + 0.5
    expo = torch.randint(-149, 128, (4096,), generator=gen).to(torch.float32)
    sign = torch.where(torch.rand(4096, generator=gen) < 0.5, -1.0, 1.0)
    rand = (sign * mant.double() * torch.exp2(expo.double())).to(torch.float32)
    return torch.cat([fixed, rand])


class DivisionRecorder(torch.overrides.TorchFunctionMode):
    """Records the divisor of every division called while it is on."""

    def __init__(self):
        super().__init__()
        self.divisors = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in (torch.Tensor.__truediv__, torch.Tensor.div, torch.div):
            self.divisors.append(args[1])
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("s", DIVISORS)
def test_div_scalar_divisor_and_quotient_are_the_tensor_divisors(s):
    a = special_f32()
    want_d = torch.tensor(s, dtype=torch.float32)
    with DivisionRecorder() as rec:
        got = div_scalar(a, s)
    (d,) = rec.divisors
    assert isinstance(d, torch.Tensor) and d.dtype == torch.float32 and d.dim() == 0
    assert d.device == a.device and bits(d) == bits(want_d)
    assert torch.equal(bits(got), bits(a / want_d))


def demo_training(device, size, ray_depth):
    """(scene, make_renderer's keyword arguments) of the demo scene."""
    scene = demo_scene().build(device)
    table = pack_block_table(constant_environment((0.7, 0.8, 1.0), device=device))
    return scene, dict(width=size, height=size, ray_depth=ray_depth, spp=1, counts=(48, 7),
                       env_table=table, russian_roulette=False)


def per_call_renderer(monkeypatch, scene, views, **kw):
    """make_renderer's render with trace_diff building its camera per call."""
    with monkeypatch.context() as m:
        m.setattr(optim, "camera_vector", lambda *args, **kwargs: None)
        return optim.make_renderer(scene, views, **kw)


@pytest.mark.parametrize("views", [[CameraConfig()], [GRID_CAM, CameraConfig()]],
                         ids=["one_view", "two_views"])
def test_prebuilt_view_camera_renders_and_differentiates_as_per_call(monkeypatch, views):
    scene, kw = demo_training("cpu", 32, 4)
    prebuilt = optim.make_renderer(scene, views, **kw)
    per_call = per_call_renderer(monkeypatch, scene, views, **kw)
    gen = torch.Generator().manual_seed(3)
    weights = torch.rand(len(views), 32, 32, 3, generator=gen)
    out = {}
    for name, render in (("prebuilt", prebuilt), ("per_call", per_call)):
        leaves = (scene.sphere_material.clone().requires_grad_(True),
                  scene.cuboid_material.clone().requires_grad_(True))
        images = torch.stack([render(*leaves, 5, v) for v in range(len(views))])
        grads = torch.autograd.grad((images * weights).sum(), leaves)
        out[name] = (images, *grads)
    for got, want in zip(out["prebuilt"], out["per_call"]):
        assert torch.equal(bits(got), bits(want))
    assert out["prebuilt"][1][:48, :3].abs().sum() > 0


def test_prebuilt_camera_refuses_a_camera_that_requires_grad():
    scene, kw = demo_training("cpu", 8, 1)
    inv_p, inv_v, _ = camera_matrices(CameraConfig(), 8, 8)
    cam = CameraConfig()
    cam20 = G.camera_vector(inv_p, inv_v, cam.focal_length, cam.aperture_diameter)
    with pytest.raises(ValueError, match="prebuilt cam20"):
        G.trace_diff(scene, inv_p.clone().requires_grad_(True), inv_v, 0, cam.focal_length,
                     cam.aperture_diameter, width=8, height=8, ray_depth=1, spp=1,
                     counts=(48, 7), cam20=cam20)


@pytest.mark.cuda
def test_inverse_step_makes_no_host_sync(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    dev = torch.device("cuda")
    views = [CameraConfig()]
    scene, kw = demo_training(dev, 256, 8)
    true = (scene.sphere_material, scene.cuboid_material)
    start = (scene.sphere_material * 0.9, scene.cuboid_material.clone())
    real_trace_grad = G.trace_grad
    calls = {"per_call": [], "prebuilt": []}

    def run(name, render):
        opt = optim.clipped_adam(0.005, total_steps=100)
        step = optim.make_inverse_step(render, opt, n_views=1)
        params, state = start, opt.init(start)
        targets, losses = [], []

        def trace_grad(*args, **kwargs):
            out = real_trace_grad(*args, **kwargs)
            calls[name].append(([a.clone() for a in args if isinstance(a, torch.Tensor)],
                                out))
            if name == "prebuilt":   # the per-call path's result, for the same inputs
                out = calls["per_call"][len(calls[name]) - 1][1]
            return out

        monkeypatch.setattr(G, "trace_grad", trace_grad)
        for i in range(2):
            with torch.no_grad():
                tgt = render(*true, i, 0)[None, None]
            params, state, loss = step(params, state, i, tgt)
            targets.append(tgt)
            losses.append(loss)
        return targets, losses, params

    per_call = run("per_call", per_call_renderer(monkeypatch, scene, views, **kw))
    torch.cuda.synchronize()
    render = optim.make_renderer(scene, views, **kw)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        prebuilt = run("prebuilt", render)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert len(calls["prebuilt"]) == len(calls["per_call"]) == 2
    for (got, _), (want, _) in zip(calls["prebuilt"], calls["per_call"]):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert torch.equal(g.view(torch.uint8), w.view(torch.uint8))
    for got, want in zip(prebuilt, per_call):
        for g, w in zip(got, want):
            assert torch.equal(bits(g), bits(w))

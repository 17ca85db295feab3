"""tpt_torch.kernels.trace_grad — the module that holds the backward CUDA
kernel — on the CPU, where its wrapper runs the plain version
(trace_grad_plain: autograd through the plain integrator's table trace).

The plain version is held against reverse mode through tpt's XLA oracle
(as tests/test_trace_grad.py holds the Pallas kernel) and, in one case,
against tpt.kernels.trace_grad.pallas_trace_grad run in interpret mode, which
pins the table layout and the cam20 order to the TPU kernel's own wrapper.
Cotangents are compared per scene leaf, inverse matrix, focal length and
aperture, at the bars of tests/test_trace_grad.py: rtol 3e-4 and atol 3e-4 x
the leaf's largest magnitude (with a 1e-6 floor for the cancellation-
dominated inverse matrices).  One bar is looser: the focal length's
cotangent, a sum of cancelling per-pixel terms, came 7.0e-4 relative
(2.67e-6 at 0.00383) from the oracle's in the demo subset, where JAX on the
CPU contracts FMAs and rounds its transcendentals an ulp differently
(tests/test_torch_integrator.py); the focal length and the aperture are held
at rtol 1e-3.  Before any gradient is compared, the final seeds and ray
counts must be exact, so no pixel took another path."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tpt import camera as jcam
from tpt import scene as jscene
from tpt.config import CameraConfig
from tpt.integrator import (camera_params as jcamera_params, compose_trace_fn,
                            make_scene_scan_fn as jscan_fn, make_xla_gather_fn,
                            trace_paths as jtrace_paths)
from tpt_torch import integrator as tint
from tpt_torch.integrator import build_attr_table
from tpt_torch.kernels import trace as K
from tpt_torch.kernels import trace_grad as G
from tpt_torch.kernels.trace import pixel_band

from test_torch_integrator import CORNELL_CAM, to_torch_scene

torch.set_num_threads(1)
W, H, DEPTH = 20, 12, 3
LEAVES = ("sphere_material", "cuboid_material", "sphere_pos_radius", "cuboid_min",
          "cuboid_max")
NAMES = LEAVES + ("inv_proj", "inv_view", "focal", "aperture")


def cotangents(spp):
    rng = np.random.default_rng(5)
    return [rng.normal(size=shape).astype(np.float32)
            for shape in ((3, H, W), (spp, 3, H, W), (spp, 3, H, W))]


class Case:
    def __init__(self, scene_name, cam_cfg, counts, spp, rr):
        self.js = getattr(jscene, scene_name)().build()
        self.ip, self.iv, _ = jcam.camera_matrices(cam_cfg, W, H)
        self.focal, self.ap = cam_cfg.focal_length, cam_cfg.aperture_diameter
        self.counts, self.spp, self.rr = counts, spp, rr
        self.g = cotangents(spp)

    def jax_grads(self):
        """Reverse mode through tpt's XLA oracle; returns (grads, seed, rays)."""
        g = [jnp.asarray(x) for x in self.g]
        py = jax.lax.broadcasted_iota(jnp.int32, (H, W), 0)
        px = jax.lax.broadcasted_iota(jnp.int32, (H, W), 1)

        def loss(sm, cm, spr, cmin, cmax, ip, iv, fo, ap):
            s = dataclasses.replace(self.js, sphere_material=sm, cuboid_material=cm,
                                    sphere_pos_radius=spr, cuboid_min=cmin, cuboid_max=cmax)
            trace = compose_trace_fn(jscan_fn(s, counts=self.counts), make_xla_gather_fn(s))
            res = jtrace_paths(trace, jcamera_params(ip, iv, fo, ap), px, py, W, H,
                               jnp.int32(0), DEPTH, self.spp, russian_roulette=self.rr)
            obj = (jnp.sum(res.radiance * g[0]) + jnp.sum(res.miss_dir * g[1])
                   + jnp.sum(res.miss_thr * g[2]))
            return obj, (res.seed, res.ray_count)

        args = tuple(getattr(self.js, k) for k in LEAVES) + (
            self.ip, self.iv, jnp.float32(self.focal), jnp.float32(self.ap))
        grads, (seed, rays) = jax.jit(jax.grad(loss, argnums=tuple(range(9)), has_aux=True))(*args)
        return [np.asarray(x) for x in grads], np.asarray(seed), np.asarray(rays)

    def torch_inputs(self):
        """Scene leaves, matrices, focal and aperture as torch leaves, and the
        table and cam20 built from them."""
        ts = to_torch_scene(self.js)
        leaves = [getattr(ts, k).clone().requires_grad_(True) for k in LEAVES]
        cam = [torch.tensor(np.asarray(self.ip)).requires_grad_(True),
               torch.tensor(np.asarray(self.iv)).requires_grad_(True),
               torch.tensor(float(self.focal)).requires_grad_(True),
               torch.tensor(float(self.ap)).requires_grad_(True)]
        scene = dataclasses.replace(ts, **dict(zip(LEAVES, leaves)))
        table = build_attr_table(scene, self.counts)
        cam20 = G.camera_vector(*cam)
        return scene, leaves + cam, table, cam20

    def leaf_grads(self, out, leaves, table, cam20):
        """Map a GradResult to the leaves through build_attr_table and
        camera_vector (autograd)."""
        grads = torch.autograd.grad([table, cam20], leaves, [out.d_table, out.d_cam],
                                    allow_unused=True)
        return [np.zeros(tuple(l.shape), np.float32) if d is None else d.numpy()
                for l, d in zip(leaves, grads)]


def assert_grads_close(got, want):
    for name, g, w in zip(NAMES, got, want):
        assert np.isfinite(g).all(), name
        scale = max(np.abs(w).max(), 1e-3)
        atol = max(3e-4 * scale, 1e-6 if name in ("inv_proj", "inv_view") else 0.0)
        rtol = 1e-3 if name in ("focal", "aperture") else 3e-4
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=name)


CASES = {
    "cornell-spp1-rr": ("cornell_scene", CORNELL_CAM, (4, 0), 1, True),
    "cornell-spp2-no-rr": ("cornell_scene", CORNELL_CAM, (4, 0), 2, False),
    "demo-subset-rr": ("demo_scene", CameraConfig(), (10, 7), 1, True),
}


@pytest.mark.parametrize("name", list(CASES))
def test_trace_grad_plain_matches_jax_oracle(name):
    case = Case(*CASES[name])
    want, seed, rays = case.jax_grads()
    scene, leaves, table, cam20 = case.torch_inputs()
    # the same paths first: the gradient path's forward gives tpt's seeds and
    # ray counts exactly
    with torch.no_grad():
        px, py = pixel_band(W, H, H, 0, "cpu")
        trace_fn = tint.make_table_trace_fn(tint.make_scene_scan_fn(scene, case.counts),
                                            table, case.counts[0])
        fwd = tint.trace_paths(trace_fn, G.camera_params_from_vector(cam20), px, py, W, H, 0,
                               DEPTH, case.spp, russian_roulette=case.rr)
    np.testing.assert_array_equal(fwd.seed.numpy().astype(np.uint32), seed)
    np.testing.assert_array_equal(fwd.ray_count.numpy(), rays)

    launches = G.GRAD_LAUNCHES
    out = G.trace_grad(scene, table, cam20, 0, *map(torch.tensor, case.g), width=W, height=H,
                       ray_depth=DEPTH, spp=case.spp, counts=case.counts, rr=case.rr)
    assert G.GRAD_LAUNCHES == launches       # the CPU runs the plain version
    assert int(out.n_zeroed) == 0
    assert_grads_close(case.leaf_grads(out, leaves, table, cam20), want)


def test_trace_grad_plain_matches_pallas_trace_grad():
    """Against the TPU kernel's own wrapper in interpret mode: its table
    layout, its cam20 order and its per-leaf mapping."""
    from tpt.kernels.trace_grad import pallas_trace_grad
    case = Case(*CASES["cornell-spp1-rr"])
    g = [jnp.asarray(x) for x in case.g]
    d_scene, d_ip, d_iv, d_f, d_a = pallas_trace_grad(
        case.js, case.ip, case.iv, jnp.int32(0), jnp.float32(case.focal),
        jnp.float32(case.ap), *g, width=W, height=H, ray_depth=DEPTH, spp=1,
        counts=case.counts, interpret=True)
    want = [np.asarray(getattr(d_scene, k)) for k in LEAVES] + [
        np.asarray(d_ip), np.asarray(d_iv), np.asarray(d_f), np.asarray(d_a)]
    scene, leaves, table, cam20 = case.torch_inputs()
    out = G.trace_grad_plain(scene, table, cam20, 0, *map(torch.tensor, case.g), width=W,
                             height=H, ray_depth=DEPTH, spp=1, counts=case.counts)
    assert_grads_close(case.leaf_grads(out, leaves, table, cam20), want)


def test_trace_diff_backward_is_trace_grad_plain():
    case = Case(*CASES["cornell-spp2-no-rr"])
    scene, leaves, table, cam20 = case.torch_inputs()
    g = list(map(torch.tensor, case.g))
    want = case.leaf_grads(G.trace_grad_plain(scene, table, cam20, 0, *g, width=W, height=H,
                                              ray_depth=DEPTH, spp=2, counts=case.counts,
                                              rr=False), leaves, table, cam20)
    ip, iv, focal, ap = leaves[5:]
    res = G.trace_diff(scene, ip, iv, 0, focal, ap, width=W, height=H, ray_depth=DEPTH, spp=2,
                       counts=case.counts, rr=False)
    assert res.ray_count.grad_fn is None and not res.seed.requires_grad
    # the forward is the trace kernel's (plain on the CPU): the same outputs
    with torch.no_grad():
        plain = K.trace(scene, ip, iv, 0, float(focal), float(ap), width=W, height=H,
                        ray_depth=DEPTH, spp=2, counts=case.counts, rr=False)
    np.testing.assert_array_equal(res.radiance.detach().numpy(), plain.radiance.numpy())
    obj = ((res.radiance * g[0]).sum() + (res.miss_dir * g[1]).sum()
           + (res.miss_thr * g[2]).sum())
    got = [d.numpy() for d in torch.autograd.grad(obj, leaves)]
    for name, a, b in zip(NAMES, got, want):
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert int(G.LAST_ZEROED) == 0


def test_trace_diff_row_band_adds_up():
    """The cotangent is a sum over pixels: two row bands add up to the
    whole frame's."""
    case = Case(*CASES["cornell-spp1-rr"])
    scene, leaves, table, cam20 = case.torch_inputs()
    g = list(map(torch.tensor, case.g))
    kw = dict(width=W, height=H, ray_depth=DEPTH, spp=1, counts=case.counts)
    whole = G.trace_grad(scene, table, cam20, 0, *g, **kw)
    bands = [G.trace_grad(scene, table, cam20, 0, g[0][:, r:r + 6], g[1][:, :, r:r + 6],
                          g[2][:, :, r:r + 6], n_rows=6, row0=r, **kw) for r in (0, 6)]
    torch.testing.assert_close(bands[0].d_table + bands[1].d_table, whole.d_table,
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(bands[0].d_cam + bands[1].d_cam, whole.d_cam,
                               rtol=1e-5, atol=1e-4)


def test_finite_filter_zeroes_and_counts():
    d_table = torch.ones((128, 24))
    d_table[3, 5] = float("nan")
    d_table[7, 0] = float("inf")
    d_cam = torch.ones(20)
    d_cam[19] = float("-inf")
    out = G.finite_filter(d_table, d_cam)
    assert int(out.n_zeroed) == 3
    assert out.d_table[3, 5] == 0 and out.d_table[7, 0] == 0 and out.d_cam[19] == 0
    assert float(out.d_table.sum()) == 128 * 24 - 2 and float(out.d_cam.sum()) == 19


def test_no_fallback_off_the_cpu_and_bad_arguments():
    case = Case(*CASES["cornell-spp1-rr"])
    scene, _, table, cam20 = case.torch_inputs()
    g = list(map(torch.tensor, case.g))
    kw = dict(width=W, height=H, ray_depth=DEPTH, spp=1)
    with pytest.raises(ValueError, match="CUDA"):
        G.trace_grad(scene, table.detach().to("meta"), cam20, 0, *g, counts=case.counts, **kw)
    with pytest.raises(ValueError, match="counts"):
        G.trace_grad(scene, table, cam20, 0, *g, counts=(100, 29), **kw)
    with pytest.raises(ValueError, match="ablate"):
        G.trace_grad(scene, table, cam20, 0, *g, counts=case.counts, ablate="fast", **kw)
    with pytest.raises(ValueError, match="probe"):
        G.trace_grad(scene, table, cam20, 0, *g, counts=case.counts, ablate="norev", **kw)

"""tpt_torch.optim: the inverse-rendering recipe, against tpt.optim (optax).

The schedule and the clipped-Adam update must follow optax's formulas on the
same gradients (to f32 rounding: rtol 1e-6); the recipe must recover a
perturbed albedo on tests/test_optim.py's problem; a checkpoint must resume
bit for bit, also from a file that tpt.optim wrote; and the training entry
point must run on the CPU."""

import json
import os
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import optax
import pytest
import torch

from tpt import optim as jopt
from tpt_torch import cornell_scene
from tpt_torch.config import CameraConfig
from tpt_torch.env import constant_environment, pack_block_table
from tpt_torch.optim import (clipped_adam, default_schedule, load_optim_checkpoint,
                             make_inverse_step, make_renderer, save_optim_checkpoint)

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H, DEPTH, SPP = 16, 12, 2, 1
COUNTS = (4, 0)
CAM = CameraConfig(position=(0.0, 0.5, 2.0), look_x=-90.0, look_y=-5.0,
                   focal_length=8.0, aperture_diameter=0.0)


def test_schedule_matches_optax():
    want, got = jopt.default_schedule(0.01, 100), default_schedule(0.01, 100)
    for count in (0, 1, 59, 60, 61, 75, 80, 99, 100, 101, 500):
        np.testing.assert_allclose(float(got(count)), float(want(jnp.int32(count))),
                                   rtol=1e-6, atol=1e-8)


def _grads(rng, shapes, scale):
    return [rng.normal(size=s).astype(np.float32) * scale for s in shapes]


@pytest.mark.parametrize("total_steps", [None, 20])
def test_clipped_adam_updates_match_optax(total_steps):
    rng = np.random.default_rng(0)
    shapes = ((6, 4), (3, 5))
    p0 = _grads(rng, shapes, 1.0)
    jo, to = jopt.clipped_adam(0.01, total_steps=total_steps), clipped_adam(0.01, total_steps)
    jp, tp = tuple(map(jnp.asarray, p0)), tuple(map(torch.tensor, p0))
    js, ts = jo.init(jp), to.init(tp)
    for it in range(14):   # norms above and below the clip bound of 1
        g = _grads(rng, shapes, 0.8 if it % 2 else 0.01)
        u, js = jo.update(tuple(map(jnp.asarray, g)), js, jp)
        jp = optax.apply_updates(jp, u)
        tu, ts = to.update(tuple(map(torch.tensor, g)), ts, tp)
        tp = tuple(a + b for a, b in zip(tp, tu))
        for a, b in zip(jp, tp):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6, atol=1e-7)
    assert int(ts.count) == 14


def _problem():
    scene = cornell_scene().build()
    env_table = pack_block_table(constant_environment((0.3, 0.45, 0.6)))
    render = make_renderer(scene, [CAM], width=W, height=H, ray_depth=DEPTH, spp=SPP,
                           counts=COUNTS, env_table=env_table)
    true_sm, true_cm = scene.sphere_material, scene.cuboid_material
    with torch.no_grad():
        targets = render(true_sm, true_cm, 0, 0)[None, None]   # [grad_frames, views, ...]
    sm0 = true_sm.clone()
    sm0[1, 0:3] = torch.tensor([0.9, 0.1, 0.6])   # the red sphere's albedo
    mask_s = torch.zeros_like(sm0)
    mask_s[1, 0:3] = 1.0
    return render, (sm0, true_cm), targets, (mask_s, torch.zeros_like(true_cm)), true_sm


def test_inverse_step_recovers_albedo():
    render, params, targets, mask, true_sm = _problem()
    opt = clipped_adam(0.02, total_steps=60)
    step = make_inverse_step(render, opt, n_views=1, param_mask=mask)
    state = opt.init(params)
    err0 = float((params[0][1, 0:3] - true_sm[1, 0:3]).abs().mean())
    first = None
    for _ in range(60):
        params, state, loss = step(params, state, 0, targets)
        first = float(loss) if first is None else first
    err = float((params[0][1, 0:3] - true_sm[1, 0:3]).abs().mean())
    assert float(loss) < first * 0.25
    assert err < err0 * 0.35
    np.testing.assert_array_equal(params[0][0].numpy(), true_sm[0].numpy())   # frozen


def test_checkpoint_resume_is_bitwise(tmp_path):
    render, params, targets, mask, _ = _problem()
    opt = clipped_adam(0.02, total_steps=10)
    step = make_inverse_step(render, opt, n_views=1, param_mask=mask)
    state = opt.init(params)
    for i in range(3):
        params, state, _ = step(params, state, i, targets)
    path = str(tmp_path / "opt.npz")
    save_optim_checkpoint(path, params, state, 3)
    ref_params, ref_state = params, state
    for i in range(3, 6):
        ref_params, ref_state, _ = step(ref_params, ref_state, i, targets)
    example = tuple(torch.zeros_like(p) for p in params)
    r_params, r_state, start = load_optim_checkpoint(path, opt, example)
    assert start == 3
    for i in range(start, 6):
        r_params, r_state, _ = step(r_params, r_state, i, targets)
    for a, b in zip(ref_params, r_params):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("total_steps", [None, 20])
def test_resume_from_a_tpt_checkpoint(tmp_path, total_steps):
    """An optimizer state that tpt.optim saved loads leaf for leaf, and the
    next update equals optax's."""
    rng = np.random.default_rng(1)
    shapes = ((256, 16), (64, 16))
    jo = jopt.clipped_adam(0.01, total_steps=total_steps)
    jp = tuple(map(jnp.asarray, _grads(rng, shapes, 1.0)))
    js = jo.init(jp)
    for _ in range(3):
        u, js = jo.update(tuple(map(jnp.asarray, _grads(rng, shapes, 0.5))), js, jp)
        jp = optax.apply_updates(jp, u)
    path = str(tmp_path / "tpt_opt.npz")
    jopt.save_optim_checkpoint(path, jp, js, 3)

    to = clipped_adam(0.01, total_steps)
    tp, ts, start = load_optim_checkpoint(path, to, tuple(torch.zeros(s) for s in shapes))
    assert start == 3 and int(ts.count) == 3
    for a, b in zip(jp, tp):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    g = _grads(rng, shapes, 0.5)
    u, js = jo.update(tuple(map(jnp.asarray, g)), js, jp)
    jp = optax.apply_updates(jp, u)
    tu, ts = to.update(tuple(map(torch.tensor, g)), ts, tp)
    for a, b in zip(jp, (p + d for p, d in zip(tp, tu))):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="leaves"):
        load_optim_checkpoint(path, clipped_adam(0.01, None if total_steps else 20),
                              tuple(torch.zeros(s) for s in shapes))


def test_inverse_demo_runs_on_the_cpu_with_a_bare_out_name(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    subprocess.run([sys.executable, "-m", "tpt_torch.inverse_demo", "--device", "cpu",
                    "--size", "16x12", "--steps", "3", "--out", "demo.json"],
                   cwd=tmp_path, env=env, check=True, timeout=300, capture_output=True)
    with open(tmp_path / "demo.json") as f:
        res = json.load(f)
    assert res["steps"] == 3 and res["device"] == "cpu"
    assert np.isfinite(res["loss_last"]) and res["sphere_param_mae_before"] == 0.2866
    for name in ("inverse_before.png", "inverse_target.png", "inverse_after.png"):
        assert (tmp_path / name).stat().st_size > 0


def test_training_path_imports_no_jax_or_optax():
    code = ("import sys; import tpt_torch.optim, tpt_torch.diff, tpt_torch.inverse_demo, "
            "tpt_torch.kernels.trace_grad, tpt_torch.profile_block; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'tpt', 'optax')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)

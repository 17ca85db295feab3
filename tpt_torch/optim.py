"""Inverse-rendering optimisation: the recipe of tpt.optim on PyTorch.

Three defaults carry over from the JAX package:

* **Fixed-depth transport** (``russian_roulette=False``): Russian roulette
  divides a surviving path's throughput by its max channel, so RR'd pixel
  values depend only on albedo ratios (tpt_torch.integrator.bounce_step).
* **Global-norm-clipped Adam**: per-parameter scaling absorbs the spread
  between albedo and emissive gradients; clipping tames firefly frames.
* **Constant-then-cosine schedule**: constant for the first 60% of the
  budget, cosine decay to 1% after.

The optimizer is written to optax's formulas, not torch.optim's, so a run
can move between the two packages: ``clip_by_global_norm`` scales only when
the norm exceeds the bound and adds no epsilon; Adam keeps its moments as
``(1 - b) * g**k + b * m`` with bias correction ``m / (1 - b**count)`` and
``mu_hat / (sqrt(nu_hat) + eps)``, eps 1e-8.  The optimizer checkpoint is
the npz layout of tpt.optim.save_optim_checkpoint (params, the Adam count,
mu, nu and, with a schedule, the schedule's count), so a run started in
tpt resumes here.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .camera import camera_matrices
from .config import CameraConfig
from .integrator import apply_environment_blocked
from .kernels.trace_grad import trace_diff
from .vecmath import div_scalar

Params = Tuple[torch.Tensor, ...]
B1, B2, EPS = 0.9, 0.999, 1e-8   # optax.adam's defaults, which tpt.optim uses


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), x, dtype=torch.float32, device=like.device)


def default_schedule(lr: float, total_steps: int) -> Callable[[torch.Tensor], torch.Tensor]:
    """Constant for the first 60% of ``total_steps``, cosine decay to 1%
    after: optax.join_schedules of constant_schedule(lr) and
    cosine_decay_schedule(lr, 40% of the steps, alpha=0.01), in f32 on the
    count's device (no host synchronisation)."""
    boundary = max(total_steps * 3 // 5, 1)
    decay_steps = float(max(total_steps * 2 // 5, 1))

    def schedule(count) -> torch.Tensor:
        count = torch.as_tensor(count, dtype=torch.int32)
        c = torch.minimum((count - boundary).to(torch.float32), _f32(decay_steps, count))
        cosine = 0.5 * (1 + torch.cos(_f32(math.pi, c) * c / _f32(decay_steps, c)))
        decayed = _f32(1 - 0.01, c) * cosine + _f32(0.01, c)
        return torch.where(count < boundary, _f32(lr, c), _f32(lr, c) * decayed)

    return schedule


class AdamState(NamedTuple):
    count: torch.Tensor                    # i32 scalar
    mu: Params
    nu: Params
    schedule_count: Optional[torch.Tensor]  # i32 scalar, with a schedule


@dataclasses.dataclass(frozen=True)
class ClippedAdam:
    """Global-norm clip, then Adam, then the (scheduled) learning rate:
    optax.chain(clip_by_global_norm(clip_norm), adam(lr or schedule))."""
    lr: float = 5e-3
    total_steps: Optional[int] = None
    clip_norm: float = 1.0

    def init(self, params: Params) -> AdamState:
        zero_i = torch.zeros((), dtype=torch.int32, device=params[0].device)
        zeros = tuple(torch.zeros_like(p) for p in params)
        return AdamState(zero_i, zeros, tuple(torch.zeros_like(p) for p in params),
                         zero_i.clone() if self.total_steps else None)

    def update(self, grads: Params, state: AdamState, params: Params = None):
        """Returns (updates, new state); the caller adds the updates."""
        g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        bound = _f32(self.clip_norm, g_norm)
        grads = tuple(torch.where(g_norm < bound, g, (g / g_norm) * bound) for g in grads)
        b1, b2 = _f32(B1, g_norm), _f32(B2, g_norm)
        mu = tuple(_f32(1 - B1, g) * g + b1 * m for g, m in zip(grads, state.mu))
        nu = tuple(_f32(1 - B2, g) * (g * g) + b2 * v for g, v in zip(grads, state.nu))
        count = state.count + 1
        c = count.to(torch.float32)
        corr1 = 1 - torch.pow(b1, c)
        corr2 = 1 - torch.pow(b2, c)
        eps = _f32(EPS, g_norm)
        updates = tuple((m / corr1) / (torch.sqrt(v / corr2) + eps) for m, v in zip(mu, nu))
        if self.total_steps:
            step = -1 * default_schedule(self.lr, self.total_steps)(state.schedule_count)
            sched = state.schedule_count + 1
        else:
            step, sched = _f32(-1 * self.lr, g_norm), None
        return tuple(step * u for u in updates), AdamState(count, mu, nu, sched)

    def state_from_leaves(self, leaves, n_params: int) -> AdamState:
        count, rest = leaves[0], leaves[1:]
        mu, nu = tuple(rest[:n_params]), tuple(rest[n_params:2 * n_params])
        sched = rest[2 * n_params] if self.total_steps else None
        return AdamState(count, mu, nu, sched)


def clipped_adam(lr: float = 5e-3, total_steps: Optional[int] = None,
                 clip_norm: float = 1.0) -> ClippedAdam:
    """The training default: global-norm clip -> Adam (-> schedule)."""
    return ClippedAdam(lr=lr, total_steps=total_steps, clip_norm=clip_norm)


def make_renderer(scene, views: Sequence[CameraConfig], *, width: int, height: int,
                  ray_depth: int, spp: int, counts: Tuple[int, int], env_table,
                  jitter: str = "corner", russian_roulette: bool = False):
    """Differentiable renderer over a set of camera views, on the scene's
    device.  Returns ``render(sphere_mat, cuboid_mat, frame, view) ->
    f32[H, W, 3]`` through trace_diff (the trace kernel forward, the
    backward kernel in reverse mode).  Several views make parameters
    identifiable that one view does not observe."""
    dev = scene.device
    mats = []
    for c in views:
        inv_p, inv_v, _ = camera_matrices(c, width, height)
        mats.append((inv_p.to(dev), inv_v.to(dev), c.focal_length, c.aperture_diameter))

    def render(sphere_mat, cuboid_mat, frame, view: int):
        inv_p, inv_v, focal, aperture = mats[view]
        s = dataclasses.replace(scene, sphere_material=sphere_mat, cuboid_material=cuboid_mat)
        res = trace_diff(s, inv_p, inv_v, int(frame), focal, aperture, 0, width=width,
                         height=height, ray_depth=ray_depth, spp=spp, counts=counts,
                         jitter=jitter, rr=russian_roulette)
        return torch.movedim(apply_environment_blocked(res, env_table, spp), 0, -1)

    return render


def make_inverse_step(render, optimizer: ClippedAdam, n_views: int, grad_frames: int = 1,
                      param_mask=None):
    """Optimisation step for material-table recovery:
    ``step(params, opt_state, frame, targets) -> (params, opt_state, loss)``
    with ``params = (sphere_material, cuboid_material)`` and ``targets``
    f32[grad_frames, n_views, H, W, 3].  The loss is the pixel MSE averaged
    over the views and ``grad_frames`` independent RNG frames;
    ``param_mask`` freezes masked-out entries."""

    def step(params, opt_state, frame, targets):
        leaves = tuple(p.detach().requires_grad_(True) for p in params)
        total = None
        for f in range(grad_frames):
            for v in range(n_views):
                err = render(*leaves, int(frame) * grad_frames + f, v) - targets[f, v]
                term = torch.mean(err * err)
                total = term if total is None else total + term
        loss = div_scalar(total, grad_frames * n_views)
        grads = torch.autograd.grad(loss, leaves)
        if param_mask is not None:
            grads = tuple(g * m for g, m in zip(grads, param_mask))
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = tuple(p.detach() + u for p, u in zip(params, updates))
        return params, opt_state, loss.detach()

    return step


def save_optim_checkpoint(path: str, params, opt_state: AdamState, step: int):
    """Persist (params, optimizer state, step counter) to one npz file, leaf
    by leaf in the order of tpt.optim.save_optim_checkpoint."""
    leaves = [*params, opt_state.count, *opt_state.mu, *opt_state.nu]
    if opt_state.schedule_count is not None:
        leaves.append(opt_state.schedule_count)
    np.savez(path, step=np.int64(step), n_leaves=np.int64(len(leaves)),
             **{f"leaf_{i}": v.detach().cpu().numpy() for i, v in enumerate(leaves)})


def load_optim_checkpoint(path: str, optimizer: ClippedAdam, example_params):
    """Restore (params, opt_state, step) from a file written by
    :func:`save_optim_checkpoint` or by tpt.optim.save_optim_checkpoint.
    ``example_params`` gives the number of parameter tensors and the
    device."""
    data = np.load(path)
    n = int(data["n_leaves"])
    dev = example_params[0].device
    leaves = [torch.as_tensor(data[f"leaf_{i}"]).to(dev) for i in range(n)]
    k = len(example_params)
    want = 3 * k + 1 + (1 if optimizer.total_steps else 0)   # params, count, mu, nu[, count]
    if n != want:
        raise ValueError(f"{path}: {n} leaves, this optimizer needs {want}")
    return (tuple(leaves[:k]), optimizer.state_from_leaves(leaves[k:], k), int(data["step"]))

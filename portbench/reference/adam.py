"""Frozen copy of tpt_torch.optim's clipped Adam: global-norm clip, then
Adam, then the constant-then-cosine learning rate, to optax's formulas."""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional, Tuple

import torch

Params = Tuple[torch.Tensor, ...]
B1, B2, EPS = 0.9, 0.999, 1e-8


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

"""Vec3 helpers on leading-axis-3 tensors (port of tpt.vecmath).

Vectors are ``f32[3, *batch]``, the layout of the JAX package, so the
parity tests compare like with like; ``torch.where`` broadcasts a
``[*batch]`` mask over them.  Every helper keeps the JAX operation order
exactly: the CUDA trace kernel repeats the same float operations in the
same order, and the plain versions are its reference.

Division by a Python number goes through :func:`div_scalar`: on a CUDA
tensor ``x / 3.0`` is computed by PyTorch as ``x * (1/3.0)``, which rounds
differently from the true division that JAX and the kernel perform.

Maxima and minima on the differentiable path go through :func:`maximum`,
:func:`minimum` and :func:`max_const`, which differentiate by JAX's rule:
the cotangent times 1 where an operand is the result, 1/2 at a tie, 0
otherwise.  ``torch.clamp_min`` gives all of it to ``x`` at a tie, and
``torch.maximum``'s backward zeroes the loser's share by masking, so a NaN
cotangent stops there where JAX (0 * NaN) carries it on; the forward bits
are ``torch.maximum``'s.
"""

from __future__ import annotations

import torch


def div_scalar(a: torch.Tensor, s) -> torch.Tensor:
    """``a / s`` as a correctly rounded f32 division on every device."""
    return a / torch.tensor(s, dtype=a.dtype, device=a.device)


def _sum_to(g: torch.Tensor, shape) -> torch.Tensor:
    """Reduce a broadcast cotangent to ``shape``."""
    while g.dim() > len(shape):
        g = g.sum(0)
    for i, n in enumerate(shape):
        if n == 1 and g.shape[i] != 1:
            g = g.sum(i, keepdim=True)
    return g


class _MinMax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, is_max):
        ans = torch.maximum(a, b) if is_max else torch.minimum(a, b)
        ctx.save_for_backward(a, b, ans)
        return ans

    @staticmethod
    def backward(ctx, g):
        a, b, ans = ctx.saved_tensors

        def share(x, other):  # jax.lax's _balanced_eq
            return (x == ans).to(g.dtype) / torch.where(other == ans, 2.0, 1.0).to(g.dtype)

        ga = _sum_to(g * share(a, b), a.shape) if ctx.needs_input_grad[0] else None
        gb = _sum_to(g * share(b, a), b.shape) if ctx.needs_input_grad[1] else None
        return ga, gb, None


def maximum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.maximum`` differentiated as ``jnp.maximum``."""
    return _MinMax.apply(a, b, True)


def minimum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.minimum`` differentiated as ``jnp.minimum``."""
    return _MinMax.apply(a, b, False)


def max_const(a: torch.Tensor, c) -> torch.Tensor:
    """``jnp.maximum(a, c)`` for a Python number ``c``."""
    return maximum(a, torch.full((), c, dtype=a.dtype, device=a.device))


def min_const(a: torch.Tensor, c) -> torch.Tensor:
    """``jnp.minimum(a, c)`` for a Python number ``c``."""
    return minimum(a, torch.full((), c, dtype=a.dtype, device=a.device))


class _SqrtClampedGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.sqrt(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        half = torch.full((), 0.5, dtype=x.dtype, device=x.device)
        return g * (half / torch.sqrt(max_const(x, 1e-12)))


def sqrt_clamped_grad(x: torch.Tensor) -> torch.Tensor:
    """sqrt with a bit-identical primal and the derivative
    ``0.5 / sqrt(max(x, 1e-12))`` (tpt.vecmath.sqrt_clamped_grad).

    sqrt'(0) is infinite; at measure-zero points (grazing intersections,
    the refraction TIR boundary) reverse mode would multiply it by a zero
    cotangent and poison whole gradient tables with NaN."""
    return _SqrtClampedGrad.apply(x)


def dot3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def normalize3(a, eps=None):
    """Unit vector. With ``eps`` set, guards the degenerate zero-vector case
    by flooring the squared length (documented deviation from GLSL's UB)."""
    d = dot3(a, a)
    if eps is not None:
        d = max_const(d, eps)
    return a / torch.sqrt(d)


def max3(a):
    return maximum(a[0], maximum(a[1], a[2]))


def mix(a, b, t):
    """GLSL mix: a*(1-t) + b*t, computed exactly as a + (b-a)*t."""
    return a + (b - a) * t

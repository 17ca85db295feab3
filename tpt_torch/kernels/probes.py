"""The backward-design probes' wrappers and their plain PyTorch versions.

The nine Pallas probes of benchmarks/exp_bwd_probes.py (p1 ... p8) asked
what Mosaic could lower for the one-hot backward kernel: the one-hot
gather, its transpose, in-kernel reshapes and a vjp.  Three CUDA kernels of
tpt_torch/csrc/probes.cu replace them:

  * ``probe_gather_kernel``: p1, p3 — ``out[b] = table[idx[b], 0]``;
  * ``probe_scatter_kernel``: p1t, p7, p8 — ``d[r, k] = sum_{idx[b]=r} g[b]``
    for every k; p6 — the table cotangent of the one-hot product (column 0
    those sums, column 1 the counts of ``idx = r``, the rest 0); p5 —
    ``(k + 1) * sum`` over the last 16 x 128 tile, r < 55, k < 4;
  * ``probe_elementwise_kernel``: p2 — ``2 x``; p4 — ``f(x) + vjp(f)(g)``.

Every wrapper takes ``(idx, table, g)``: idx i32[N, 128] in [0, 55), table
f32[128, 32], g f32[N, 128] (the harness passes g as x too), and returns
the probe's output (:func:`output_shape`).  For CPU tensors it runs its
plain version (``<name>_plain``); for CUDA tensors it launches its kernel
or raises.  ``PROBE_LAUNCHES[name]`` counts each probe's kernel launches.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

TR, L, R, K = 16, 128, 128, 32   # the harness's tile rows, lanes, table rows, columns
P5_ROWS, P5_COLS = 55, 4

PROBES = ("p1", "p1t", "p2", "p3", "p4", "p5", "p6", "p7", "p8")
KERNEL_OF = {"p1": "probe_gather_kernel", "p3": "probe_gather_kernel",
             "p1t": "probe_scatter_kernel", "p5": "probe_scatter_kernel",
             "p6": "probe_scatter_kernel", "p7": "probe_scatter_kernel",
             "p8": "probe_scatter_kernel",
             "p2": "probe_elementwise_kernel", "p4": "probe_elementwise_kernel"}
PROBE_LAUNCHES: Dict[str, int] = dict.fromkeys(PROBES, 0)

# the scatter probes: (rows, cols, a, c, last tile only) of
# d[r, k] = a_k * sum_{idx[b] = r} g[b] + c_k * #{idx[b] = r}
_ONES, _ZEROS = [1.0] * K, [0.0] * K
SCATTER = {
    "p1t": (R, K, _ONES, _ZEROS, False),
    "p7": (R, K, _ONES, _ZEROS, False),
    "p8": (R, K, _ONES, _ZEROS, False),
    "p6": (R, K, [1.0] + [0.0] * (K - 1), [0.0, 1.0] + [0.0] * (K - 2), False),
    "p5": (P5_ROWS, P5_COLS, [1.0, 2.0, 3.0, 4.0], [0.0] * P5_COLS, True),
}


def output_shape(name: str, n_rows: int) -> Tuple[int, ...]:
    """The shape of probe ``name``'s output for inputs of ``n_rows`` x 128."""
    if name in SCATTER:
        return tuple(SCATTER[name][:2])
    return (n_rows, L)


# ---- plain versions ----

def _row_sums(idx, g, rows: int = R):
    """sum_{idx[b] = r} g[b] for r < rows, by index_add_."""
    return torch.zeros(rows, dtype=torch.float32, device=g.device).index_add_(
        0, idx.reshape(-1).long(), g.reshape(-1))


def p1_plain(idx, table, g):
    return table[idx.long(), 0]


def p2_plain(idx, table, g):
    return g * 2.0


def p1t_plain(idx, table, g):
    return _row_sums(idx, g)[:, None].expand(R, K).contiguous()


def p6_plain(idx, table, g):
    d = torch.zeros((R, K), dtype=torch.float32, device=g.device)
    d[:, 0] = _row_sums(idx, g)
    d[:, 1] = torch.bincount(idx.reshape(-1).long(), minlength=R)[:R].to(torch.float32)
    return d


def p5_plain(idx, table, g):
    sums = _row_sums(idx[-TR:], g[-TR:])[:P5_ROWS]
    return sums[:, None] * torch.arange(1, P5_COLS + 1, dtype=torch.float32, device=g.device)


def p4_f(x):
    """The probe's bounce-like function (exp_bwd_probes.py:97-100)."""
    y = x * torch.rsqrt(x * x + 1.0)
    z = torch.where(x > 0, y * y, torch.exp(-y))
    return torch.tanh(z) + y / (z + 2.0)


def p4_plain(idx, table, g):
    with torch.enable_grad():
        x = g.detach().requires_grad_(True)
        out = p4_f(x)
        (dx,) = torch.autograd.grad(out, x, grad_outputs=g.detach())
    return (out + dx).detach()


# p3 is p1 through a 3-D contraction; p7 and p8 are p1t phrased two other ways
p3_plain = p1_plain
p7_plain = p8_plain = p1t_plain


# ---- kernel launches ----

def _check(name, idx, table, g):
    device = g.device
    if device.type != "cuda":
        raise ValueError(f"probe {name} runs its kernel on CUDA tensors, got {device}")
    n_rows = g.shape[0] if g.dim() == 2 else -1
    for what, t, dtype, shape in (("idx", idx, torch.int32, (n_rows, L)),
                                  ("table", table, torch.float32, (R, K)),
                                  ("g", g, torch.float32, (n_rows, L))):
        if t.device != device or t.dtype != dtype or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"{what} must be a contiguous {dtype}{list(shape)} on {device}, "
                             f"got {t.dtype}{list(t.shape)} on {t.device}")
    if n_rows < TR:
        raise ValueError(f"need at least one {TR} x {L} tile, got {list(g.shape)}")


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _launched(name: str, entry: str, err: int):
    if err != 0:
        raise RuntimeError(f"{entry} launch failed for probe {name}: CUDA error {err}")
    PROBE_LAUNCHES[name] += 1


def _gather(name, idx, table, g):
    from ._build import load_library
    _check(name, idx, table, g)
    out = torch.empty_like(g)
    lib = load_library()
    with torch.cuda.device(g.device):
        err = lib.tpt_probe_gather(idx.data_ptr(), table.data_ptr(), K, 0, g.numel(),
                                   out.data_ptr(), _stream(g.device))
    _launched(name, "tpt_probe_gather", err)
    return out


def _scatter(name, idx, table, g):
    from ._build import load_library
    _check(name, idx, table, g)
    rows, cols, a, c, last_tile = SCATTER[name]
    n = g.numel()
    first = n - TR * L if last_tile else 0
    a_host = torch.tensor(a, dtype=torch.float32)
    c_host = torch.tensor(c, dtype=torch.float32)
    scratch = torch.zeros(2 * R + 1, dtype=torch.float32, device=g.device)
    d = torch.empty((rows, cols), dtype=torch.float32, device=g.device)
    lib = load_library()
    with torch.cuda.device(g.device):
        err = lib.tpt_probe_scatter(idx.data_ptr(), g.data_ptr(), first, n, a_host.data_ptr(),
                                    c_host.data_ptr(), rows, cols, scratch.data_ptr(),
                                    d.data_ptr(), _stream(g.device))
    _launched(name, "tpt_probe_scatter", err)
    return d


def _elementwise(name, idx, table, g):
    from ._build import load_library
    _check(name, idx, table, g)
    out = torch.empty_like(g)
    lib = load_library()
    with torch.cuda.device(g.device):
        err = lib.tpt_probe_elementwise(g.data_ptr(), g.data_ptr(), g.numel(),
                                        int(name == "p4"), out.data_ptr(), _stream(g.device))
    _launched(name, "tpt_probe_elementwise", err)
    return out


_LAUNCH = {"probe_gather_kernel": _gather, "probe_scatter_kernel": _scatter,
           "probe_elementwise_kernel": _elementwise}


def _probe(name: str) -> Callable:
    def wrapper(idx, table, g):
        if g.device.type == "cpu":
            return globals()[f"{name}_plain"](idx, table, g)
        return _LAUNCH[KERNEL_OF[name]](name, idx, table, g)

    wrapper.__name__ = wrapper.__qualname__ = name
    wrapper.__doc__ = (f"Probe {name} of benchmarks/exp_bwd_probes.py: {KERNEL_OF[name]} on "
                       f"CUDA tensors, {name}_plain on CPU tensors.")
    return wrapper


p1, p1t, p2, p3, p4, p5, p6, p7, p8 = (_probe(name) for name in PROBES)

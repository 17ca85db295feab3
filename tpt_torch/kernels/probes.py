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
or raises (ValueError for inputs the kernel does not take, among them a g,
or for the gather and the scatter an idx, that does not start on a 16-byte
boundary: every probe kernel loads 16 bytes at a time).  The inputs' shape,
[N, 128], holds a multiple of 4 elements.
``PROBE_LAUNCHES[name]`` counts each probe's kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Dict, Tuple

import torch

from . import _build

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
#
# The launch path is lean because a probe's kernel takes a few
# microseconds: one pass of checks over the inputs (an error message is
# built only when one fails), a device guard only when g's device is not
# the current one, the raw stream handle, one output allocation and one
# ctypes call.  The scatter's column weights are built once per probe and
# its workspace once per (device, stream).

_F32, _I32, _TABLE = torch.float32, torch.int32, (R, K)


def _col_weights(a, c) -> _build.ColWeights:
    w = _build.ColWeights()
    w.a[:len(a)], w.c[:len(c)] = a, c
    return w


_WEIGHTS = {name: _col_weights(a, c) for name, (_, _, a, c, _) in SCATTER.items()}
_WEIGHT_ADDRESSES = {name: ctypes.addressof(w) for name, w in _WEIGHTS.items()}


def scatter_args(name: str, n: int):
    """The launch arguments of scatter probe ``name`` on ``n`` elements:
    (its ColWeights, built once, window first, n, rows, cols)."""
    rows, cols, _, _, last_tile = SCATTER[name]
    return _WEIGHTS[name], (n - TR * L if last_tile else 0), n, rows, cols


# (device index, raw stream) -> the scatter's workspace, of the size
# csrc/probes.cu gives (the partials and the last-block counter), zeroed
# once here; the kernel leaves the counter at 0, so the next launch on the
# stream needs no memset.  Kept for the life of the process, like the stream.
_WORKSPACES: Dict[Tuple[int, int], torch.Tensor] = {}


def _workspace(dev: int, stream: int) -> torch.Tensor:
    work = _WORKSPACES.get((dev, stream))
    if work is None:
        words, weights_bytes = ctypes.c_int64(), ctypes.c_int64()
        _build.library("probes.cu").tpt_probe_scatter_layout(ctypes.byref(words),
                                                             ctypes.byref(weights_bytes))
        if weights_bytes.value != ctypes.sizeof(_build.ColWeights):
            raise RuntimeError(f"csrc/probes.cu's ColWeights has {weights_bytes.value} bytes, "
                               f"_build.ColWeights {ctypes.sizeof(_build.ColWeights)}")
        work = torch.zeros(words.value, dtype=torch.int32, device=torch.device("cuda", dev))
        _WORKSPACES[(dev, stream)] = work
    return work


def _refused(what, t, dtype, shape, dev) -> ValueError:
    return ValueError(f"{what} must be a contiguous {dtype}{list(shape)} on cuda:{dev}, got "
                      f"{'a' if t.is_contiguous() else 'a strided'} {t.dtype}{list(t.shape)} "
                      f"on {t.device}")


def _ready(name, idx, table, g) -> int:
    """g's device index, once the three inputs pass the kernels' checks;
    raises ValueError naming the first check that fails.  Each check is
    written once, beside the error that words it."""
    if not g.is_cuda:
        raise ValueError(f"probe {name} runs its kernel on CUDA tensors, got {g.device}")
    dev, shape = g.get_device(), g.shape
    if len(shape) != 2 or shape[0] < TR or shape[1] != L:
        raise ValueError(f"g must be [N, {L}] with N >= {TR} (one {TR} x {L} tile or more), "
                         f"got {list(shape)}")
    if not (g.dtype == _F32 and g.is_contiguous()):
        raise _refused("g", g, _F32, shape, dev)
    if not (idx.dtype == _I32 and idx.shape == shape and idx.get_device() == dev
            and idx.is_contiguous()):
        raise _refused("idx", idx, _I32, shape, dev)
    if not (table.dtype == _F32 and table.shape == _TABLE and table.get_device() == dev
            and table.is_contiguous()):
        raise _refused("table", table, _F32, _TABLE, dev)
    return dev


def _aligned(name, **ptrs):
    """The kernels' 16-byte loads need each input to start on a 16-byte
    boundary."""
    for what, ptr in ptrs.items():
        if ptr % 16:
            raise ValueError(f"probe {name}: {what} must start on a 16-byte boundary for the "
                             f"kernel's 16-byte loads, got address {ptr:#x}")


def _launched(name: str, entry: str, err: int):
    if err != 0:
        raise RuntimeError(f"{entry} launch failed for probe {name}: CUDA error {err}")
    PROBE_LAUNCHES[name] += 1


def _gather(name, idx, table, g, stream):
    pi = idx.data_ptr()
    if pi % 16:
        _aligned(name, idx=pi)
    out = torch.empty_like(g)
    err = _build.library("probes.cu").tpt_probe_gather(pi, table.data_ptr(), K, 0,
                                                       g.numel(), out.data_ptr(), stream)
    _launched(name, "tpt_probe_gather", err)
    return out


def _scatter(name, idx, table, g, stream):
    pi, pg = idx.data_ptr(), g.data_ptr()
    if (pi | pg) % 16:
        _aligned(name, idx=pi, g=pg)
    _, first, n, rows, cols = scatter_args(name, g.numel())
    work = _workspace(g.get_device(), stream)
    d = g.new_empty((rows, cols))
    err = _build.library("probes.cu").tpt_probe_scatter(pi, pg, first, n,
                                                        _WEIGHT_ADDRESSES[name], rows, cols,
                                                        work.data_ptr(), d.data_ptr(), stream)
    _launched(name, "tpt_probe_scatter", err)
    return d


def _elementwise(name, idx, table, g, stream):
    x = g.data_ptr()
    if x % 16:
        _aligned(name, g=x)
    out = torch.empty_like(g)
    err = _build.library("probes.cu").tpt_probe_elementwise(x, x, g.numel(),
                                                            int(name == "p4"),
                                                            out.data_ptr(), stream)
    _launched(name, "tpt_probe_elementwise", err)
    return out


_LAUNCH = {"probe_gather_kernel": _gather, "probe_scatter_kernel": _scatter,
           "probe_elementwise_kernel": _elementwise}


def _probe(name: str) -> Callable:
    launch = _LAUNCH[KERNEL_OF[name]]

    def wrapper(idx, table, g):
        if g.is_cpu:
            return globals()[f"{name}_plain"](idx, table, g)
        dev = _ready(name, idx, table, g)
        # torch's own device and stream getters, without the Python layers
        # of torch.cuda.current_device() and current_stream()
        if dev != torch._C._cuda_getDevice():
            with torch.cuda.device(dev):
                return wrapper(idx, table, g)
        return launch(name, idx, table, g, torch._C._cuda_getCurrentRawStream(dev))

    wrapper.__name__ = wrapper.__qualname__ = name
    wrapper.__doc__ = (f"Probe {name} of benchmarks/exp_bwd_probes.py: {KERNEL_OF[name]} on "
                       f"CUDA tensors, {name}_plain on CPU tensors.")
    return wrapper


p1, p1t, p2, p3, p4, p5, p6, p7, p8 = (_probe(name) for name in PROBES)

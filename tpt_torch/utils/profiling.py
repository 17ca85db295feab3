"""Frame timing (port of tpt.utils.profiling.frame_stats), and the
program's spans and counters.

The reference's only GPU timing is a TimerQuery around the atmosphere pass
(src/Render/Objects/TimerQuery.cs); its frame rate lives in the window
title.  :func:`frame_stats` times a thunk on the host clock, synchronising
the thunk's CUDA device, and reports the frame time and the traced
segments a second.

**Spans.** :func:`span` marks a layer boundary of the program.  It is on
exactly while a torch profiler records (``torch.autograd._profiler_enabled``,
true on the recording thread and on autograd's engine threads); otherwise
it returns a shared no-op context, and the program pays one check.  When on,
a span opens the profiler range ``tpt::<name>``, so that it sits on the
profiler's timeline beside the device's operations, and appends a
:class:`SpanRecord` to an in-memory list (at most ``MAX_RECORDS``): its
start and end on ``time.time_ns()``, the clock of the profiler's own host
events, taken just inside its range, and its thread, parent span and
request.  A span opened with no
span open on its thread starts a request of its own, unless a span opened
with ``for_workers=True`` is open: that one is then its parent (autograd's
engine runs a CUDA backward on a thread of its own, with an empty stack).

**Syncs.** Each host–device synchronisation on the render's and the
training step's hot paths is wrapped in :func:`sync`, a span named
``sync.<site>``: the calls of those spans count the syncs and their time is
the host's wait.  :func:`span_totals` gives each span name's host time less
the time its ``sync.*`` descendants cover.

**Counters.** :func:`count` adds a device tensor to a named total without a
synchronisation (tpt_torch.kernels.trace counts traced segments and each
warp's longest path with it, while the profiler records); :func:`counters`
reads the totals out.  :func:`reset` clears spans and counters.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

MAX_RECORDS = 1 << 20   # span records kept; later spans still open their profiler range


def _wait(value):
    """Synchronise the CUDA devices of the tensors in ``value`` (a tensor or
    a tuple or list of them); other values need no wait."""
    values = value if isinstance(value, (tuple, list)) else (value,)
    for device in {v.device for v in values if isinstance(v, torch.Tensor)}:
        if device.type == "cuda":
            torch.cuda.synchronize(device)


def frame_stats(thunk: Callable[[], object], rays: int, n: int = 5) -> dict:
    """Time ``thunk``: one warm call, then the median of ``n`` calls, each
    synchronised on the CUDA devices of the tensors it returns (a tensor or
    a tuple of them; host values need no wait).

    Returns ms_per_frame and mrays_per_s (``rays`` traced segments a call),
    on whatever device ran the thunk."""
    _wait(thunk())
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        _wait(thunk())
        ts.append(time.perf_counter() - t0)
    sec = float(np.median(ts))
    return {"ms_per_frame": sec * 1e3, "mrays_per_s": rays / sec / 1e6}


class SpanRecord(NamedTuple):
    name: str
    start_ns: int            # time.time_ns() when the span opened
    end_ns: int
    thread: int              # threading.get_ident() of the opening thread
    id: int
    parent: Optional[int]    # the enclosing span's id; None for a request's first span
    request: int


_enabled = torch.autograd._profiler_enabled
_NULL = contextlib.nullcontext()
_RECORDS: List[SpanRecord] = []
_COUNTERS: Dict[str, torch.Tensor] = {}
_ids = itertools.count(1)
_requests = itertools.count(1)
_local = threading.local()
_worker_parent = None   # the open span opened with for_workers=True


def enabled() -> bool:
    """Whether spans and counters record now (a torch profiler is on)."""
    return _enabled()


class _Span:
    __slots__ = ("name", "for_workers", "id", "parent", "request", "start", "range",
                 "outer_worker_parent")

    def __init__(self, name: str, for_workers: bool):
        self.name, self.for_workers = name, for_workers

    def __enter__(self):
        global _worker_parent
        stack = _local.__dict__.setdefault("stack", [])
        parent = stack[-1] if stack else _worker_parent
        self.parent = parent.id if parent is not None else None
        self.request = parent.request if parent is not None else next(_requests)
        self.id = next(_ids)
        stack.append(self)
        if self.for_workers:
            self.outer_worker_parent, _worker_parent = _worker_parent, self
        self.range = torch.profiler.record_function("tpt::" + self.name)
        self.range.__enter__()
        self.start = time.time_ns()   # inside the range: its first call's set-up stays out
        return self

    def __exit__(self, *exc):
        global _worker_parent
        end = time.time_ns()
        self.range.__exit__(*exc)
        _local.stack.pop()
        if self.for_workers:
            _worker_parent = self.outer_worker_parent
        if len(_RECORDS) < MAX_RECORDS:
            _RECORDS.append(SpanRecord(self.name, self.start, end, threading.get_ident(),
                                       self.id, self.parent, self.request))
        return False


def span(name: str, *, for_workers: bool = False):
    """The span ``name`` (module docstring) while a profiler records, else a
    no-op context.  ``for_workers``: spans opened while this one is open, on
    a thread that has no span open, take it as their parent."""
    return _Span(name, for_workers) if _enabled() else _NULL


def sync(site: str, *devices):
    """The span ``sync.<site>`` around a host–device synchronisation, which
    happens only when one of ``devices`` is a CUDA device (else the no-op)."""
    if _enabled() and any(torch.device(d).type == "cuda" for d in devices):
        return _Span("sync." + site, False)
    return _NULL


def count(name: str, value: torch.Tensor):
    """Add ``value`` (an integer tensor, on any device) to the counter
    ``name``, with no synchronisation.  Callers count only while
    :func:`enabled`."""
    total = _COUNTERS.get(name)
    _COUNTERS[name] = value if total is None else total + value


def spans() -> List[SpanRecord]:
    """The span records so far, each appended when its span closed."""
    return list(_RECORDS)


def counters() -> Dict[str, int]:
    """Each counter's total (reading them synchronises their devices)."""
    return {name: int(v) for name, v in _COUNTERS.items()}


def _covered(intervals, lo: int, hi: int) -> int:
    """Length of the union of ``intervals`` clipped to [lo, hi]."""
    total, end = 0, lo
    for s, e in sorted(intervals):
        s, e = max(s, end), min(e, hi)
        if e > s:
            total, end = total + e - s, e
    return total


def span_totals() -> Dict[str, dict]:
    """By span name: ``calls``, ``ns`` (host time inside the span), ``syncs``
    (its ``sync.*`` descendants, on any thread) and ``self_ns`` (``ns`` less
    the time those descendants cover)."""
    records = list(_RECORDS)
    by_id = {r.id: r for r in records}
    under: Dict[int, list] = {}   # span id -> its sync descendants' intervals
    for r in records:
        if r.name.startswith("sync."):
            p = r.parent
            while p in by_id:
                under.setdefault(p, []).append((r.start_ns, r.end_ns))
                p = by_id[p].parent
    out: Dict[str, dict] = {}
    for r in records:
        t = out.setdefault(r.name, {"calls": 0, "ns": 0, "self_ns": 0, "syncs": 0})
        syncs = under.get(r.id, [])
        t["calls"] += 1
        t["ns"] += r.end_ns - r.start_ns
        t["self_ns"] += r.end_ns - r.start_ns - _covered(syncs, r.start_ns, r.end_ns)
        t["syncs"] += len(syncs)
    return out


def reset():
    """Forget every span record and counter."""
    _RECORDS.clear()
    _COUNTERS.clear()

"""The traced run: torch.profiler over the measured window, reduced to what
the per-layer readers and the result's ``device`` and ``breakdown`` take.

The arithmetic is tpt_torch/profile_block.py's: device time by kernel name
from the profiler, the window from CUDA events around it, the idle share
1 - busy / window.  Here busy is the union of the device operations'
intervals (kernels, copies, sets), so that nothing is counted twice.  The
benchmark's own spans (:func:`span`) mark the calls into each layer, so
that an idle gap can be named by what the host was doing.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

ACTIVE = False   # set while a traced window runs: spans are recorded only then


def span(name: str):
    """A profiler range around a call into the program, recorded in the
    traced run only (the untraced run pays nothing)."""
    if not ACTIVE:
        return contextlib.nullcontext()
    return torch.profiler.record_function(name)


@dataclasses.dataclass
class Trace:
    window_s: float                      # CUDA-event window
    busy_s: float                        # union of device operations
    device_s: Dict[str, float]           # device seconds by operation name
    idle_gaps: List[Tuple[str, float]]   # longest gaps, named by the host's activity

    def seconds(self, *fragments: str) -> float:
        """Device seconds of the operations whose name holds every fragment
        (spaces ignored)."""
        frags = [f.replace(" ", "") for f in fragments]
        return sum(s for name, s in self.device_s.items()
                   if all(f in name.replace(" ", "") for f in frags))

    def breakdown(self, n: int = 10) -> dict:
        ops = sorted(self.device_s.items(), key=lambda kv: -kv[1])[:n]
        return {"device_ops": [[name[:160], s] for name, s in ops],
                "idle_gaps": [[name[:160], s] for name, s in self.idle_gaps[:n]]}


def _union(intervals: List[Tuple[float, float]]) -> Tuple[float, List[Tuple[float, float]]]:
    """(covered length, the gaps between covered stretches)."""
    total, gaps = 0.0, []
    cur_s = cur_e = None
    for s, e in sorted(intervals):
        if cur_e is None:
            cur_s, cur_e = s, e
        elif s > cur_e:
            total += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total, gaps


def run_traced(fn):
    """Run ``fn()`` under torch.profiler (CPU and CUDA activities), between
    two CUDA events.  Returns (fn's result, :class:`Trace`).  The profiler's
    raw event list is read, not its event tree, whose building would take
    minutes for a window of host-bound steps."""
    global ACTIVE
    from torch.profiler import ProfilerActivity, profile

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ACTIVE = True
        try:
            start.record()
            out = fn()
            end.record()
            torch.cuda.synchronize()
        finally:
            ACTIVE = False
    window_s = start.elapsed_time(end) / 1e3
    return out, reduce(prof.profiler.kineto_results.events(), window_s)


def reduce(events, window_s: float) -> Trace:
    """Device seconds by operation name, busy time, and the longest idle
    gaps, from the profiler's raw events (times in ns)."""
    device, host = [], []
    for e in events:
        kind = e.device_type().name
        s, d = e.start_ns(), e.duration_ns()
        if d <= 0:
            continue
        if kind == "CUDA":
            # a range's copy on the device timeline is no operation
            if not (e.is_user_annotation() or e.name().startswith("portbench.")):
                device.append((s, s + d, e.name()))
        elif kind == "CPU":
            host.append((s, s + d, e.name()))
    device_s: Dict[str, float] = {}
    for s, t, name in device:
        device_s[name] = device_s.get(name, 0.0) + (t - s) / 1e9
    busy_ns, gaps = _union([(s, t) for s, t, _ in device])
    gaps.sort(key=lambda g: g[0] - g[1])
    return Trace(window_s=window_s, busy_s=busy_ns / 1e9, device_s=device_s,
                 idle_gaps=_name_gaps(gaps[:10], host))


def _name_gaps(gaps, host) -> List[Tuple[str, float]]:
    """Each gap named by the innermost host operation running at its middle,
    inside the benchmark span that encloses it."""
    ops = sorted(host)
    starts = [o[0] for o in ops]
    out = []
    for g0, g1 in gaps:
        mid = 0.5 * (g0 + g1)
        i = bisect.bisect_right(starts, mid)
        inner: Optional[Tuple[float, float, str]] = None
        outer = None
        for s, t, name in reversed(ops[max(0, i - 4000):i]):
            if s <= mid <= t:
                if inner is None or s >= inner[0]:
                    inner = (s, t, name)
                if name.startswith("portbench.") and (outer is None or s >= outer[0]):
                    outer = (s, t, name)
        label = inner[2] if inner else "host outside any profiled operation"
        if outer and inner and outer[2] != inner[2]:
            label = f"{outer[2]} > {label}"
        out.append((label, (g1 - g0) / 1e9))
    return out

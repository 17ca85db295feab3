"""Host ms a step inside the program's ``optim.render`` spans (the target
and the gradient renders: the trace wrapper, trace_diff's set-up, the
blocked environment fetch), less the time their ``sync.*`` spans wait: the
renders' own enqueue work.  None for a program without the spans."""


def read(view):
    try:
        from tpt_torch.utils.profiling import span_totals
    except ImportError:
        return None
    t, steps = span_totals().get("optim.render"), view["counts"].get("steps", 0)
    return t["self_ns"] / steps / 1e6 if t and steps > 0 else None

"""Host ms a step inside the program's ``optim.adam`` spans (the mask,
clipped Adam's update, the parameters' add), less the time their
``sync.*`` spans wait: the optimizer's own enqueue work.  None for a
program without the spans."""


def read(view):
    try:
        from tpt_torch.utils.profiling import span_totals
    except ImportError:
        return None
    t, steps = span_totals().get("optim.adam"), view["counts"].get("steps", 0)
    return t["self_ns"] / steps / 1e6 if t and steps > 0 else None

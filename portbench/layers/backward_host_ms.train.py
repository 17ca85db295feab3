"""Host ms a step inside the program's ``optim.backward`` spans (autograd
through trace_diff's backward and the environment fetch's), less the time
the ``sync.*`` spans inside them wait, on any thread: the backward's own
enqueue work.  None for a program without the spans."""


def read(view):
    try:
        from tpt_torch.utils.profiling import span_totals
    except ImportError:
        return None
    t, steps = span_totals().get("optim.backward"), view["counts"].get("steps", 0)
    return t["self_ns"] / steps / 1e6 if t and steps > 0 else None

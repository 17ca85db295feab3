"""Host-device synchronisations a step: every ``sync.*`` span of the
program over the window (the target renders, the step and its backward),
per step.  None for a program without the spans."""


def read(view):
    try:
        from tpt_torch.utils.profiling import span_totals
    except ImportError:
        return None
    totals, steps = span_totals(), view["counts"].get("steps", 0)
    if "optim.step" not in totals or steps <= 0:
        return None
    return sum(t["calls"] for name, t in totals.items() if name.startswith("sync.")) / steps

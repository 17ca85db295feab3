"""Host ms a block inside the program's ``render.block`` span, less the
time its ``sync.*`` spans wait: the program's own enqueue work (argument
checks, allocations, the camera, the launch, the fold).  None for a
program without the spans."""


def read(view):
    try:
        from tpt_torch.utils.profiling import span_totals
    except ImportError:
        return None
    t, blocks = span_totals().get("render.block"), view["counts"].get("launches", 0)
    return t["self_ns"] / blocks / 1e6 if t and blocks > 0 else None

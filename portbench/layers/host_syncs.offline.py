"""Host-device synchronisations a block: the program's ``sync.*`` spans
under its ``render.block`` spans over the window's blocks.  None for a
program without the spans."""


def read(view):
    try:
        from tpt_torch.utils.profiling import span_totals
    except ImportError:
        return None
    t, blocks = span_totals().get("render.block"), view["counts"].get("launches", 0)
    return t["syncs"] / blocks if t and blocks > 0 else None

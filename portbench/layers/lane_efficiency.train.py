"""Lane efficiency of the one-frame (select) trace kernel over the window's
target and gradient renders, in %: 100 x the traced segments over 32 x the
sum of each warp's longest path (the program's counters ``trace.select.*``,
kept on the device while the profiler records).  None for a program
without them."""


def read(view):
    try:
        from tpt_torch.utils.profiling import counters
    except ImportError:
        return None
    c = counters()
    segments, warp_max = c.get("trace.select.segments"), c.get("trace.select.warp_max_segments")
    return 100.0 * segments / (32.0 * warp_max) if segments and warp_max else None

"""Device milliseconds a draw spends outside the trace kernel in the
viewer: the environment fetch, the mix, the tonemap, the uint8 image and
its copy to the host."""

KERNEL = "trace_progressive_kernel"


def read(view):
    t, c = view["trace"], view["counts"]
    if c.get("draws", 0) <= 0 or t.busy_s <= 0:
        return None
    return (t.busy_s - t.seconds(KERNEL)) / c["draws"] * 1e3

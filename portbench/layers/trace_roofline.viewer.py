"""The per-frame (select) trace kernel's share of its roofline in the
viewer: the least time of the window's draws (portbench.counts.trace_bound
per launch: the traced segments the draws returned, every sample's camera
ray, the miss slots written) over the kernel's device time."""

from portbench.counts import trace_bound

KERNEL = "trace_progressive_kernel<false,false,false>"


def read(view):
    t, c = view["trace"], view["counts"]
    kernel_s = t.seconds(KERNEL)
    n = c.get("launches", 0)
    if kernel_s <= 0 or n <= 0:
        return None
    per_launch_ms, _ = trace_bound(c["segments"] / n, c["samples"] / n, c["pixels"],
                                   c["slots"], c["counts"])
    return 100.0 * per_launch_ms * n / 1e3 / kernel_s

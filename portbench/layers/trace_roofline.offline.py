"""The environment-mode trace kernel's share of its roofline in the offline
render: the least time for the window's work (portbench.counts.trace_bound
per launch: the traced segments the program counted, every sample's camera
ray, each escape's environment lookup at the reference's escapes per
frame) over the kernel's device time."""

from portbench.counts import trace_bound

KERNEL = "trace_progressive_kernel<false,true,false>"


def read(view):
    t, c = view["trace"], view["counts"]
    kernel_s = t.seconds(KERNEL)
    n = c.get("launches", 0)
    if kernel_s <= 0 or n <= 0 or "escapes_per_frame" not in c:
        return None
    per_launch_ms, _ = trace_bound(c["segments"] / n, c["samples"] / n, c["pixels"], 0,
                                   c["counts"], env_bytes=c["env_bytes"],
                                   escapes=c["escapes_per_frame"] * c["frames"] / n)
    return 100.0 * per_launch_ms * n / 1e3 / kernel_s

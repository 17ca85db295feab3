"""The backward kernels' share of their roofline in the training step: the
least time of the tape and adjoint kernels' work (portbench.counts.
grad_kernel_bounds per gradient render, at the segments a gradient render
traced in the reference's checked steps) over the two kernels' device
time."""

from portbench.counts import grad_kernel_bounds

KERNELS = ("trace_grad_tape_kernel", "trace_grad_adjoint_kernel")


def read(view):
    t, c = view["trace"], view["counts"]
    kernel_s = sum(t.seconds(k) for k in KERNELS)
    n = c.get("grad_renders", 0)
    if kernel_s <= 0 or n <= 0 or "segments_per_render" not in c:
        return None
    samples = c["pixels"] * c["spp"]
    b = grad_kernel_bounds(c["segments_per_render"], samples, c["pixels"], c["spp"], c["counts"])
    per_render_ms = b["tape"][0] + b["adjoint"][0]
    return 100.0 * per_render_ms * n / 1e3 / kernel_s

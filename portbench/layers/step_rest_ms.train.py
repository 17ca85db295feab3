"""Device milliseconds a training step spends outside the forward, tape and
adjoint kernels: the environment fetch and its backward, the loss, the
maps from the attribute table to the materials, clipped Adam."""

KERNELS = ("trace_progressive_kernel", "trace_grad_tape_kernel", "trace_grad_adjoint_kernel")


def read(view):
    t, c = view["trace"], view["counts"]
    if c.get("steps", 0) <= 0 or t.busy_s <= 0:
        return None
    return (t.busy_s - sum(t.seconds(k) for k in KERNELS)) / c["steps"] * 1e3

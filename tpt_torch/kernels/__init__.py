"""Hand-written CUDA kernels of the port, their wrappers and plain versions.

Submodules are imported explicitly (``tpt_torch.kernels.trace``,
``tpt_torch.kernels.trace_grad``, ``tpt_torch.kernels.render``); nothing
here builds or loads a kernel."""

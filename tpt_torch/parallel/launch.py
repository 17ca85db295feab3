"""Start a world of local ranks and collect what each returns.

``torch.distributed`` runs one process per rank.  :func:`launch` spawns
``world_size`` of them on this host (``torch.multiprocessing``, the spawn
method), joins them into one process group through a ``file://`` store in a
temporary directory (so concurrent launches never contend for a TCP port),
runs ``fn(*args)`` in each and returns the ranks' return values, in rank
order.  ``fn`` must be a module-level function of an importable module: a
spawned rank imports the module that holds it.

    from tpt_torch.parallel import launch
    from tpt_torch.parallel.runs import run_jobs
    results = launch(run_jobs, 4, setup, jobs, backend="gloo")

Each rank runs with one intra-op thread (``torch.set_num_threads(1)``).
``device="cuda"``, the default, puts rank r on card ``r % device_count``
and raises at once where there is no card (``device="cpu"`` asks for the
CPU, as the tests do); ``"cuda:0"``
puts every rank on card 0, as a smoke run on one card does); NCCL needs a
card for each rank, so ranks that share a card use gloo, which reduces CUDA
tensors through host memory.
"""

from __future__ import annotations

import os
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def default_backend(world_size: int, device) -> str:
    """NCCL when every rank has a card of its own, else gloo."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None \
            and world_size <= torch.cuda.device_count():
        return "nccl"
    if device.type == "cuda" and world_size == 1:
        return "nccl"
    return "gloo"


def _rank_main(rank, fn, args, world_size, init_method, backend, device, out_dir):
    from .init import init_distributed
    torch.set_num_threads(1)
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device.index if device.index is not None
                              else rank % torch.cuda.device_count())
    init_distributed(init_method, world_size, rank, backend)
    try:
        torch.save(fn(*args), os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def launch(fn, world_size: int, *args, backend: str | None = None, device="cuda",
           timeout: float = 900.0) -> list:
    """Run ``fn(*args)`` on ``world_size`` local ranks; returns their
    results in rank order.  A rank that raises makes this raise (the others
    are terminated); a world still running after ``timeout`` seconds is
    killed and raises ``TimeoutError``.  A CUDA ``device`` with no card
    raises RuntimeError before any rank starts."""
    if world_size < 1:
        raise ValueError(f"world_size must be >= 1, got {world_size}")
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"launch(device={str(device)!r}): no CUDA device is available; "
                           f"pass device='cpu' to run the ranks on the CPU")
    backend = backend or default_backend(world_size, device)
    with tempfile.TemporaryDirectory(prefix="tpt_launch_") as tmp:
        init_method = "file://" + os.path.join(tmp, "store")
        ctx = mp.start_processes(
            _rank_main, args=(fn, args, world_size, init_method, backend, str(device), tmp),
            nprocs=world_size, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=0.2):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{world_size} ranks still running after {timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                for r in range(world_size)]

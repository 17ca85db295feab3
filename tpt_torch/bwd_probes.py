"""Run the backward-design probes through the port (counterpart of
benchmarks/exp_bwd_probes.py).

    python -m tpt_torch.bwd_probes [p1 p1t ...] [--device cuda|cpu]

The inputs have the harness's shapes — idx i32[GRID*16, 128] in [0, 55),
table f32[128, 32], g f32[GRID*16, 128], GRID = 100 — drawn from a
torch.Generator seeded 0 (``randint`` and ``randn``: the distributions of
the harness's jax.random draws, not its numbers).  Each probe is called
once, then three times under the clock (CUDA events on the card), and
prints one line in the harness's format.  Unlike the harness, which prints
FAIL and exits 0, a probe that raises or returns a wrong shape or a
non-finite value makes the run exit 1.  The default device is the card.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from .kernels import probes as P

GRID = 100
N_VALUES = 55   # winner rows drawn for idx


def make_inputs(grid: int = GRID, device="cpu", seed: int = 0):
    """(idx, table, gvals) at the harness's shapes for ``grid`` tiles."""
    gen = torch.Generator().manual_seed(seed)
    idx = torch.randint(0, N_VALUES, (grid * P.TR, P.L), generator=gen, dtype=torch.int32)
    table = torch.randn((P.R, P.K), generator=gen)
    gvals = torch.randn((grid * P.TR, P.L), generator=gen)
    return idx.to(device), table.to(device), gvals.to(device)


def time_calls(fn, device, reps: int = 3) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` calls: CUDA events on
    the card, the host clock on the CPU."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e3


def run(name: str, inputs, device) -> bool:
    """One probe: a warm-up call, three timed calls, one line.  Returns
    whether it passed."""
    fn = getattr(P, name)
    try:
        out = fn(*inputs)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        want = P.output_shape(name, inputs[2].shape[0])
        if tuple(out.shape) != want or not bool(torch.isfinite(out).all()):
            raise ValueError(f"output {list(out.shape)} (want {list(want)}) or not finite")
        ms = time_calls(lambda: fn(*inputs), device)
        print(f"{name:12s}: OK   {ms:8.2f} ms/3calls", flush=True)
        return True
    except Exception as e:  # noqa: BLE001 - the harness reports every failure and carries on
        msg = str(e).replace("\n", " ")[:160]
        print(f"{name:12s}: FAIL {type(e).__name__}: {msg}", flush=True)
        return False


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("probes", nargs="*", metavar="PROBE",
                    help=f"probes to run (default all: {' '.join(P.PROBES)})")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    unknown = [p for p in args.probes if p not in P.PROBES]
    if unknown:
        ap.error(f"unknown probes {unknown}; choose from {' '.join(P.PROBES)}")
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("bwd_probes: no CUDA device (pass --device cpu for the plain versions)")
    device = torch.device(args.device)
    inputs = make_inputs(GRID, device)
    results = [run(name, inputs, device) for name in args.probes or P.PROBES]
    return 0 if all(results) else 1


if __name__ == "__main__":
    sys.exit(main())

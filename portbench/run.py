"""Run one cell of tpt_torch's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds tpt_torch.  The cell's set-up
builds what it launches (into tpt_torch/_build/) and warms its shapes; the
window then drives the program for ``--seconds`` seconds; after it, with
the program's state freed, the plain reference (portbench/reference/)
checks a sample of the window's answers drawn from the seed.  With
``--trace 0`` the result reports the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, read from torch.profiler over the
window.

The last line of standard output is the result, one JSON object; the
compared numbers with their limits are the last lines of standard error
and the result's last key.  Exits non-zero, with no result, when there is
no CUDA card (or fewer than the cell asks for), or when JAX or the JAX
package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def prepare_environment():
    """Every cache of the program and its libraries at a fixed path inside
    the checkout, and the checkout's root first on the import path."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(ROOT / ".portbench_cache" / sub)
    os.environ["USE_FLAX"] = "0"
    sys.path[:] = [str(ROOT)] + [p for p in sys.path
                                 if Path(p or ".").resolve() != ROOT / "portbench"]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="portbench/run.py", description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True, help="a cell's name in BENCHMARK.json")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True, help="length of the measured window")
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    prepare_environment()
    import torch

    from portbench import harness

    benchmark = harness.load_benchmark()
    entry = harness.cell_entry(benchmark, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(entry["chips"]):
        print(f"portbench: the cell needs {entry['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    cell = harness.load_cell(args.workload, args.seed)
    result = harness.run_cell(cell, benchmark, args.seconds, bool(args.trace), T_START,
                              log=lambda line: print(line, flush=True))
    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {', '.join(bad)}; no result", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

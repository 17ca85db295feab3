"""Readings that set a cell's limits: the compared numbers of sound runs over
many seeds, of the control (the program's bf16 environment table) and of
planted faults, all at the cell's own size, in one process.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        --variants none,control --seconds 2 [--out readings.jsonl]

One JSON line per (seed, variant): the compared numbers, the window's
summary and the set-up seconds.  The benchmark's own runs never run this;
it is how the limits in ``workloads/<cell>.json`` were read (PERF.md).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from portbench.run import prepare_environment  # noqa: E402


def readings(name: str, seed: int, variant, seconds: float, device: str = "cuda") -> dict:
    from portbench import harness

    cell = harness.load_cell(name, seed, device=device)
    t0 = time.perf_counter()
    drv = harness.driver_class(cell)(cell, variant=variant)
    drv.setup()
    drv.sync()
    setup_s = time.perf_counter() - t0
    window = drv.window(seconds)
    drv.free()
    t1 = time.perf_counter()
    checks = drv.check()
    return {"cell": name, "seed": seed, "variant": variant or "none",
            "checks": {c.name: c.value for c in checks}, "notes": drv.notes,
            "summary": window["summary"],
            "setup_s": setup_s, "check_s": time.perf_counter() - t1}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench/calibrate.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--variants", default="none,control", help="comma-separated: none, "
                    "control or a driver's fault")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    prepare_environment()
    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    out = open(args.out, "a") if args.out else None
    try:
        for seed in (int(s) for s in args.seeds.split(",")):
            for v in args.variants.split(","):
                rec = readings(args.workload, seed, None if v == "none" else v, args.seconds)
                line = json.dumps(rec)
                print(line, flush=True)
                if out:
                    out.write(line + "\n")
                    out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())

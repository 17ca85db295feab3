"""One run of one cell: find the cell's files by name, set up, measure the
window, read the per-layer metrics, check the answers against the plain
reference, and build the result line.

Everything particular to a cell is data or a file of its own:

* ``BENCHMARK.json`` (the repository root): the cells, the metrics, which
  cell reports which metric;
* ``workloads/<cell>.json``: the configuration's name, the driver's name,
  the traffic parameters and the limit of each compared number;
* ``configs/<config>.json``: the scene's arrays and the render settings;
* ``drivers/<driver>.py``: a ``Driver`` class per kind of traffic;
* ``layers/<metric>.py``: a ``read(view)`` per per-layer metric.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level modules that no run may load: JAX, its libraries, and the JAX
# package with its harness (compared as whole top-level names: the port's
# name, tpt_torch, begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "tpt", "benchmarks", "bench", "chip_smoke")


@dataclasses.dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    seed: int
    device: str = "cuda"

    @property
    def traffic(self) -> dict:
        return self.workload["traffic"]


@dataclasses.dataclass
class Check:
    """One compared number with its limit; the run is correct when every
    value is at most its limit."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def load_cell(name: str, seed: int, root: Path = ROOT, device: str = "cuda") -> Cell:
    bench = root / "portbench"
    with open(bench / "workloads" / f"{name}.json") as f:
        workload = json.load(f)
    with open(bench / "configs" / f"{workload['config']}.json") as f:
        config = json.load(f)
    return Cell(name=name, workload=workload, config=config, seed=int(seed), device=device)


def cell_entry(benchmark: dict, name: str) -> dict:
    for w in benchmark["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"portbench: no cell {name!r} in BENCHMARK.json")


def metrics_for(benchmark: dict, cell: str, kind: str) -> List[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics that ``cell`` reports: a
    metric with ``workloads`` names its cells; one without it is reported by
    every cell (an end-to-end metric) or by every cell that reports the
    end-to-end metric it moves (a per-layer metric)."""
    e2e = [m for m in benchmark["end_to_end"] if cell in m.get("workloads", [cell])]
    if kind == "end_to_end":
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in benchmark["per_layer"]
            if cell in m.get("workloads", [cell]) and m["moves"] in names]


def driver_class(cell: Cell):
    return importlib.import_module(f"portbench.drivers.{cell.workload['driver']}").Driver


def reader(metric: str, root: Path = ROOT) -> Callable:
    path = root / "portbench" / "layers" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench.layers." + metric.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card_line(*fields: str) -> str:
    """One nvidia-smi reading of the card (``fields`` of --query-gpu)."""
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={','.join(fields)}",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else out.stderr.strip()
    except (OSError, subprocess.SubprocessError, IndexError) as exc:
        return f"nvidia-smi not read: {exc}"


def built_libraries() -> Dict[str, float]:
    """The program's kernel libraries present now, with the nvcc seconds
    each build took (its .log's last line)."""
    from tpt_torch.kernels import _build
    out = {}
    for path in sorted(_build.BUILD_DIR.glob("*/*.so")):
        out[str(path.relative_to(_build.BUILD_DIR))] = _build.build_seconds(path)
    return out


def run_cell(cell: Cell, benchmark: dict, seconds: float, trace: bool,
             t_start: float, variant: Optional[str] = None,
             log: Callable[[str], None] = print, root: Path = ROOT) -> dict:
    """One run: set-up, window (traced or not), the per-layer readers, the
    reference check.  Returns the result line's object."""
    import torch

    cuda = cell.device == "cuda"
    if cuda:
        log(f"card: {card_line('name', 'power.limit', 'clocks.max.sm')}")
        before = built_libraries()
    drv = driver_class(cell)(cell, variant=variant)
    drv.setup()
    if cuda:
        torch.cuda.synchronize()
        cold = {k: v for k, v in built_libraries().items() if k not in before}
        log(f"nvcc: {len(cold)} libraries built in this run "
            + (json.dumps(cold) if cold else "(all found built)"))
        log(f"card before the window: {card_line('clocks.sm', 'power.draw', 'temperature.gpu')}")
    setup_s = time.perf_counter() - t_start

    trace_out = None
    if trace:
        from . import tracing
        window, trace_out = tracing.run_traced(lambda: drv.window(seconds))
    else:
        window = drv.window(seconds)
    device = {"platform": "gpu" if cuda else "cpu", "kind": "cpu", "count": 1,
              "memory_peak_bytes": 0}
    if cuda:
        device.update(kind=torch.cuda.get_device_name(0),
                      memory_peak_bytes=int(torch.cuda.max_memory_allocated()))
        log(f"card after the window: {card_line('clocks.sm', 'power.draw', 'temperature.gpu')}")
        from tpt_torch.kernels import trace as K
        log("launches by build: " + json.dumps({str(k): v for k, v in K.BUILD_LAUNCHES.items()}))
    log(f"window: {json.dumps(window['summary'])}")
    drv.free()
    checks = drv.check()
    log(f"check: {json.dumps(drv.notes)}")
    counts = dict(window["counts"], **drv.ref_counts)

    metrics = {}
    if trace:
        device.update(busy_s=trace_out.busy_s, window_s=trace_out.window_s)
        view = dict(trace=trace_out, counts=counts, cell=cell.name)
        for m in metrics_for(benchmark, cell.name, "per_layer"):
            value = reader(m["name"], root)(view)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(window["end_to_end"], setup_s=setup_s)
        for m in metrics_for(benchmark, cell.name, "end_to_end"):
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}

    failed = [c for c in checks if not c.ok]
    result = {"correct": not failed, "attempted": window["attempted"],
              "failed": drv.wrong if failed else 0, "metrics": metrics, "device": device}
    if trace:
        result["breakdown"] = trace_out.breakdown()
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in checks}
    return result

"""The harness on the CPU: its flags, its refusal without a card,
BENCHMARK.json's shape, which cell reports which metric, that a new cell
and a new metric are data and a file found by name, and that nothing it
loads is JAX or the JAX package."""

import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import harness, run

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")
ENTRY_KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def benchmark():
    return harness.load_benchmark(ROOT)


def test_flags_parse():
    args = run.parse_args(["--workload", "demo.offline-1080p", "--seed", "3000000000",
                           "--seconds", "10", "--trace", "1"])
    assert (args.workload, args.seed, args.seconds, args.trace) == ("demo.offline-1080p",
                                                                    3000000000, 10.0, 1)
    with pytest.raises(SystemExit):
        run.parse_args(["--workload", "x", "--seed", "1", "--seconds", "1", "--trace", "2"])


def test_no_card_exits_nonzero_with_no_result(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, str(ROOT / "portbench" / "run.py"), "--workload",
                          "demo.offline-1080p", "--seed", "5", "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "metrics" not in out.stdout and "{" not in out.stdout


def test_benchmark_names_units_and_keys():
    b = benchmark()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert 1 <= b["run_seconds"] <= 51 and b["paths"] == ["portbench"]
    names = set()
    for kind, keys in ENTRY_KEYS.items():
        for e in b[kind]:
            extra = set(e) - keys - ({"workloads"} if kind in ("end_to_end", "per_layer") else set())
            assert keys <= set(e) and not extra, (kind, e["name"])
            assert NAME.match(e["name"]) and e["name"] not in names
            names.add(e["name"])
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
            for k in ("why", "layer", "source"):
                if k in e and kind != "end_to_end" and kind != "per_layer":
                    assert LINE.match(e[k])
            if "layer" in e:
                assert LINE.match(e["layer"])
    for c in b["configs"]:
        assert c["file"].startswith("portbench/") and (ROOT / c["file"]).exists()
        assert all(NAME.match(k) for k in c["reduced"])
    for w in b["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert (ROOT / "portbench" / "workloads" / f"{w['name']}.json").exists()
    assert len(json.dumps(b)) < 64 * 1024


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    b = benchmark()
    for w in b["workloads"]:
        e2e = {m["name"] for m in harness.metrics_for(b, w["name"], "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert harness.metrics_for(b, w["name"], "per_layer")


def test_every_layer_metric_moves_a_metric_its_cells_report():
    b = benchmark()
    for m in b["per_layer"]:
        for cell in m["workloads"]:
            e2e = {x["name"] for x in harness.metrics_for(b, cell, "end_to_end")}
            assert m["moves"] in e2e, (m["name"], cell)
            assert m in harness.metrics_for(b, cell, "per_layer")
        assert (ROOT / "portbench" / "layers" / f"{m['name']}.py").exists()


def test_a_new_cell_and_metric_are_found_with_no_other_edit(tmp_path):
    """A workload file, a reader file and their entries, dropped into a copy
    of the benchmark, are found by name; nothing else changes."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    wl = json.loads((ROOT / "portbench" / "workloads" / "demo.offline-1080p.json").read_text())
    wl["traffic"].update(width=20, height=12, frames_per_block=2)
    wl["traffic"]["checked"]["below"] = 2
    (tmp_path / "portbench" / "workloads" / "demo.offline-tiny.json").write_text(json.dumps(wl))
    (tmp_path / "portbench" / "layers" / "blocks_a_second.offline.py").write_text(
        "def read(view):\n    return view['counts']['launches'] / view['trace'].window_s\n")
    b = json.loads((tmp_path / "BENCHMARK.json").read_text())
    b["workloads"].append({"name": "demo.offline-tiny", "config": "demo", "traffic": "tiny",
                           "chips": 1, "why": "a tiny copy of the offline cell"})
    b["end_to_end"][0]["workloads"].append("demo.offline-tiny")
    b["per_layer"].append({"name": "blocks_a_second.offline", "unit": "1/s", "better": "higher",
                           "source": "device_trace", "layer": "device",
                           "moves": "mrays_per_s", "workloads": ["demo.offline-tiny"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))

    bench = harness.load_benchmark(tmp_path)
    cell = harness.load_cell("demo.offline-tiny", 9, root=tmp_path, device="cpu")
    assert [m["name"] for m in harness.metrics_for(bench, cell.name, "per_layer")] == [
        "blocks_a_second.offline"]

    class View:
        window_s = 2.0
    assert harness.reader("blocks_a_second.offline", tmp_path)(
        {"trace": View(), "counts": {"launches": 10}}) == 5.0
    result = harness.run_cell(cell, bench, 1.0, False,
                              0.0, log=lambda s: None, root=tmp_path)
    assert result["correct"] and set(result["metrics"]) == {"mrays_per_s", "setup_s"}
    assert list(result)[-1] == "checks"


def test_harness_and_reference_load_no_jax_and_no_tpt():
    """Every module of the benchmark imported in a fresh process: no
    top-level name is jax, jaxlib, flax or tpt (whole names: tpt_torch is
    the program); the reference alone loads nothing of the program."""
    code = (
        "import sys, pathlib, importlib\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "import portbench.reference.paths, portbench.reference.controller\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in "
        "('tpt_torch', 'tpt', 'jax', 'jaxlib', 'flax')], 'reference'\n"
        "import portbench.harness, portbench.run, portbench.tracing, portbench.counts, "
        "portbench.traffic, portbench.calibrate\n"
        "for d in ('offline', 'viewer', 'inverse'):\n"
        "    importlib.import_module('portbench.drivers.' + d)\n"
        "for p in pathlib.Path('portbench/layers').glob('*.py'):\n"
        "    portbench.harness.reader(p.stem)\n"
        "import tpt_torch, tpt_torch.interactive, tpt_torch.optim, tpt_torch.kernels.render\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
        "print(portbench.harness.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300, env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode == 0, out.stderr
    tops, bad = (eval(line) for line in out.stdout.strip().splitlines()[-2:])
    assert bad == [] and not {"jax", "jaxlib", "flax", "tpt"} & set(tops)

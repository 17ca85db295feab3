"""The readers of the program's spans and counters (tpt_torch.utils.
profiling): each gives its number from planted totals and None where its
span or counter is missing or the program has none; their entries keep the
benchmark's contract.  On the card (``cuda``), a traced run of each cell
reports all of them, and over the offline window the program's segment
counter equals the window's own count (each block's ``int(rays)``)."""

import json

import pytest
import torch

from portbench import harness
from tpt_torch.utils import profiling

OFF, TRAIN = "demo.offline-1080p", "demo-inverse.1080p-one-view"
NEW = {OFF: ("lane_efficiency.offline", "host_syncs.offline", "host_ms.offline"),
       TRAIN: ("lane_efficiency.train", "host_syncs.train", "render_host_ms.train",
               "backward_host_ms.train", "adam_host_ms.train")}
VIEW = {OFF: {"counts": {"launches": 4}}, TRAIN: {"counts": {"steps": 5}}}


def totals(name, calls, ns, self_ns, syncs):
    return {name: {"calls": calls, "ns": ns, "self_ns": self_ns, "syncs": syncs}}


SPANS = {**totals("render.block", 4, 48_000_000, 40_000_000, 8),
         **totals("render.fold", 4, 2_000_000, 1_000_000, 4),
         **totals("optim.step", 5, 60_000_000, 50_000_000, 40),
         **totals("optim.render", 10, 30_000_000, 20_000_000, 30),
         **totals("optim.backward", 5, 15_000_000, 12_500_000, 0),
         **totals("optim.adam", 5, 6_000_000, 5_000_000, 0),
         **totals("sync.div_scalar", 15, 3_000_000, 3_000_000, 0),
         **totals("sync.camera_matrix", 20, 4_000_000, 4_000_000, 0),
         **totals("sync.fold_denominator", 4, 1_000_000, 1_000_000, 0)}
COUNTERS = {"trace.env.segments": 3 * 32 * 1000, "trace.env.warp_max_segments": 4000,
            "trace.select.segments": 32 * 900, "trace.select.warp_max_segments": 1000}
WANT = {"lane_efficiency.offline": 75.0, "host_syncs.offline": 2.0, "host_ms.offline": 10.0,
        "lane_efficiency.train": 90.0, "host_syncs.train": 39 / 5,
        "render_host_ms.train": 4.0, "backward_host_ms.train": 2.5, "adam_host_ms.train": 1.0}
SOURCE = {"lane_efficiency.offline": ("counters", ("trace.env.segments",)),
          "lane_efficiency.train": ("counters", ("trace.select.warp_max_segments",)),
          "host_syncs.offline": ("span_totals", ("render.block",)),
          "host_ms.offline": ("span_totals", ("render.block",)),
          "host_syncs.train": ("span_totals", ("optim.step",)),
          "render_host_ms.train": ("span_totals", ("optim.render",)),
          "backward_host_ms.train": ("span_totals", ("optim.backward",)),
          "adam_host_ms.train": ("span_totals", ("optim.adam",))}
ALL = [(cell, m) for cell, names in NEW.items() for m in names]


def plant(monkeypatch, spans, counters):
    monkeypatch.setattr(profiling, "span_totals", lambda: dict(spans))
    monkeypatch.setattr(profiling, "counters", lambda: dict(counters))


@pytest.mark.parametrize("cell,metric", ALL)
def test_reader_reads_planted_totals(monkeypatch, cell, metric):
    plant(monkeypatch, SPANS, COUNTERS)
    assert harness.reader(metric)(VIEW[cell]) == pytest.approx(WANT[metric], rel=1e-12)


@pytest.mark.parametrize("cell,metric", ALL)
def test_reader_gives_none_without_its_total(monkeypatch, cell, metric):
    kind, keys = SOURCE[metric]
    spans = {k: v for k, v in SPANS.items() if kind != "span_totals" or k not in keys}
    counters = {k: v for k, v in COUNTERS.items() if kind != "counters" or k not in keys}
    plant(monkeypatch, spans, counters)
    assert harness.reader(metric)(VIEW[cell]) is None
    plant(monkeypatch, SPANS, COUNTERS)   # no blocks or steps counted
    if kind == "span_totals":
        assert harness.reader(metric)({"counts": {}}) is None
    monkeypatch.delattr(profiling, kind)   # a program without the spans and counters
    assert harness.reader(metric)(VIEW[cell]) is None


def test_entries_name_one_cell_each_and_read_the_program():
    b = harness.load_benchmark()
    entries = {m["name"]: m for m in b["per_layer"]}
    for cell, names in NEW.items():
        for name in names:
            m = entries[name]
            assert m["workloads"] == [cell]
            assert m["source"] == ("program_counter" if name.startswith("lane_efficiency")
                                   else "program_span")
            assert m in harness.metrics_for(b, cell, "per_layer")
    # the kernel's lane efficiency is the trace kernel's layer, as its roofline is
    assert entries["lane_efficiency.offline"]["layer"] == entries["trace_roofline.offline"]["layer"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU form")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("cell_name", [OFF, TRAIN])
def test_a_traced_run_reports_every_program_metric(card, cell_name):
    profiling.reset()
    lines = []
    cell = harness.load_cell(cell_name, 3_141_592_654, device=card)
    if "checked" in cell.traffic:   # answers the short window reaches
        cell.traffic["checked"]["below"] = 20
    result = harness.run_cell(cell, harness.load_benchmark(), 3.0, True, 0.0,
                              log=lines.append)
    assert result["correct"], result["checks"]
    got = {m: result["metrics"].get(m, {}).get("value") for m in NEW[cell_name]}
    assert all(isinstance(v, float) for v in got.values()), got
    lane = [v for m, v in got.items() if m.startswith("lane_efficiency")]
    assert len(lane) == 1 and 0 < lane[0] <= 100
    if cell_name == OFF:
        window = json.loads(next(x for x in lines if x.startswith("window: "))[len("window: "):])
        assert profiling.counters()["trace.env.segments"] == window["segments"]
    profiling.reset()

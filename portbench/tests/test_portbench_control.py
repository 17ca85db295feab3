"""The control on the card: each cell at its own size, driven as a run
drives it (set-up, a one-second window, the reference), once sound and once
with the program's bf16 environment table in place of the f32 one (the
lower precision its output check has to catch).  The sound run must come
out correct and the control not.  Run on the card with
``python -m pytest portbench/tests -q``; the cell-size readings are
``portbench/calibrate.py``'s (PERF.md)."""

import pytest
import torch

from portbench import harness

pytestmark = pytest.mark.cuda

CELLS = ("demo.offline-1080p", "demo.viewer-832", "demo-inverse.512-two-views",
         "demo-inverse.1080p-one-view")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU form")
    return "cuda"


@pytest.mark.parametrize("cell_name", CELLS)
def test_sound_run_is_correct_and_the_control_is_not(card, cell_name):
    results = {}
    for variant in (None, "control"):
        cell = harness.load_cell(cell_name, 3_141_592_653, device=card)
        if "checked" in cell.traffic:   # answers the one-second window reaches
            cell.traffic["checked"]["below"] = 20
        bench = {"end_to_end": [], "per_layer": []}
        results[variant] = harness.run_cell(cell, bench, 1.0, False, 0.0,
                                            variant=variant, log=lambda s: None)
    assert results[None]["correct"], results[None]["checks"]
    assert not results["control"]["correct"], results["control"]["checks"]

"""The output check sees each fault a cell can have.  Each case skips the
harness's look for a card and drives the rest of a run on the CPU (the
program's plain versions) at a tiny size, with the timed path broken
underneath: the state returned unchanged, half the batch left out with the
mean taken over the rest, an answer altered where it is produced, and the
control (the program's bf16 environment table).  The sound run must come
out correct and every broken one not.  One card, so no cell exchanges
anything between chips."""

import pytest

from portbench import harness

TINY = {"demo.offline-1080p": dict(width=20, height=12, frames_per_block=2),
        "demo.viewer-832": dict(size=12),
        "demo-inverse.512-two-views": dict(width=12, height=10),
        "demo-inverse.1080p-one-view": dict(width=14, height=8)}
CASES = [(cell, variant) for cell in TINY
         for variant in harness.driver_class(harness.load_cell(cell, 0)).VARIANTS]


def tiny_run(cell_name, variant, seed=2_718_281_828):
    cell = harness.load_cell(cell_name, seed, device="cpu")
    cell.workload["traffic"].update(TINY[cell_name])
    if "checked" in cell.workload["traffic"]:
        cell.workload["traffic"]["checked"]["below"] = 3
    return harness.run_cell(cell, {"end_to_end": [], "per_layer": []}, 1.5, False, 0.0,
                            variant=variant, log=lambda s: None)


@pytest.mark.parametrize("cell,variant", CASES)
def test_check_sees_the_fault(cell, variant):
    result = tiny_run(cell, variant)
    assert result["correct"] is (variant is None), result["checks"]
    assert list(result)[-1] == "checks"
    if variant is not None:
        assert result["failed"] > 0

"""Settings of the benchmark's own tests (python -m pytest portbench/tests).

Tests that need a CUDA card carry the ``cuda`` marker and decide inside a
fixture whether there is one, so every process collects the same tests."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (the port's kernels); skipped without one")

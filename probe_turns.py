"""Time the backward-design probes of two checkouts of the port in turns on
one CUDA card, with this checkout's measurement code.

    python3 probe_turns.py OTHER_CHECKOUT

Runs ``chip_smoke.probe_timings`` of this checkout in a fresh process
for each turn, with ``tpt_torch`` imported from OTHER_CHECKOUT or from this
checkout in the order other, this, this, other, so two versions of the
probe kernels and wrappers are compared on one card, with one clock and
the same inputs.  Each turn prints chip_smoke's probe
lines and then one JSON line {"turn", "checkout", "probes": {probe: {grid:
record}}}; each kernel is built into its own checkout's tpt_torch/_build.
Exits non-zero if a turn fails.  ``run_turns`` runs the turns of
grad_turns.py as well.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))

TURN = """
import importlib.util, json, sys
import torch
sys.path.insert(0, {root!r})
spec = importlib.util.spec_from_file_location("chip_smoke", {smoke!r})
smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(smoke)
import tpt_torch
assert tpt_torch.__file__.startswith({root!r}), tpt_torch.__file__
per = smoke.probe_timings(torch.device("cuda"), smoke.gpu_name_and_power())
print(json.dumps({{"turn": {turn}, "checkout": {root!r},
                  "probes": {{n: {{str(g): r for g, r in v.items()}} for n, v in per.items()}}}}))
"""


def other_checkout(ap: argparse.ArgumentParser, path: str) -> str:
    """The absolute root of another checkout of the port (``ap.error`` if
    it holds no tpt_torch/)."""
    other = os.path.abspath(path)
    if not os.path.isdir(os.path.join(other, "tpt_torch")):
        ap.error(f"{other} holds no tpt_torch/")
    return other


def run_turns(name: str, template: str, roots) -> int:
    """Run ``template`` in a fresh Python process from each root in turn,
    formatted with ``root``, ``smoke`` (this checkout's chip_smoke.py),
    ``turn`` (its index) and ``this`` (whether the root is this checkout).
    Returns the first failing turn's exit code, else 0."""
    for turn, root in enumerate(roots):
        code = template.format(root=root, smoke=os.path.join(HERE, "chip_smoke.py"), turn=turn,
                               this=root == HERE)
        rc = subprocess.run([sys.executable, "-c", code], cwd=root, timeout=900).returncode
        if rc != 0:
            print(f"{name}: turn {turn} ({root}) failed with {rc}", file=sys.stderr)
            return rc
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", help="root of the other checkout (holding tpt_torch/)")
    other = other_checkout(ap, ap.parse_args(argv).other)
    return run_turns("probe_turns", TURN, (other, HERE, HERE, other))


if __name__ == "__main__":
    sys.exit(main())

"""tpt_torch.kernels.probes on the CPU against the Pallas probes of
benchmarks/exp_bwd_probes.py, run in interpret mode.

The harness reads its inputs (idx, table, gvals, GRID) from module globals
when a probe is called, so each test hands it numpy inputs from a seed
through monkeypatch, with GRID = 4, and wraps pl.pallas_call for
interpret=True; nothing in benchmarks/ changes.

Bars and why:

* p1, p2, p3 and p6's count column exact: gathers, doubling and counts;
  p6's columns 2-31 are exactly 0;
* sums (p1t, p5, p6's column 0, p7, p8) at rtol 1e-5 and atol 1e-5 x the
  output's largest magnitude: the sum is taken in another order (on the
  card, by atomics in no fixed order);
* p4 at rtol 1e-5, atol 1e-6: libm's tanh and exp differ by an ulp.
"""

import functools
import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from tpt_torch import bwd_probes
from tpt_torch.kernels import probes as P

torch.set_num_threads(1)
GRID = 4
HARNESS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "benchmarks",
                       "exp_bwd_probes.py")
SUMS = ("p1t", "p5", "p7", "p8")


@pytest.fixture(scope="module")
def harness():
    spec = importlib.util.spec_from_file_location("exp_bwd_probes", HARNESS)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def inputs(seed=0):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, 55, (GRID * P.TR, P.L), dtype=np.int32)
    table = rng.standard_normal((P.R, P.K)).astype(np.float32)
    gvals = rng.standard_normal((GRID * P.TR, P.L)).astype(np.float32)
    return idx, table, gvals


def assert_sum_close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("name", P.PROBES)
def test_probe_matches_pallas(harness, monkeypatch, name):
    idx, table, gvals = inputs()
    monkeypatch.setattr(harness, "idx", idx)
    monkeypatch.setattr(harness, "table", table)
    monkeypatch.setattr(harness, "gvals", gvals)
    monkeypatch.setattr(harness, "GRID", GRID)
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    want = np.asarray(getattr(harness, name)()())

    launches = dict(P.PROBE_LAUNCHES)
    got = getattr(P, name)(torch.from_numpy(idx), torch.from_numpy(table),
                           torch.from_numpy(gvals)).numpy()
    assert P.PROBE_LAUNCHES == launches          # the CPU runs the plain version
    assert got.shape == want.shape == P.output_shape(name, GRID * P.TR)
    if name in ("p1", "p2", "p3"):
        np.testing.assert_array_equal(got, want)
    elif name == "p4":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    elif name == "p6":
        assert_sum_close(got[:, 0], want[:, 0])
        np.testing.assert_array_equal(got[:, 1:], want[:, 1:])
        assert not got[:, 2:].any()
    else:
        assert name in SUMS
        assert_sum_close(got, want)


def test_bwd_probes_main_on_the_cpu(capsys):
    assert bwd_probes.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split(":")[0].strip() for ln in lines] == list(P.PROBES)
    assert all(": OK " in ln and ln.endswith("ms/3calls") for ln in lines)


def test_bwd_probes_exits_1_when_a_probe_fails(monkeypatch, capsys):
    def boom(idx, table, g):
        raise RuntimeError("probe failed")

    monkeypatch.setattr(P, "p3_plain", boom)
    assert bwd_probes.main(["p1", "p3", "p5", "--device", "cpu"]) == 1
    lines = capsys.readouterr().out.splitlines()
    assert [": OK " in ln for ln in lines] == [True, False, True]
    assert "FAIL RuntimeError: probe failed" in lines[1]


def test_no_fallback_off_the_cpu():
    idx, table, gvals = (torch.from_numpy(a).to("meta") for a in inputs())
    for name in P.PROBES:
        with pytest.raises(ValueError, match="CUDA"):
            getattr(P, name)(idx, table, gvals)


def test_probes_path_imports_no_jax():
    """The probes' entry point, run on the CPU, and chip_smoke.py import
    nothing of JAX, the JAX package, benchmarks/ or optax."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys; import chip_smoke; from tpt_torch import bwd_probes; "
            "assert bwd_probes.main(['p1', 'p6', '--device', 'cpu']) == 0; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'tpt', 'benchmarks', 'optax', 'exp_bwd_probes')]; assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=repo, check=True, timeout=120,
                   stdout=subprocess.DEVNULL)

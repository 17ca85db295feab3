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
  card, by per-warp shared-memory atomics and a merge in block order);
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


@pytest.mark.parametrize("name", sorted(P.SCATTER))
def test_scatter_launch_args_match_the_harness(harness, monkeypatch, name):
    """The launch arguments of each scatter probe, built without a card,
    equal SCATTER's and the harness's: column weights a, c, the window
    (first, n), rows and cols.  The harness's probe runs in interpret mode
    at GRID = 2 with idx = each element's tile number, once with g = 1 and
    once with g = 2; tile t's row of d is then (a_k + c_k) n_t and
    (2 a_k + c_k) n_t, n_t = 2048 inside the window and 0 outside."""
    grid, tile = 2, P.TR * P.L
    n = grid * tile
    weights, first, n_args, rows, cols = P.scatter_args(name, n)
    s_rows, s_cols, a, c, last_tile = P.SCATTER[name]
    assert (rows, cols, first, n_args) == (s_rows, s_cols, n - tile if last_tile else 0, n)
    pad = [0.0] * (P.K - cols)
    assert list(weights.a) == list(a) + pad and list(weights.c) == list(c) + pad

    monkeypatch.setattr(harness, "idx", np.repeat(np.arange(grid, dtype=np.int32),
                                                  tile).reshape(grid * P.TR, P.L))
    monkeypatch.setattr(harness, "table", np.zeros((P.R, P.K), np.float32))
    monkeypatch.setattr(harness, "GRID", grid)
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    d = []
    for gv in (1.0, 2.0):
        monkeypatch.setattr(harness, "gvals", np.full((grid * P.TR, P.L), gv, np.float32))
        d.append(np.asarray(getattr(harness, name)()(), dtype=np.float64))
    assert d[0].shape == (rows, cols)
    for t in range(grid):
        inside = t * tile >= first
        np.testing.assert_array_equal((d[1][t] - d[0][t]) / tile, weights.a[:cols] if inside else 0)
        np.testing.assert_array_equal((2 * d[0][t] - d[1][t]) / tile,
                                      weights.c[:cols] if inside else 0)
    assert not d[0][grid:].any() and not d[1][grid:].any()


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
    """The probes' entry point, run on the CPU, chip_smoke.py,
    probe_turns.py, grad_turns.py, render_turns.py and scatter_designs.py
    import nothing of JAX, the JAX package, benchmarks/ or optax."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys; import chip_smoke, probe_turns, grad_turns, render_turns, "
            "scatter_designs; "
            "from tpt_torch import bwd_probes; "
            "assert bwd_probes.main(['p1', 'p6', '--device', 'cpu']) == 0; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'tpt', 'benchmarks', 'optax', 'exp_bwd_probes')]; assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=repo, check=True, timeout=120,
                   stdout=subprocess.DEVNULL)


def test_probe_turns_refuses_a_checkout_without_the_port(tmp_path):
    """probe_turns.py compares two checkouts of the port; a directory that
    holds no tpt_torch/ is refused before any turn runs."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo)
    try:
        import probe_turns
    finally:
        sys.path.remove(repo)
    with pytest.raises(SystemExit) as exc:
        probe_turns.main([str(tmp_path)])
    assert exc.value.code == 2


def test_turns_run_from_each_root_and_stop_at_the_first_failure(tmp_path):
    """probe_turns.run_turns, which grad_turns.py shares: each turn is a fresh
    process started from its root, told its index and whether the root is
    this checkout; the first failing turn's exit code ends the run."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo)
    try:
        import probe_turns
    finally:
        sys.path.remove(repo)
    log = tmp_path / "turns.txt"
    template = ("import os, sys\n"
                "open(" + repr(str(log)) + ", 'a').write(f'{turn} {this} {{os.getcwd()}}\\n')\n"
                "sys.exit(3 if {turn} == 1 else 0)\n")
    roots = [str(tmp_path), probe_turns.HERE, str(tmp_path)]
    assert probe_turns.run_turns("test", template, roots) == 3
    assert log.read_text().splitlines() == [f"0 False {tmp_path}", f"1 True {repo}"]

"""tpt_torch.parallel.init against tpt.parallel.init: the properties of
tests/test_parallel_init.py.  The single-process and layout checks run in
this process; the meshes themselves are built in one gloo world of 4 CPU
ranks (the JAX tests' simulated devices are ranks here), started once for
the module."""

import pytest
import torch

from tpt_torch.parallel import dryrun, init_distributed, launch, make_host_mesh, make_mesh
from tpt_torch.parallel.init import host_layout
from tpt_torch.parallel.runs import mesh_layouts

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def layouts():
    return launch(mesh_layouts, 4, backend="gloo", device="cpu", timeout=300)


@pytest.fixture
def no_rendezvous(monkeypatch):
    for name in ("RANK", "WORLD_SIZE", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(name, raising=False)


def test_single_process_init_is_noop(no_rendezvous):
    assert init_distributed() == 1
    assert init_distributed() == 1     # idempotent
    assert make_mesh().shape == make_host_mesh().shape == {"dp": 1, "sp": 1}


def test_explicit_init_requires_full_triple(no_rendezvous):
    with pytest.raises(ValueError, match="together"):
        init_distributed("tcp://127.0.0.1:9999")
    with pytest.raises(ValueError, match="together"):
        init_distributed(world_size=2, rank=0)


def test_heterogeneous_hosts_rejected(no_rendezvous, monkeypatch):
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "3")   # a world of 1 on hosts of 3
    with pytest.raises(RuntimeError, match="heterogeneous"):
        init_distributed()


def test_host_mesh_matches_make_mesh_single_host(layouts):
    for rank, got in enumerate(layouts):
        shape, grid, coord = got["host_sp1"]
        assert shape == {"dp": 4, "sp": 1}
        assert got["make_mesh_sp1"] == (shape, grid, coord) and coord == (rank, 0)


def test_host_mesh_sp_axis(layouts):
    assert layouts[3]["host_sp2"] == ({"dp": 2, "sp": 2}, [[0, 1], [2, 3]], (1, 1))
    assert layouts[0]["two_hosts_sp2"][0] == {"dp": 2, "sp": 2}


def test_host_mesh_rejects_nondivisible_sp(layouts, no_rendezvous):
    assert layouts[0]["host_sp_world_plus_7"][0] == "ValueError"
    assert "divide" in layouts[0]["host_sp_world_plus_7"][1]
    # sp must divide the ranks a host once there are several hosts
    assert layouts[0]["two_hosts_sp4"][0] == "ValueError"
    with pytest.raises(ValueError, match="divide"):
        make_host_mesh(sp=8)


def test_host_mesh_explicit_rank_list(layouts):
    # explicit lists are honoured verbatim; a rank outside one takes no part
    assert layouts[2]["explicit_4_sp2"] == ({"dp": 2, "sp": 2}, [[0, 1], [2, 3]], (1, 0))
    assert layouts[1]["explicit_3_sp1"] == ({"dp": 3, "sp": 1}, [[0], [1], [2]], (1, 0))
    assert layouts[3]["explicit_3_sp1"][2] is None
    assert layouts[0]["explicit_3_sp2"][0] == "ValueError"
    assert "divide" in layouts[0]["explicit_3_sp2"][1]


def test_host_mesh_rejects_imbalanced_explicit_list():
    # three ranks of host 0 and one of host 1 (hosts of 4 ranks)
    with pytest.raises(ValueError, match="imbalanced"):
        host_layout(sp=2, ranks=[0, 1, 2, 4], local_size=4)
    assert host_layout(sp=1, ranks=[0, 1, 2, 4], local_size=4) == [[0], [1], [2], [4]]


def test_second_init_with_another_topology_raises(layouts):
    for got in layouts:
        assert got["reinit"][0] == "RuntimeError"


def test_dryrun_runs_the_sharded_paths(capsys):
    """The counterpart of dryrun_multichip on 4 CPU ranks: the Cornell toy
    render and SGD step, then the demo scene's band render and banded step."""
    dryrun(4, device="cpu")
    out = capsys.readouterr().out
    assert "dryrun cornell ok: 16x8, mesh dp=2 sp=2" in out
    assert "dryrun demo ok: 128x48, mesh dp=2 sp=2" in out

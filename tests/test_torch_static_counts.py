"""The static-count builds on the CPU: the build key and the flags each
library is built with (nvcc is a stub here), the plain path's indifference
to ``counts`` beside tpt's transport, which launches take a build for
counts, the counts the render callers choose, and the sharded entry
points' default device.  The kernels themselves, and their bits against
the dynamic build, are held on the card (tests/test_torch_cuda.py)."""

import inspect
import json
import sys
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpt import camera as jcam
from tpt import integrator as jint
from tpt import scene as jscene
from tpt.config import CameraConfig
from tpt_torch import cli
from tpt_torch.env import constant_environment, pack_block_table
from tpt_torch.kernels import _build
from tpt_torch.kernels import render as R
from tpt_torch.kernels import trace as K
from tpt_torch.kernels import trace_grad as G
from tpt_torch.parallel import launch
from tpt_torch.parallel import runs

from test_torch_integrator import CORNELL_CAM, assert_parity, setup, to_torch_scene

torch.set_num_threads(1)


def test_build_key_differs_per_counts():
    keys = [None, (48, 7), (4, 0), (1, 0)]
    assert [_build.build_key(c) for c in (None, (48, 7), (4, 0), [1, 0])] == keys
    for src in _build.SOURCES:
        paths = [_build.library_path(src, k) for k in keys]
        assert len({p.parent for p in paths}) == len(keys), src
        assert _build.library_path(src, (48, 7)) == paths[1]   # a repeat: the same key
        assert _build.library_path(src) == paths[0]
    assert _build.define_flags(None) == ()
    assert _build.define_flags((48, 7)) == ("-DTPT_NUM_SPHERES=48", "-DTPT_NUM_CUBOIDS=7")
    with pytest.raises(ValueError, match="csrc holds"):
        _build.library_path("render.cu")


RECORDING_NVCC = """#!{python}
import json, pathlib, sys
with open({record!r}, "a") as f:
    f.write(json.dumps(sys.argv[1:]) + "\\n")
pathlib.Path(sys.argv[sys.argv.index("-o") + 1]).write_bytes(b"")
print("ptxas info    : Used 40 registers")
"""


class StubLibrary:
    """ctypes.CDLL's stand-in for the stub's empty libraries: any entry
    point is an object whose signature can be set."""

    def __init__(self, path):
        self.path = path

    def __getattr__(self, name):
        return types.SimpleNamespace()


@pytest.fixture
def stub_nvcc(tmp_path, monkeypatch):
    """The recording stub as nvcc, a fresh build directory, the stub's
    libraries loaded as StubLibrary, no library loaded before; yields the
    recorded runs' reader."""
    record = tmp_path / "calls.jsonl"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(RECORDING_NVCC.format(python=sys.executable, record=str(record)))
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build.ctypes, "CDLL", StubLibrary)
    _build._load.cache_clear()
    G.libraries.cache_clear()
    G.diff_libraries.cache_clear()
    yield lambda: ([json.loads(line) for line in record.read_text().splitlines()]
                   if record.exists() else [])
    _build._load.cache_clear()
    G.libraries.cache_clear()
    G.diff_libraries.cache_clear()


# what each wrapper loads, through the call it makes: {case: (the call,
# [(source, its -D flags)] of the libraries it must build)}; trace_diff
# builds its forward's trace.cu with the backward pair, as it launches all three
STATIC = ("-DTPT_NUM_SPHERES=48", "-DTPT_NUM_CUBOIDS=7")
WRAPPER_LIBRARIES = {
    "trace.cu dynamic": (lambda: [K.forward_library((48, 7), True, 1)], [("trace.cu", ())]),
    "trace.cu (48, 7)": (lambda: [K.forward_library((48, 7), True, K.BLOCK_FRAMES)],
                         [("trace.cu", STATIC)]),
    "backward pair": (lambda: list(G.libraries()),
                      [("trace_grad.cu", ()), ("trace_grad_adjoint.cu", ())]),
    "trace_diff": (lambda: list(G.diff_libraries((48, 7))),
                   [("trace.cu", ()), ("trace_grad.cu", ()), ("trace_grad_adjoint.cu", ())]),
    "probes.cu": (lambda: [_build.library("probes.cu")], [("probes.cu", ())]),
}


@pytest.mark.parametrize("case", sorted(WRAPPER_LIBRARIES))
def test_stub_nvcc_builds_only_the_libraries_a_wrapper_loads(stub_nvcc, case):
    """A wrapper's first load runs nvcc once per library it launches, with
    the build's flags and exactly its -D flags, and no more; each library
    it returns holds its source's entry points and keeps its log with the
    build's seconds beside it; a second load builds nothing."""
    load, want = WRAPPER_LIBRARIES[case]
    libs = load()
    calls = stub_nvcc()
    assert sorted((argv[-1].rsplit("/", 1)[-1], tuple(a for a in argv if a.startswith("-D")))
                  for argv in calls) == sorted(want)
    for argv in calls:
        assert argv[:len(_build.NVCC_FLAGS)] == list(_build.NVCC_FLAGS)
    assert all((lib.source, _build.define_flags(lib.key)) in want for lib in libs)
    for lib in libs:
        names = {n for n, (src, _) in _build.ENTRY_POINTS.items() if src == lib.source}
        assert names and all(hasattr(lib, n) for n in names)
        assert not any(hasattr(lib, n) for n in set(_build.ENTRY_POINTS) - names)
        assert lib.log.count("Used 40 registers") == 1 and _build.build_seconds(lib.path) >= 0
    _build._load.cache_clear()
    G.libraries.cache_clear()
    G.diff_libraries.cache_clear()
    assert [(lib.source, lib.key, lib.path, lib.log) for lib in load()] == \
        [(lib.source, lib.key, lib.path, lib.log) for lib in libs]
    assert stub_nvcc() == calls


# every way to a library, each handed the counts
WAYS = {"build_key": _build.build_key,
        "library_path": lambda c: _build.library_path("trace.cu", c),
        "build_all": lambda c: _build.build_all([("trace.cu", None), ("trace.cu", c)]),
        "library": lambda c: _build.library("trace.cu", c),
        "forward_library": lambda c: K.forward_library(c, True, K.BLOCK_FRAMES)}


@pytest.mark.parametrize("way", sorted(WAYS))
def test_counts_out_of_range_raise_before_any_nvcc(stub_nvcc, way):
    for counts in ((257, 0), (0, 65), (-1, 0)):
        with pytest.raises(ValueError, match="counts out of range"):
            WAYS[way](counts)
    assert stub_nvcc() == []


def test_failed_build_raises(tmp_path, monkeypatch):
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(f"#!{sys.executable}\nimport sys\nprint('error: no')\nsys.exit(2)\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="-DTPT_NUM_SPHERES=4 .*failed"):
        _build.build_all([("trace.cu", (4, 0))])
    assert not list((tmp_path / "build").rglob("*.so"))


# (scene, camera, size, spp, rr, jitter, flipped, diverged): the bars of
# tests/test_torch_integrator.py's PER_FRAME cases
PLAIN_CASES = {"cornell": ("cornell_scene", CORNELL_CAM, 24, 16, 2, True, "corner", 0, 0),
               "demo": ("demo_scene", CameraConfig(), 64, 64, 1, True, "corner", 4, 8)}


@pytest.mark.parametrize("case", sorted(PLAIN_CASES))
def test_plain_path_gives_the_same_bits_for_any_counts(case):
    """On the CPU ``counts`` bounds the plain scan and no build is loaded:
    the wrappers' results are the same bits with the scene's counts and
    without, in the select and the environment mode, and they hold to tpt's
    transport at the static counts as tests/test_torch_integrator.py does."""
    scene_name, cam, w, h, spp, rr, jitter, flips, diverged = PLAIN_CASES[case]
    (_, jcp), _, px, py = setup(scene_name, cam, w, h)
    js = getattr(jscene, scene_name)().build()
    ts = to_torch_scene(js)
    inv_p, inv_v, _ = jcam.camera_matrices(cam, w, h)
    args = (ts, np.asarray(inv_p), np.asarray(inv_v), 5, cam.focal_length,
            cam.aperture_diameter)
    kw = dict(width=w, height=h, ray_depth=13, spp=spp, rr=rr, jitter=jitter)
    launches = dict(K.BUILD_LAUNCHES)
    base = K.trace(*args, **kw)
    got = K.trace(*args, counts=ts.counts, **kw)
    for name in ("radiance", "miss_dir", "miss_thr", "ray_count", "seed"):
        assert torch.equal(getattr(got, name), getattr(base, name)), name
    table = pack_block_table(constant_environment((0.7, 0.8, 1.0)))
    env = [K.trace_progressive(*args, n_frames=2, env_table=table, counts=c, **kw)
           for c in (None, ts.counts)]
    for name in ("rad_sum", "ray_count", "seed"):
        assert torch.equal(getattr(env[0], name), getattr(env[1], name)), name
    assert dict(K.BUILD_LAUNCHES) == launches   # the CPU launches no build
    counts = (int(js.num_spheres), int(js.num_cuboids))
    jstatic = jint.compose_trace_fn(jint.make_scene_scan_fn(js, counts),
                                    jint.make_xla_gather_fn(js))
    want = jax.jit(lambda: jint.trace_paths(
        jstatic, jcp, jnp.asarray(px.numpy()), jnp.asarray(py.numpy()), w, h, jnp.int32(5),
        13, spp, jitter=jitter, russian_roulette=rr))()
    assert_parity(base, want, flips, diverged)


@pytest.mark.parametrize("counts,env_mode,n_frames,want",
                         [((48, 7), True, 30, ((48, 7),)),
                          ((48, 7), True, K.BLOCK_FRAMES, ((48, 7),)),
                          ((48, 7), True, K.BLOCK_FRAMES - 1, (None,)),
                          (None, True, 30, (None,)),
                          ((48, 7), False, 30, (None,)),
                          (None, False, 1, (None,))])
def test_only_an_environment_mode_launch_with_counts_takes_their_build(monkeypatch, counts,
                                                                       env_mode, n_frames,
                                                                       want):
    """The card's measured choice (kernels.trace.forward_library): trace.cu
    built for the counts for an environment-mode launch of at least
    BLOCK_FRAMES frames with counts; the dynamic build for any other
    launch."""
    seen = []
    monkeypatch.setattr(K, "library", lambda *a: seen.append(a) or a)
    assert K.forward_library(counts, env_mode, n_frames) == ("trace.cu", *want)
    assert seen == [("trace.cu", *want)]


def test_kernel_counts_follows_the_device():
    """tpt's choice (tpt/cli.py:154-158, tpt/interactive.py:340-344): the
    configured counts, else the scene's on the accelerator, else None."""
    from tpt_torch import demo_scene
    scene = demo_scene().build()
    assert R.kernel_counts(scene, torch.device("cuda")) == (48, 7) == scene.counts
    assert R.kernel_counts(scene, "cuda:1") == (48, 7)
    assert R.kernel_counts(scene, torch.device("cpu")) is None
    assert R.kernel_counts(scene, "cpu", configured=(48, 7)) == (48, 7)
    assert R.kernel_counts(scene, torch.device("cuda"), configured=[40, 2]) == (40, 2)


def _recording_blocks(monkeypatch):
    """progressive_frames replaced by a recorder of its ``counts``."""
    seen = []

    def record(state, scene, env_table, *args, counts=None, n_valid=None, **kw):
        seen.append(counts)
        state.frame += kw["n_frames"] if n_valid is None else n_valid
        return state, torch.zeros((), dtype=torch.int64)

    monkeypatch.setattr(R, "progressive_frames", record)
    return seen


@pytest.mark.parametrize("device,want", [("cuda", (48, 7)), ("cpu", None)])
def test_cli_render_hands_the_kernel_the_scene_counts_on_cuda(monkeypatch, device, want):
    """``cli render --backend kernel``: the scene's counts for a scene on a
    CUDA device, None on the CPU (a stand-in scene carries the device, so
    this runs without a card)."""
    from tpt_torch.env import constant_environment
    from tpt_torch.progressive import init_accumulator
    seen = _recording_blocks(monkeypatch)
    args = cli.build_parser().parse_args(["render", "--width", "8", "--height", "4",
                                          "--frames", "3", "--chunk", "2"])
    cfg = types.SimpleNamespace(width=8, height=4, ray_depth=2, spp=1, jitter="corner")
    scene = types.SimpleNamespace(counts=(48, 7), device=torch.device(device))
    state = init_accumulator(4, 8)
    cli._render_kernel(args, cfg, scene, constant_environment((0.5, 0.5, 0.5)),
                       CameraConfig(), state, time.time())
    assert seen == [want, want] and state.frame == 3


@pytest.mark.parametrize("configured,device,want", [(None, "cuda", (48, 7)),
                                                    (None, "cpu", None),
                                                    ((48, 7), "cpu", (48, 7))])
def test_viewer_hands_the_kernel_the_scene_counts_on_cuda(monkeypatch, configured, device,
                                                          want):
    import dataclasses
    from tpt_torch.interactive import ViewerSession
    ses = ViewerSession(size=8, device="cpu")
    ses.cfg = dataclasses.replace(ses.cfg, static_counts=configured)
    ses.device = torch.device(device)   # the choice reads the session's device alone
    assert ses._static_counts() == want
    seen = _recording_blocks(monkeypatch)
    ses.device = torch.device("cpu")
    ses.render_one(2)
    assert seen == [configured]


def test_sharded_entry_points_default_to_the_card(monkeypatch):
    assert inspect.signature(launch).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch(runs.run_jobs, 1, {}, [])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        runs.build_setup({"scene": "cornell"})
    scene, _, _, device = runs.build_setup({"scene": "cornell", "device": "cpu"})
    assert device == torch.device("cpu") and scene.device == device

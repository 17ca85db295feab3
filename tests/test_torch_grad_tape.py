"""The backward kernels' host side on the CPU: the tape's size and its row
chunks, the lane efficiency of a thread-per-pixel reverse sweep, the ablate
modes' phase flags, the wrapper's checks, and the build's entry table
against the CUDA sources (tpt_torch/csrc/grad.cuh, trace_grad.cu,
trace_grad_adjoint.cu).  Nothing here needs a card or nvcc."""

import re

import numpy as np
import pytest
import torch

from tpt_torch import demo_scene
from tpt_torch.integrator import build_attr_table
from tpt_torch.kernels import _build
from tpt_torch.kernels import trace_grad as G

torch.set_num_threads(1)
GRAD_CUH = (_build.SRC_DIR / "grad.cuh").read_text()


def tape_bytes_ref(width, n_rows, spp, depth, half):
    """Carries f32[spp][slots][10][P], codes i32[spp][depth][P], counts
    i32[spp][P], P = n_rows * width."""
    slots = -(-depth // 2) if half else depth
    pixels = n_rows * width
    return 4 * (spp * slots * 10 * pixels + spp * depth * pixels + spp * pixels)


@pytest.mark.parametrize("width,n_rows,spp,depth,half", [
    (1920, 1080, 1, 13, False), (1920, 1080, 1, 13, True), (512, 512, 1, 8, False),
    (32, 32, 3, 50, False), (7, 3, 2, 1, True), (16, 16, 1, 0, False)])
def test_tape_bytes(width, n_rows, spp, depth, half):
    assert G.tape_bytes(width, n_rows, spp, depth, half) == tape_bytes_ref(
        width, n_rows, spp, depth, half)


def test_train_bench_tape_is_1_19_gb():
    assert G.tape_bytes(1920, 1080, 1, 13) == 1_194_393_600


@pytest.mark.parametrize("n_rows,width,spp,depth,half,limit_rows", [
    (1080, 1920, 1, 13, False, None), (1080, 1920, 1, 50, False, None),
    (1080, 1920, 4, 50, False, None), (32, 32, 2, 13, False, 5), (33, 16, 1, 13, True, 4),
    (10, 8, 1, 13, False, 0)])
def test_row_chunks_cover_the_band_under_the_limit(monkeypatch, n_rows, width, spp, depth,
                                                   half, limit_rows):
    if limit_rows is not None:
        monkeypatch.setattr(G, "TAPE_BYTES_MAX", G.tape_bytes(width, limit_rows, spp, depth,
                                                              half))
    chunks = G.row_chunks(n_rows, width, spp, depth, half)
    per_row = tape_bytes_ref(width, 1, spp, depth, half)
    rows = max(1, min(n_rows, G.TAPE_BYTES_MAX // per_row))
    assert chunks == [(r, min(rows, n_rows - r)) for r in range(0, n_rows, rows)]
    assert sum(n for _, n in chunks) == n_rows and chunks[0][0] == 0
    assert all(a + n == b for (a, n), (b, _) in zip(chunks, chunks[1:]))
    assert all(n == 1 or G.tape_bytes(width, n, spp, depth, half) <= G.TAPE_BYTES_MAX
               for _, n in chunks)
    assert len(chunks) == -(-n_rows // rows)


def test_one_chunk_at_the_train_bench_launch():
    assert G.row_chunks(1080, 1920, 1, 13) == [(0, 1080)]
    assert len(G.row_chunks(1080, 1920, 1, 50)) == 3


def lane_efficiency_ref(rays):
    n = np.asarray(rays, np.float64).reshape(-1)
    if n.sum() == 0:
        return 1.0
    n = np.concatenate([n, np.zeros(-len(n) % 32)])
    return n.sum() / (32 * n.reshape(-1, 32).max(axis=1).sum())


@pytest.mark.parametrize("shape,high", [((64, 64), 14), ((37, 11), 51), ((1, 5), 3),
                                        ((8, 32), 1)])
def test_lane_efficiency(shape, high):
    rays = np.random.default_rng(shape[0]).integers(0, high, size=shape).astype(np.int32)
    assert G.lane_efficiency(torch.from_numpy(rays)) == pytest.approx(
        lane_efficiency_ref(rays), rel=1e-12)


def test_lane_efficiency_bounds():
    assert G.lane_efficiency(torch.full((32, 4), 7, dtype=torch.int32)) == 1.0
    one_long = torch.ones(32, dtype=torch.int32)
    one_long[5] = 32
    assert G.lane_efficiency(one_long) == pytest.approx(63 / (32 * 32))
    assert G.lane_efficiency(torch.zeros(10, dtype=torch.int32)) == 1.0


def header_constant(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", GRAD_CUH).group(1))


def test_ablate_flags_turn_off_one_phase_each():
    flags = {"STORES": "kFlagStores", "REVERSE": "kFlagReverse", "ADJOINT": "kFlagAdjoint",
             "CAMERA": "kFlagCamera", "TABLE": "kFlagTable"}
    for py, cu in flags.items():
        assert getattr(G, py) == header_constant(cu), py
    assert G.ALL_PHASES == header_constant("kFlagsAll") == 31
    assert set(G.ABLATE_FLAGS) == set(G.ABLATE_MODES)
    off = {"none": 0, "nocam": G.CAMERA, "nostores": G.STORES, "nodtbl": G.TABLE,
           "norev": G.REVERSE, "primalonly": G.ADJOINT}
    for mode, phase in off.items():
        assert G.ABLATE_FLAGS[mode] == G.ALL_PHASES & ~phase, mode


def test_tape_words_match_the_header():
    assert G.CARRY_WORDS == header_constant("kCarryWords")
    assert header_constant("kMaxDepth") == 50 and header_constant("kRows") == 128
    assert G.OUT_WORDS == 128 * 24 + 20 + 2


def c_signature(source, name):
    """The parameter list of ``extern "C" int name(...)`` in a csrc file."""
    text = (_build.SRC_DIR / source).read_text()
    m = re.search(rf'extern "C" int {name}\((.*?)\)\s*\{{', text, re.S)
    return [p.strip() for p in m.group(1).split(",")]


@pytest.mark.parametrize("name", ["tpt_trace_grad_tape", "tpt_trace_grad_tape_layout",
                                  "tpt_trace_grad_adjoint", "tpt_trace_grad_adjoint_layout",
                                  "tpt_trace_progressive", "tpt_trace_progressive_env",
                                  "tpt_trace_progressive_env_bf16", "tpt_trace_onehot",
                                  "tpt_trace_layout"])
def test_entry_points_match_their_sources(name):
    """Each backward and forward entry's ctypes argument types against its
    C signature: a pointer for each pointer, a 64-bit int for int64_t, an
    int for int."""
    source, argtypes = _build.ENTRY_POINTS[name]
    params = c_signature(source, name)
    assert len(params) == len(argtypes)
    for p, t in zip(params, argtypes):
        want = (_build._P if "*" in p else _build._L if p.startswith("int64_t") else _build._I)
        assert t is want, (name, p)


def test_every_source_builds_without_contraction():
    """-fmad=false and IEEE division and square root for every source (the
    parity policy of csrc/common.cuh), and ptxas's report in the output."""
    flags = _build.NVCC_FLAGS
    assert "-fmad=false" in flags and "-fmad=true" not in flags
    assert "--use_fast_math" not in flags and "-use_fast_math" not in flags
    assert flags[flags.index("-Xptxas") + 1] == "-v"


FAKE_NVCC = """#!{python}
import pathlib, sys
out = pathlib.Path(sys.argv[sys.argv.index("-o") + 1])
stem = pathlib.Path(sys.argv[-1]).stem
out.write_bytes(b"")
print(f"ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_1{{len(stem) + 7}}"
      f"{{stem}}_kernelEPKfi' for 'sm_90a'")
print(f"ptxas info    : Function properties for _ZN12_GLOBAL__N_1{{stem}}_kernelEPKfi")
print(f"    {{len(stem)}} bytes stack frame, 8 bytes spill stores, 12 bytes spill loads")
print(f"ptxas info    : Used {{len(stem) * 4}} registers, used 0 barriers, 396 bytes cmem[0]")
"""


def test_build_all_keeps_each_report_beside_its_library(tmp_path, monkeypatch):
    """A build keeps each library's compiler output beside it, and a later
    call, which builds nothing, returns the same reports; they are what
    chip_smoke.ptxas_report (and grad_turns.py) read.  nvcc is a stub
    here, so this runs on the CPU."""
    import sys
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable))
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    built = _build.build_all((src, None) for src in _build.SOURCES)
    assert set(built) == {(src, None) for src in ("trace.cu", "trace_grad.cu",
                                                  "trace_grad_adjoint.cu", "probes.cu")}
    assert all(p.exists() and p.with_suffix(".log").exists() for p, _ in built.values())
    assert _build.build_all(built) == built
    repo = str(_build.PACKAGE_DIR.parent)
    sys.path.insert(0, repo)
    try:
        import chip_smoke
    finally:
        sys.path.remove(repo)
    for (src, _), (_, log) in built.items():
        stem = src[:-3]
        assert chip_smoke.ptxas_report(log)[f"{stem}_kernel"] == (
            f"{len(stem) * 4} registers, 8/12 bytes spill stores/loads, {len(stem)} bytes "
            f"stack"), src


def scene_inputs(spp=1, size=8):
    scene = demo_scene().build("cpu")
    table = build_attr_table(scene, scene.counts)
    cam20 = torch.zeros(20)
    g = [torch.zeros(s) for s in ((3, size, size), (spp, 3, size, size), (spp, 3, size, size))]
    return scene, table, cam20, g


def test_device_inputs_refuse_wrong_tensors():
    """The kernels' input check names the first wrong tensor, before any
    launch; it takes the device to hold them to, so it runs here on the
    CPU."""
    scene, table, cam20, g = scene_inputs()
    cpu = torch.device("cpu")
    args = G._device_inputs(cpu, scene, table, cam20, g, 64, 1)
    assert list(args) == ["scene.sphere_pos_radius", "scene.cuboid_min", "scene.cuboid_max",
                          "table", "cam20", "g_rad", "g_missd", "g_misst"]
    assert list(G._device_inputs(cpu, scene, table, cam20, None, 64, 1))[-1] == "cam20"
    with pytest.raises(ValueError, match=r"sphere_pos_radius must be f32\[256, 4\] on cuda"):
        G._device_inputs(torch.device("cuda"), scene, table, cam20, g, 64, 1)
    with pytest.raises(ValueError, match=r"g_rad must be f32\[3, 64\]"):
        G._device_inputs(cpu, scene, table, cam20, [g[0][:, :4]] + g[1:], 64, 1)
    with pytest.raises(ValueError, match=r"g_missd must be f32\[2, 3, 64\]"):
        G._device_inputs(cpu, scene, table, cam20, g, 64, 2)
    with pytest.raises(ValueError, match="table"):
        G._device_inputs(cpu, scene, table.double(), cam20, g, 64, 1)


def test_tape_counts_runs_on_the_card_only():
    scene, table, cam20, _ = scene_inputs()
    with pytest.raises(ValueError, match="CUDA"):
        G._tape_counts(scene, table, cam20, 0, width=8, height=8, ray_depth=3, spp=1,
                       counts=scene.counts)
    with pytest.raises(ValueError, match="counts"):
        G._tape_counts(scene, table, cam20, 0, width=8, height=8, ray_depth=3, spp=1,
                       counts=(200, 60))


def test_trace_grad_refuses_bad_arguments_before_any_work():
    scene, table, cam20, g = scene_inputs()
    kw = dict(width=8, height=8, spp=1, counts=scene.counts)
    with pytest.raises(ValueError, match="ray_depth"):
        G.trace_grad(scene, table, cam20, 0, *g, ray_depth=51, **kw)
    with pytest.raises(ValueError, match="jitter"):
        G.trace_grad(scene, table, cam20, 0, *g, ray_depth=3, jitter="middle", **kw)
    with pytest.raises(ValueError, match="CUDA"):
        G.trace_grad(scene, table.to("meta"), cam20, 0, *g, ray_depth=3, half_stores=True,
                     **kw)

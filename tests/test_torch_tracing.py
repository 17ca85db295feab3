"""The program's spans and counters (tpt_torch.utils.profiling).

On the CPU: nothing records without a profiler; under one, a progressive
block and an inverse-rendering step record the span tree of the render and
training paths, with parents and requests, and the profiler holds the same
``tpt::`` ranges on the same clock; the self-time arithmetic; a span on
another thread nests under the open ``for_workers`` span; the trace
counters give the traced segments and kernels.trace_grad.lane_efficiency
(the environment mode's too on the CPU), and take the pooled kernel's warp
iterations where it wrote them.

On a CUDA card (``cuda`` marker; ``python -m pytest
tests/test_torch_tracing.py -q --noconftest -m cuda``), in a process of its
own: over one 1080p block and one 1080p training step, the ``sync.*`` spans
equal the synchronisations torch.cuda.set_sync_debug_mode("warn") reports,
and every span's start lies within 50 us of its profiler range's.
"""

import json
import os
import statistics
import subprocess
import sys
import threading
import time
import warnings

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tpt_torch.camera import camera_matrices
from tpt_torch.config import CameraConfig
from tpt_torch.env import constant_environment, pack_block_table
from tpt_torch.kernels.render import kernel_counts, progressive_frames
from tpt_torch.kernels import trace as K
from tpt_torch.kernels.trace import trace, trace_progressive, warp_segments
from tpt_torch.kernels.trace_grad import lane_efficiency
from tpt_torch.optim import clipped_adam, make_inverse_step, make_renderer
from tpt_torch.progressive import init_accumulator
from tpt_torch.scene import demo_scene
from tpt_torch.utils import profiling

CAM = CameraConfig()


@pytest.fixture(autouse=True)
def fresh():
    profiling.reset()
    yield
    profiling.reset()


def make_block(device, width, height, n_frames=2):
    """() -> (accumulator, rays): the next environment-mode block of the
    demo scene into one accumulator."""
    scene = demo_scene().build(device)
    table = pack_block_table(constant_environment((0.7, 0.8, 1.0), device=device))
    inv_p, inv_v, _ = camera_matrices(CAM, width, height)
    acc = init_accumulator(height, width, device)
    counts = kernel_counts(scene, device)
    return lambda: progressive_frames(acc, scene, table, inv_p, inv_v, 3 + acc.frame,
                                      CAM.focal_length, CAM.aperture_diameter, width=width,
                                      height=height, ray_depth=4, spp=1, counts=counts,
                                      n_frames=n_frames)


def training(device, width, height, ray_depth=3):
    """(target render, step, params, opt state) wired as inverse_demo.main
    wires them, at the given size."""
    scene = demo_scene().build(device)
    table = pack_block_table(constant_environment((0.7, 0.8, 1.0), device=device))
    render = make_renderer(scene, [CAM], width=width, height=height, ray_depth=ray_depth,
                           spp=1, counts=(48, 7), env_table=table, russian_roulette=False)
    opt = clipped_adam(0.005, total_steps=100)
    step = make_inverse_step(render, opt, n_views=1)
    params = (scene.sphere_material * 0.9, scene.cuboid_material.clone())
    true = (scene.sphere_material, scene.cuboid_material)

    def targets(frame):
        with torch.no_grad():
            return render(*true, frame, 0)[None, None]

    return targets, step, params, opt.init(params)


def tree(records):
    """{span name: set of its parents' names} over ``records``."""
    names = {r.id: r.name for r in records}
    out = {}
    for r in records:
        out.setdefault(r.name, set()).add(names.get(r.parent))
    return out


def test_nothing_records_without_a_profiler():
    assert not profiling.enabled()
    make_block("cpu", 16, 16)()
    targets, step, params, state = training("cpu", 8, 8)
    step(params, state, 0, targets(0))
    assert profiling.spans() == [] and profiling.counters() == {}
    assert profiling.span_totals() == {}


def test_block_and_step_record_the_span_tree_under_the_profiler():
    targets, step, params, state = training("cpu", 16, 16)
    block = make_block("cpu", 16, 16)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert profiling.enabled()
        _, rays = block()
        tgt = targets(0)
        step(params, state, 0, tgt)
    records = profiling.spans()
    assert tree(records) == {
        "render.block": {None}, "render.fold": {"render.block"},
        "trace.launch": {"render.block", "optim.render"},
        "optim.render": {None, "optim.step"}, "optim.step": {None},
        "optim.loss": {"optim.step"}, "optim.backward": {"optim.step"},
        "trace_grad.launch": {"optim.backward"}, "optim.adam": {"optim.step"}}
    by_name = {}
    for r in records:
        by_name.setdefault(r.name, []).append(r)
    assert {k: len(v) for k, v in by_name.items()} == {
        "render.block": 1, "render.fold": 1, "trace.launch": 3, "optim.render": 2,
        "optim.step": 1, "optim.loss": 2, "optim.backward": 1, "trace_grad.launch": 1,
        "optim.adam": 1}
    # three requests: the block, the target render, the step; a child shares
    # its parent's request and lies inside it in time
    ids = {r.id: r for r in records}
    roots = [r for r in records if r.parent is None]
    assert sorted(r.name for r in roots) == ["optim.render", "optim.step", "render.block"]
    assert len({r.request for r in roots}) == 3
    for r in records:
        assert r.start_ns <= r.end_ns
        if r.parent is not None:
            p = ids[r.parent]
            assert r.request == p.request and p.start_ns <= r.start_ns <= r.end_ns <= p.end_ns
    # the CPU makes no host-device synchronisation, so no sync span
    assert not [r for r in records if r.name.startswith("sync.")]
    # the profiler holds the same ranges, each opening just before its span's
    # start on the same clock (time.time_ns; the monotonic clocks lie ~1e18 ns
    # away): the card test holds each to 50 us, a loaded CPU to less
    events = [e for e in prof.profiler.kineto_results.events() if e.name().startswith("tpt::")]
    assert sorted(e.name() for e in events) == sorted("tpt::" + r.name for r in records)
    gaps = []
    for name, mine in by_name.items():
        theirs = sorted(e.start_ns() for e in events if e.name() == "tpt::" + name)
        gaps += [r.start_ns - t for r, t in zip(sorted(mine, key=lambda r: r.start_ns), theirs)]
    assert 0 <= statistics.median(gaps) < 1_000_000 and max(map(abs, gaps)) < 50_000_000
    assert profiling.counters()["trace.env.segments"] == int(rays)


def test_span_totals_take_sync_descendants_out_of_self_time(monkeypatch):
    """A nest built by hand: a > (b > sync.x, sync.y), and a second a."""
    monkeypatch.setattr(profiling, "_enabled", lambda: True)
    with profiling.span("a"):
        with profiling.span("b"):
            with profiling.sync("x", "cuda"):
                time.sleep(0.002)
        with profiling.sync("y", torch.device("cuda")):
            time.sleep(0.002)
        with profiling.sync("z", "cpu"):   # no sync on the host: no span
            pass
    with profiling.span("a"):
        pass
    recs = {r.name: r for r in profiling.spans()}
    assert set(recs) == {"a", "b", "sync.x", "sync.y"}
    dur = {k: r.end_ns - r.start_ns for k, r in recs.items()}
    a1 = [r for r in profiling.spans() if r.name == "a"]
    t = profiling.span_totals()
    assert t["a"]["calls"] == 2 and t["a"]["syncs"] == 2
    assert t["a"]["ns"] == sum(r.end_ns - r.start_ns for r in a1)
    assert t["a"]["self_ns"] == t["a"]["ns"] - dur["sync.x"] - dur["sync.y"]
    assert t["b"] == {"calls": 1, "ns": dur["b"], "self_ns": dur["b"] - dur["sync.x"],
                      "syncs": 1}
    assert t["sync.x"] == {"calls": 1, "ns": dur["sync.x"], "self_ns": dur["sync.x"],
                           "syncs": 0}
    assert profiling._covered([(0, 10), (5, 20), (30, 40), (35, 36)], 2, 38) == 26


def test_a_span_on_another_thread_nests_under_the_for_workers_span(monkeypatch):
    monkeypatch.setattr(profiling, "_enabled", lambda: True)

    def worker():
        with profiling.span("w"):
            with profiling.sync("s", "cuda"):
                pass

    with profiling.span("outer"):
        with profiling.span("backward", for_workers=True):
            t = threading.Thread(target=worker)
            t.start()
            t.join(timeout=10)
            assert not t.is_alive()
    t = threading.Thread(target=worker)
    t.start()
    t.join(timeout=10)
    recs = profiling.spans()
    ids = {r.id: r for r in recs}
    w_in, w_out = [r for r in recs if r.name == "w"]
    assert ids[w_in.parent].name == "backward" and w_in.thread != ids[w_in.parent].thread
    assert w_in.request == ids[w_in.parent].request
    assert w_out.parent is None and w_out.request != w_in.request
    assert profiling.span_totals()["backward"]["syncs"] == 1


@pytest.mark.parametrize("width,height,gather", [(16, 16, "select"), (20, 12, "select"),
                                                 (20, 12, "onehot")])
def test_trace_counters_give_segments_and_lane_efficiency(width, height, gather):
    scene = demo_scene().build("cpu")
    inv_p, inv_v, _ = camera_matrices(CAM, width, height)
    with profile(activities=[ProfilerActivity.CPU]):
        res = [trace(scene, inv_p, inv_v, f, CAM.focal_length, CAM.aperture_diameter,
                     width=width, height=height, ray_depth=5, spp=1, counts=(48, 7),
                     gather=gather) for f in (0, 1)]
    c = profiling.counters()
    assert set(c) == {f"trace.{gather}.segments", f"trace.{gather}.warp_max_segments"}
    assert c[f"trace.{gather}.segments"] == sum(int(r.ray_count.sum()) for r in res)
    assert c[f"trace.{gather}.warp_max_segments"] * 32 == pytest.approx(
        sum(int(r.ray_count.sum()) / lane_efficiency(r.ray_count) for r in res))
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        trace(scene, inv_p, inv_v, 0, CAM.focal_length, CAM.aperture_diameter, width=width,
              height=height, ray_depth=5, spp=1, counts=(48, 7), gather=gather)
    c = profiling.counters()
    assert c[f"trace.{gather}.segments"] / (32 * c[f"trace.{gather}.warp_max_segments"]) == \
        pytest.approx(lane_efficiency(res[0].ray_count), rel=1e-12)


@pytest.mark.parametrize("width,height,n_frames", [(16, 16, 2), (20, 12, 3)])
def test_env_counters_on_the_cpu_keep_their_meaning(width, height, n_frames):
    """On the CPU the environment mode runs the plain version, one pixel a
    lane, so ``trace.env.*`` stay the ray counts' warp_segments; on the card
    the pooled kernel's warp iterations take ``warp_max_segments``' place
    (tests/test_torch_env_pool.py)."""
    scene = demo_scene().build("cpu")
    table = pack_block_table(constant_environment((0.7, 0.8, 1.0)))
    inv_p, inv_v, _ = camera_matrices(CAM, width, height)
    with profile(activities=[ProfilerActivity.CPU]):
        res = trace_progressive(scene, inv_p, inv_v, 3, CAM.focal_length,
                                CAM.aperture_diameter, width=width, height=height,
                                ray_depth=5, spp=1, n_frames=n_frames, env_table=table)
    c = profiling.counters()
    segments, warp_max = warp_segments(res.ray_count)
    assert c == {"trace.env.segments": int(segments), "trace.env.warp_max_segments": int(warp_max)}
    assert c["trace.env.segments"] / (32 * c["trace.env.warp_max_segments"]) == pytest.approx(
        lane_efficiency(res.ray_count), rel=1e-12)


def test_count_lanes_takes_the_kernels_warp_iterations(monkeypatch):
    """Given the kernel's warp iterations, a launch's ``warp_max_segments``
    is their sum; without them, the ray counts' warp_segments."""
    monkeypatch.setattr(profiling, "_enabled", lambda: True)
    rays = torch.arange(40, dtype=torch.int32) % 7
    K._count_lanes("env", rays, torch.tensor([9, 4], dtype=torch.int32))
    K._count_lanes("select", rays)
    c = profiling.counters()
    assert c["trace.env.segments"] == c["trace.select.segments"] == int(rays.sum())
    assert c["trace.env.warp_max_segments"] == 13
    assert c["trace.select.warp_max_segments"] == int(warp_segments(rays)[1]) == 6 + 6
    assert [K.n_warps(n) for n in (1, 32, 33, 40, 64)] == [1, 1, 2, 2, 2]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def sync_warnings(fn):
    """fn() under set_sync_debug_mode("warn"): (its result, the number of
    synchronising CUDA operations it made)."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return out, sum("synchroniz" in str(w.message) for w in caught)


def card_readings() -> dict:
    """One 1080p 8-frame block, then one 1080p training step with its
    target render, each called whole inside its top-level span, after a
    block and a step that warm the profiler's first range on each thread
    (its set-up, ~0.3-1.4 ms, falls inside that range): the sync spans and
    sync warnings of each, the span tree, and each span name's largest gap
    between a span's start and its profiler range's."""
    dev = torch.device("cuda")
    targets, step, params, state = training(dev, 1920, 1080, ray_depth=8)
    block = make_block(dev, 1920, 1080, n_frames=8)
    block()
    step(params, state, 0, targets(0))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        block()
        step(params, state, 1, targets(1))
        torch.cuda.synchronize()
        profiling.reset()
        t0 = time.time_ns()
        _, n_block = sync_warnings(block)
        block_syncs = sum(r.name.startswith("sync.") for r in profiling.spans())
        _, n_step = sync_warnings(lambda: step(params, state, 2, targets(2)))
    records = profiling.spans()
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("tpt::") and e.device_type().name == "CPU"
              and e.start_ns() >= t0]
    gaps = {}
    for name in {r.name for r in records}:
        mine = sorted(r.start_ns for r in records if r.name == name)
        theirs = sorted(e.start_ns() for e in events if e.name() == "tpt::" + name)
        gaps[name] = (len(mine), len(theirs),
                      max(abs(t - m) for m, t in zip(mine, theirs)) if theirs else None)
    main = next(r.thread for r in records if r.name == "optim.step")
    return {"syncs": [block_syncs, sum(r.name.startswith("sync.") for r in records) - block_syncs],
            "warnings": [n_block, n_step],
            "tree": {k: sorted(map(str, v)) for k, v in tree(records).items()},
            "off_main_thread": sorted({r.name for r in records if r.thread != main}),
            "events": len(events), "records": len(records), "start_gaps_ns": gaps}


@pytest.mark.cuda
def test_sync_spans_are_the_card_syncs_and_start_on_the_profilers_clock(cuda):
    """:func:`card_readings` in a process of its own: a profiler session
    started in this one would come before tests/test_torch_cuda.py's; on
    the H100 a profiler session that came before the loading of a kernel
    library read no time of that library's kernels."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.dirname(here), here, os.environ.get("PYTHONPATH", "")]))
    out = subprocess.run([sys.executable, "-c", "import json, test_torch_tracing as t; "
                          "print(json.dumps(t.card_readings()))"],
                         cwd=here, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["syncs"] == got["warnings"] == [1, 0]   # the fold's denominator; none a step
    assert got["tree"]["trace_grad.launch"] == ["optim.backward"]
    assert got["off_main_thread"] == ["trace_grad.launch"]   # autograd's engine thread
    assert got["events"] == got["records"]
    for name, (n_mine, n_theirs, gap) in got["start_gaps_ns"].items():
        assert n_mine == n_theirs and gap < 50_000, (name, gap)

"""What each rank of a launched world runs: the sharded paths at given
layouts, with their results returned as numpy arrays.

A spawned rank imports the module that holds its function, so these live in
the port, beside the paths they drive.  The CPU tests
(tests/test_torch_dist.py, tests/test_torch_parallel_init.py) and
chip_smoke.py's dist phases hand :func:`run_jobs` a setup (scene, camera,
environment, device) and a list of jobs, each at its own ('dp', 'sp')
layout over the first dp*sp ranks of the world:

  * ``render``: ``make_dist_renderer`` at each of ``frames``;
  * ``progressive``: ``blocks`` blocks of ``make_dist_progressive``;
  * ``train``: ``steps`` steps of ``make_train_step`` (SGD at ``lr``, or
    ``ClippedAdam`` with ``adam`` as its learning rate) against a
    constant or rendered target, from a scene whose sphere-material
    entries may be scaled first;
  * ``all_reduce``: one all-reduce over the world on the rank's device,
    with the backend that carried it.

Each job's result holds the kernel launches its rank made while driving the
path (the counters are zeroed just before and read just after), the
assembled images and tables on the mesh's rank (0, 0), and, with ``reps``,
the wall time of one more call after a warm one, the slowest rank's, with
a synchronise at the end (``ms``; these calls are not counted).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np
import torch
import torch.distributed as dist

from ..camera import camera_matrices
from ..config import CameraConfig, RenderConfig
from ..env import constant_environment, pack_block_table
from ..kernels import trace as _trace
from ..kernels import trace_grad as _trace_grad
from ..optim import clipped_adam
from .dist import (band_accumulator, gather_image, make_dist_progressive, make_dist_renderer,
                   make_mesh, make_train_step)
from .init import make_host_mesh

COUNTERS = ((_trace, ("LAUNCHES", "ENV_LAUNCHES")),
            (_trace_grad, ("GRAD_LAUNCHES", "TAPE_LAUNCHES", "ADJOINT_LAUNCHES")))


def reset_launches():
    for mod, names in COUNTERS:
        for name in names:
            setattr(mod, name, 0)
    _trace.BUILD_LAUNCHES.clear()


def read_launches() -> dict:
    """Every counter, and the forward kernel's launches by build key."""
    out = {name: getattr(mod, name) for mod, names in COUNTERS for name in names}
    out["BUILD_LAUNCHES"] = dict(_trace.BUILD_LAUNCHES)
    return out


@contextlib.contextmanager
def recording_jitter(log: list):
    """Record the ``jitter`` argument of every trace and trace_diff call in
    this process (the sharded paths call them through their modules)."""
    saved = _trace.trace, _trace_grad.trace_diff

    def spy(real):
        def call(*args, **kwargs):
            log.append(kwargs.get("jitter", "corner"))
            return real(*args, **kwargs)
        return call

    _trace.trace, _trace_grad.trace_diff = spy(saved[0]), spy(saved[1])
    try:
        yield log
    finally:
        _trace.trace, _trace_grad.trace_diff = saved


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed(fn, reps: int, mesh, device) -> float:
    """ms of one ``fn()`` over ``reps`` calls after a warm one, the slowest
    rank's (host clock, synchronised at both ends)."""
    fn()
    _sync(device)
    if mesh.device_mesh is not None:
        dist.barrier(group=mesh.group(("dp", "sp")))
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    _sync(device)
    ms = torch.tensor([(time.perf_counter() - t0) * 1e3 / reps], dtype=torch.float64)
    if mesh.device_mesh is not None and mesh.size > 1:
        group = mesh.group(("dp", "sp"))
        if dist.get_backend(group) == "nccl":
            ms = ms.to(device)
        dist.all_reduce(ms, op=dist.ReduceOp.MAX, group=group)
    return float(ms.item())


def build_setup(setup: dict):
    """(scene builder's scene, CameraConfig, env faces, device) of a setup."""
    from ..cli import _build_scene, resolve_device
    device = resolve_device(setup.get("device", "cuda"))
    scene = _build_scene(setup.get("scene", "cornell")).build(device)
    cam = CameraConfig(**setup.get("camera", {}))
    env = setup.get("env", (0.3, 0.45, 0.6))
    faces = (torch.as_tensor(np.asarray(env, np.float32), device=device)
             if np.ndim(env) == 4 else constant_environment(env, device=device))
    return scene, cam, faces, device


def scale_spheres(scene, entries):
    """The scene with ``sphere_material[row, c0:c1] *= factor`` for each
    (row, c0, c1, factor), and the 0/1 masks of those entries."""
    sm = scene.sphere_material.clone()
    mask = torch.zeros_like(sm)
    for row, c0, c1, factor in entries:
        sm[row, c0:c1] *= factor
        mask[row, c0:c1] = 1.0
    return (dataclasses.replace(scene, sphere_material=sm),
            (mask, torch.zeros_like(scene.cuboid_material)))


def _np(t):
    return t.detach().cpu().numpy()


def _render_job(job, cfg, mesh, scene, cam, faces, device):
    render = make_dist_renderer(mesh, cfg, n_sample_groups=job.get("n_sample_groups"),
                                backend=job.get("backend", "kernel"))
    ip, iv, _ = camera_matrices(cam, cfg.width, cfg.height)
    args = (scene, faces, ip, iv, cam.focal_length, cam.aperture_diameter)
    out = {"images": [], "rays": []}
    for frame in job.get("frames", [0]):
        band, rays = render(*args, frame)
        out["images"].append(_np(gather_image(mesh, band, cfg.height)))
        out["rays"].append(int(rays))
    return out, lambda: render(*args, 0)


def _progressive_job(job, cfg, mesh, scene, cam, faces, device):
    n_frames = job["n_frames"]
    render = make_dist_progressive(mesh, cfg, n_frames)
    table = pack_block_table(faces)
    ip, iv, _ = camera_matrices(cam, cfg.width, cfg.height)
    acc = band_accumulator(mesh, cfg, device)
    out = {"images": [], "rays": []}
    for b in range(job.get("blocks", 1)):
        acc, rays = render(acc, scene, table, ip, iv, cam.focal_length, cam.aperture_diameter,
                           b * n_frames)
        out["images"].append(_np(gather_image(mesh, acc.image, cfg.height)))
        out["rays"].append(int(rays))
    out["frame"] = acc.frame
    spare = band_accumulator(mesh, cfg, device)
    return out, lambda: render(spare, scene, table, ip, iv, cam.focal_length,
                               cam.aperture_diameter, 0)


def _train_job(job, cfg, mesh, scene, cam, faces, device):
    ip, iv, _ = camera_matrices(cam, cfg.width, cfg.height)
    args = (faces, ip, iv, cam.focal_length, cam.aperture_diameter)
    target = job.get("target", 0.25)
    if target == "render":
        band, _ = make_dist_renderer(mesh, cfg)(scene, *args, 0)
        target = gather_image(mesh, band, cfg.height)
    else:
        target = torch.full((cfg.height, cfg.width, 3), float(target), device=device)
    start, mask = scale_spheres(scene, job.get("scale", []))
    adam = job.get("adam")
    optimizer = clipped_adam(lr=adam) if adam else None
    step = make_train_step(mesh, cfg, counts=job.get("counts"),
                           param_mask=mask if job.get("scale") else None,
                           backend=job.get("backend", "kernel"),
                           russian_roulette=job.get("rr", True), optimizer=optimizer,
                           psum_bands=job.get("psum_bands", 1))
    state = {}
    if optimizer is not None:
        state["opt"] = optimizer.init((start.sphere_material, start.cuboid_material))

    def run(s):
        if optimizer is None:
            return step(s, *args, 0, target, job.get("lr", 0.1))
        s, state["opt"], loss = step(s, *args, 0, target, state["opt"])
        return s, loss

    s, losses = start, []
    for _ in range(job.get("steps", 1)):
        s, loss = run(s)
        losses.append(float(loss))
    out = {"losses": losses, "sphere_material": _np(s.sphere_material),
           "cuboid_material": _np(s.cuboid_material),
           "start": (_np(start.sphere_material), _np(start.cuboid_material)),
           "geometry_unchanged": bool(torch.equal(s.sphere_pos_radius, scene.sphere_pos_radius))}
    return out, lambda: run(start)


def _all_reduce_job(job, cfg, mesh, scene, cam, faces, device):
    """One all-reduce over the whole world of a tensor on the rank's
    device: the backend that carried it and the sum."""
    t = torch.full((4,), float(dist.get_rank() + 1), device=device)
    dist.all_reduce(t)
    _sync(device)
    return {"backend": dist.get_backend(), "sum": t.tolist(), "device": str(t.device)}, None


JOBS = {"render": _render_job, "progressive": _progressive_job, "train": _train_job,
        "all_reduce": _all_reduce_job}


def run_jobs(setup: dict, jobs: list) -> list:
    """Run each job at its layout on this rank (a job's ``setup`` entries
    override the common ones).  Returns one dict a job (None on a rank
    outside the job's mesh); images and tables only on the mesh's rank
    (0, 0)."""
    results = []
    for job in jobs:
        scene, cam, faces, device = build_setup({**setup, **job.get("setup", {})})
        mesh = make_mesh(job["dp"], job["sp"], ranks=range(job["dp"] * job["sp"]))
        if mesh.coordinate is None:
            results.append(None)
            continue
        cfg = RenderConfig(**job["cfg"])
        jitters = []
        with recording_jitter(jitters) if job.get("record") else contextlib.nullcontext():
            reset_launches()
            out, again = JOBS[job["kind"]](job, cfg, mesh, scene, cam, faces, device)
            out["launches"] = read_launches()
        if job.get("reps"):
            out["ms"] = _timed(again, job["reps"], mesh, device)
        out["jitters"] = sorted(set(jitters))
        if mesh.coordinate != (0, 0):
            out = {k: v for k, v in out.items()
                   if k in ("launches", "ms", "rays", "losses", "jitters", "backend", "sum")}
        results.append(out)
    return results


def mesh_layouts() -> dict:
    """The host meshes of tests/test_parallel_init.py in this world (one
    host, unless ``local_size`` says otherwise): each call's (shape, rank
    grid, this rank's coordinate), or the error it raised; and what a second
    init_distributed with another topology raises."""
    from .init import init_distributed
    world = dist.get_world_size()
    calls = {"host_sp1": dict(sp=1), "host_sp2": dict(sp=2),
             "host_sp_world_plus_7": dict(sp=world + 7),
             "explicit_4_sp2": dict(sp=2, ranks=[0, 1, 2, 3]),
             "explicit_3_sp1": dict(sp=1, ranks=[0, 1, 2]),
             "explicit_3_sp2": dict(sp=2, ranks=[0, 1, 2]),
             "two_hosts_sp2": dict(sp=2, local_size=2),
             "two_hosts_sp4": dict(sp=4, local_size=2)}
    out = {}
    for name, kw in calls.items():
        try:
            mesh = make_host_mesh(**kw)
            out[name] = (mesh.shape, mesh.ranks.tolist(), mesh.coordinate)
        except ValueError as e:
            out[name] = ("ValueError", str(e))
    mesh = make_mesh(sp=1)
    out["make_mesh_sp1"] = (mesh.shape, mesh.ranks.tolist(), mesh.coordinate)
    try:
        init_distributed("file:///nonexistent", world + 1, dist.get_rank())
    except RuntimeError as e:
        out["reinit"] = ("RuntimeError", str(e))
    return out

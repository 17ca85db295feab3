"""Sharded rendering and inverse-rendering training on ``torch.distributed``
(port of tpt.parallel.dist).

The JAX package runs one program over a ('dp', 'sp') device mesh with
shard_map and psum; here each rank is a process that renders its own part
and meets the others in collectives of the mesh's process groups.  The
axes, their names and the estimator are the JAX package's:

  * ``dp`` shards pixel rows: rank (d, s) renders rows
    ``[d * rows_local, (d + 1) * rows_local)`` of the image padded to a
    multiple of dp (pad rows redo the last row).  Seeds depend only on
    absolute pixel coordinates and the frame index, so dp sharding is bit
    for bit the whole-frame render;
  * ``sp`` shards the samples: the ``groups`` sample groups (default: the
    axis size) are dealt over sp, group ``g`` rendering frame
    ``frame * groups + g``, and the band's groups meet in one sum over
    ``sp``, divided by ``groups``.  That is an equally unbiased estimator
    with other random streams, not the sequential-spp one;
  * the scene and camera are replicated; a band stays on its rank
    (:func:`gather_image` assembles the frame where a caller asks for it);
    the only traffic is the sum over ``sp`` of the band, the ray count's sum
    and, in training, the material gradients' sum over the whole mesh.

Each rank runs the port's single-device code on its band: the trace
kernel's wrappers (tpt_torch.kernels.trace with ``row0``/``n_rows``) and,
in training, ``trace_diff`` with its backward kernels.  A rank on the CPU
runs their plain versions, as everywhere in the port.

A process that never called :func:`tpt_torch.parallel.init_distributed`
(or whose world is one rank) gets a 1x1 mesh whose collectives are
identities, so a single-process caller needs no rendezvous.

Gradient notes: the training step differentiates each rank's own band
sum with autograd and hands it the pixel-MSE cotangent analytically; no
collective is ever differentiated (differentiating an all-reduce would
count the ``sp`` axis twice).  Discrete decisions (lobe pick, roulette,
closest-hit winner) are piecewise constant, so the gradient is the usual
detached-decision estimator of differentiable path tracing.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..config import RenderConfig
from ..env import pack_block_table
from ..integrator import (apply_environment, apply_environment_blocked, camera_params,
                          make_scene_trace_fn, trace_paths)
from ..kernels import trace as _trace
from ..kernels import trace_grad as _trace_grad
from ..kernels.trace import pixel_band
from ..progressive import AccumulatorState
from ..scene import Scene
from ..vecmath import div_scalar
from .init import world_size

AXES = ("dp", "sp")


class _Done:
    """The handle of a collective over one rank: nothing to wait for."""

    def wait(self):
        return True


class Mesh:
    """A ('dp', 'sp') grid of ranks with the process groups of its axes.

    ``ranks`` is the int grid [dp, sp]; ``shape`` maps each axis to its
    size, as a JAX mesh does.  With a process group, the axes' groups come
    from a ``torch.distributed`` DeviceMesh and one more group spans the
    whole grid; in a world of one there are no groups and every collective
    is an identity.  Every rank of the world builds every mesh (group
    creation is collective); a rank outside the grid has no
    :attr:`coordinate` and takes no part in the mesh's work."""

    def __init__(self, ranks: np.ndarray, device_mesh=None, all_group=None):
        self.ranks = ranks
        self.device_mesh = device_mesh
        self._all_group = all_group
        me = dist.get_rank() if dist.is_initialized() else 0
        hit = np.argwhere(ranks == me)
        self.coordinate: Optional[Tuple[int, int]] = (
            (int(hit[0, 0]), int(hit[0, 1])) if len(hit) else None)

    @classmethod
    def from_ranks(cls, rows: Sequence[Sequence[int]]) -> "Mesh":
        grid = np.asarray(rows, dtype=np.int64)
        if grid.ndim != 2 or grid.size == 0:
            raise ValueError(f"a mesh is a non-empty [dp, sp] grid of ranks, got {grid.shape}")
        world = world_size()
        if len(set(grid.ravel().tolist())) != grid.size or grid.min() < 0 \
                or grid.max() >= world:
            raise ValueError(f"mesh ranks {grid.ravel().tolist()} are not distinct ranks of a "
                             f"world of {world}")
        if not dist.is_initialized():
            return cls(grid)
        from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
        if grid.size == world and (grid.ravel() == np.arange(world)).all():
            dm = init_device_mesh(device_type, grid.shape, mesh_dim_names=AXES)
            all_group = dist.group.WORLD
        else:
            dm = DeviceMesh(device_type, torch.as_tensor(grid), mesh_dim_names=AXES)
            all_group = dist.new_group(grid.ravel().tolist())
        return cls(grid, dm, all_group)

    axis_names = AXES

    @property
    def shape(self) -> dict:
        return {"dp": int(self.ranks.shape[0]), "sp": int(self.ranks.shape[1])}

    @property
    def size(self) -> int:
        return int(self.ranks.size)

    def group(self, axes):
        """The process group of ``axes`` ('dp', 'sp' or both) holding this rank."""
        if axes == AXES:
            return self._all_group
        return self.device_mesh.get_group(axes)

    def _axes_size(self, axes) -> int:
        return self.size if axes == AXES else self.shape[axes]

    def all_reduce(self, t: torch.Tensor, axes, async_op: bool = False):
        """Sum ``t`` in place over ``axes`` ('dp', 'sp' or both, as a
        tuple).  Returns the work handle with ``async_op``."""
        if self.device_mesh is None or self._axes_size(axes) == 1:
            return _Done() if async_op else None
        return dist.all_reduce(t, group=self.group(axes), async_op=async_op)

    def gather_rows(self, band: torch.Tensor) -> torch.Tensor:
        """Concatenate the dp-group's bands along rows (dim 0), in dp order."""
        if self.device_mesh is None or self.shape["dp"] == 1:
            return band
        parts = [torch.empty_like(band) for _ in range(self.shape["dp"])]
        dist.all_gather(parts, band.contiguous(), group=self.group("dp"))
        return torch.cat(parts, 0)

    def __repr__(self):
        return f"Mesh(dp={self.shape['dp']}, sp={self.shape['sp']}, ranks={self.ranks.tolist()})"


def make_mesh(dp: Optional[int] = None, sp: int = 1,
              ranks: Optional[Sequence[int]] = None) -> Mesh:
    """Build a ('dp', 'sp') mesh over ``ranks`` (default: the whole world)
    in rank order.  Defaults: every rank on dp."""
    ranks = list(range(world_size())) if ranks is None else [int(r) for r in ranks]
    n = len(ranks)
    if dp is None:
        dp = n // sp
    if dp * sp != n:
        raise ValueError(f"dp*sp = {dp}*{sp} != {n} ranks")
    return Mesh.from_ranks([ranks[i * sp:(i + 1) * sp] for i in range(dp)])


def _pad_rows(height: int, dp: int) -> int:
    return -(-height // dp) * dp


def _member(mesh: Mesh) -> Tuple[int, int]:
    if mesh.coordinate is None:
        raise RuntimeError(f"this rank is not part of {mesh}")
    return mesh.coordinate


def gather_image(mesh: Mesh, band: torch.Tensor, height: int) -> torch.Tensor:
    """The full image f32[height, W, 3] from each rank's band (an all-gather
    over ``dp``; every rank of the mesh gets it)."""
    return mesh.gather_rows(band)[:height]


def band_accumulator(mesh: Mesh, cfg: RenderConfig, device="cpu") -> AccumulatorState:
    """A zero accumulator for this rank's row band, f32[rows_local, W, 3]."""
    rows_local = _pad_rows(cfg.height, mesh.shape["dp"]) // mesh.shape["dp"]
    return AccumulatorState(
        image=torch.zeros((rows_local, cfg.width, 3), dtype=torch.float32, device=device),
        frame=0)


def _oracle_band(scene, env_faces, inv_proj, inv_view, focal, aperture, frame_eff, y0, n_rows,
                 cfg: RenderConfig, counts, rr: bool = True):
    """The plain integrator on rows [y0, y0 + n_rows) with the planar
    environment fetch: the 'oracle' backend, f32[3, n_rows, W]."""
    px, py = pixel_band(cfg.width, cfg.height, n_rows, y0, scene.device)
    cam = camera_params(inv_proj, inv_view, focal, aperture)
    res = trace_paths(make_scene_trace_fn(scene, counts), cam, px, py, cfg.width, cfg.height,
                      int(frame_eff), cfg.ray_depth, cfg.spp, jitter=cfg.jitter,
                      russian_roulette=rr)
    return apply_environment(res, env_faces, cfg.spp), res.ray_count


def make_dist_renderer(mesh: Mesh, cfg: RenderConfig, n_sample_groups: int = None,
                       backend: str = "kernel"):
    """Sharded frame renderer.

    Returns ``render(scene, env_faces, inv_proj, inv_view, focal, aperture,
    frame) -> (band f32[rows_local, W, 3], rays i64)``: this rank's row
    band (rows ``[d * rows_local, (d + 1) * rows_local)`` of the image
    padded to a multiple of dp; :func:`gather_image` assembles the frame)
    and the ray count summed over the whole mesh.

    ``n_sample_groups`` independent sample groups (default: the sp axis
    size, which must divide them) run over 'sp'; each renders cfg.spp
    samples with its own random stream, and the groups' mean is the band.

    ``backend``: 'kernel' (the trace kernel on the band, the environment
    from its pack_block_table table) or 'oracle' (the plain integrator,
    planar environment fetch).  Under pure dp both equal a whole-frame
    single-process render bit for bit.
    """
    if backend not in ("kernel", "oracle"):
        raise ValueError(f"unknown backend {backend!r}")
    dp, sp = mesh.shape["dp"], mesh.shape["sp"]
    groups = n_sample_groups or sp
    if groups % sp:
        raise ValueError(f"n_sample_groups {groups} must divide over sp={sp}")
    groups_per_shard = groups // sp
    rows_local = _pad_rows(cfg.height, dp) // dp
    counts = cfg.static_counts

    def render(scene, env_faces, inv_proj, inv_view, focal, aperture, frame):
        dp_idx, sp_idx = _member(mesh)
        y0 = dp_idx * rows_local
        env = pack_block_table(env_faces) if backend == "kernel" else env_faces
        acc = torch.zeros((3, rows_local, cfg.width), dtype=torch.float32, device=scene.device)
        rays = torch.zeros((), dtype=torch.int64, device=scene.device)
        for g in range(groups_per_shard):
            frame_eff = int(frame) * groups + sp_idx * groups_per_shard + g
            if backend == "kernel":
                res = _trace.trace(scene, inv_proj, inv_view, frame_eff, focal, aperture,
                                   width=cfg.width, height=cfg.height, ray_depth=cfg.ray_depth,
                                   spp=cfg.spp, counts=counts, n_rows=rows_local, row0=y0,
                                   jitter=cfg.jitter)
                acc = acc + apply_environment_blocked(res, env, cfg.spp)
                count = res.ray_count
            else:
                mean, count = _oracle_band(scene, env, inv_proj, inv_view, focal, aperture,
                                           frame_eff, y0, rows_local, cfg, counts)
                acc = acc + mean
            rays = rays + count.sum()
        mesh.all_reduce(acc, "sp")
        mesh.all_reduce(rays, AXES)
        return torch.movedim(div_scalar(acc, groups), 0, -1), rays

    return render


def make_dist_progressive(mesh: Mesh, cfg: RenderConfig, n_frames: int,
                          tile_rows: int | None = None):
    """Sharded progressive block renderer, the multi-rank twin of
    kernels.render.progressive_frames.

    Each rank folds a block of frames into its row band with one launch of
    the trace kernel's environment mode on the band.  The 'sp' axis shards
    the block's frames: rank (d, s) renders frames
    ``[frame0 + s * n_frames / sp, ...)`` and the bands' sums meet in one
    sum over sp.  The estimator is the single-process block's (seeds depend
    only on pixel coordinates and frame indices); only the order of the sum
    over frames differs, in the last bits.

    Returns ``render_block(accum, scene, env_table, inv_proj, inv_view,
    focal, aperture, frame0) -> (accum, rays)``: ``accum`` is this rank's
    band accumulator (:func:`band_accumulator`), updated in place;
    ``env_table`` a pack_block_table table; ``rays`` the mesh's total.
    ``n_frames`` must divide by sp.  ``tile_rows`` is the TPU kernel's tile
    height, accepted for the JAX signature: the CUDA kernel has no tile to
    size, so it is unused.
    """
    del tile_rows
    dp, sp = mesh.shape["dp"], mesh.shape["sp"]
    if n_frames % sp:
        raise ValueError(f"n_frames {n_frames} must divide by sp={sp}")
    f_loc = n_frames // sp
    rows_local = _pad_rows(cfg.height, dp) // dp

    def render_block(accum: AccumulatorState, scene, env_table, inv_proj, inv_view, focal,
                     aperture, frame0):
        dp_idx, sp_idx = _member(mesh)
        res = _trace.trace_progressive(
            scene, inv_proj, inv_view, int(frame0) + sp_idx * f_loc, focal, aperture,
            width=cfg.width, height=cfg.height, ray_depth=cfg.ray_depth, spp=cfg.spp,
            n_frames=f_loc, counts=cfg.static_counts, n_rows=rows_local,
            row0=dp_idx * rows_local, jitter=cfg.jitter, env_table=env_table)
        total = res.rad_sum
        mesh.all_reduce(total, "sp")
        image = div_scalar(torch.movedim(total, 0, -1), cfg.spp)
        n0 = np.float32(accum.frame)
        accum.image.mul_(float(n0)).add_(image).div_(
            torch.tensor(n0 + np.float32(n_frames), device=accum.image.device))
        accum.frame += n_frames
        rays = res.ray_count.sum()
        mesh.all_reduce(rays, AXES)
        return accum, rays

    return render_block


def trainable_filter_grads(grads: Scene) -> Scene:
    """Zero gradients for non-optimizable scene leaves (geometry, counts):
    inverse rendering here optimizes the material tables."""
    return Scene(sphere_pos_radius=torch.zeros_like(grads.sphere_pos_radius),
                 sphere_material=grads.sphere_material,
                 cuboid_min=torch.zeros_like(grads.cuboid_min),
                 cuboid_max=torch.zeros_like(grads.cuboid_max),
                 cuboid_material=grads.cuboid_material, num_spheres=0, num_cuboids=0)


def make_train_step(mesh: Mesh, cfg: RenderConfig, n_sample_groups: int = None,
                    counts: Tuple[int, int] = None, param_mask=None, backend: str = "kernel",
                    russian_roulette: bool = True, optimizer=None, psum_bands: int = 1):
    """Inverse-rendering step: pixel MSE against a target image, gradient
    descent on the material tables.

    With ``optimizer=None`` (bare SGD): ``step(scene, env_faces, inv_proj,
    inv_view, focal, aperture, frame, target f32[H, W, 3], lr) ->
    (new_scene, loss)``.  With ``optimizer`` a tpt_torch.optim.ClippedAdam:
    the step takes ``opt_state`` in place of ``lr`` and returns
    ``(new_scene, new_opt_state, loss)``; initialize with
    ``optimizer.init((scene.sphere_material, scene.cuboid_material))``.
    Every rank of the mesh gets the same new scene and loss.

    ``param_mask``: optional (sphere_mask, cuboid_mask) 0/1 tensors shaped
    like the material tables; entries with mask 0 stay frozen.

    ``backend``: 'kernel' = trace_diff (the trace kernel forward, the
    backward kernels) on each band, which needs ``counts``; 'oracle' =
    autograd through the plain integrator.

    How the gradient is formed, the one code path for every
    ``psum_bands``: each rank splits its band into ``psum_bands`` sub-bands;
    for each, it computes its own groups' radiance sum with autograd, sums
    a detached copy over 'sp' to form the image and the error against the
    target (masked to the image's rows), and hands the analytic cotangent
    ``2 * err / groups`` to autograd; the sub-band's material gradients and
    squared error go into one all-reduce over the whole mesh, started
    asynchronously so that it overlaps the next sub-band's work.  The
    handles are waited on before the update, and the sums are normalised
    once by ``H * W * 3``.  ``psum_bands`` must divide the rank's band.

    ``russian_roulette=False`` selects fixed-depth transport: roulette'd
    pixel values depend only on albedo ratios, so albedo-scale recovery
    needs it off (tpt_torch.integrator.bounce_step).
    """
    if backend not in ("kernel", "oracle"):
        raise ValueError(f"unknown backend {backend!r}")
    if backend == "kernel" and counts is None:
        raise ValueError("backend='kernel' requires explicit counts, e.g. counts=(48, 7) for "
                         "the demo scene")
    dp, sp = mesh.shape["dp"], mesh.shape["sp"]
    groups = n_sample_groups or sp
    if groups % sp:
        raise ValueError(f"n_sample_groups {groups} must divide over sp={sp}")
    groups_per_shard = groups // sp
    hpad = _pad_rows(cfg.height, dp)
    rows_local = hpad // dp
    if rows_local % psum_bands:
        raise ValueError(f"psum_bands {psum_bands} must divide the local row band "
                         f"({rows_local} rows at dp={dp})")
    rows_sub = rows_local // psum_bands
    width, height, spp = cfg.width, cfg.height, cfg.spp
    if counts is None:
        warnings.warn("make_train_step(backend='oracle') without counts differentiates the "
                      "whole 320-slot padded scan; pass counts=(n_spheres, n_cuboids)",
                      stacklevel=2)
    c = tuple(counts) if counts is not None else (256, 64)

    def band_sum(scene, env, inv_proj, inv_view, focal, aperture, frame, sp_idx, y0b):
        """This rank's sample-group radiance sum on one sub-band,
        f32[3, rows_sub, W]: the only part autograd touches."""
        acc = torch.zeros((3, rows_sub, width), dtype=torch.float32, device=scene.device)
        for g in range(groups_per_shard):
            frame_eff = int(frame) * groups + sp_idx * groups_per_shard + g
            if backend == "kernel":
                res = _trace_grad.trace_diff(
                    scene, inv_proj, inv_view, frame_eff, focal, aperture, y0b, width=width,
                    height=height, ray_depth=cfg.ray_depth, spp=spp, counts=c, n_rows=rows_sub,
                    jitter=cfg.jitter, rr=russian_roulette)
                acc = acc + apply_environment_blocked(res, env, spp)
            else:
                mean, _ = _oracle_band(scene, env, inv_proj, inv_view, focal, aperture,
                                       frame_eff, y0b, rows_sub, cfg, c, russian_roulette)
                acc = acc + mean
        return acc

    def grads(scene, env_faces, inv_proj, inv_view, focal, aperture, frame, target):
        dp_idx, sp_idx = _member(mesh)
        dev = scene.device
        env = pack_block_table(env_faces) if backend == "kernel" else env_faces
        target = torch.as_tensor(target, dtype=torch.float32, device=dev)
        sm = scene.sphere_material.detach().requires_grad_(True)
        cm = scene.cuboid_material.detach().requires_grad_(True)
        s = dataclasses.replace(scene, sphere_material=sm, cuboid_material=cm)
        n_s, n_c = sm.numel(), cm.numel()
        pending = []
        for b in range(psum_bands):
            y0b = dp_idx * rows_local + b * rows_sub
            rows = torch.arange(y0b, y0b + rows_sub, device=dev)
            valid = (rows < height).to(torch.float32)[:, None, None]
            target_sub = target[torch.clamp_max(rows, height - 1)]
            acc_local = band_sum(s, env, inv_proj, inv_view, focal, aperture, frame, sp_idx,
                                 y0b)
            acc = acc_local.detach().clone()
            mesh.all_reduce(acc, "sp")
            image = torch.movedim(div_scalar(acc, groups), 0, -1)
            err = (image - target_sub) * valid
            sse = torch.sum(err * err)
            # d(sse)/d(acc_local) by hand: 2 * err through the mean over groups
            ct = div_scalar(torch.movedim(2.0 * err, -1, 0), groups)
            gs, gc = torch.autograd.grad(acc_local, (sm, cm), grad_outputs=ct,
                                         allow_unused=True, materialize_grads=True)
            # every sp rank holds the same error: count its square once
            packet = torch.cat([gs.reshape(-1), gc.reshape(-1),
                                (sse if sp_idx == 0 else torch.zeros_like(sse)).reshape(1)])
            pending.append((packet, mesh.all_reduce(packet, AXES, async_op=True)))
        total = torch.zeros(n_s + n_c + 1, dtype=torch.float32, device=dev)
        for packet, handle in pending:
            handle.wait()
            total = total + packet
        total = div_scalar(total, height * width * 3)
        g_sphere = total[:n_s].reshape(sm.shape)
        g_cuboid = total[n_s:n_s + n_c].reshape(cm.shape)
        if param_mask is not None:
            g_sphere = g_sphere * param_mask[0]
            g_cuboid = g_cuboid * param_mask[1]
        return total[-1], g_sphere, g_cuboid

    if optimizer is None:
        def step(scene, env_faces, inv_proj, inv_view, focal, aperture, frame, target, lr):
            loss, g_sphere, g_cuboid = grads(scene, env_faces, inv_proj, inv_view, focal,
                                             aperture, frame, target)
            new_scene = dataclasses.replace(
                scene, sphere_material=scene.sphere_material - lr * g_sphere,
                cuboid_material=scene.cuboid_material - lr * g_cuboid)
            return new_scene, loss

        return step

    def opt_step(scene, env_faces, inv_proj, inv_view, focal, aperture, frame, target,
                 opt_state):
        loss, g_sphere, g_cuboid = grads(scene, env_faces, inv_proj, inv_view, focal,
                                         aperture, frame, target)
        params = (scene.sphere_material, scene.cuboid_material)
        updates, opt_state = optimizer.update((g_sphere, g_cuboid), opt_state, params)
        new_scene = dataclasses.replace(scene, sphere_material=params[0] + updates[0],
                                        cuboid_material=params[1] + updates[1])
        return new_scene, opt_state, loss

    return opt_step

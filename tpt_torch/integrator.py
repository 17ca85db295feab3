"""The light-transport integrator core, forward half (port of
tpt.integrator).

A faithful re-derivation of the reference GLSL integrator
(res/shaders/PathTracing/compute.glsl:101-224) in batched form over any
pixel batch shape:

  * the per-pixel ``rndSeed`` is an explicit seed tensor whose draw sites
    advance in exactly the shader's order (see tpt_torch.rng for the int64
    carrier), so the random stream matches the shader draw-for-draw;
  * ``break`` becomes an alive mask over the bounce loop;
  * the environment lookup for escaped rays is *deferred*: a sample misses
    at most once, so the transport records (miss_direction,
    throughput-at-miss) per sample and the cubemap fetch happens afterwards.

Deliberate, documented deviations from the shader (which hits undefined
behavior in these spots), kept from the JAX package:
  * total internal reflection with zero refraction roughness: the shader
    normalizes a zero vector (NaN); this falls back to the mirror
    reflection direction;
  * normalize() of degenerate vectors is floored at 1e-20 squared length.

These functions are the plain versions of the CUDA kernels
(tpt_torch/csrc/trace.cu, trace_grad.cu), which repeat every float
operation below in the same order.  They run on any device and are
differentiable with autograd: as in the JAX package, discrete decisions
(closest-hit winner, lobe pick, Russian roulette) carry no gradient, and
every maximum against a constant splits ties like ``jnp.maximum``
(tpt_torch.vecmath.max_const).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Tuple, Union

import numpy as np
import torch

from . import rng
from .config import MAX_SPHERES, KERNEL_EPSILON
from .vecmath import div_scalar, dot3, max_const, normalize3, max3, mix
from .ops.intersect import (FLOAT_MAX, ray_sphere, ray_cuboid,
                            smallest_positive, sphere_normal, cuboid_normal)
from .ops.sampling import cosine_sample_hemisphere, uniform_sample_unit_circle
from .ops.bsdf_math import fresnel_schlick, reflect3, refract3
from .env import sample_environment_blocked, sample_environment_planar

EPS = float(np.float32(KERNEL_EPSILON))
_TINY = float(np.float32(1e-20))
_TIR_LEN2 = float(np.float32(1e-12))


class Winner(NamedTuple):
    """Per-lane attributes of the closest-hit primitive."""
    material: torch.Tensor       # f32[16, *batch] (tpt_torch.materials layout)
    sphere_center: torch.Tensor  # f32[3, *batch]
    sphere_radius: torch.Tensor  # f32[*batch]
    cuboid_min: torch.Tensor     # f32[3, *batch]
    cuboid_max: torch.Tensor     # f32[3, *batch]
    is_sphere: torch.Tensor      # bool[*batch]


Scalar = Union[float, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class CameraParams:
    """Camera inputs as f32 scalars: Python floats, or 0-d f32 tensors that
    autograd follows back to the matrices they were taken from.

    ``ip??`` are inverse-projection elements used by the eye-ray transform;
    ``right``/``up``/``backward``/``eye`` are the inverse-view columns."""
    ip00: Scalar
    ip01: Scalar
    ip02: Scalar
    ip10: Scalar
    ip11: Scalar
    ip12: Scalar
    right: Tuple[Scalar, Scalar, Scalar]
    up: Tuple[Scalar, Scalar, Scalar]
    backward: Tuple[Scalar, Scalar, Scalar]
    eye: Tuple[Scalar, Scalar, Scalar]
    focal_length: Scalar
    aperture_diameter: Scalar


def _scalar(x) -> Scalar:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).reshape(())
    return float(np.float32(x))


def camera_params(inv_proj, inv_view, focal_length, aperture_diameter) -> CameraParams:
    """Build CameraParams from 4x4 inverse matrices (element extraction only).

    Tensors are kept: the entries are 0-d views of the matrices, so a
    gradient reaches ``inv_proj``, ``inv_view``, the focal length and the
    aperture.  Host values (numpy arrays, floats) become Python floats.
    The view position is inv_view's translation column — identical to the
    ViewPos the reference uploads (Camera.Position, src/MainWindow.cs:132)."""
    def entries(m):
        if isinstance(m, torch.Tensor):
            return m.to(torch.float32)
        return np.asarray(m, np.float32).tolist()

    ip, iv = entries(inv_proj), entries(inv_view)
    col = lambda j: (iv[0][j], iv[1][j], iv[2][j])
    return CameraParams(
        ip00=ip[0][0], ip01=ip[0][1], ip02=ip[0][2],
        ip10=ip[1][0], ip11=ip[1][1], ip12=ip[1][2],
        right=col(0), up=col(1), backward=col(2), eye=col(3),
        focal_length=_scalar(focal_length),
        aperture_diameter=_scalar(aperture_diameter),
    )


def _splat(components, like: torch.Tensor) -> torch.Tensor:
    """Broadcast 3 scalars to f32[3, *batch] of ``like``."""
    if any(isinstance(c, torch.Tensor) for c in components):
        v = torch.stack([torch.as_tensor(c, dtype=torch.float32) for c in components])
        v = v.to(like.device)
    else:
        v = torch.tensor(components, dtype=torch.float32, device=like.device)
    return v.view((3,) + (1,) * like.dim()).expand((3,) + tuple(like.shape))


# trace_fn(origin, direction) -> (found bool, t f32, inside bool, Winner)
TraceFn = Callable[[torch.Tensor, torch.Tensor],
                   Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Winner]]


def make_scene_scan_fn(scene, counts: Tuple[int, int] | None = None):
    """Sequential closest-hit fold in the shader's scan order
    (compute.glsl:226-258): all spheres first, then all cuboids, keeping a
    candidate when ``ok && t2 > 0 && t1 < bestT``.  The fold is
    order-dependent (a candidate's raw t1 — possibly negative — is compared
    against the incumbent's smallest-positive T), which is reproduced
    exactly.  ``counts`` overrides the scene's (n_spheres, n_cuboids).

    Returns scan(origin, direction) -> (found, winner index, t, inside)."""
    ns, nc = counts if counts is not None else scene.counts

    def scan(origin, direction):
        batch = origin.shape[1:]
        col = (3,) + (1,) * len(batch)
        best_t = torch.full(batch, FLOAT_MAX, dtype=torch.float32, device=origin.device)
        best_idx = torch.full(batch, -1, dtype=torch.int32, device=origin.device)
        best_inside = torch.zeros(batch, dtype=torch.bool, device=origin.device)

        def consider(t1, t2, ok, idx):
            cond = ok & (t2 > 0.0) & (t1 < best_t)
            t = smallest_positive(t1, t2)
            best_inside.copy_(torch.where(cond, t == t2, best_inside))
            best_idx.masked_fill_(cond, idx)
            best_t.copy_(torch.where(cond, t, best_t))

        for i in range(ns):
            row = scene.sphere_pos_radius[i]
            t1, t2, ok = ray_sphere(origin, direction, row[:3].view(col), row[3])
            consider(t1, t2, ok, i)
        for i in range(nc):
            t1, t2, ok = ray_cuboid(origin, direction,
                                    scene.cuboid_min[i].view(col),
                                    scene.cuboid_max[i].view(col))
            consider(t1, t2, ok, MAX_SPHERES + i)
        # found-check via T != FLOAT_MAX — the shader's convention
        # (compute.glsl:257), kept identical in every implementation
        return best_t != FLOAT_MAX, best_idx, best_t, best_inside

    return scan


def make_gather_fn(scene):
    """Winner-attribute gather by index: gather(idx) -> Winner."""

    def gather(idx) -> Winner:
        is_sphere = (idx >= 0) & (idx < MAX_SPHERES)
        sidx = torch.clamp(idx, 0, MAX_SPHERES - 1).long()
        cidx = torch.clamp(idx - MAX_SPHERES, 0, scene.cuboid_min.shape[0] - 1).long()
        # [*batch, k] gathers, moved to leading-component layout
        smat = torch.movedim(scene.sphere_material[sidx], -1, 0)
        cmat = torch.movedim(scene.cuboid_material[cidx], -1, 0)
        spr = torch.movedim(scene.sphere_pos_radius[sidx], -1, 0)
        return Winner(
            material=torch.where(is_sphere, smat, cmat),
            sphere_center=spr[:3],
            sphere_radius=spr[3],
            cuboid_min=torch.movedim(scene.cuboid_min[cidx], -1, 0),
            cuboid_max=torch.movedim(scene.cuboid_max[cidx], -1, 0),
            is_sphere=is_sphere,
        )

    return gather


def make_scene_trace_fn(scene, counts: Tuple[int, int] | None = None) -> TraceFn:
    """Closest-hit trace over the scene: the scan fold, then the winner
    gather."""
    scan, gather = make_scene_scan_fn(scene, counts), make_gather_fn(scene)

    def trace(origin, direction):
        found, idx, t, inside = scan(origin, direction)
        return found, t, inside, gather(idx)

    return trace


ATTR_ROWS = 128   # at most ns + nc primitives
ATTR_COLS = 24    # 0:4 sphere geom | 4:10 cuboid geom | 10:24 material


def build_attr_table(scene, counts: Tuple[int, int]) -> torch.Tensor:
    """Pack the differentiable scene parameters into the winner-attribute
    table f32[ATTR_ROWS, ATTR_COLS]: row i < ns = sphere i (center, radius,
    zeros, material lanes 0:14), row ns + j = cuboid j (zeros, min, max,
    material lanes 0:14); zero-padded (tpt.integrator.build_attr_table).

    Differentiable torch ops: autograd maps a table cotangent back to the
    Scene leaves."""
    ns, nc = counts
    if ns + nc > ATTR_ROWS:
        raise ValueError(f"the attribute table holds <= {ATTR_ROWS} primitives, got {ns}+{nc}")
    z = dict(dtype=torch.float32, device=scene.device)
    sph = torch.cat([scene.sphere_pos_radius[:ns], torch.zeros((ns, 6), **z),
                     scene.sphere_material[:ns, :14]], dim=1)
    cub = torch.cat([torch.zeros((nc, 4), **z), scene.cuboid_min[:nc],
                     scene.cuboid_max[:nc], scene.cuboid_material[:nc, :14]], dim=1)
    pad = torch.zeros((ATTR_ROWS - ns - nc, ATTR_COLS), **z)
    return torch.cat([sph, cub, pad], dim=0)


def table_hit_trace(table, num_spheres: int, origin, direction, idx, inside):
    """Differentiable winner evaluation from a precomputed (detached) hit
    record: the winner's row of the attribute table gathered by index, and
    the winning distance recomputed from the gathered geometry — the
    by-index form of tpt.integrator.onehot_hit_trace, with the same primal
    values as the scan-and-gather trace.

    ``idx``: the closest-hit fold's winner (-1 = miss, spheres i, cuboids
    MAX_SPHERES + j); ``inside``: the fold's inside flag."""
    found = idx >= 0
    is_sphere = found & (idx < MAX_SPHERES)
    row = torch.where(is_sphere, idx, idx - MAX_SPHERES + num_spheres)
    attrs = torch.movedim(table[torch.clamp_min(row, 0).long()], -1, 0)
    attrs = torch.where(found, attrs, 0.0)
    center, radius = attrs[0:3], attrs[3]
    cmin, cmax, mat = attrs[4:7], attrs[7:10], attrs[10:24]

    # Gradient hygiene (as tpt): axis-parallel rays give ray_cuboid
    # infinite partials (1/d); neutralise the direction on lanes whose
    # winner is not a cuboid so 0-cotangent x inf can't NaN the transpose.
    dir_c = torch.where(found & ~is_sphere, direction, 1.0)
    t1s, t2s, _ = ray_sphere(origin, direction, center, max_const(radius, EPS))
    t1c, t2c, _ = ray_cuboid(origin, dir_c, cmin, cmax)
    t = smallest_positive(torch.where(is_sphere, t1s, t1c), torch.where(is_sphere, t2s, t2c))
    return found, t, inside, Winner(material=mat, sphere_center=center,
                                    sphere_radius=radius, cuboid_min=cmin,
                                    cuboid_max=cmax, is_sphere=is_sphere)


def make_onehot_gather_trace_fn(scan_fn, table, num_spheres: int) -> TraceFn:
    """The forward trace of the one-hot TPU kernel
    (tpt/kernels/trace.py:235-254): the scan fold gives found, the winner,
    ``t`` and inside (``t`` is the fold's own, not recomputed as in
    :func:`table_hit_trace`), and the winner's attributes are its row of
    ``table`` (:func:`build_attr_table`), zero on a miss.  Sphere i is row
    i, cuboid j is row ``num_spheres + j``.

    The TPU kernel takes the row with a one-hot [24, 128] x [128, B]
    product because it has no per-lane gather; reading by index gives the
    same values, so this trace is bit-identical to the select gather of
    :func:`make_scene_trace_fn`.  One value could differ: the product turns
    a -0.0 in the table into +0.0 where the index read keeps it.  Such a
    zero reaches an output only as the sign of a zero (a -0.0 albedo gives
    a -0.0 throughput in ``miss_thr``), which compares equal, and neither
    the demo nor the Cornell table holds one."""

    def trace(origin, direction):
        found, idx, t, inside = scan_fn(origin, direction)
        hit = idx >= 0
        is_sphere = hit & (idx < MAX_SPHERES)
        row = torch.where(is_sphere, idx, idx - MAX_SPHERES + num_spheres)
        attrs = torch.movedim(table[torch.clamp_min(row, 0).long()], -1, 0)
        attrs = torch.where(hit, attrs, 0.0)
        return found, t, inside, Winner(material=attrs[10:24], sphere_center=attrs[0:3],
                                        sphere_radius=attrs[3], cuboid_min=attrs[4:7],
                                        cuboid_max=attrs[7:10], is_sphere=is_sphere)

    return trace


def make_table_trace_fn(scan_fn, table, num_spheres: int) -> TraceFn:
    """Differentiable closest-hit trace: the scan fold on detached rays for
    the winner index (the discrete argmin carries no gradient), then
    :func:`table_hit_trace` for the attributes and ``t``."""

    def trace(origin, direction):
        with torch.no_grad():
            _found, idx, _t, inside = scan_fn(origin.detach(), direction.detach())
        return table_hit_trace(table, num_spheres, origin, direction, idx, inside)

    return trace


@dataclasses.dataclass(frozen=True)
class PathState:
    """Per-lane bounce-loop carry."""
    origin: torch.Tensor       # f32[3, B]
    direction: torch.Tensor    # f32[3, B]
    throughput: torch.Tensor   # f32[3, B]
    radiance: torch.Tensor     # f32[3, B]   emission picked up so far
    seed: torch.Tensor         # i64[B]      uint32 value (tpt_torch.rng)
    alive: torch.Tensor        # bool[B]
    miss_dir: torch.Tensor     # f32[3, B]   direction at escape (0 if none yet)
    miss_thr: torch.Tensor     # f32[3, B]   throughput at escape (0 if none)
    ray_count: torch.Tensor    # i32[B]      traced segments (for Mrays/s)


def bounce_step(state: PathState, trace_fn: TraceFn,
                russian_roulette: bool = True) -> PathState:
    """One bounce of the Radiance loop (compute.glsl:132-182).

    ``russian_roulette=False`` disables the RR termination/reweighting
    (compute.glsl:166-173) — the fixed-depth transport of the
    differentiable path.  The RR roll is still drawn, keeping the RNG
    stream aligned with rr=True draw-for-draw."""
    o, d, thr, rad, seed = (state.origin, state.direction, state.throughput,
                            state.radiance, state.seed)
    alive = state.alive

    found, t, inside, w = trace_fn(o, d)
    ray_count = state.ray_count + alive.to(torch.int32)
    hit = alive & found
    miss = alive & ~found

    mat = w.material
    albedo = mat[0:3]
    spec0 = mat[3]
    emissive = mat[4:7]
    spec_rough = mat[7]
    absorb = mat[8:11]
    refr0 = mat[11]
    refr_rough = mat[12]
    ior = mat[13]

    t_safe = torch.where(found, t, 1.0)            # miss lanes carry FLOAT_MAX
    ior_safe = max_const(ior, EPS)                 # padded materials carry 0

    hp = o + d * t_safe
    n_raw = torch.where(w.is_sphere,
                   sphere_normal(w.sphere_center,
                                 max_const(w.sphere_radius, EPS), hp),
                   cuboid_normal(w.cuboid_min, w.cuboid_max, hp))
    n = torch.where(inside, -n_raw, n_raw)

    # Beer's law when exiting a medium (compute.glsl:145-149)
    t_beer = torch.where(hit & inside, t_safe, 0.0)
    thr = torch.where(hit & inside, thr * torch.exp(-absorb * t_beer), thr)

    # --- BSDF lobe probabilities (compute.glsl:184-195) ---
    n1 = torch.where(inside, ior_safe, 1.0)
    n2 = torch.where(inside, 1.0, ior_safe)
    fres = fresnel_schlick(dot3(-d, n), n1, n2)
    spec_f = mix(spec0, 1.0, fres)
    diffuse_c = 1.0 - spec_f - refr0
    spec = torch.where(spec0 > 0.0, spec_f, spec0)
    refr = torch.where(spec0 > 0.0, 1.0 - spec_f - diffuse_c, refr0)

    # --- RNG draws, in shader order ---
    r_z, s1 = rng.random_float01(seed)
    r_a, s2 = rng.random_float01(s1)
    diffuse_ray = cosine_sample_hemisphere(n, r_z, r_a)
    roll, s3 = rng.random_float01(s2)
    take_spec = spec > roll
    take_refr = (~take_spec) & (spec + refr > roll)
    r_z2, s4 = rng.random_float01(s3)
    r_a2, s5 = rng.random_float01(s4)
    seed_after_bsdf = torch.where(take_refr, s5, s3)

    # --- lobe directions ---
    refl_pure = reflect3(d, n)
    refl_dir = normalize3(mix(refl_pure, diffuse_ray, spec_rough * spec_rough),
                          eps=_TINY)
    eta = torch.where(inside, ior_safe, 1.0 / ior_safe)
    refr_raw, _tir = refract3(d, n, eta)
    hemi_neg = cosine_sample_hemisphere(-n, r_z2, r_a2)
    refr_mixed = mix(refr_raw, hemi_neg, refr_rough * refr_rough)
    refr_len2 = dot3(refr_mixed, refr_mixed)
    # TIR with ~zero roughness degenerates to the zero vector (shader UB);
    # defined policy: mirror reflection.
    refr_dir = torch.where(refr_len2 > _TIR_LEN2,
                      refr_mixed / torch.sqrt(max_const(refr_len2, _TIR_LEN2)),
                      refl_pure)

    new_d = torch.where(take_spec, refl_dir, torch.where(take_refr, refr_dir, diffuse_ray))
    p = torch.where(take_spec, spec,
                    torch.where(take_refr, refr, 1.0 - spec - refr))
    p = max_const(p, EPS)
    new_o = hp + new_d * EPS

    # --- throughput / radiance updates (compute.glsl:156-164) ---
    rad = rad + torch.where(hit, emissive * thr, 0.0)
    thr_after = torch.where(hit & ~take_refr, thr * albedo, thr)
    thr_after = torch.where(hit, thr_after / p, thr_after)

    # --- Russian roulette (compute.glsl:166-173) ---
    p_max = max3(thr_after)
    rr_roll, s6 = rng.random_float01(seed_after_bsdf)
    if russian_roulette:
        die = rr_roll > p_max
        survive = hit & ~die
        p_max_safe = torch.where(survive, p_max, 1.0)
        thr_after = torch.where(survive, thr_after / p_max_safe, thr_after)
    else:
        survive = hit

    # --- escaped rays: defer the environment fetch ---
    return PathState(
        origin=torch.where(hit, new_o, o),
        direction=torch.where(hit, new_d, d),
        throughput=torch.where(hit, thr_after, thr),
        radiance=rad,
        seed=torch.where(hit, s6, seed),
        alive=survive,
        miss_dir=torch.where(miss, d, state.miss_dir),
        miss_thr=torch.where(miss, thr, state.miss_thr),
        ray_count=ray_count,
    )


def sample_draws(seed):
    """The four per-sample RNG draws preceding the bounce loop, in shader
    order (compute.glsl:113-119): sub-pixel jitter x/y, lens angle, lens
    radius.  Returns ((jx, jy, r_angle, r_radius), seed_after)."""
    jx, seed = rng.random_float01(seed)
    jy, seed = rng.random_float01(seed)
    r_angle, seed = rng.random_float01(seed)
    r_radius, seed = rng.random_float01(seed)
    return (jx, jy, r_angle, r_radius), seed


def primary_ray(cam: CameraParams, fpx, fpy, width: int, height: int,
                draws, jitter: str = "corner"):
    """Jittered thin-lens eye ray (compute.glsl:113-121,352-357)."""
    jx, jy, r_angle, r_radius = draws
    right = _splat(cam.right, fpx)
    up = _splat(cam.up, fpx)
    backward = _splat(cam.backward, fpx)
    eye = _splat(cam.eye, fpx)

    if jitter == "corner":
        u = div_scalar(fpx + jx, width) * 2.0 - 1.0
        v = div_scalar(fpy + jy, height) * 2.0 - 1.0
    else:
        u = (div_scalar(fpx + 0.5, width) + div_scalar(jx - 0.5, width)) * 2.0 - 1.0
        v = (div_scalar(fpy + 0.5, height) + div_scalar(jy - 0.5, height)) * 2.0 - 1.0

    # eye ray (compute.glsl:352-357): invP @ (u, v, -1, 0), zw := (-1, 0)
    ex = cam.ip00 * u + cam.ip01 * v - cam.ip02
    ey = cam.ip10 * u + cam.ip11 * v - cam.ip12
    d = normalize3(right * ex + up * ey - backward)

    # thin-lens DoF (compute.glsl:117-121)
    focal_point = eye + d * cam.focal_length
    cx, cy = uniform_sample_unit_circle(r_angle, r_radius)
    half_ap = cam.aperture_diameter * 0.5     # exact: a power-of-two scale
    o = eye + right * (half_ap * cx) + up * (half_ap * cy)
    d = normalize3(focal_point - o)
    return o, d


class TraceResult(NamedTuple):
    radiance: torch.Tensor    # f32[3, *B]        emission-path radiance, summed over spp
    miss_dir: torch.Tensor    # f32[spp, 3, *B]   escape directions (0 where none)
    miss_thr: torch.Tensor    # f32[spp, 3, *B]   throughput at escape (0 where none)
    ray_count: torch.Tensor   # i32[*B]           traced segments
    seed: torch.Tensor        # i64[*B]           final RNG state (uint32 value)


def _check_jitter(jitter: str):
    if jitter not in ("corner", "center"):
        raise ValueError(f"jitter must be 'corner' or 'center', got {jitter!r}")


def trace_paths(trace_fn: TraceFn, cam: CameraParams,
                px, py, width: int, height: int, frame,
                ray_depth: int, spp: int, jitter: str = "corner",
                russian_roulette: bool = True) -> TraceResult:
    """Full per-pixel sampling loop (compute.glsl:101-130), environment
    fetch deferred.  ``px``/``py`` are integer pixel coords (GL convention:
    y bottom-up) of any batch shape.

    ``jitter`` selects the reference's sub-pixel jitter arithmetic:
    ``"corner"`` (the compute variant, ndc = (p + rand01)/size*2-1) or
    ``"center"`` (the shipped fragment variant,
    ndc = ((p+0.5)/size + (rand01-0.5)/size)*2-1).  They are algebraically
    identical and differ only in float rounding order.

    Bounces stop early once every lane is dead (Russian roulette keeps
    E[bounces] far below ray_depth); that changes no result."""
    _check_jitter(jitter)
    seed = rng.pixel_seed(px, py, frame)
    fpx = px.to(torch.float32)
    fpy = py.to(torch.float32)

    rad_total = torch.zeros((3,) + tuple(px.shape), dtype=torch.float32, device=px.device)
    ray_count = torch.zeros(px.shape, dtype=torch.int32, device=px.device)
    miss_dirs = []
    miss_thrs = []

    for _ in range(spp):
        draws, seed = sample_draws(seed)
        o, d = primary_ray(cam, fpx, fpy, width, height, draws, jitter)
        zero_v3 = torch.zeros_like(o)
        state = PathState(origin=o, direction=d, throughput=torch.ones_like(o),
                          radiance=zero_v3, seed=seed,
                          alive=torch.ones_like(ray_count, dtype=torch.bool),
                          miss_dir=zero_v3, miss_thr=zero_v3, ray_count=ray_count)
        for _bounce in range(ray_depth):
            if _bounce > 0 and not bool(state.alive.any()):
                break
            state = bounce_step(state, trace_fn, russian_roulette)

        rad_total = rad_total + state.radiance
        miss_dirs.append(state.miss_dir)
        miss_thrs.append(state.miss_thr)
        seed = state.seed
        ray_count = state.ray_count

    return TraceResult(
        radiance=rad_total,
        miss_dir=torch.stack(miss_dirs),
        miss_thr=torch.stack(miss_thrs),
        ray_count=ray_count,
        seed=seed,
    )


class ProgressiveTraceResult(NamedTuple):
    rad_sum: torch.Tensor     # f32[3, *B]          emission radiance SUMMED over all frames
    miss_dir: torch.Tensor    # f32[F*spp, 3, *B]   escape dir per (frame, sample) slot
    miss_thr: torch.Tensor    # f32[F*spp, 3, *B]   throughput at escape per slot
    ray_count: torch.Tensor   # i32[*B]             traced segments, all frames
    seed: torch.Tensor        # i64[*B]             RNG state after the last finished sample


def trace_progressive(trace_fn: TraceFn, cam: CameraParams,
                      px, py, width: int, height: int, frame0,
                      ray_depth: int, spp: int, n_frames: int,
                      n_valid: int | None = None, jitter: str = "corner",
                      russian_roulette: bool = True) -> ProgressiveTraceResult:
    """Path-regeneration ("refill") sampling loop over ``n_frames``
    progressive frames: each lane treats its pixel's samples for
    ``n_frames`` consecutive frames as a queue, starting the next sample the
    iteration after its path ends (tpt.integrator.trace_progressive).

    Equivalences vs ``n_frames`` sequential :func:`trace_paths` calls: the
    RNG stream, every discrete decision, the final seeds and the ray counts
    are identical; radiance flushes into ``rad_sum`` in sample order and
    slot ``f*spp + s`` of ``miss_dir``/``miss_thr`` holds frame
    ``frame0 + f``'s sample ``s``.  Frames ``f >= n_valid`` are skipped
    (their slots stay zero).  The loop stops once no lane has work.
    """
    _check_jitter(jitter)
    if n_valid is None:
        n_valid = n_frames
    n_slots = n_frames * spp
    batch = tuple(px.shape)
    dev = px.device
    fpx = px.to(torch.float32)
    fpy = py.to(torch.float32)

    zero_v3 = torch.zeros((3,) + batch, dtype=torch.float32, device=dev)
    zero_i = torch.zeros(batch, dtype=torch.int32, device=dev)
    state = PathState(origin=zero_v3, direction=zero_v3 + 1.0,
                      throughput=zero_v3, radiance=zero_v3,
                      seed=zero_i.to(torch.int64),
                      alive=zero_i.to(torch.bool), miss_dir=zero_v3,
                      miss_thr=zero_v3, ray_count=zero_i)
    lane_frame = zero_i
    lane_sample = zero_i
    lane_bounce = zero_i
    rad_sum = zero_v3
    miss_dir = torch.zeros((n_slots, 3) + batch, dtype=torch.float32, device=dev)
    miss_thr = torch.zeros_like(miss_dir)
    out_seed = zero_i.to(torch.int64)
    flat_dir = miss_dir.view(n_slots, 3, -1)
    flat_thr = miss_thr.view(n_slots, 3, -1)

    for _ in range(n_frames * spp * ray_depth):
        if not bool((lane_frame < n_valid).any()):
            break
        state, lane_frame, lane_sample, lane_bounce, done, slot = \
            progressive_iteration(
                trace_fn, cam, px, py, fpx, fpy, width, height, frame0,
                ray_depth, spp, n_valid, jitter, russian_roulette,
                state, lane_frame, lane_sample, lane_bounce)
        # ---- flush completed samples into their slots ----
        rad_sum = rad_sum + torch.where(done, state.radiance, 0.0)
        lanes = done.reshape(-1).nonzero().squeeze(1)
        slots = slot.reshape(-1)[lanes].long()
        flat_dir[slots, :, lanes] = state.miss_dir.reshape(3, -1)[:, lanes].T
        flat_thr[slots, :, lanes] = state.miss_thr.reshape(3, -1)[:, lanes].T
        out_seed = torch.where(done, state.seed, out_seed)

    return ProgressiveTraceResult(rad_sum=rad_sum, miss_dir=miss_dir,
                                  miss_thr=miss_thr,
                                  ray_count=state.ray_count, seed=out_seed)


def progressive_iteration(trace_fn: TraceFn, cam: CameraParams, px, py,
                          fpx, fpy, width: int, height: int, frame0,
                          ray_depth: int, spp: int, n_valid,
                          jitter: str, russian_roulette: bool,
                          state: PathState, lane_frame, lane_sample,
                          lane_bounce):
    """One refill-loop iteration: restart ended lanes on their next queued
    sample, bounce every live lane, mark completions, advance the queue.

    Returns (state', lane_frame', lane_sample', lane_bounce', done, slot):
    ``done`` lanes just completed a sample whose results are still readable
    in ``state'``; ``slot`` is the completed sample's flat index
    ``frame*spp + sample``; ``state'.alive`` is already cleared on them.
    """
    has_work = lane_frame < n_valid

    # A frame's first sample reseeds from the pixel hash (compute.glsl:106);
    # later samples chain the running seed like trace_paths's spp loop.
    start = has_work & ~state.alive
    fresh = rng.pixel_seed(px, py, lane_frame.to(torch.int64) + int(frame0))
    seed0 = torch.where(start,
                        torch.where(lane_sample == 0, fresh, state.seed),
                        state.seed)
    draws, seed1 = sample_draws(seed0)
    o, d = primary_ray(cam, fpx, fpy, width, height, draws, jitter)
    state = PathState(
        origin=torch.where(start, o, state.origin),
        direction=torch.where(start, d, state.direction),
        throughput=torch.where(start, 1.0, state.throughput),
        radiance=torch.where(start, 0.0, state.radiance),
        seed=torch.where(start, seed1, state.seed),
        alive=start | state.alive,
        miss_dir=torch.where(start, 0.0, state.miss_dir),
        miss_thr=torch.where(start, 0.0, state.miss_thr),
        ray_count=state.ray_count,
    )
    lane_bounce = torch.where(start, 0, lane_bounce)

    # ---- one bounce on every live lane ----
    state = bounce_step(state, trace_fn, russian_roulette)
    lane_bounce = lane_bounce + has_work.to(torch.int32)

    # ---- completion + queue advance ----
    done = has_work & (~state.alive | (lane_bounce >= ray_depth))
    slot = lane_frame * spp + lane_sample
    last_sample = lane_sample == (spp - 1)
    lane_frame = torch.where(done & last_sample, lane_frame + 1, lane_frame)
    lane_sample = torch.where(done, torch.where(last_sample, 0, lane_sample + 1),
                              lane_sample)
    state = dataclasses.replace(state, alive=state.alive & ~done)
    return state, lane_frame, lane_sample, lane_bounce, done, slot


def apply_environment(result: TraceResult, env_faces, spp: int):
    """Add the deferred environment term and average over spp.

    Returns the frame's per-pixel mean radiance, f32[3, *B]."""
    rad = result.radiance
    for s in range(spp):
        envc = sample_environment_planar(env_faces, result.miss_dir[s])
        rad = rad + result.miss_thr[s] * envc
    return div_scalar(rad, spp)


def apply_environment_blocked(result: TraceResult, env_table, spp: int):
    """apply_environment on the production fetch path: one row gather per
    sample from a tpt_torch.env.pack_block_table table (bit-identical
    values)."""
    rad = result.radiance
    for s in range(spp):
        envc = sample_environment_blocked(env_table, result.miss_dir[s])
        rad = rad + result.miss_thr[s] * envc
    return div_scalar(rad, spp)

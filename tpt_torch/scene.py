"""Scene model: a dataclass of padded struct-of-arrays tensors (port of
tpt.scene).

The layout is the JAX package's, which is the reference's std140 UBO split
into arrays: 256 sphere slots (position+radius, 16-float material) and 64
cuboid slots (min, max, 16-float material), plus the two live counts.  The
counts are Python ints: the plain integrator loops over them on the host and
the CUDA kernel takes them as launch arguments, so one build serves any
scene.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple, Union

import numpy as np
import torch

from .config import MAX_SPHERES, MAX_CUBOIDS, HOST_EPSILON
from .materials import Material, MATERIAL_WIDTH

# The reference's std140 UBO layout (src/GameObjects/Sphere.cs:20-31,
# src/GameObjects/Cuboid.cs:21-35): a sphere slot is vec4 pos+radius and a
# 4-vec4 material, a cuboid slot padded min, padded max and the material.
SPHERE_STRIDE_FLOATS = 20   # 80 bytes
CUBOID_STRIDE_FLOATS = 24   # 96 bytes
STD140_TOTAL_FLOATS = MAX_SPHERES * SPHERE_STRIDE_FLOATS + MAX_CUBOIDS * CUBOID_STRIDE_FLOATS

_TENSOR_FIELDS = ("sphere_pos_radius", "sphere_material", "cuboid_min",
                  "cuboid_max", "cuboid_material")
FIELDS = _TENSOR_FIELDS + ("num_spheres", "num_cuboids")


@dataclasses.dataclass
class Scene:
    """Padded struct-of-arrays scene. All tensors are f32."""

    sphere_pos_radius: torch.Tensor   # [MAX_SPHERES, 4] xyz + radius
    sphere_material: torch.Tensor     # [MAX_SPHERES, 16]
    cuboid_min: torch.Tensor          # [MAX_CUBOIDS, 3]
    cuboid_max: torch.Tensor          # [MAX_CUBOIDS, 3]
    cuboid_material: torch.Tensor     # [MAX_CUBOIDS, 16]
    num_spheres: int
    num_cuboids: int

    @property
    def counts(self) -> Tuple[int, int]:
        return self.num_spheres, self.num_cuboids

    @property
    def device(self) -> torch.device:
        return self.sphere_pos_radius.device

    def to(self, device) -> "Scene":
        return dataclasses.replace(
            self, **{f: getattr(self, f).to(device) for f in _TENSOR_FIELDS})

    @classmethod
    def from_numpy(cls, arrays: Sequence, device) -> "Scene":
        """Build from the seven leaves of a ``tpt.scene.Scene`` as numpy
        arrays, in field order (``FIELDS``)."""
        if len(arrays) != len(FIELDS):
            raise ValueError(f"expected {len(FIELDS)} arrays, got {len(arrays)}")
        leaves = {f: torch.tensor(np.asarray(a, np.float32), device=device)
                  for f, a in zip(_TENSOR_FIELDS, arrays)}
        return cls(**leaves, num_spheres=int(arrays[5]), num_cuboids=int(arrays[6]))

    def to_numpy(self) -> Tuple[np.ndarray, ...]:
        """The seven leaves as numpy arrays, counts as int32 scalars."""
        return tuple(getattr(self, f).cpu().numpy() for f in _TENSOR_FIELDS) + (
            np.int32(self.num_spheres), np.int32(self.num_cuboids))


@dataclasses.dataclass
class SphereObject:
    position: Tuple[float, float, float]
    radius: float
    material: Material


@dataclasses.dataclass
class CuboidObject:
    """Host-side cuboid stored as center + dimensions like the reference
    (src/GameObjects/Cuboid.cs:8-19); serialized as min/max."""

    position: Tuple[float, float, float]
    dimensions: Tuple[float, float, float]
    material: Material

    @property
    def aabb_min(self) -> np.ndarray:
        return np.asarray(self.position, np.float32) - np.asarray(self.dimensions, np.float32) / 2

    @property
    def aabb_max(self) -> np.ndarray:
        return np.asarray(self.position, np.float32) + np.asarray(self.dimensions, np.float32) / 2


SceneObject = Union[SphereObject, CuboidObject]


class SceneBuilder:
    """Mutable host-side scene; ``build(device)`` produces the tensors."""

    def __init__(self):
        self.objects: List[SceneObject] = []

    def add_sphere(self, position, radius, material: Material) -> SphereObject:
        if len(self.spheres) >= MAX_SPHERES:
            raise ValueError(f"scene supports at most {MAX_SPHERES} spheres")
        obj = SphereObject(tuple(map(float, position)), float(radius), material)
        self.objects.append(obj)
        return obj

    def add_cuboid(self, position, dimensions, material: Material) -> CuboidObject:
        if len(self.cuboids) >= MAX_CUBOIDS:
            raise ValueError(f"scene supports at most {MAX_CUBOIDS} cuboids")
        obj = CuboidObject(tuple(map(float, position)), tuple(map(float, dimensions)), material)
        self.objects.append(obj)
        return obj

    @property
    def spheres(self) -> List[SphereObject]:
        return [o for o in self.objects if isinstance(o, SphereObject)]

    @property
    def cuboids(self) -> List[CuboidObject]:
        return [o for o in self.objects if isinstance(o, CuboidObject)]

    def build(self, device="cpu") -> Scene:
        spheres, cuboids = self.spheres, self.cuboids
        spr = np.zeros((MAX_SPHERES, 4), np.float32)
        smat = np.zeros((MAX_SPHERES, MATERIAL_WIDTH), np.float32)
        for i, s in enumerate(spheres):
            spr[i, :3] = s.position
            spr[i, 3] = s.radius
            smat[i] = s.material.to_array()
        cmin = np.zeros((MAX_CUBOIDS, 3), np.float32)
        cmax = np.zeros((MAX_CUBOIDS, 3), np.float32)
        cmat = np.zeros((MAX_CUBOIDS, MATERIAL_WIDTH), np.float32)
        for i, c in enumerate(cuboids):
            cmin[i] = c.aabb_min
            cmax[i] = c.aabb_max
            cmat[i] = c.material.to_array()
        return Scene.from_numpy((spr, smat, cmin, cmax, cmat, len(spheres),
                                 len(cuboids)), device)


def pack_std140(scene: Scene) -> np.ndarray:
    """Serialize to the reference's flat UBO layout: f32[6656] == 26624 bytes,
    the bytes of tpt.scene.pack_std140.

    Sphere slot i at float offset 20*i: [pos.xyz, radius, material(16)].
    Cuboid slot j at 256*20 + 24*j: [min.xyz, pad, max.xyz, pad, material(16)].
    """
    buf = np.zeros(STD140_TOTAL_FLOATS, np.float32)
    spheres = buf[:MAX_SPHERES * SPHERE_STRIDE_FLOATS].reshape(MAX_SPHERES, SPHERE_STRIDE_FLOATS)
    spheres[:, :4] = scene.sphere_pos_radius.detach().cpu().numpy()
    spheres[:, 4:] = scene.sphere_material.detach().cpu().numpy()
    cuboids = buf[MAX_SPHERES * SPHERE_STRIDE_FLOATS:].reshape(MAX_CUBOIDS, CUBOID_STRIDE_FLOATS)
    cuboids[:, 0:3] = scene.cuboid_min.detach().cpu().numpy()
    cuboids[:, 4:7] = scene.cuboid_max.detach().cpu().numpy()
    cuboids[:, 8:] = scene.cuboid_material.detach().cpu().numpy()
    return buf


def unpack_std140(buf: np.ndarray, num_spheres: int, num_cuboids: int, device="cpu") -> Scene:
    """Inverse of :func:`pack_std140`, the scene's tensors on ``device``."""
    buf = np.asarray(buf, np.float32).reshape(-1)
    if buf.size != STD140_TOTAL_FLOATS:
        raise ValueError(f"expected {STD140_TOTAL_FLOATS} floats, got {buf.size}")
    spheres = buf[:MAX_SPHERES * SPHERE_STRIDE_FLOATS].reshape(MAX_SPHERES, SPHERE_STRIDE_FLOATS)
    cuboids = buf[MAX_SPHERES * SPHERE_STRIDE_FLOATS:].reshape(MAX_CUBOIDS, CUBOID_STRIDE_FLOATS)
    return Scene.from_numpy((spheres[:, :4], spheres[:, 4:], cuboids[:, 0:3], cuboids[:, 4:7],
                             cuboids[:, 8:], num_spheres, num_cuboids), device)


def update_sphere(scene: Scene, index, position=None, radius=None,
                  material: Material | None = None) -> Scene:
    """Single-object update returning a new Scene (the UBO SubData analogue,
    src/BaseSTD140Compatible.cs:12-16).  The input scene is left as it was,
    as in the functional JAX version."""
    spr = scene.sphere_pos_radius.clone()
    smat = scene.sphere_material.clone()
    if position is not None:
        spr[index, :3] = torch.as_tensor(position, dtype=torch.float32)
    if radius is not None:
        spr[index, 3] = float(np.float32(radius))
    if material is not None:
        smat[index] = torch.from_numpy(material.to_array())
    return dataclasses.replace(scene, sphere_pos_radius=spr, sphere_material=smat)


def update_cuboid(scene: Scene, index, position=None, dimensions=None,
                  material: Material | None = None) -> Scene:
    """Cuboid update returning a new Scene; position/dimensions follow the
    host-side center+dimensions convention (src/GameObjects/Cuboid.cs:8-19)."""
    cmin = scene.cuboid_min.clone()
    cmax = scene.cuboid_max.clone()
    cmat = scene.cuboid_material.clone()
    if position is not None or dimensions is not None:
        old_c = (cmin[index] + cmax[index]) / 2
        old_d = cmax[index] - cmin[index]
        c = (torch.as_tensor(position, dtype=torch.float32, device=cmin.device)
             if position is not None else old_c)
        d = (torch.as_tensor(dimensions, dtype=torch.float32, device=cmin.device)
             if dimensions is not None else old_d)
        cmin[index] = c - d / 2
        cmax[index] = c + d / 2
    if material is not None:
        cmat[index] = torch.from_numpy(material.to_array())
    return dataclasses.replace(scene, cuboid_min=cmin, cuboid_max=cmax,
                               cuboid_material=cmat)


def randomize_materials(builder: SceneBuilder, max_num: int, kind=SphereObject, rng=None) -> int:
    """Assign random materials to the first ``max_num`` objects of ``kind``
    (the GUI's random-materials button, src/MainWindow.cs:324-336 /
    src/Render/Gui.cs:69-73); the same generator state assigns the same
    materials as tpt.scene.randomize_materials.  Returns the count changed;
    call ``builder.build()`` to refresh the device scene."""
    from .materials import random_material
    rng = rng if rng is not None else np.random.default_rng()
    changed = 0
    for obj in builder.objects:
        if changed >= max_num:
            break
        if isinstance(obj, kind):
            obj.material = random_material(rng)
            changed += 1
    return changed


def demo_scene() -> SceneBuilder:
    """The reference demo scene, reproduced exactly
    (reference: src/MainWindow.cs:208-267).

    48 spheres: a 6x6 grid ramping specular chance (x) and roughness (y),
    6 red absorbing glass spheres, 6 rough glass spheres; 7 cuboids forming
    the room (floor, area light, back wall, refractive front pane, gold
    mirror right wall, blue left wall, white box).
    """
    b = SceneBuilder()
    width, height, depth = 40.0, 25.0, 25.0
    balls = 6
    radius = 1.3
    dim = np.array([width * 0.6, height, depth], np.float32)

    # 6x6 grid (x outer, y inner: slot order matters for scan-order parity).
    for x in range(balls):
        for y in range(balls):
            pos = (dim[0] / balls * x * 1.1 - dim[0] / 2,
                   (dim[1] / balls) * y - dim[1] / 2 + radius,
                   -5.0)
            b.add_sphere(pos, radius, Material.make(
                albedo=(0.59, 0.59, 0.99), emissive=(0, 0, 0), absorbance=(0, 0, 0),
                specular_chance=x / (balls - 1), specular_roughness=y / (balls - 1),
                ior=1.0, refraction_chance=0.0, refraction_roughness=0.1))

    delta = dim / balls
    for x in range(balls):
        # Red absorbing glass (fields written directly in the reference —
        # no constructor clamping, src/MainWindow.cs:225-232).
        red = Material.zero()
        red.albedo = (0.9, 0.25, 0.25)
        red.specular_chance = 0.02
        red.ior = 1.05
        red.refraction_chance = 0.98
        red.absorbance = tuple(np.array([1.0, 2.0, 3.0]) * (x / balls))
        b.add_sphere((-dim[0] / 2 + radius + delta[0] * x, 3.0, -20.0), radius, red)

        # Rough glass with roughness ramp (src/MainWindow.cs:235-243).
        rough = Material.zero()
        rough.specular_chance = 0.02
        rough.specular_roughness = x / balls
        rough.ior = 1.1
        rough.refraction_chance = 0.98
        rough.refraction_roughness = x / balls
        b.add_sphere((-dim[0] / 2 + radius + delta[0] * x, -6.0, -20.0), radius, rough)

    eps = HOST_EPSILON
    down_pos = (0.0, -height / 2, -10.0)
    down_dim = (width, eps, depth)
    b.add_cuboid(down_pos, down_dim, Material.make(
        (0.2, 0.04, 0.04), (0, 0, 0), (0, 0, 0), 0.0, 0.051, 1.0, 0.0, 0.0))
    b.add_cuboid((0.0, 18.495 - eps, -4.0), (width * 0.3, eps, depth * 0.3), Material.make(
        (0.04, 0.04, 0.04), tuple(np.array([0.917, 0.945, 0.513]) * 5.0), (0, 0, 0),
        0.0, 0.0, 1.0, 0.0, 0.0))
    b.add_cuboid((down_pos[0], down_pos[1] + height / 2, down_pos[2] + depth / 2 - 5.0),
                 (width, height, eps), Material.make(
        (0.37109375, 0.67578125, 0.3359375), (0, 0, 0), (0, 0, 0), 0.0, 0.0, 1.0, 0.0, 0.0))
    b.add_cuboid((down_pos[0], down_pos[1] + height / 2 + eps, down_pos[2] - depth / 2),
                 (width, height - eps * 2, 0.3), Material.make(
        (1.0, 1.0, 1.0), (0, 0, 0), (0.01, 0.01, 0.01), 0.04, 0.0, 1.0, 0.954, 0.0))
    b.add_cuboid((down_pos[0] + width / 2, down_pos[1] + height / 2, down_pos[2]),
                 (eps, height, depth), Material.make(
        (0.9453125, 0.75390625, 0.3046875), (0, 0, 0), (0, 0, 0), 1.0, 0.19, 1.0, 0.0, 0.0))
    b.add_cuboid((down_pos[0] - width / 2, down_pos[1] + height / 2, down_pos[2]),
                 (eps, height, depth), Material.make(
        (0.074219, 0.25, 0.453125), (0, 0, 0), (0, 0, 0), 0.0, 0.0, 1.0, 0.0, 0.0))
    b.add_cuboid((-15.0, -10.5 + eps, -15.0), (3.0, 6.0, 3.0), Material.make(
        (1.0, 1.0, 1.0), (0, 0, 0), (0, 0, 0), 0.0, 0.0, 1.0, 0.0, 0.0))
    return b


def cornell_scene() -> SceneBuilder:
    """Small Cornell-style 4-sphere test scene (BASELINE.json config 1)."""
    b = SceneBuilder()
    b.add_sphere((0.0, -101.0, -6.0), 100.0, Material.make(   # floor
        (0.8, 0.8, 0.8), (0, 0, 0), (0, 0, 0), 0.0, 0.0, 1.0, 0.0, 0.0))
    b.add_sphere((-1.5, 0.0, -6.0), 1.0, Material.make(       # diffuse red
        (0.9, 0.2, 0.2), (0, 0, 0), (0, 0, 0), 0.0, 0.0, 1.0, 0.0, 0.0))
    b.add_sphere((1.5, 0.0, -6.0), 1.0, Material.make(        # mirror
        (0.9, 0.9, 0.9), (0, 0, 0), (0, 0, 0), 1.0, 0.05, 1.0, 0.0, 0.0))
    b.add_sphere((0.0, 4.0, -6.0), 1.5, Material.make(        # light
        (1.0, 1.0, 1.0), (8.0, 7.5, 6.0), (0, 0, 0), 0.0, 0.0, 1.0, 0.0, 0.0))
    return b

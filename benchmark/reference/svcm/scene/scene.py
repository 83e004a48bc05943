"""Scene container: SoA geometry/material/light tensors + Cornell builder.

Port of ``smallvcm_tpu/scene/scene.py``. The numpy builder is carried over
as it is and emits torch tensors; ``SceneData`` is a plain dataclass with
a ``.to(device)``. Light types are an integer code with unified parameter
slots (evaluated branch-free in :mod:`smallvcm_tpu_torch.ops.lights`).

The four procedural Cornell-box variants replicate scene.hxx:132-398 exactly
(vertices, 9 materials, camera pose, light intensities).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..core.vec3 import V3
from ..core.vecmath import INV_PI_F
from ..device import resolve_device
from .camera import CameraData, setup_camera

# Light type codes.
LIGHT_AREA = 0
LIGHT_DIRECTIONAL = 1
LIGHT_POINT = 2
LIGHT_BACKGROUND = 3

# Box masks (scene.hxx:116-130).
LIGHT_CEILING = 1
LIGHT_SUN = 2
LIGHT_POINT_MASK = 4
LIGHT_BACKGROUND_MASK = 8
LARGE_MIRROR_SPHERE = 16
LARGE_GLASS_SPHERE = 32
SMALL_MIRROR_SPHERE = 64
SMALL_GLASS_SPHERE = 128
GLOSSY_FLOOR = 256
BOTH_SMALL_SPHERES = SMALL_MIRROR_SPHERE | SMALL_GLASS_SPHERE
BOTH_LARGE_SPHERES = LARGE_MIRROR_SPHERE | LARGE_GLASS_SPHERE
DEFAULT_MASK = LIGHT_CEILING | BOTH_SMALL_SPHERES

# The four --report scene configs (config.hxx:146-151).
SCENE_CONFIGS = (
    GLOSSY_FLOOR | BOTH_SMALL_SPHERES | LIGHT_SUN,
    GLOSSY_FLOOR | LARGE_MIRROR_SPHERE | LIGHT_CEILING,
    GLOSSY_FLOOR | BOTH_SMALL_SPHERES | LIGHT_POINT_MASK,
    GLOSSY_FLOOR | BOTH_SMALL_SPHERES | LIGHT_BACKGROUND_MASK,
)


class Materials(NamedTuple):
    """materials.hxx:36-66 as SoA."""

    diffuse: V3              # V3 of [M]
    phong: V3                # V3 of [M]
    exponent: torch.Tensor   # [M]
    mirror: V3               # V3 of [M]
    ior: torch.Tensor        # [M] (< 0 => no refraction)


class Lights(NamedTuple):
    """Unified light records (lights.hxx:112-514).

    Per light: type code + generic slots.
      area:        p0, e1, e2, frame basis, intensity, inv_area
      directional: frame basis (z = direction), intensity
      point:       p0 = position, intensity
      background:  intensity = color * scale
    """

    kind: torch.Tensor       # [L] int32
    p0: V3                   # V3 of [L]
    e1: V3                   # V3 of [L]
    e2: V3                   # V3 of [L]
    frame_x: V3              # V3 of [L]
    frame_y: V3              # V3 of [L]
    frame_z: V3              # V3 of [L] (normal / direction)
    intensity: V3            # V3 of [L]
    inv_area: torch.Tensor   # [L]
    is_finite: torch.Tensor  # [L] bool
    is_delta: torch.Tensor   # [L] bool


class SceneSphere(NamedTuple):
    center: V3                    # V3 of scalars
    radius: torch.Tensor          # scalar
    inv_radius_sqr: torch.Tensor  # scalar


def tree_to(obj, device):
    """Move every tensor leaf of a NamedTuple/dataclass tree to ``device``."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(tree_to(v, device) for v in obj))
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: tree_to(getattr(obj, f.name), device)
            for f in dataclasses.fields(obj)
        })
    return obj


@dataclasses.dataclass(frozen=True)
class SceneData:
    """Scene tensors. ``background_idx`` is plain host metadata."""

    # Triangles (two-sided; geometry.hxx:106-177).
    tri_p0: V3                 # V3 of [T]
    tri_p1: V3                 # V3 of [T]
    tri_p2: V3                 # V3 of [T]
    tri_normal: V3             # V3 of [T]
    tri_mat: torch.Tensor      # [T] int32
    # Spheres (geometry.hxx:179-266).
    sph_center: V3             # V3 of [S]
    sph_radius: torch.Tensor   # [S]
    sph_mat: torch.Tensor      # [S] int32
    materials: Materials
    lights: Lights
    mat_to_light: torch.Tensor  # [M] int32, -1 when not emissive
    scene_sphere: SceneSphere
    camera: CameraData
    # light index of BackgroundLight or -1
    background_idx: int = -1

    @property
    def device(self) -> torch.device:
        return self.tri_mat.device

    def to(self, device) -> "SceneData":
        return tree_to(self, torch.device(device))


def _frame_from_z_np(z):
    z = np.asarray(z, np.float64)
    z = z / np.linalg.norm(z)
    tmp_x = np.array([0.0, 1.0, 0.0]) if abs(z[0]) > 0.99 else np.array([1.0, 0.0, 0.0])
    y = np.cross(z, tmp_x)
    y = y / np.linalg.norm(y)
    x = np.cross(y, z)
    return x, y, z


class _SceneBuilder:
    def __init__(self):
        self.tris = []        # (p0, p1, p2, mat)
        self.spheres = []     # (center, radius, mat)
        self.materials = []   # dict per material
        self.lights = []      # dict per light
        self.mat_to_light = {}
        self.background_idx = -1

    def add_material(self, diffuse=(0, 0, 0), phong=(0, 0, 0), exponent=1.0,
                     mirror=(0, 0, 0), ior=-1.0):
        self.materials.append(
            dict(diffuse=diffuse, phong=phong, exponent=exponent,
                 mirror=mirror, ior=ior)
        )

    def add_tri(self, p0, p1, p2, mat):
        self.tris.append((np.asarray(p0, np.float64), np.asarray(p1, np.float64),
                          np.asarray(p2, np.float64), mat))

    def add_sphere(self, center, radius, mat):
        self.spheres.append((np.asarray(center, np.float64), float(radius), mat))

    def add_area_light(self, p0, p1, p2, intensity, material_id):
        p0 = np.asarray(p0, np.float64)
        e1 = np.asarray(p1, np.float64) - p0
        e2 = np.asarray(p2, np.float64) - p0
        normal = np.cross(e1, e2)
        inv_area = 2.0 / np.linalg.norm(normal)
        fx, fy, fz = _frame_from_z_np(normal)
        self.lights.append(dict(
            kind=LIGHT_AREA, p0=p0, e1=e1, e2=e2, frame=(fx, fy, fz),
            intensity=np.asarray(intensity, np.float64), inv_area=inv_area,
            is_finite=True, is_delta=False,
        ))
        if material_id is not None:
            self.mat_to_light[material_id] = len(self.lights) - 1

    def add_directional_light(self, direction, intensity):
        fx, fy, fz = _frame_from_z_np(direction)
        self.lights.append(dict(
            kind=LIGHT_DIRECTIONAL, p0=np.zeros(3), e1=np.zeros(3),
            e2=np.zeros(3), frame=(fx, fy, fz),
            intensity=np.asarray(intensity, np.float64), inv_area=0.0,
            is_finite=False, is_delta=True,
        ))

    def add_point_light(self, position, intensity):
        self.lights.append(dict(
            kind=LIGHT_POINT, p0=np.asarray(position, np.float64),
            e1=np.zeros(3), e2=np.zeros(3),
            frame=(np.eye(3)[0], np.eye(3)[1], np.eye(3)[2]),
            intensity=np.asarray(intensity, np.float64), inv_area=0.0,
            is_finite=True, is_delta=True,
        ))

    def add_background_light(self, color, scale):
        self.lights.append(dict(
            kind=LIGHT_BACKGROUND, p0=np.zeros(3), e1=np.zeros(3),
            e2=np.zeros(3),
            frame=(np.eye(3)[0], np.eye(3)[1], np.eye(3)[2]),
            intensity=np.asarray(color, np.float64) * scale, inv_area=0.0,
            is_finite=False, is_delta=False,
        ))
        self.background_idx = len(self.lights) - 1

    def finish(self, camera: CameraData) -> SceneData:
        f32 = lambda a: torch.from_numpy(np.array(a, np.float32))
        i32 = lambda a: torch.from_numpy(np.array(a, np.int32))
        fv3 = lambda a: V3(*(f32(np.asarray(a, np.float64)[..., i])
                             for i in range(3)))

        tri_p0 = np.stack([t[0] for t in self.tris])
        tri_p1 = np.stack([t[1] for t in self.tris])
        tri_p2 = np.stack([t[2] for t in self.tris])
        tri_n = np.cross(tri_p1 - tri_p0, tri_p2 - tri_p0)
        tri_n = tri_n / np.linalg.norm(tri_n, axis=-1, keepdims=True)
        tri_mat = np.array([t[3] for t in self.tris], np.int32)

        if self.spheres:
            sph_c = np.stack([s[0] for s in self.spheres])
            sph_r = np.array([s[1] for s in self.spheres])
            sph_m = np.array([s[2] for s in self.spheres], np.int32)
        else:
            sph_c = np.zeros((0, 3))
            sph_r = np.zeros((0,))
            sph_m = np.zeros((0,), np.int32)

        mats = Materials(
            diffuse=fv3([m["diffuse"] for m in self.materials]),
            phong=fv3([m["phong"] for m in self.materials]),
            exponent=f32([m["exponent"] for m in self.materials]),
            mirror=fv3([m["mirror"] for m in self.materials]),
            ior=f32([m["ior"] for m in self.materials]),
        )

        lights = Lights(
            kind=i32([l["kind"] for l in self.lights]),
            p0=fv3([l["p0"] for l in self.lights]),
            e1=fv3([l["e1"] for l in self.lights]),
            e2=fv3([l["e2"] for l in self.lights]),
            frame_x=fv3([l["frame"][0] for l in self.lights]),
            frame_y=fv3([l["frame"][1] for l in self.lights]),
            frame_z=fv3([l["frame"][2] for l in self.lights]),
            intensity=fv3([l["intensity"] for l in self.lights]),
            inv_area=f32([l["inv_area"] for l in self.lights]),
            is_finite=torch.tensor([l["is_finite"] for l in self.lights]),
            is_delta=torch.tensor([l["is_delta"] for l in self.lights]),
        )

        m2l = np.full((len(self.materials),), -1, np.int32)
        for mat_id, light_id in self.mat_to_light.items():
            m2l[mat_id] = light_id

        # Bounding sphere (scene.hxx:387-398): bbox over tris and spheres.
        pts = np.concatenate([tri_p0, tri_p1, tri_p2], axis=0)
        bbox_min = pts.min(axis=0)
        bbox_max = pts.max(axis=0)
        for c, r, _ in self.spheres:
            bbox_min = np.minimum(bbox_min, c - r)
            bbox_max = np.maximum(bbox_max, c + r)
        radius = 0.5 * np.linalg.norm(bbox_max - bbox_min)
        sphere = SceneSphere(
            center=fv3((bbox_max + bbox_min) * 0.5),
            radius=f32(radius),
            inv_radius_sqr=f32(1.0 / (radius * radius)),
        )

        return SceneData(
            tri_p0=fv3(tri_p0), tri_p1=fv3(tri_p1), tri_p2=fv3(tri_p2),
            tri_normal=fv3(tri_n), tri_mat=i32(tri_mat),
            sph_center=fv3(sph_c), sph_radius=f32(sph_r), sph_mat=i32(sph_m),
            materials=mats, lights=lights, mat_to_light=i32(m2l),
            scene_sphere=sphere, camera=camera,
            background_idx=self.background_idx,
        )


def load_cornell_box(resolution, box_mask: int = DEFAULT_MASK,
                     device="cuda") -> SceneData:
    """Procedural Cornell-box build replicating scene.hxx:132-385, on
    ``device`` (default the card; without one it raises, as
    ``device.resolve_device`` does)."""
    device = resolve_device(device)
    if (box_mask & BOTH_LARGE_SPHERES) == BOTH_LARGE_SPHERES:
        print("Cannot have both large balls, using mirror\n")
        box_mask &= ~LARGE_GLASS_SPHERE

    light_ceiling = (box_mask & LIGHT_CEILING) != 0
    light_sun = (box_mask & LIGHT_SUN) != 0
    light_point = (box_mask & LIGHT_POINT_MASK) != 0
    light_background = (box_mask & LIGHT_BACKGROUND_MASK) != 0
    light_box = not light_point  # scene.hxx:149-153

    b = _SceneBuilder()

    camera = setup_camera(
        position=(-0.0439815, -4.12529, 0.222539),
        forward=(0.00688625, 0.998505, -0.0542161),
        up=(3.73896e-4, 0.0542148, 0.998529),
        resolution=resolution,
        horizontal_fov=45.0,
    )

    # Materials (scene.hxx:162-205).
    b.add_material()  # 0: light1, emit only
    b.add_material()  # 1: light2, emit only
    b.add_material(diffuse=(0.1, 0.1, 0.1), phong=(0.7, 0.7, 0.7), exponent=90.0)  # 2: glossy floor
    b.add_material(diffuse=(0.156863, 0.803922, 0.172549))  # 3: green left wall
    b.add_material(diffuse=(0.803922, 0.152941, 0.152941))  # 4: red right wall
    b.add_material(diffuse=(0.803922, 0.803922, 0.803922))  # 5: white back wall
    b.add_material(mirror=(1.0, 1.0, 1.0))  # 6: mirror ball
    b.add_material(mirror=(1.0, 1.0, 1.0), ior=1.6)  # 7: glass ball
    b.add_material(diffuse=(0.156863, 0.172549, 0.803922))  # 8: blue wall

    # Cornell box vertices (scene.hxx:211-220).
    cb = np.array([
        [-1.27029,  1.30455, -1.28002],
        [ 1.28975,  1.30455, -1.28002],
        [ 1.28975,  1.30455,  1.28002],
        [-1.27029,  1.30455,  1.28002],
        [-1.27029, -1.25549, -1.28002],
        [ 1.28975, -1.25549, -1.28002],
        [ 1.28975, -1.25549,  1.28002],
        [-1.27029, -1.25549,  1.28002],
    ])

    floor_mat, back_mat = (2, 8) if (box_mask & GLOSSY_FLOOR) else (5, 5)
    b.add_tri(cb[0], cb[4], cb[5], floor_mat)
    b.add_tri(cb[5], cb[1], cb[0], floor_mat)
    b.add_tri(cb[0], cb[1], cb[2], back_mat)
    b.add_tri(cb[2], cb[3], cb[0], back_mat)

    # Ceiling (scene.hxx:245-255).
    if light_ceiling and not light_box:
        b.add_tri(cb[2], cb[6], cb[7], 0)
        b.add_tri(cb[7], cb[3], cb[2], 1)
    else:
        b.add_tri(cb[2], cb[6], cb[7], 5)
        b.add_tri(cb[7], cb[3], cb[2], 5)

    # Left and right walls.
    b.add_tri(cb[3], cb[7], cb[4], 3)
    b.add_tri(cb[4], cb[0], cb[3], 3)
    b.add_tri(cb[1], cb[5], cb[6], 4)
    b.add_tri(cb[6], cb[2], cb[1], 4)

    # Spheres (scene.hxx:265-287).
    large_radius = 0.8
    center = (cb[0] + cb[1] + cb[4] + cb[5]) * 0.25 + np.array([0, 0, large_radius])
    if box_mask & LARGE_MIRROR_SPHERE:
        b.add_sphere(center, large_radius, 6)
    if box_mask & LARGE_GLASS_SPHERE:
        b.add_sphere(center, large_radius, 7)

    small_radius = 0.5
    left_wall_center = (cb[0] + cb[4]) * 0.5 + np.array([0, 0, small_radius])
    right_wall_center = (cb[1] + cb[5]) * 0.5 + np.array([0, 0, small_radius])
    xlen = right_wall_center[0] - left_wall_center[0]
    left_ball = left_wall_center + np.array([2.0 * xlen / 7.0, 0, 0])
    right_ball = right_wall_center - np.array([2.0 * xlen / 7.0, 0, 0])
    if box_mask & SMALL_MIRROR_SPHERE:
        b.add_sphere(left_ball, small_radius, 6)
    if box_mask & SMALL_GLASS_SPHERE:
        b.add_sphere(right_ball, small_radius, 7)

    # Light box at the ceiling (scene.hxx:291-329).
    lb = np.array([
        [-0.25,  0.25, 1.26002],
        [ 0.25,  0.25, 1.26002],
        [ 0.25,  0.25, 1.28002],
        [-0.25,  0.25, 1.28002],
        [-0.25, -0.25, 1.26002],
        [ 0.25, -0.25, 1.26002],
        [ 0.25, -0.25, 1.28002],
        [-0.25, -0.25, 1.28002],
    ])
    if light_box:
        b.add_tri(lb[0], lb[2], lb[1], 5)
        b.add_tri(lb[2], lb[0], lb[3], 5)
        b.add_tri(lb[3], lb[4], lb[7], 5)
        b.add_tri(lb[4], lb[3], lb[0], 5)
        b.add_tri(lb[1], lb[6], lb[5], 5)
        b.add_tri(lb[6], lb[1], lb[2], 5)
        b.add_tri(lb[4], lb[5], lb[6], 5)
        b.add_tri(lb[6], lb[7], lb[4], 5)
        if light_ceiling:
            b.add_tri(lb[0], lb[5], lb[4], 0)
            b.add_tri(lb[5], lb[0], lb[1], 1)
        else:
            b.add_tri(lb[0], lb[5], lb[4], 5)
            b.add_tri(lb[5], lb[0], lb[1], 5)

    # Lights (scene.hxx:332-384).
    if light_ceiling and not light_box:
        b.add_area_light(cb[2], cb[6], cb[7], (0.95492965,) * 3, material_id=0)
        b.add_area_light(cb[7], cb[3], cb[2], (0.95492965,) * 3, material_id=1)
    elif light_ceiling and light_box:
        b.add_area_light(lb[0], lb[5], lb[4], (25.03329895614464,) * 3, material_id=0)
        b.add_area_light(lb[5], lb[0], lb[1], (25.03329895614464,) * 3, material_id=1)

    if light_sun:
        b.add_directional_light((-1.0, 1.5, -1.0), np.array([0.5, 0.2, 0.0]) * 20.0)

    if light_point:
        b.add_point_light((0.0, -0.5, 1.0), (70.0 * (INV_PI_F * 0.25),) * 3)

    if light_background:
        b.add_background_light(np.array([135, 206, 250]) / 255.0, 1.0)

    return b.finish(camera).to(device)

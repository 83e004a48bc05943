"""Pinhole camera: host-side matrix construction, device-side batched rays.

Port of ``smallvcm_tpu/scene/camera.py``: the numpy matrix construction is
carried over as it is (45-degree horizontal FOV, raster<->world 4x4
matrices, image-plane distance chosen so the pixel-area pdf is exactly 1,
camera.hxx:74-75) and emits float32 tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.vec3 import V3, normalize
from ..core.vecmath import PI_F


class CameraData(NamedTuple):
    position: V3                  # V3 of scalars
    forward: V3                   # V3 of scalars
    resolution: torch.Tensor      # [2] float (resX, resY)
    raster_to_world: torch.Tensor  # [4,4] row-major
    world_to_raster: torch.Tensor  # [4,4] row-major
    image_plane_dist: torch.Tensor  # scalar


def _perspective(fov_deg: float, near: float, far: float) -> np.ndarray:
    """math.hxx:250-267 (row-major here)."""
    f = 1.0 / np.tan(fov_deg * PI_F / 360.0)
    d = 1.0 / (near - far)
    m = np.zeros((4, 4), dtype=np.float64)
    m[0, 0] = f
    m[1, 1] = -f
    m[2, 2] = (near + far) * d
    m[2, 3] = 2.0 * near * far * d
    m[3, 2] = -1.0
    return m


def setup_camera(
    position, forward, up, resolution, horizontal_fov: float = 45.0
) -> CameraData:
    """camera.hxx:37-76. resolution = (resX, resY)."""
    position = np.asarray(position, np.float64)
    fwd = np.asarray(forward, np.float64)
    fwd = fwd / np.linalg.norm(fwd)
    upn = np.cross(np.asarray(up, np.float64), -fwd)
    upn = upn / np.linalg.norm(upn)
    left = np.cross(-fwd, upn)

    pos = np.array(
        [np.dot(upn, position), np.dot(left, position), np.dot(-fwd, position)]
    )

    world_to_camera = np.eye(4, dtype=np.float64)
    world_to_camera[0, :3], world_to_camera[0, 3] = upn, -pos[0]
    world_to_camera[1, :3], world_to_camera[1, 3] = left, -pos[1]
    world_to_camera[2, :3], world_to_camera[2, 3] = -fwd, -pos[2]

    perspective = _perspective(horizontal_fov, 0.1, 10000.0)
    world_to_nscreen = perspective @ world_to_camera
    nscreen_to_world = np.linalg.inv(world_to_nscreen)

    res_x, res_y = float(resolution[0]), float(resolution[1])

    scale = np.diag([res_x * 0.5, res_y * 0.5, 0.0, 1.0])
    translate = np.eye(4)
    translate[0, 3] = 1.0
    translate[1, 3] = 1.0
    world_to_raster = scale @ translate @ world_to_nscreen

    scale2 = np.diag([2.0 / res_x, 2.0 / res_y, 0.0, 1.0])
    translate2 = np.eye(4)
    translate2[0, 3] = -1.0
    translate2[1, 3] = -1.0
    raster_to_world = nscreen_to_world @ translate2 @ scale2

    tan_half = np.tan(horizontal_fov * PI_F / 360.0)
    image_plane_dist = res_x / (2.0 * tan_half)

    f32 = lambda a: torch.from_numpy(np.array(a, np.float32))
    fv3 = lambda a: V3(*(f32(float(a[i])) for i in range(3)))
    return CameraData(
        position=fv3(position),
        forward=fv3(fwd),
        resolution=f32([res_x, res_y]),
        raster_to_world=f32(raster_to_world),
        world_to_raster=f32(world_to_raster),
        image_plane_dist=f32(image_plane_dist),
    )


def transform_point(mat: torch.Tensor, p: V3) -> V3:
    """Homogeneous transform of V3 point batches by a [4,4] row-major matrix.

    w == 0 (point on the camera plane during light-path splat projection)
    is guarded: such raster positions land far off-screen either way.
    """
    r = V3(
        mat[0, 0] * p.x + mat[0, 1] * p.y + mat[0, 2] * p.z + mat[0, 3],
        mat[1, 0] * p.x + mat[1, 1] * p.y + mat[1, 2] * p.z + mat[1, 3],
        mat[2, 0] * p.x + mat[2, 1] * p.y + mat[2, 2] * p.z + mat[2, 3],
    )
    w = mat[3, 0] * p.x + mat[3, 1] * p.y + mat[3, 2] * p.z + mat[3, 3]
    w = torch.where(torch.abs(w) < 1e-35, 1e-35, w)
    return r * (1.0 / w)


def generate_ray(cam: CameraData, sx, sy):
    """Batched camera.hxx:108-117: raster coords (sx, sy) -> (org V3, dir V3)."""
    world = transform_point(
        cam.raster_to_world, V3(sx, sy, torch.zeros_like(sx))
    )
    d = normalize(world - cam.position)
    org = cam.position.broadcast_to(d.shape)
    return org, d


def world_to_raster(cam: CameraData, world_pos: V3):
    """Batched camera.hxx:95-99: V3 -> raster (x, y)."""
    r = transform_point(cam.world_to_raster, world_pos)
    return r.x, r.y


def check_raster(cam: CameraData, rx, ry) -> torch.Tensor:
    """camera.hxx:102-106."""
    return (
        (rx >= 0) & (ry >= 0)
        & (rx < cam.resolution[0]) & (ry < cam.resolution[1])
    )

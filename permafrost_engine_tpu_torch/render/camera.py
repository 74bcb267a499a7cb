"""Cameras: FPS / RTS modes, view/projection math, frustum construction.

Mirrors src/camera.c + src/cam_control.c: position/pitch/yaw cameras with
perspective projection, RTS edge-pan/zoom parameters, and frustum planes
for culling (ref: Camera_MakeFrustum). All math is NumPy (host-rate); the
frustum is exported as plane equations consumed by the device culling
kernel (render/draw.py).

The port's own copy of ``permafrost_engine_tpu/render/camera.py``, verbatim
but for the package name. The port's ``pf`` unprojects clicks and drags
through it, and ``render/draw.cull_and_emit`` culls against its frustum.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np


class CameraMode:
    FPS = 0
    RTS = 1
    FREE = 2


@dataclasses.dataclass
class Camera:
    pos: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0.0, 120.0, 0.0]))
    pitch: float = -65.0          # degrees (ref RTS default tilt)
    yaw: float = 90.0
    fov: float = math.radians(45.0)
    aspect: float = 16.0 / 9.0
    near: float = 0.3
    far: float = 1024.0
    speed: float = 0.2
    sensitivity: float = 0.05
    mode: int = CameraMode.RTS

    def __post_init__(self):
        self.pos = np.asarray(self.pos, np.float64)

    # -- basis ------------------------------------------------------------------

    def direction(self) -> np.ndarray:
        cp, sp = math.cos(math.radians(self.pitch)), math.sin(math.radians(self.pitch))
        cy, sy = math.cos(math.radians(self.yaw)), math.sin(math.radians(self.yaw))
        d = np.array([cp * cy, sp, -cp * sy])
        return d / np.linalg.norm(d)

    def basis(self):
        front = self.direction()
        world_up = np.array([0.0, 1.0, 0.0])
        right = np.cross(front, world_up)
        right /= max(np.linalg.norm(right), 1e-9)
        up = np.cross(right, front)
        return front, right, up

    # -- matrices ------------------------------------------------------------------

    def view_matrix(self) -> np.ndarray:
        front, right, up = self.basis()
        m = np.eye(4, dtype=np.float32)
        m[0, :3], m[1, :3], m[2, :3] = right, up, -front
        m[:3, 3] = -m[:3, :3] @ self.pos
        return m

    def proj_matrix(self) -> np.ndarray:
        f = 1.0 / math.tan(self.fov / 2)
        m = np.zeros((4, 4), np.float32)
        m[0, 0] = f / self.aspect
        m[1, 1] = f
        m[2, 2] = (self.far + self.near) / (self.near - self.far)
        m[2, 3] = 2 * self.far * self.near / (self.near - self.far)
        m[3, 2] = -1.0
        return m

    def frustum_planes(self) -> np.ndarray:
        """6 planes (nx, ny, nz, d), inward-facing, from the VP matrix
        (Gribb-Hartmann extraction; ref: Camera_MakeFrustum)."""
        vp = self.proj_matrix() @ self.view_matrix()
        rows = [vp[3] + vp[0], vp[3] - vp[0],   # left, right
                vp[3] + vp[1], vp[3] - vp[1],   # bottom, top
                vp[3] + vp[2], vp[3] - vp[2]]   # near, far
        planes = np.stack(rows)
        n = np.linalg.norm(planes[:, :3], axis=1, keepdims=True)
        return planes / np.maximum(n, 1e-9)

    def screen_ray(self, px: float, py: float, w: int, h: int) -> np.ndarray:
        """World-space direction of the ray through pixel (px, py) on a
        w x h viewport (ref: map/raycast.c mouse unprojection)."""
        front, right, up = self.basis()
        tan = math.tan(self.fov / 2)
        nx = (px + 0.5) / w * 2 - 1
        ny = 1 - (py + 0.5) / h * 2
        d = front + right * (nx * tan * self.aspect) + up * (ny * tan)
        return d / np.linalg.norm(d)

    def world_to_screen(self, world, w: int, h: int):
        """World point -> (px, py) on a w x h viewport, or None when the
        point is behind the near plane (the inverse of screen_ray; game
        scripts use it to aim injected clicks at world positions)."""
        vp = self.proj_matrix() @ self.view_matrix()
        p = vp @ np.array([world[0], world[1], world[2], 1.0], np.float64)
        if p[3] <= 1e-6:
            return None
        ndc = p[:3] / p[3]
        return (float((ndc[0] + 1) / 2 * w), float((1 - ndc[1]) / 2 * h))

    def ground_point(self, px: float, py: float, w: int, h: int,
                     ground_y: float = 0.0):
        """Pixel -> intersection with the y = ground_y plane, or None."""
        d = self.screen_ray(px, py, w, h)
        if d[1] >= -1e-5:
            return None
        t = (ground_y - self.pos[1]) / d[1]
        hit = self.pos + d * t
        return (float(hit[0]), float(hit[1]), float(hit[2]))

    # -- control (ref: cam_control.c RTS pan/zoom) -----------------------------------

    def pan(self, dx: float, dz: float) -> None:
        _, right, _ = self.basis()
        fwd = np.array([right[2], 0.0, -right[0]])  # ground-projected forward
        self.pos += right * dx * self.speed + fwd * dz * self.speed

    def zoom(self, amount: float) -> None:
        self.pos += self.direction() * amount

    def move_within_bounds_and_face(self, pos_xz, bounds=None) -> None:
        """Center the RTS camera over a ground point."""
        height = self.pos[1]
        d = self.direction()
        t = -height / min(d[1], -1e-3)
        ground = self.pos + d * t
        delta = np.array([pos_xz[0] - ground[0], 0.0, pos_xz[1] - ground[2]])
        self.pos = self.pos + delta

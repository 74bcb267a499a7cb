"""Collision / intersection library: frustum, OBB, AABB, ray tests.

Port of ``permafrost_engine_tpu/ops/collision.py``, the reference's C_*
collision library (ref: src/phys/collision.c: frustum/OBB/AABB/ray tests,
used by culling at game.c:2201 and picking). Everything is batched torch
over tensors of shapes, on the inputs' device, so one call tests the whole
arena.

OBBs here are y-axis-aligned boxes (yaw rotation only), matching how the
engine derives entity OBBs from bind-pose AABBs + yaw facing
(ref: Entity_CurrentOBB, src/entity.c:336).
"""

from __future__ import annotations

import torch

_EPS = 1e-9

_SIGNS = [[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)]


def obb_corners(center, half_ext, yaw):
    """8 corners of yaw-rotated boxes. center [...,3], half_ext [...,3],
    yaw [...] -> [..., 8, 3]."""
    c, s = torch.cos(yaw), torch.sin(yaw)
    signs = torch.tensor(_SIGNS, dtype=torch.float32, device=center.device)
    local = signs * half_ext[..., None, :]             # [...,8,3]
    x = local[..., 0] * c[..., None] + local[..., 2] * s[..., None]
    z = -local[..., 0] * s[..., None] + local[..., 2] * c[..., None]
    rot = torch.stack([x, local[..., 1], z], dim=-1)
    return center[..., None, :] + rot


def frustum_obb_test(planes, center, half_ext, yaw):
    """Conservative frustum-vs-OBB: keep if no plane has all 8 corners
    outside (the reference's fast frustum-OBB used in culling).
    planes f32[6,4]; box args batched [...]. Returns bool[...]."""
    corners = obb_corners(center, half_ext, yaw)       # [...,8,3]
    d = torch.einsum("...kc,pc->...kp", corners, planes[:, :3]) + planes[:, 3]
    all_out = torch.any(torch.all(d < 0, dim=-2), dim=-1)
    return ~all_out


def _slab(lo, hi, origin, direction):
    """Slab test of rays against boxes [lo, hi]: (hit, t)."""
    inv = 1.0 / torch.where(direction.abs() < _EPS,
                            torch.where(direction >= 0, _EPS, -_EPS),
                            direction)
    t1 = (lo - origin) * inv
    t2 = (hi - origin) * inv
    tmin = torch.minimum(t1, t2).amax(dim=-1)
    tmax = torch.maximum(t1, t2).amin(dim=-1)
    hit = tmax >= tmin.clamp(min=0.0)
    return hit, torch.where(hit, tmin.clamp(min=0.0),
                            torch.full_like(tmin, float("inf")))


def ray_aabb(origin, direction, box_min, box_max):
    """Slab test. origin/direction [3]; boxes [...,3].
    Returns (hit bool[...], t f32[...])."""
    return _slab(box_min, box_max, origin, direction)


def _to_local(point, center, yaw):
    """Points relative to yaw-rotated boxes, in each box's frame."""
    c, s = torch.cos(yaw), torch.sin(yaw)
    rel = point - center                               # [...,3]
    lx = rel[..., 0] * c - rel[..., 2] * s
    lz = rel[..., 0] * s + rel[..., 2] * c
    return torch.stack([lx, rel[..., 1], lz], -1), c, s


def ray_obb(origin, direction, center, half_ext, yaw):
    """Transform the ray into each box's local frame, then slab-test."""
    lo, c, s = _to_local(origin, center, yaw)
    dx = direction[0] * c - direction[2] * s
    dz = direction[0] * s + direction[2] * c
    ld = torch.stack([dx, direction[1].expand_as(dx), dz], -1)
    return _slab(-half_ext, half_ext, lo, ld)


def aabb_aabb_test(min_a, max_a, min_b, max_b):
    """Overlap test, batched over leading dims of either side."""
    return torch.all((min_a <= max_b) & (max_a >= min_b), dim=-1)


def sphere_obb_test(sphere_c, sphere_r, center, half_ext, yaw):
    """Clamp the sphere centre into the box's local frame."""
    lo, _, _ = _to_local(sphere_c, center, yaw)
    nearest = torch.clamp(lo, -half_ext, half_ext)
    d2 = torch.sum((lo - nearest) ** 2, dim=-1)
    return d2 <= sphere_r * sphere_r


def swept_sphere_obb(p0, p1, radius, center, half_ext, yaw, steps: int = 4):
    """Swept-sphere vs OBB via conservative sub-stepping — the projectile
    hit test (ref: phys_sweep_test, projectile.c:282-354). p0/p1 [...,3]."""
    ts = torch.linspace(0.0, 1.0, steps, device=p0.device)
    hits = [sphere_obb_test(p0 + (p1 - p0) * ts[i], radius, center, half_ext,
                            yaw) for i in range(steps)]
    return torch.any(torch.stack(hits), dim=0)

"""Skeletal pose palettes as batched elementwise math.

The benchmark's frozen copy of ``permafrost_engine_tpu_torch/ops/pose.py``,
taken when the benchmark was defined and kept as it was: part of the plain
reference that ``benchmark/check.py`` holds the program against. It imports
nothing of the program and nothing of JAX.

Port of ``permafrost_engine_tpu/ops/pose.py``. The reference computes
per-entity joint pose matrices on the CPU each tick (ref: src/anim/anim.c
A_Update) and packs every entity's palette into one shared texture for GPU
skinning (ref: src/anim/anim_texture.c:93-145). Here both halves are one
batched computation over [N, J, 4, 4] tensors:

  * local joint transforms from keyframe interpolation (lerp + slerp);
  * globals = parent-chain products, level by level over the skeleton
    hierarchy (a level's parents all sit on the level before it);
  * the skinning palette = global @ inverse bind.

``_affine_mul`` is the JAX code's broadcast-multiply-sum over the 3x4
affine block, not ``torch.matmul``: each element sums the same three
products in the same order, and no TF32 setting can touch it. The
hierarchy's gather indices are built once per (rig, device) outside any
CUDA graph capture (``_level_tables``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

MAX_JOINTS = 96  # ref: src/entity.h:50


def trs_to_mat(trans: torch.Tensor, rot_quat: torch.Tensor,
               scale: torch.Tensor) -> torch.Tensor:
    """Compose TRS -> 4x4 matrices, batched over leading dims: trans
    [..., 3], rot_quat [..., 4] (x, y, z, w), scale [..., 3]."""
    x, y, z, w = (rot_quat[..., 0], rot_quat[..., 1],
                  rot_quat[..., 2], rot_quat[..., 3])
    n = x * x + y * y + z * z + w * w
    # a true division, as jnp's (a Python number over a tensor is a
    # reciprocal times the number in torch)
    s = torch.where(n > 0, torch.full_like(n, 2.0) / torch.clamp(n, min=1e-12),
                    0.0)
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z

    r = torch.stack([
        torch.stack([1 - (yy + zz), xy - wz, xz + wy], -1),
        torch.stack([xy + wz, 1 - (xx + zz), yz - wx], -1),
        torch.stack([xz - wy, yz + wx, 1 - (xx + yy)], -1),
    ], -2)                                              # [..., 3, 3]
    r = r * scale[..., None, :]
    m = torch.zeros((*r.shape[:-2], 4, 4), dtype=r.dtype, device=r.device)
    m[..., :3, :3] = r
    m[..., :3, 3] = trans
    m[..., 3, 3].fill_(1.0)
    return m


def quat_slerp(q0: torch.Tensor, q1: torch.Tensor, t) -> torch.Tensor:
    """Batched slerp; t broadcastable over leading dims."""
    dot = (q0 * q1).sum(-1, keepdim=True)
    q1 = torch.where(dot < 0, -q1, q1)
    dot = dot.abs()
    # fall back to lerp when nearly parallel
    theta = torch.arccos(torch.clamp(dot, -1.0, 1.0))
    sin_t = torch.sin(theta)
    w0 = torch.where(sin_t > 1e-5, torch.sin((1 - t) * theta) / sin_t, 1 - t)
    w1 = torch.where(sin_t > 1e-5, torch.sin(t * theta) / sin_t, t)
    out = w0 * q0 + w1 * q1
    norm = torch.sqrt((out * out).sum(-1, keepdim=True))
    return out / torch.clamp(norm, min=1e-12)


def hierarchy_levels(parents: np.ndarray) -> list[np.ndarray]:
    """Group joint indices by depth; parents[j] < j or -1 for roots."""
    depth = np.zeros(len(parents), np.int32)
    for j, p in enumerate(parents):
        depth[j] = 0 if p < 0 else depth[p] + 1
    return [np.nonzero(depth == d)[0] for d in range(depth.max() + 1)]


def _affine_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched affine 4x4 product a @ b (bottom rows assumed [0,0,0,1]), as
    the JAX code writes it: a broadcast multiply summed over the 3x4 block."""
    ra, ta = a[..., :3, :3], a[..., :3, 3]
    rb = b[..., :3, :4]
    top = (ra[..., :, :, None] * rb[..., None, :, :]).sum(-2)
    top[..., :, 3] += ta
    bot = torch.zeros(top.shape[:-2] + (1, 4), dtype=a.dtype, device=a.device)
    bot[..., 3].fill_(1.0)
    return torch.cat([top, bot], dim=-2)


@functools.cache
def _level_tables(parents: tuple, levels: tuple, device: torch.device):
    """Device index tensors of the per-level walk: (joint ids of each
    level, the parents' positions within the previous level for levels
    1.., the permutation from level order back to joint order)."""
    j = len(parents)
    pos = np.full(j, -1, np.int64)          # joint -> index within its level
    ids, ppos = [], []
    for d, lvl in enumerate(levels):
        lv = np.asarray(lvl, np.int64)
        if d:
            ppos.append(torch.from_numpy(
                pos[np.asarray([parents[i] for i in lv])]).to(device))
        ids.append(torch.from_numpy(lv).to(device))
        pos[lv] = np.arange(len(lv))
    order = np.concatenate([np.asarray(l, np.int64) for l in levels])
    return (tuple(ids), tuple(ppos),
            torch.from_numpy(np.argsort(order)).to(device))


def pose_palette(local: torch.Tensor, inv_bind: torch.Tensor, parents,
                 levels: tuple) -> torch.Tensor:
    """Global pose palette [N, J, 4, 4] from local joint transforms f32[N,
    J, 4, 4]: parent-chain products then the inverse-bind multiply (the
    anim-texture contents). `inv_bind` is [J, 4, 4] or [N, J, 4, 4];
    `parents` and `levels` (joint ids by depth) are host values."""
    par = tuple(int(p) for p in np.asarray(parents))
    return _pose_palette(local, inv_bind, par, levels)


def _pose_palette(local, inv_bind, parents: tuple, levels: tuple):
    # per-level pieces and ONE final permutation: level d's parents all sit
    # at level d-1, so only the previous level's small piece is ever read
    ids, ppos, unperm = _level_tables(parents, levels, local.device)
    pieces = [local[:, ids[0]]]
    for d in range(1, len(levels)):
        pieces.append(_affine_mul(pieces[d - 1][:, ppos[d - 1]],
                                  local[:, ids[d]]))
    glob = torch.cat(pieces, dim=1) if len(pieces) > 1 else pieces[0]
    glob = glob[:, unperm]                  # back to joint order
    if inv_bind.dim() == 3:
        inv_bind = inv_bind[None]
    return _affine_mul(glob, inv_bind.expand(glob.shape))



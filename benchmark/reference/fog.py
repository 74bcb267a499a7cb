"""Fog of war: per-faction visibility, recomputed densely each update.

The benchmark's frozen copy of ``permafrost_engine_tpu_torch/ops/fog.py``,
taken when the benchmark was defined and kept as it was: part of the plain
reference that ``benchmark/check.py`` holds the program against. It imports
nothing of the program and nothing of JAX.

Port of ``permafrost_engine_tpu/ops/fog.py`` (ref: src/game/fog_of_war.c:
203-354 disc stamps, 163-177 the explored ladder, 427-541 shadowcasting).

Flat maps: entities mark per-(faction, radius-bucket) occupancy planes and
one dilation cascade of 3-wide max passes (``max3_rows``/``max3_cols``,
also the movement substep's blocker dilation) grows them to their radii,
largest bucket first (full 3x3 steps and cross steps mixed, so each
bucket's reach is a near-exact octagon; dilation distributes over union,
so every bucket joins the cascade after its own number of stages). Uneven maps (a ``tile_height``):
viewers are deduplicated by (faction, tile), keeping each tile's largest
vision, and the ring-DP shadowcaster (``ops/shadowcast.py``) runs over the
unique viewers. Explored memory (UNEXPLORED -> IN_FOG) is a running max.
"""

from __future__ import annotations

import functools

import torch

from benchmark.reference.config import FogState, UNITS_PER_TILE
from benchmark.reference.shadowcast import shadowcast_visibility

# vision radii quantized to buckets, in map tiles
VISION_BUCKET_RADII = (4, 8, 12, 16)

# per 4-tile radius increment: (full 3x3 steps, cross steps)
_DILATE_STAGES = ((2, 2), (1, 3), (2, 2), (2, 2))


@functools.cache
def _bucket_radii(device: torch.device) -> torch.Tensor:
    """``VISION_BUCKET_RADII`` as f32 on `device`, made once per device."""
    return torch.tensor(VISION_BUCKET_RADII, dtype=torch.float32,
                        device=device)


def max3_rows(x: torch.Tensor) -> torch.Tensor:
    """3-wide max along rows (axis -2) of a non-negative [..., H, W] grid,
    zero outside (a JAX 3x1 reduce_window max, "SAME")."""
    p = torch.nn.functional.pad(x, (0, 0, 1, 1))
    return torch.maximum(torch.maximum(p[..., :-2, :], p[..., 1:-1, :]),
                         p[..., 2:, :])


def max3_cols(x: torch.Tensor) -> torch.Tensor:
    """3-wide max along columns (axis -1), zero outside."""
    p = torch.nn.functional.pad(x, (1, 1))
    return torch.maximum(torch.maximum(p[..., :-2], p[..., 1:-1]), p[..., 2:])


def _dilate_stage(x: torch.Tensor, full: int, cross: int) -> torch.Tensor:
    """Grow a [..., H, W] occupancy mask by one radius increment."""
    for _ in range(full):
        x = max3_cols(max3_rows(x))
    for _ in range(cross):
        x = torch.maximum(max3_rows(x), max3_cols(x))
    return x


def update_fog(fog_state, enabled, pos, alive, faction, vision_range,
               tile_height=None, *, tiles_h: int, tiles_w: int,
               max_factions: int) -> torch.Tensor:
    """New fog planes u8[F, TH, TW] (FogState codes) from the entities'
    positions f32[N, 2], liveness, factions and vision ranges (world
    units); every tile VISIBLE when fog is disabled."""
    n = pos.shape[0]
    dev = pos.device
    nb = len(VISION_BUCKET_RADII)
    radii = _bucket_radii(dev)
    plane = tiles_h * tiles_w

    c = torch.clamp((pos[:, 0] / UNITS_PER_TILE).to(torch.int32), 0, tiles_w - 1)
    r = torch.clamp((pos[:, 1] / UNITS_PER_TILE).to(torch.int32), 0, tiles_h - 1)
    vr_tiles = vision_range / UNITS_PER_TILE
    # smallest bucket covering the range (clamped to the largest)
    bucket = torch.clamp((vr_tiles[:, None] > radii[None, :]).sum(1), 0, nb - 1)
    ok = alive & (faction >= 0) & (vision_range > 0)

    if tile_height is not None:
        # dedupe viewers by (faction, tile): same-tile viewers with the max
        # vision see a superset of the rest; capacity max(1024, N/4) unique
        # tiles, overflow tiles see nothing until the next update
        cap = max(1024, n // 4)
        big = max_factions * plane
        key = torch.where(ok, torch.clamp(faction, 0, max_factions - 1) * plane
                          + r * tiles_w + c, big).long()
        visg = torch.zeros(big + 1, dtype=torch.float32, device=dev)
        visg.scatter_reduce_(0, key, vr_tiles, reduce="amax")
        skeys = torch.sort(key).values
        prev = torch.cat([skeys.new_full((1,), -1), skeys[:-1]])
        first = (skeys != prev) & (skeys < big)
        upos = torch.cumsum(first, 0) - 1
        slot = torch.where(first & (upos < cap), upos, cap)
        ukeys = torch.full((cap + 1,), big, dtype=torch.int64, device=dev)
        ukeys[slot] = skeys          # only the spare row takes duplicates
        ukeys = ukeys[:cap]
        uvalid = ukeys < big
        uk = torch.where(uvalid, ukeys, 0)
        visible = shadowcast_visibility(
            torch.stack([(uk % plane) // tiles_w, uk % tiles_w], 1),
            uvalid, uk // plane, visg[ukeys], tile_height,
            radius=VISION_BUCKET_RADII[-1], tiles_h=tiles_h, tiles_w=tiles_w,
            max_factions=max_factions)
    else:
        chan = faction * nb + bucket
        nchan = max_factions * nb
        flat = torch.where(ok, chan * plane + r * tiles_w + c,
                           nchan * plane).long()
        occ = torch.zeros(nchan * plane + 1, dtype=torch.uint8, device=dev)
        occ.index_fill_(0, flat, 1)  # max with 1 is a set
        occ = occ[:-1].reshape(max_factions, nb, tiles_h, tiles_w)
        x = occ[:, nb - 1]
        for i, (full, cross) in enumerate(reversed(_DILATE_STAGES)):
            x = _dilate_stage(x, full, cross)
            if i < nb - 1:
                x = torch.maximum(x, occ[:, nb - 2 - i])
        visible = x > 0
    explored = fog_state > FogState.UNEXPLORED
    new = torch.where(
        visible, int(FogState.VISIBLE),
        torch.where(explored, int(FogState.IN_FOG),
                    int(FogState.UNEXPLORED))).to(torch.uint8)
    return torch.where(enabled, new, int(FogState.VISIBLE)).to(torch.uint8)

"""Per-entity desired-velocity sampling from the flow-field slab.

The benchmark's frozen copy of
``permafrost_engine_tpu_torch/ops/velocity.py``, taken when the benchmark
was defined and kept as it was: part of the plain reference that
``benchmark/check.py`` holds the program against. It imports nothing of the
program and nothing of JAX.

Port of ``permafrost_engine_tpu/ops/velocity.py`` (ref:
N_DesiredPointSeekVelocity, src/navigation/nav.c:3401-3468): each entity
samples the 4 nav tiles around its position, resolves each tile's chunk
through its flock's chunk->slot table, decodes the FlowDir codes and blends
the unit vectors bilinearly. On a GPU an element gather is cheap, so the
slab reads are plain indexing (the JAX version's row-gather + one-hot
extract exists for the TPU's gather cost).
"""

from __future__ import annotations

import torch

from benchmark.reference.config import FIELD_RES, NAV_TILE_SIZE
from benchmark.reference.flowfield import dir_code_to_vec


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1])


def flow_velocity(pos, flock, field_slot, flow_slab, global_slot,
                  global_flow, ent_gslot, *, chunks_r: int, chunks_c: int):
    """Sample flow direction per entity. A flock with a whole-map field
    (`global_slot` >= 0) samples it directly, as does a flockless entity
    with `ent_gslot` >= 0 (combat chase); others resolve per-chunk slab
    slots. Returns (dir f32[N,2] blended unit direction, zero without field
    data; has_field bool[N])."""
    field_h = chunks_r * FIELD_RES
    field_w = chunks_c * FIELD_RES

    fx = pos[:, 0] / NAV_TILE_SIZE - 0.5
    fz = pos[:, 1] / NAV_TILE_SIZE - 0.5
    c0 = torch.floor(fx).to(torch.int32)
    r0 = torch.floor(fz).to(torch.int32)
    wx = fx - c0
    wz = fz - r0

    fl = torch.clamp(flock, min=0).long()
    no_flock = flock < 0
    gslot = global_slot[fl]
    use_global = (gslot >= 0) & ~no_flock
    use_ent = no_flock & (ent_gslot >= 0)
    gslot = torch.where(use_ent, ent_gslot, gslot)
    use_global = use_global | use_ent

    rc = torch.clamp(torch.stack([r0, r0, r0 + 1, r0 + 1], 1), 0, field_h - 1)
    cc = torch.clamp(torch.stack([c0, c0 + 1, c0, c0 + 1], 1), 0, field_w - 1)
    chunk = (rc // FIELD_RES) * chunks_c + (cc // FIELD_RES)          # [N,4]
    slot = torch.gather(field_slot[fl], 1, chunk.long())             # [N,4]
    lr, lc = (rc % FIELD_RES).long(), (cc % FIELD_RES).long()
    code = flow_slab[torch.clamp(slot, min=0).long(), lr, lc]
    g4 = torch.clamp(gslot, min=0).long()[:, None].expand(-1, 4)
    gcode = global_flow[g4, rc.long(), cc.long()]
    code = torch.where(use_global[:, None], gcode, code)
    has = ((slot >= 0) & ~no_flock[:, None]) | use_global[:, None]
    vec = dir_code_to_vec(torch.where(has, code, 0))                 # [N,4,2]
    hasd = has & (code > 0)

    w00 = ((1 - wz) * (1 - wx))[:, None]
    w01 = ((1 - wz) * wx)[:, None]
    w10 = (wz * (1 - wx))[:, None]
    w11 = (wz * wx)[:, None]
    blend = vec[:, 0] * w00 + vec[:, 1] * w01 + vec[:, 2] * w10 + vec[:, 3] * w11
    norm = _norm(blend)[:, None]
    direction = torch.where(norm > 1e-6, blend / torch.clamp(norm, min=1e-6),
                            0.0)
    has_field = hasd.any(dim=1)
    return torch.where(has_field[:, None], direction, 0.0), has_field


def dest_los(pos, flock, los_slot, los_slab, *, chunks_r: int,
             chunks_c: int):
    """Per-entity line of sight to the flock destination from the LOS slab
    at the entity's nav tile (ref: movement.c:4129). bool[N]."""
    field_h = chunks_r * FIELD_RES
    field_w = chunks_c * FIELD_RES
    c = torch.clamp((pos[:, 0] / NAV_TILE_SIZE).to(torch.int32), 0, field_w - 1)
    r = torch.clamp((pos[:, 1] / NAV_TILE_SIZE).to(torch.int32), 0, field_h - 1)
    chunk = (r // FIELD_RES) * chunks_c + (c // FIELD_RES)
    fl = torch.clamp(flock, min=0).long()
    slot = los_slot[fl, chunk.long()]
    val = los_slab[torch.clamp(slot, min=0).long(), (r % FIELD_RES).long(),
                   (c % FIELD_RES).long()]
    return (flock >= 0) & (slot >= 0) & (val > 0)

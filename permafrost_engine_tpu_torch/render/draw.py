"""Draw-buffer emission: culling, instance transforms, minimap, healthbars.

The reference's render producer side records GL commands per frame
(ref: src/game/game.c:2163-2359 — vis culling + draw-list build in
G_Update, render-input assembly in G_Render). The engine's presentation
contract is *arrays, not commands*: one device pass culls the arena
against the camera frustum and emits instance model matrices, healthbar
fractions and minimap dots; a host renderer (or test) consumes them. GPU
skinning palettes come from render/anim_system.py.

Port of ``permafrost_engine_tpu/render/draw.py``: ``cull_and_emit`` is
plain PyTorch on the engine's device (its plane test written out as
products and sums, so no matmul and no TF32), and ``minimap_raster`` reads
the arena through one ``Engine.ents_host`` copy per call.
"""

from __future__ import annotations

import numpy as np
import torch

from permafrost_engine_tpu_torch.core.config import (
    EngineConfig,
    EntityFlags,
    FogState,
)
from permafrost_engine_tpu_torch.render.raster import dot


def cull_and_emit(
    pos: torch.Tensor,        # f32[N,2]
    prev_pos: torch.Tensor,   # f32[N,2] previous movement-tick position
    alpha: float,             # interpolation fraction within the tick
    height: torch.Tensor,     # f32[N]
    facing: torch.Tensor,     # f32[N]
    radius: torch.Tensor,     # f32[N]
    alive: torch.Tensor,      # bool[N]
    flags: torch.Tensor,      # i32[N] (the JAX u32 bit pattern)
    hp: torch.Tensor,
    max_hp: torch.Tensor,
    planes: torch.Tensor,     # f32[6,4] frustum planes (nx,ny,nz,d)
    cam_pos: torch.Tensor,    # f32[3]
    lod_dists: torch.Tensor,  # f32[2] LOD switch distances
):
    """Frustum-cull (sphere test, the cheap half of the reference's
    frustum/OBB test, ref: game.c:2193-2219) and emit draw inputs.
    Positions interpolate between movement ticks at render rate
    (ref: interpolate_tick, movement.c:4085) and a LOD index is selected
    by camera distance (ref: game.c:439-463)."""
    pos = prev_pos + (pos - prev_pos) * float(alpha)
    p3 = torch.stack([pos[:, 0], height, pos[:, 1]], 1)     # [N,3]
    vis = alive & ((flags & int(EntityFlags.INVISIBLE)) == 0)
    dists = dot(p3[:, None, :], planes[None, :, :3]) + planes[None, :, 3]
    inside = torch.all(dists >= -radius[:, None], 1)        # [N,6] -> [N]
    visible = vis & inside
    d = p3 - cam_pos[None, :]
    cam_d = torch.sqrt(dot(d, d))
    lod = (cam_d > lod_dists[0]).to(torch.int32) + (
        cam_d > lod_dists[1]).to(torch.int32)

    # model matrices: translate * rotY(facing)
    c, s = torch.cos(facing), torch.sin(facing)
    zeros = torch.zeros_like(c)
    ones = torch.ones_like(c)
    m = torch.stack([
        torch.stack([c, zeros, s, p3[:, 0]], -1),
        torch.stack([zeros, ones, zeros, p3[:, 1]], -1),
        torch.stack([-s, zeros, c, p3[:, 2]], -1),
        torch.stack([zeros, zeros, zeros, ones], -1),
    ], 1)                                                    # [N,4,4]

    health_frac = torch.where(max_hp > 0, hp / torch.clamp(max_hp, min=1e-6),
                              0.0)
    return visible, m, health_frac, lod


def frustum_tensors(camera, device):
    """The camera's frustum planes f32[6,4] and position f32[3] on
    `device`."""
    planes = torch.from_numpy(np.asarray(camera.frustum_planes(), np.float32))
    cam = torch.from_numpy(np.asarray(camera.pos, np.float32))
    return planes.to(device), cam.to(device)


def draw_buffers(engine, camera, alpha: float = 1.0) -> dict:
    """One-call presentation export for the host renderer. `alpha` is the
    render-frame fraction within the current movement tick."""
    e = engine.state.ents
    planes, cam_pos = frustum_tensors(camera, engine.device)
    try:
        d1 = engine.settings.get("pf.video.lod_dist1")
        d2 = engine.settings.get("pf.video.lod_dist2")
    except Exception:
        d1, d2 = 200.0, 400.0
    visible, mats, health, lod = cull_and_emit(
        e.pos, e.prev_pos, alpha, e.height, e.facing,
        e.sel_radius, e.alive, e.flags, e.hp, e.max_hp, planes, cam_pos,
        torch.tensor([d1, d2], dtype=torch.float32).to(engine.device))
    out = {
        "visible": visible,
        "model_mats": mats,
        "health_frac": health,
        "lod": lod,
        "faction": e.faction,
        "selection": list(engine.selection.selection),
    }
    # billboard sprites (ref: src/sprite.c, src/render/gl_sprite.c): host
    # list — scripts spawn few of them; exported as-is for the renderer
    try:
        from permafrost_engine_tpu_torch.script import pf
        out["sprites"] = list(pf._sprites)
    except Exception:
        out["sprites"] = []
    return out


# faction dot colors for the minimap
_FACTION_COLORS = np.array([
    [60, 120, 255], [255, 60, 60], [60, 220, 60], [255, 220, 60],
    [200, 60, 255], [60, 220, 220], [255, 140, 0], [150, 150, 150],
] * 2, np.uint8)


def minimap_raster(engine, size: int = 256, faction_pov: int | None = None) -> np.ndarray:
    """Baked-terrain + live-unit-dots minimap (ref: src/render/gl_minimap.c,
    src/map/minimap.c) as a u8[size, size, 3] image, optionally fogged from
    one faction's point of view."""
    cfg: EngineConfig = engine.cfg
    heights = engine.heights

    def _resample(src: np.ndarray) -> np.ndarray:
        # exact nearest-neighbour index map: strided slicing only works
        # when the source resolution divides `size` (a 64-tile fog plane
        # vs an 85-px scripted minimap crashed the HUD compositor)
        ri = np.minimum(np.arange(size) * src.shape[0] // size,
                        src.shape[0] - 1)
        ci = np.minimum(np.arange(size) * src.shape[1] // size,
                        src.shape[1] - 1)
        return src[ri[:, None], ci[None, :]]

    hg = _resample(np.asarray(heights))
    img = np.zeros((size, size, 3), np.uint8)
    water = hg < 0
    img[water] = (40, 60, 140)
    land_shade = np.clip(90 + hg * 4, 60, 200).astype(np.uint8)
    img[~water] = np.stack([land_shade[~water] // 2,
                            land_shade[~water],
                            land_shade[~water] // 3], -1)

    if faction_pov is not None:
        fog = engine.state.fog.state[faction_pov].cpu().numpy()
        fr = _resample(fog)
        img[fr == int(FogState.UNEXPLORED)] = 0
        img[fr == int(FogState.IN_FOG)] //= 2

    h = engine.ents_host("alive", "pos", "faction")
    alive = h["alive"]
    pos = h["pos"][alive]
    fac = h["faction"][alive]
    ys = np.clip((pos[:, 1] / cfg.world_h * img.shape[0]).astype(int),
                 0, img.shape[0] - 1)
    xs = np.clip((pos[:, 0] / cfg.world_w * img.shape[1]).astype(int),
                 0, img.shape[1] - 1)
    img[ys, xs] = _FACTION_COLORS[np.clip(fac, 0, len(_FACTION_COLORS) - 1)]
    return img

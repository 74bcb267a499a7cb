"""Scene assembly: engine state -> rendered frames via the rasterizer.

The reference's G_Render records GL commands for terrain, batched skinned
entities, water (reflection FBO), shadows (light depth pass), skybox and
overlays (ref: src/game/game.c:2251-2359, src/render/).
Here the same passes are expressed as raster/shade invocations over one
concatenated triangle soup:

  terrain   — height-field mesh with slope/height materials (gl_terrain.c)
  entities  — per-instance procedural meshes (soldier/building/resource)
              transformed by the cull_and_emit model matrices; real PFObj
              meshes with pose-palette skinning ride the same path
  shadow    — depth-only raster from the sun's ortho view (gl_shadows.c)
  water     — plane + planar reflection: the scene re-rastered under a
              mirror matrix, sampled at the same pixel (gl_water.c)
  sky       — per-ray gradient fallback (gl_skybox.c)
  overlays  — healthbars / selection circles composited on host
              (gl_statusbar.c, gl_ui.c draw-lists)

Port of ``permafrost_engine_tpu/render/scene.py``. A ``SceneRenderer``
renders on its engine's device and caches the terrain mesh, the atlas,
the per-camera view rays and the shadow map across frames. A frame is one
call of ``_frame_device`` (raster -> shade -> water -> gamma -> u8) that
ends in a single device-to-host copy of the u8 image; the pass-by-pass
path (``pf.debug.render_log_mask`` bit 1) is the same function with a
synchronizing timer between the passes. The host reads of a frame (model
slots, healthbars, the HUD and debug overlays) go through one
``Engine.ents_host`` copy.

Deliberate difference: the shadow pass rasterizes the whole soup, without
the live-triangle compaction (the JAX package's ``raster_budget=0``) and
without the near-plane clip (see ``SceneRenderer._shadow_pass``).
"""

from __future__ import annotations

import functools
import os
import time

import numpy as np
import torch
import torch.nn.functional as F

from permafrost_engine_tpu_torch.core.config import (EntityFlags, FogState,
                                                     NAV_TILE_SIZE)
from permafrost_engine_tpu_torch.render import debug_overlays, raster
from permafrost_engine_tpu_torch.render.draw import (cull_and_emit,
                                                     frustum_tensors)
from permafrost_engine_tpu_torch.render.raster import dot, transform

SUN_DIR = np.array([-0.45, -0.8, -0.35], np.float32)
SUN_DIR /= np.linalg.norm(SUN_DIR)
SKY = np.array([[0.35, 0.55, 0.85], [0.78, 0.82, 0.88]], np.float32)

GRASS = np.array([0.30, 0.46, 0.22], np.float32)
ROCK = np.array([0.46, 0.42, 0.38], np.float32)
SAND = np.array([0.70, 0.65, 0.45], np.float32)
WATER_DEEP = np.array([0.10, 0.22, 0.40], np.float32)

FACTION_RGB = np.array([
    [0.25, 0.45, 0.95], [0.95, 0.25, 0.25], [0.25, 0.85, 0.25],
    [0.95, 0.85, 0.25], [0.75, 0.25, 0.95], [0.25, 0.85, 0.85],
    [0.95, 0.55, 0.05], [0.60, 0.60, 0.60],
] * 2, np.float32)
RESOURCE_RGB = np.array([0.2, 0.7, 0.3], np.float32)

# the entity columns a frame reads on the host, in one ents_host copy:
# model slots, healthbars and selection, the HUD and the debug overlays
HOST_COLUMNS = ("hp", "max_hp") + debug_overlays.HOST_COLUMNS


# ---------------------------------------------------------------------------
# Procedural instance meshes (triangle soup, unit-scale)
# ---------------------------------------------------------------------------


def _soldier_mesh() -> np.ndarray:
    """Hexagonal bipyramid 'pawn': 12 tris, ~1u radius, 3.2u tall."""
    ang = np.linspace(0, 2 * np.pi, 7)[:6]
    ring = np.stack([np.cos(ang) * 0.8, np.full(6, 1.2), np.sin(ang) * 0.8], 1)
    top = np.array([0.0, 3.2, 0.0])
    bot = np.array([0.0, 0.0, 0.0])
    tris = []
    for i in range(6):
        a, b = ring[i], ring[(i + 1) % 6]
        tris.append([top, a, b])
        tris.append([bot, b, a])
    return np.asarray(tris, np.float32)


def _box_mesh() -> np.ndarray:
    """Unit box (12 tris), base at y=0, 2u wide, 2.5u tall."""
    x, y, z = 1.0, 2.5, 1.0
    c = np.array([[-x, 0, -z], [x, 0, -z], [x, 0, z], [-x, 0, z],
                  [-x, y, -z], [x, y, -z], [x, y, z], [-x, y, z]], np.float32)
    quads = [(0, 1, 5, 4), (1, 2, 6, 5), (2, 3, 7, 6),
             (3, 0, 4, 7), (4, 5, 6, 7), (1, 0, 3, 2)]
    tris = []
    for a, b, cc, d in quads:
        tris.append([c[a], c[b], c[cc]])
        tris.append([c[a], c[cc], c[d]])
    return np.asarray(tris, np.float32)


def _cone_mesh() -> np.ndarray:
    """Hex cone (resource node): 12 tris (6 side + 6 base)."""
    ang = np.linspace(0, 2 * np.pi, 7)[:6]
    ring = np.stack([np.cos(ang) * 1.2, np.zeros(6), np.sin(ang) * 1.2], 1)
    top = np.array([0.0, 2.4, 0.0])
    bot = np.array([0.0, 0.0, 0.0])
    tris = []
    for i in range(6):
        a, b = ring[i], ring[(i + 1) % 6]
        tris.append([top, a, b])
        tris.append([bot, b, a])
    return np.asarray(tris, np.float32)


MESH_TRIS = 12  # every bank entry is padded to this many triangles


def _mesh_bank() -> np.ndarray:
    bank = [_soldier_mesh(), _box_mesh(), _cone_mesh()]
    out = np.zeros((len(bank), MESH_TRIS, 3, 3), np.float32)
    for i, m in enumerate(bank):
        out[i, :len(m)] = m[:MESH_TRIS]
    return out


# ---------------------------------------------------------------------------
# Terrain
# ---------------------------------------------------------------------------


ATTR_C = 14   # wpos3 + normal3 + tint3 + uv2 + tex_a + tex_b + blend
TEX_GRASS, TEX_ROCK, TEX_SAND = 0, 1, 2
TEX_WORLD_SCALE = 48.0     # world units per texture repeat


def terrain_mesh(heights: np.ndarray, nav_tile: float = 4.0, step: int = 2):
    """Height-field -> (verts f32[T,3,3], normals, tints, uvs, texsel).
    Vertices sit at nav-tile corners every `step` nav tiles (step=2 ->
    map-tile quads, ref: gl_tile.c tile patches). Tints blend grass/rock/
    sand by height+slope and texsel [..., (tex_a, tex_b, blend)] selects
    the detail maps the shader mixes (the splat-material analogue, ref:
    terrain shaders + gl_image_quilt.c variation)."""
    hs = heights[::step, ::step]
    gh, gw = hs.shape
    sz = nav_tile * step
    xs = np.arange(gw) * sz
    zs = np.arange(gh) * sz
    vx, vz = np.meshgrid(xs, zs)
    v = np.stack([vx, hs, vz], -1).astype(np.float32)        # [gh,gw,3]

    # smooth normals from central differences
    gx = np.gradient(hs, sz, axis=1)
    gz = np.gradient(hs, sz, axis=0)
    n = np.stack([-gx, np.ones_like(hs), -gz], -1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)

    slope = np.clip(np.hypot(gx, gz) * 1.6, 0, 1)[..., None]
    hnorm = np.clip(hs / 12.0, 0, 1)[..., None]
    col = GRASS * (1 - slope) + ROCK * slope
    col = col * (1 - 0.25 * hnorm) + ROCK * 0.25 * hnorm
    tex = np.zeros((gh, gw, 3), np.float32)
    tex[..., 0] = TEX_GRASS
    tex[..., 1] = TEX_ROCK
    tex[..., 2] = slope[..., 0]
    if (heights < -0.01).any():     # beach/bed bands only on maps with water
        sandy = hs < 0.5
        col = np.where(sandy[..., None], SAND, col)
        tex[sandy] = (TEX_SAND, TEX_SAND, 0.0)
        col = np.where(hs[..., None] < -0.5, WATER_DEEP, col)
    col = col.astype(np.float32)
    uv = np.stack([vx / TEX_WORLD_SCALE, vz / TEX_WORLD_SCALE],
                  -1).astype(np.float32)

    def quads(field):
        a = field[:-1, :-1]; b = field[:-1, 1:]
        c = field[1:, 1:]; d = field[1:, :-1]
        t1 = np.stack([a, b, c], -2)
        t2 = np.stack([a, c, d], -2)
        last = field.shape[-1]
        return np.concatenate([t1.reshape(-1, 3, last),
                               t2.reshape(-1, 3, last)])

    return quads(v), quads(n), quads(col), quads(uv), quads(tex)


# ---------------------------------------------------------------------------
# Entity instance assembly (device)
# ---------------------------------------------------------------------------


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def _face_normals(tris):
    """Unit face normals of f32[..., 3, 3] triangles, broadcast to their
    three vertices."""
    fn = _cross(tris[..., 1, :] - tris[..., 0, :],
                tris[..., 2, :] - tris[..., 0, :])
    fn = fn / torch.clamp(torch.sqrt(dot(fn, fn))[..., None], min=1e-6)
    return fn[..., None, :].expand(tris.shape)


def _pad_attrs(verts, normals, tints):
    """(wpos, normal, tint) -> full attr channels with texturing off."""
    pad = torch.zeros(verts.shape[:-1] + (ATTR_C - 9,), dtype=verts.dtype,
                      device=verts.device)
    pad[..., 2:4] = -1.0                                   # tex_a, tex_b
    return torch.cat([verts, normals, tints, pad], -1)


def assemble_instances(mats, visible, scale, mesh_id, color, bank, *,
                       maxi: int):
    """Select up to `maxi` visible instances and expand their bank meshes
    into world-space triangles with flat normals and per-vertex colors.
    mats f32[N,4,4], visible bool[N], scale f32[N], mesh_id i32[N],
    color f32[N,3], bank f32[M,MESH_TRIS,3,3].
    Returns (verts f32[maxi*MESH_TRIS,3,3], attrs f32[...,3,ATTR_C])."""
    score, idx = raster.stable_top(visible.to(torch.int32), maxi)
    take = score > 0
    m = mats[idx]                                             # row gathers
    s = torch.where(take, scale[idx], 0.0)
    mid = torch.clamp(mesh_id[idx], 0, bank.shape[0] - 1).long()
    col = color[idx]

    local = bank[mid] * s[:, None, None, None]                # [maxi,12,3,3]
    m = m[:, None, None]                                      # [maxi,1,1,4,4]
    world = torch.stack([dot(local, m[..., i, :3]) + m[..., i, 3]
                         for i in range(3)], -1)
    fn = _face_normals(world)
    cols = col[:, None, None, :].expand(world.shape)
    verts = world.reshape(-1, 3, 3)
    attrs = _pad_attrs(verts, fn.reshape(-1, 3, 3), cols.reshape(-1, 3, 3))
    return verts, attrs


def skin_instances(palettes, mats, ok, verts, wj, wv, cols, uvs, texid):
    """GPU-skinning: blend pose palettes per vertex, then instance-
    transform (ref: shaders/vertex/skinned.glsl over the anim texture,
    src/render/gl_anim.c). palettes f32[n,J,4,4], mats f32[n,4,4],
    ok bool[n], verts f32[V,3] (triangle soup), wj i32[V,4], wv f32[V,4],
    cols f32[V,3] material tints, uvs f32[V,2], texid f32[V] atlas id or
    -1. Returns (tris f32[n*V/3,3,3], attrs f32[...,3,ATTR_C])."""
    n, v = mats.shape[0], verts.shape[0]
    safe = torch.clamp(wj, min=0).long()
    wvv = torch.where(wj >= 0, wv, 0.0)                      # [V,4]
    pv = palettes[:, safe]                                   # [n,V,4,4,4]
    m = pv[:, :, 0] * wvv[None, :, 0, None, None]
    for k in range(1, 4):
        m = m + pv[:, :, k] * wvv[None, :, k, None, None]    # [n,V,4,4]
    unweighted = (wvv.sum(-1) <= 1e-6)
    m = m + torch.eye(4, device=m.device) * unweighted[None, :, None, None]
    hom = torch.cat([verts, torch.ones((v, 1), dtype=verts.dtype,
                                       device=verts.device)], -1)
    sk = dot(m, hom[None, :, None, :])                       # [n,V,4]
    world = torch.stack([dot(sk, mats[:, None, i, :]) for i in range(3)], -1)
    world = torch.where(ok[:, None, None], world, 0.0)       # degenerate pad

    tris = world.reshape(n, v // 3, 3, 3)
    fn = _face_normals(tris)
    cc = cols.reshape(1, v // 3, 3, 3).expand(tris.shape)
    tris = tris.reshape(-1, 3, 3)
    extra = torch.cat([uvs, texid[:, None], texid[:, None],
                       torch.zeros((v, 1), dtype=verts.dtype,
                                   device=verts.device)], -1)  # uv, tex_a=b, blend 0
    ee = extra.reshape(1, v // 3, 3, 5).expand(n, v // 3, 3, 5).reshape(-1, 3, 5)
    attrs = torch.cat([tris, fn.reshape(-1, 3, 3), cc.reshape(-1, 3, 3), ee],
                      -1)
    return tris, attrs


# ---------------------------------------------------------------------------
# Full-frame renderer
# ---------------------------------------------------------------------------


def _ortho_vp(lo, hi, light_dir):
    """Ortho view-projection from the sun covering the world AABB."""
    center = (lo + hi) / 2
    ext = float(np.linalg.norm(hi - lo)) / 2 + 1.0
    eye = center - light_dir * ext
    f = light_dir
    r = np.cross(f, [0.0, 1.0, 0.0]); r /= max(np.linalg.norm(r), 1e-9)
    u = np.cross(r, f)
    view = np.eye(4, dtype=np.float32)
    view[0, :3], view[1, :3], view[2, :3] = r, u, -f
    view[:3, 3] = -view[:3, :3] @ eye
    # view-space z spans [0, -2*ext]; map it onto ndc z in [-1, 1]
    proj = np.diag([1 / ext, 1 / ext, -1 / ext, 1]).astype(np.float32)
    proj[2, 3] = -1.0
    return proj @ view


def _raster_pass(verts, attrs, vp, *, h, w, k=96, kbig=64, keep=None,
                 clip=True, budget=0, live=None):
    """Clip, project and rasterize one pass -> (zbuf, tri, bary, inv_w,
    attrs). `live`, a list, gets the pass's live-triangle count appended
    (one synchronization)."""
    if clip:
        # split near-plane-crossing triangles instead of rejecting them
        verts, attrs, ok = raster.clip_near(verts, attrs, vp)
        keep = ok if keep is None else ok & keep.repeat(2)
    xy, z, inv_w, valid, flip = raster.project(verts, vp, w, h)
    if keep is not None:
        valid = valid & keep                  # reflection clip plane analogue
    attrs = torch.where(flip[:, None, None], attrs.flip(1), attrs)
    if live is not None:
        live.append(int(valid.sum()))
    if budget and budget < xy.shape[0]:
        # COMPACT live triangles before binning: the static soup is mostly
        # dead rows (capacity padding, culled/off-screen geometry, the
        # [2T] near-clip doubling), and the binning sort otherwise carries
        # every dead row as a sentinel key. Stable cumsum scatter of source
        # indices + row gathers; overflow beyond the budget drops
        # back-of-soup-order (sprites last), degrading like the per-tile K
        # cap. Overflow rows all land on the extra last row, cut off.
        t2 = xy.shape[0]
        dev = xy.device
        pos = torch.cumsum(valid.to(torch.int64), 0) - 1
        pos = torch.where(valid, torch.clamp(pos, max=budget), budget)
        src = torch.zeros(budget + 1, dtype=torch.int64, device=dev)
        src[pos] = torch.arange(t2, device=dev)
        keep_rows = torch.zeros(budget + 1, dtype=torch.bool, device=dev)
        keep_rows[pos] = valid
        src, valid = src[:budget], keep_rows[:budget]
        xy, z, inv_w, attrs = xy[src], z[src], inv_w[src], attrs[src]
    zbuf, tri, bary = raster.raster_gbuffer(xy, z, valid, h=h, w=w,
                                            k=k, kbig=kbig)
    return zbuf, tri, bary, inv_w, attrs


@functools.cache
def _consts(device: torch.device):
    """The renderer's constant tensors, once per device."""
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    mirror_base = np.eye(4, dtype=np.float32)
    mirror_base[1, 1] = -1.0
    return dict(sun=t(SUN_DIR), sky=t(SKY), deep=t(WATER_DEEP),
                faction_rgb=t(FACTION_RGB), resource_rgb=t(RESOURCE_RGB),
                bank=t(_mesh_bank()), mirror=t(mirror_base),
                fog_off=torch.full((2, 2), int(FogState.VISIBLE),
                                   dtype=torch.uint8, device=device),
                no_shadow=torch.full((2, 2), float("inf"), device=device),
                no_rays=torch.zeros((1, 1, 3), device=device))


def _mat4_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b for 4x4 matrices, as products and sums (no TF32)."""
    return torch.stack([transform(a, b[:, j]) for j in range(4)], 1)


def _water_pass(col, zbuf, verts, attrs, vp, shade, rays, cam_pos, wl,
                heights, *, h, w, h2, w2, refr_on, world_w, world_h,
                budget, live=None):
    """Water plane + planar reflection (ref: gl_water.c reflection FBO:
    the scene re-rendered under a mirror matrix is sampled at the same
    pixel), over the shaded frame `col`."""
    dev = col.device
    # the water plane needs no raster: intersect each pixel ray with
    # y = wl analytically and depth-test the hit against the scene
    ry = rays[..., 1]
    t = (wl - cam_pos[1]) / torch.where(torch.abs(ry) < 1e-5,
                                        torch.full_like(ry, -1e-5), ry)
    wpt = cam_pos[None, None] + rays * t[..., None]
    hom = torch.cat([wpt, torch.ones_like(wpt[..., :1])], -1)
    clip = transform(vp, hom)
    z_ndc = clip[..., 2] / torch.clamp(clip[..., 3], min=1e-6)
    inb = ((wpt[..., 0] >= 0) & (wpt[..., 0] <= world_w)
           & (wpt[..., 2] >= 0) & (wpt[..., 2] <= world_h))
    water_vis = (t > 0) & (clip[..., 3] > 1e-4) & inb & (z_ndc < zbuf)

    mirror = _consts(dev)["mirror"].clone()
    mirror[1, 3] = 2.0 * wl
    vp_r = _mat4_mul(vp, mirror)
    # clip-plane analogue: below-water geometry must not occlude the
    # mirrored view (the GL path uses glClipPlane in the FBO pass)
    above = torch.any(verts[..., 1] > wl - 0.25, 1)
    _z2, tri2, bary2, iw2, a2 = _raster_pass(verts, attrs, vp_r, h=h2, w=w2,
                                             keep=above, budget=budget,
                                             live=live)
    refl = shade(tri2, bary2, iw2, a2, (h2, w2))
    if (h2, w2) != (h, w):
        # pf.video.water_rt_scale: the reflection renders at a reduced
        # resolution and upsamples (ref: gl_water.c render-target scale)
        refl = F.interpolate(refl.permute(2, 0, 1)[None], size=(h, w),
                             mode="bilinear", align_corners=False,
                             antialias=False)[0].permute(1, 2, 0)

    fresnel = torch.clamp(0.25 + 0.6 * (1.0 + rays[..., 1]) ** 2,
                          0.0, 0.9)[..., None]
    deep = _consts(dev)["deep"][None, None]
    if refr_on:
        # refraction: the shaded underwater scene at the same pixel (the
        # raster includes below-water geometry), attenuated toward the deep
        # color with water depth; soft shore edges fade the water layer out
        # where depth -> 0 (ref: gl_water.c:736 reflection + refraction
        # FBOs with depth-based soft edges)
        ri = torch.clamp(raster.to_i32(wpt[..., 2] / NAV_TILE_SIZE),
                         0, heights.shape[0] - 1).long()
        ci = torch.clamp(raster.to_i32(wpt[..., 0] / NAV_TILE_SIZE),
                         0, heights.shape[1] - 1).long()
        depth = torch.clamp(wl - heights[ri, ci], min=0.0)[..., None]
        refr = deep + (col - deep) * torch.exp(-0.55 * depth)
        water_col = refr * (1 - fresnel) + refl * fresnel
        edge = torch.clamp(depth / 0.75, 0.0, 1.0)
        water_col = col + (water_col - col) * edge
    else:
        water_col = deep * (1 - fresnel) + refl * fresnel
    return torch.where(water_vis[..., None], water_col, col)


def _frame_device(verts, attrs, vp, shade, rays, cam_pos, wl, heights, *,
                  h, w, h2, w2, water_on, refr_on, world_w, world_h,
                  budget=0, mark=None, live=None):
    """The whole post-soup frame: raster -> deferred shade -> water (mirror
    re-raster + refraction) -> gamma -> u8, fetched to the host once.
    `mark(name, tensor)`, when given, is called after each pass (the
    pass-by-pass path's timer); `live` collects live-triangle counts.
    Mirrors the reference's render-thread frame: all passes execute
    back-to-back on the device with no host round trips
    (ref: src/render/render_gl.c frame pass sequence)."""
    mark = mark or (lambda name, x: None)
    zbuf, tri, bary, inv_w, pattrs = _raster_pass(verts, attrs, vp, h=h, w=w,
                                                  budget=budget, live=live)
    mark("raster_ms", zbuf)
    col = shade(tri, bary, inv_w, pattrs, (h, w))
    mark("shade_ms", col)
    if water_on:
        col = _water_pass(col, zbuf, verts, attrs, vp, shade, rays, cam_pos,
                          wl, heights, h=h, w=w, h2=h2, w2=w2,
                          refr_on=refr_on, world_w=world_w, world_h=world_h,
                          budget=budget, live=live)
        mark("water_ms", col)
    col = torch.clamp(col, 0.0, 1.0) ** (1.0 / 2.2)     # linear -> sRGB-ish
    return torch.clamp(col * 255.0, 0, 255).to(torch.uint8).cpu().numpy()


class SceneRenderer:
    """Caches terrain geometry and device constants; renders u8 frames on
    its engine's device."""

    def __init__(self, engine, w: int = 640, h: int = 384, *,
                 maxi: int = 1024, shadow_res: int = 256,
                 shadows: bool = True, reflections: bool = True,
                 terrain_step: int = 2, model_cap: int = 32,
                 quilt_textures: bool = False, foliage_blades: int = 4096,
                 sprite_cap: int = 64, raster_budget: int = 24576):
        self.foliage_blades = foliage_blades
        self.sprite_cap = sprite_cap
        # live-triangle compaction budget for the main and mirror passes
        # (the static soup is mostly dead rows; see _raster_pass). 0
        # disables. The shadow pass never compacts (_shadow_pass).
        self.raster_budget = raster_budget
        from permafrost_engine_tpu_torch.render.textures import (TextureAtlas,
                                                                 detail_map)
        self.engine = engine
        self.device = engine.device
        self.w, self.h = w, h
        self.maxi = min(maxi, engine.cfg.max_ents)
        self.model_cap = model_cap
        self.shadow_res = shadow_res
        self.shadows = shadows
        self.atlas = TextureAtlas()
        for i, kind in enumerate(("grass", "rock", "sand")):
            self.atlas.add(kind, detail_map(kind, seed=11 * i,
                                            quilt=quilt_textures,
                                            device=self.device))
        self._atlas_dev = None
        self._terrain_key = None
        self._model_cache: dict = {}
        self._rays_cache: dict = {}
        self._heights_cache = None
        self._build_terrain(terrain_step)
        self.water_level = 0.0
        self.reflections = reflections and bool(
            (engine.heights < -0.01).any())
        self._light_vp = self._dev(_ortho_vp(
            np.array([0.0, float(engine.heights.min()) - 1, 0.0]),
            np.array([engine.cfg.world_w,
                      float(engine.heights.max()) + 8.0,
                      engine.cfg.world_h]), SUN_DIR))
        self._shadow_z = None
        self._shadow_frame = -1

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
            self.device)

    def _build_terrain(self, step: int) -> None:
        hts = self.engine.heights
        v, n, c, uv, tex = terrain_mesh(hts, step=step)
        self.t_verts = self._dev(v)
        self.t_attrs = self._dev(np.concatenate([v, n, c, uv, tex], -1))
        self._terrain_key = (hts.shape, float(hts.sum()), step)
        self._terrain_step = step
        self._build_foliage(self.foliage_blades)

    def _build_foliage(self, max_blades: int = 4096) -> None:
        """Static grass blades scattered over flat grassy terrain (ref:
        src/map/foliage.c placement + gl_foliage.c instanced draws).
        Placement uses the map's per-tile cover field when a map is
        loaded, else flat-grass heuristics; deterministic per map."""
        hts = self.engine.heights
        step = 4
        hs = hts[::step, ::step]
        gx = np.gradient(hs, axis=1)
        gz = np.gradient(hs, axis=0)
        grassy = (np.hypot(gx, gz) < 0.4) & (hs > 0.6)
        md = getattr(self.engine, "map_data", None)
        if md is not None and getattr(md, "cover", None) is not None:
            cov = md.cover
            ch, cw = cov.shape
            rr = np.minimum((np.arange(hs.shape[0]) * step) // 2, ch - 1)
            cc = np.minimum((np.arange(hs.shape[1]) * step) // 2, cw - 1)
            grassy &= cov[rr][:, cc] > 0
        ys, xs = np.nonzero(grassy)
        if not len(ys):
            self.f_verts = self._dev(np.zeros((0, 3, 3), np.float32))
            self.f_attrs = self._dev(np.zeros((0, 3, ATTR_C), np.float32))
            return
        rng = np.random.default_rng(1234)
        per = max(1, max_blades // max(len(ys), 1))
        k = min(len(ys) * per, max_blades)
        pick = rng.integers(0, len(ys), k)
        cell = 4.0 * step
        bx = xs[pick] * cell + rng.uniform(0, cell, k)
        bz = ys[pick] * cell + rng.uniform(0, cell, k)
        by = hs[ys[pick], xs[pick]]
        lean = rng.uniform(-0.5, 0.5, (k, 2))
        hgt = rng.uniform(0.8, 1.8, k)
        base0 = np.stack([bx - 0.25, by, bz], 1)
        base1 = np.stack([bx + 0.25, by, bz], 1)
        tip = np.stack([bx + lean[:, 0], by + hgt, bz + lean[:, 1]], 1)
        verts = np.stack([base0, base1, tip], 1).astype(np.float32)
        shade = rng.uniform(0.75, 1.2, k).astype(np.float32)
        col = (GRASS[None] * 1.15) * shade[:, None]
        attrs = np.zeros((k, 3, ATTR_C), np.float32)
        attrs[..., 0:3] = verts
        attrs[..., 4] = 1.0                      # normal: up (lit like turf)
        attrs[..., 6:9] = col[:, None, :]
        attrs[..., 11:13] = -1.0                 # untextured
        self.f_verts = self._dev(verts)
        self.f_attrs = self._dev(attrs)

    def _sprite_tris(self, camera, cap: int = 64):
        """Camera-facing billboard quads for pf sprites (ref: src/sprite.c,
        src/render/gl_sprite.c). Fixed-capacity, degenerate padding."""
        try:
            from permafrost_engine_tpu_torch.script import pf
            sprites = (list(pf._sprites)[:cap]
                       if pf.context().engine is self.engine else [])
        except Exception:
            sprites = []
        verts = np.zeros((cap * 2, 3, 3), np.float32)
        attrs = np.zeros((cap * 2, 3, ATTR_C), np.float32)
        attrs[..., 11:13] = -1.0
        _f, right, up = camera.basis()
        for i, s in enumerate(sprites):
            p = np.asarray(s["pos"], np.float32)
            if p.shape[0] == 2:
                p = np.array([p[0], 0.0, p[1]], np.float32)
            hw, hh = s["w"] / 2, s["h"] / 2
            a = p - right * hw - up * hh
            b = p + right * hw - up * hh
            c = p + right * hw + up * hh
            d = p - right * hw + up * hh
            verts[2 * i] = [a, b, c]
            verts[2 * i + 1] = [a, c, d]
            rngc = (abs(hash(s["image"])) % 900) / 1000 + 0.1
            col = np.array([rngc, 1.0 - rngc, 0.85], np.float32)
            tid = self.atlas.names.get(s["image"], -1)
            for t in (2 * i, 2 * i + 1):
                attrs[t, :, 0:3] = verts[t]
                attrs[t, :, 4] = 1.0
                attrs[t, :, 6:9] = col
                if tid >= 0:
                    attrs[t, :, 11] = tid
                    attrs[t, :, 12] = tid
            uvq = np.array([[0, 1], [1, 1], [1, 0], [0, 0]], np.float32)
            attrs[2 * i, :, 9:11] = uvq[[0, 1, 2]]
            attrs[2 * i + 1, :, 9:11] = uvq[[0, 2, 3]]
        return self._dev(verts), self._dev(attrs)

    def _atlas_arrays(self):
        if self._atlas_dev is None or \
                self._atlas_dev[2] != len(self.atlas.tiles):
            atlas, table = self.atlas.build()
            self._atlas_dev = (self._dev(atlas),
                               torch.from_numpy(table).to(self.device),
                               len(self.atlas.tiles))
        return self._atlas_dev[0], self._atlas_dev[1]

    def _maybe_refresh_terrain(self) -> None:
        hts = self.engine.heights
        key = (hts.shape, float(hts.sum()), self._terrain_step)
        if key != self._terrain_key:
            self._build_terrain(self._terrain_step)

    # -- scene triangle soup -------------------------------------------------

    def _entity_tris(self, alpha: float, alive_host):
        eng = self.engine
        e = eng.state.ents
        from permafrost_engine_tpu_torch.render.camera import Camera
        cam_stub = getattr(eng, "_scene_cam", None) or Camera()
        planes, cam_pos = frustum_tensors(cam_stub, self.device)
        visible, mats, _hp, _lod = cull_and_emit(
            e.pos, e.prev_pos, alpha, e.height, e.facing,
            e.sel_radius, e.alive, e.flags, e.hp, e.max_hp, planes, cam_pos,
            torch.full((2,), 1e6, device=self.device))

        model_parts, handled = self._model_tris(mats, alive_host)
        if handled:
            excl = np.zeros(eng.cfg.max_ents, bool)
            excl[list(handled)] = True
            visible = visible & ~torch.from_numpy(excl).to(self.device)

        c = _consts(self.device)
        flags = e.flags
        is_bld = (flags & int(EntityFlags.BUILDING)) != 0
        is_res = (flags & int(EntityFlags.RESOURCE)) != 0
        mesh_id = torch.where(is_bld, 1, torch.where(is_res, 2, 0))
        fac = torch.clamp(e.faction.long(), 0, len(FACTION_RGB) - 1)
        color = torch.where(is_res[:, None], c["resource_rgb"],
                            c["faction_rgb"][fac])
        pv, pa = assemble_instances(mats, visible, e.sel_radius, mesh_id,
                                    color, c["bank"], maxi=self.maxi)
        parts = [(pv, pa)] + model_parts
        return (torch.cat([p[0] for p in parts]),
                torch.cat([p[1] for p in parts]))

    def _model_dev(self, key: str, model):
        """Device-resident mesh data per PFObj (verts/weights/colors)."""
        cache = self._model_cache
        if key not in cache:
            v = np.asarray(model.verts, np.float32)
            cols = np.full((len(v), 3), 0.75, np.float32)
            texid = np.full(len(v), -1.0, np.float32)
            if model.materials:
                diff = np.asarray([m.diffuse for m in model.materials],
                                  np.float32)
                mi = np.clip(model.vert_mat, 0, len(diff) - 1)
                cols = diff[mi]
                # material textures load into the shared atlas when the
                # image file exists (ref: gl_texture.c material loads)
                mat_tex = np.full(len(model.materials), -1.0, np.float32)
                base = getattr(self.engine, "basedir", ".")
                for i, m in enumerate(model.materials):
                    t = m.texture
                    if t and t != "__none__":
                        for cand in (t, os.path.join(base, t)):
                            if os.path.exists(cand):
                                mat_tex[i] = self.atlas.add_file(t, cand)
                                self._atlas_dev = None
                                break
                texid = mat_tex[mi]
            cache[key] = (self._dev(v),
                          torch.from_numpy(np.asarray(model.weight_joints,
                                                      np.int32)).to(self.device),
                          self._dev(model.weight_vals),
                          self._dev(cols),
                          self._dev(model.uvs),
                          self._dev(texid))
        return cache[key]

    def _model_tris(self, mats, alive):
        """Skinned real-mesh instances for entities with registered PFObj
        models (ref: gl_anim.c batched skinned draws). Counts are padded
        to power-of-two buckets, as the JAX package pads them."""
        eng = self.engine
        anim = eng.anim
        out, handled = [], set()
        for key in sorted(anim.models):
            model = anim.models[key]
            v_n = len(getattr(model, "verts", ()))
            if v_n < 3 or v_n % 3:
                continue
            uids_all = [u for u, st in anim.states.items()
                        if st.model == key]
            if not uids_all:
                continue
            slots, rows = [], []
            for i, u in enumerate(uids_all):
                s = eng.uid_to_slot.get(u)
                if s is not None and alive[s]:
                    slots.append(s)
                    rows.append(i)
            slots, rows = slots[:self.model_cap], rows[:self.model_cap]
            if not slots:
                continue
            pal = anim.pose_palettes(key)
            if pal is None:      # rigid model: identity palette, 1 joint
                pal = np.broadcast_to(
                    np.eye(4, dtype=np.float32),
                    (len(uids_all), 1, 4, 4))
            n = len(slots)
            bucket = max(4, 1 << (n - 1).bit_length())
            ok = np.zeros(bucket, bool)
            ok[:n] = True
            slots = np.asarray(slots + [0] * (bucket - n), np.int64)
            rows = np.asarray(rows + [0] * (bucket - n), np.int64)
            handled.update(int(s) for s in slots[:n])
            tris, attrs = skin_instances(
                self._dev(pal[rows]), mats[torch.from_numpy(slots).to(
                    self.device)],
                torch.from_numpy(ok).to(self.device),
                *self._model_dev(key, model))
            out.append((tris, attrs))
        return out, handled

    def scene_soup(self, camera, alpha: float = 1.0, alive_host=None):
        """The frame's triangle soup (verts f32[T,3,3], attrs
        f32[T,3,ATTR_C]): terrain, foliage, entities, sprites."""
        self._maybe_refresh_terrain()
        self.engine._scene_cam = camera
        if alive_host is None:
            alive_host = self.engine.ents_host("alive")["alive"]
        ev, ea = self._entity_tris(alpha, alive_host)
        sv, sa = self._sprite_tris(camera, self.sprite_cap)
        verts = torch.cat([self.t_verts, self.f_verts, ev, sv])
        attrs = torch.cat([self.t_attrs, self.f_attrs, ea, sa])
        return verts, attrs

    # -- passes ----------------------------------------------------------------

    def _shadow_pass(self, verts, live=None):
        """The sun's depth map over the whole soup. Deliberate difference
        from the JAX package, whose shadow pass compacts to
        `raster_budget` live triangles: the sun's ortho view sees the
        whole terrain, so the live rows outgrow the budget and the
        compaction drops the back of the soup, which is where the
        entities sit; no entity then casts a shadow (its own
        tests/test_raster.py::test_scene_shadows_darken_ground fails).
        This pass keeps every triangle, as JAX does with
        ``raster_budget=0``. It also skips the near-plane clip: the
        light's ortho projection has w = 1 everywhere, so the clip would
        keep every triangle as it is and add only invalid rows, and the
        depth map is the same (tests/test_torch_scene.py holds it equal to
        JAX's ``raster_budget=0`` shadow pass and holds the shadow test's
        assertions)."""
        zbuf, _t, _b, _iw, _a = _raster_pass(
            verts, torch.zeros(verts.shape[:2] + (9,), dtype=verts.dtype,
                               device=verts.device),
            self._light_vp, h=self.shadow_res, w=self.shadow_res,
            k=160, kbig=64, clip=False, budget=0, live=live)
        return zbuf

    def _fog_grid(self, faction_pov):
        eng = self.engine
        if faction_pov is None:
            return _consts(self.device)["fog_off"], self._dev(
                [2.0 / max(eng.cfg.world_h, 1), 2.0 / max(eng.cfg.world_w, 1)])
        fog = eng.state.fog.state[faction_pov].to(torch.uint8)
        fh, fw = fog.shape
        return fog, self._dev([fh / eng.cfg.world_h, fw / eng.cfg.world_w])

    def _rays_dev(self, camera, w: int, h: int):
        """Per-pixel view rays, device-resident, cached per camera
        ORIENTATION (pos never enters — rays are directions). The rays
        feed the sky gradient and the water-plane intersection."""
        key = (round(float(camera.pitch), 5), round(float(camera.yaw), 5),
               round(float(camera.fov), 5), round(float(camera.aspect), 5),
               w, h)
        cache = self._rays_cache
        if key not in cache:
            if len(cache) > 8:
                cache.clear()
            cache[key] = self._dev(raster.camera_rays(camera, w, h))
        return cache[key]

    def _heights_dev(self):
        """Device-resident terrain heights, refreshed with the terrain key
        (the water refraction's depth lookup)."""
        key = self._terrain_key
        if self._heights_cache is None or self._heights_cache[0] != key:
            self._heights_cache = (key, self._dev(self.engine.heights))
        return self._heights_cache[1]

    def _shader(self, camera, shadow_z, fog, fog_scale):
        """shade(tri, bary, inv_w, attrs, (h, w)) -> f32[h,w,3] with this
        frame's light, shadow map, fog and atlas."""
        from permafrost_engine_tpu_torch.render.textures import TEX_SIZE
        atlas, table = self._atlas_arrays()
        c = _consts(self.device)

        def shade(tri, bary, inv_w, attrs, hw):
            h, w = hw
            return raster.shade_gbuffer(
                tri, bary, inv_w, attrs, c["sun"], shadow_z, self._light_vp,
                fog, fog_scale, c["sky"], self._rays_dev(camera, w, h),
                atlas=atlas, tex_table=table, tex_size=TEX_SIZE)
        return shade

    def _setting(self, name: str, default):
        """Video settings drive the renderer like the reference's do
        (ref: game.c:1070-1536 settings -> R_* state)."""
        try:
            return self.engine.settings.get(name)
        except Exception:   # raw Engine without the pf settings registry
            return default

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def render(self, camera, *, faction_pov=None, alpha: float = 1.0,
               overlays: bool = True) -> np.ndarray:
        """Render one frame -> u8[h, w, 3]."""
        w, h = self.w, self.h
        eng = self.engine
        # pf.debug.render_log_mask: bit 1 = per-pass wall timings (each
        # pass synced — a measurement cost, like the reference's render
        # logging), bit 2 = geometry counts (the soup's triangles and each
        # pass's live triangles, one sync each); appended to
        # self.render_log
        log_mask = int(self._setting("pf.debug.render_log_mask", 0) or 0)
        if log_mask and not hasattr(self, "render_log"):
            from collections import deque
            self.render_log = deque(maxlen=16)
        rec: dict = {}
        live = [] if log_mask & 2 else None
        t_mark = [time.perf_counter()]

        def mark(key, _x=None):
            if log_mask & 1:
                self._sync()
                now = time.perf_counter()
                rec[key] = round((now - t_mark[0]) * 1e3, 2)
                t_mark[0] = now

        # the frame's one host copy of the entity columns it reads
        host = eng.ents_host(*HOST_COLUMNS)
        verts, attrs = self.scene_soup(camera, alpha, host["alive"])
        mark("soup_ms")
        if log_mask & 2:
            rec["triangles"] = int(verts.shape[0])
        vp = self._dev(camera.proj_matrix() @ camera.view_matrix())

        if self.shadows and self._setting("pf.video.shadows_enabled", True):
            # the shadow map is cached per host frame counter
            frame = eng._frame
            if self._shadow_z is None or frame != self._shadow_frame:
                self._shadow_z = self._shadow_pass(verts, live)
                self._shadow_frame = frame
                if live is not None:
                    rec["live_shadow"] = live.pop()
            shadow_z = self._shadow_z
        else:
            shadow_z = _consts(self.device)["no_shadow"]
        mark("shadow_ms")
        fog, fog_scale = self._fog_grid(faction_pov)

        water_on = bool(self.reflections
                        and self._setting("pf.video.water_reflection", True))
        refr_on = bool(self._setting("pf.video.water_refraction", True))
        rt_scale = float(self._setting("pf.video.water_rt_scale", 1.0))
        if rt_scale < 0.999:
            # raster tiles are 16x16: snap the reflection target to tile
            # multiples (720 * 0.5 = 360 would break binning)
            h2 = max(int(h * rt_scale) // 16 * 16, 16)
            w2 = max(int(w * rt_scale) // 16 * 16, 16)
        else:
            h2, w2 = h, w
        img = _frame_device(
            verts, attrs, vp, self._shader(camera, shadow_z, fog, fog_scale),
            self._rays_dev(camera, w, h), self._dev(camera.pos),
            float(self.water_level), self._heights_dev(),
            h=h, w=w, h2=h2, w2=w2, water_on=water_on, refr_on=refr_on,
            world_w=float(eng.cfg.world_w), world_h=float(eng.cfg.world_h),
            budget=self.raster_budget, mark=mark if log_mask & 1 else None,
            live=live)
        if live is not None:
            rec.update(zip(("live_main", "live_mirror"), live))
            rec["raster_budget"] = self.raster_budget
        if overlays:
            from permafrost_engine_tpu_torch.render.hud import compose_hud
            img = self._overlays(img, camera, host)
            img = debug_overlays.apply_debug_overlays(img, eng, camera, w, h,
                                                      host=host)
            img = compose_hud(img, eng, camera, host=host)
            img = self._compose_ui(img)
            mark("overlays_ms")
        if log_mask:
            self.render_log.append(rec)
        return img

    def _compose_ui(self, img: np.ndarray) -> np.ndarray:
        """Composite shown pf UI windows (ref: gl_ui.c draw pass)."""
        try:
            from permafrost_engine_tpu_torch.script import pf
            ctx = pf.context()
        except Exception:
            return img
        if ctx.engine is not self.engine or not ctx.ui_windows:
            return img
        from permafrost_engine_tpu_torch.render.ui_compose import compose_ui
        return compose_ui(img, ctx.ui_windows, ctx.ui.virtual_resolution)

    # -- host overlays (healthbars / selection, ref: gl_statusbar.c) ---------

    def _overlays(self, img: np.ndarray, camera, host: dict) -> np.ndarray:
        eng = self.engine
        alive = host["alive"]
        if not alive.any():
            return img
        hp = host["hp"][alive]
        max_hp = host["max_hp"][alive]
        pos = host["pos"][alive]
        hgt = host["height"][alive]
        # pf.game.healthbar_mode: ALWAYS / DAMAGED / NEVER
        # (ref: game.c healthbar setting; HB_MODE_* constants)
        hb_mode = int(self._setting("pf.game.healthbar_mode", 1))
        if hb_mode == 0:          # HB_MODE_ALWAYS
            hurt = max_hp > 0
        elif hb_mode == 2:        # HB_MODE_NEVER
            hurt = np.zeros(len(hp), bool)
        else:                     # HB_MODE_DAMAGED
            hurt = (hp < max_hp) & (max_hp > 0)
        if not _ctx_healthbars_enabled(self.engine):
            hurt = np.zeros(len(hp), bool)
        sel = np.zeros(len(alive), bool)
        for u in list(eng.selection.selection):
            s = eng.uid_to_slot.get(int(u))
            if s is not None:
                sel[s] = True
        sel = sel[alive]
        if not (hurt.any() or sel.any()):
            return img
        vp = camera.proj_matrix() @ camera.view_matrix()
        p = np.stack([pos[:, 0], hgt + 4.0, pos[:, 1],
                      np.ones(len(pos))], 1)
        c = p @ vp.T
        ok = c[:, 3] > 1e-3
        x = (c[:, 0] / np.maximum(c[:, 3], 1e-6) * 0.5 + 0.5) * self.w
        y = (0.5 - c[:, 1] / np.maximum(c[:, 3], 1e-6) * 0.5) * self.h
        xi = x.astype(int); yi = y.astype(int)
        on = ok & (xi >= 6) & (xi < self.w - 6) & (yi >= 2) & (yi < self.h - 2)
        img = img.copy()
        for i in np.nonzero(on & hurt)[0]:
            frac = float(hp[i] / max(max_hp[i], 1e-6))
            full = int(10 * np.clip(frac, 0, 1))
            img[yi[i] - 2, xi[i] - 5:xi[i] + 5] = (60, 60, 60)
            img[yi[i] - 2, xi[i] - 5:xi[i] - 5 + full] = (80, 220, 80)
        for i in np.nonzero(on & sel)[0]:
            img[yi[i] + 1, xi[i] - 5:xi[i] + 5] = (240, 240, 240)
        return img


def _ctx_healthbars_enabled(engine) -> bool:
    """pf.hide_healthbars() routes here (ref: the reference's healthbar
    visibility toggles, py_script.c hide/show_healthbars)."""
    try:
        from permafrost_engine_tpu_torch.script import pf
        ctx = pf._context
        return ctx is None or ctx.engine is not engine or ctx.healthbars
    except Exception:
        return True


def render_frame(engine, camera, w: int = 640, h: int = 384,
                 **kw) -> np.ndarray:
    """One-shot convenience wrapper (caches the renderer on the engine)."""
    key = (w, h)
    cache = getattr(engine, "_scene_renderers", None)
    if cache is None:
        cache = engine._scene_renderers = {}
    if key not in cache:
        cache[key] = SceneRenderer(engine, w, h, **kw)
    return cache[key].render(camera)

"""Triangle rasterizer: the render backend's shader stack as batched tensor
code.

The reference renders through OpenGL: a render thread replays recorded
GL commands into 40 GLSL shader passes (ref: src/render/,
shaders/). This module re-designs the backend as data-parallel compute,
following the same sort+segment pattern as the engine's spatial grid
(ops/grid.py):

  1. project   — world -> clip -> screen, winding-normalized
  2. bin       — each triangle emits (tile, near-depth) keys; one stable
                 sort groups them; per-tile ranks keep the NEAREST K
                 triangles (depth-ordered keys make the K-cap a
                 back-to-front drop, so overflow degrades like a
                 far-geometry LOD, not noise)
  3. raster    — per 16x16 pixel tile, barycentric coverage of its K
                 candidates in chunks; z-buffered G-buffer out (tri id +
                 screen barycentrics); oversized triangles take a
                 brute-force path over the full image (bounded count)
  4. shade     — deferred: row-gather vertex attributes by tri id,
                 perspective-correct interpolation, lambert + shadow-map
                 test + distance fog; sky for uncovered pixels

Depth is interpolated in NDC (linear in screen space, so plain
barycentrics are exact for the z-test); attributes use perspective-
correct weights (bary * 1/w, renormalized).

The same code renders the shadow pass (depth-only, light ortho) and
water reflections (scene re-rastered under a mirror matrix; the
winding normalization in `project` makes mirrored geometry "just work"),
mirroring the reference's depth-pass and reflection-FBO passes
(ref: src/render/gl_shadows.c, gl_water.c).

Port of ``permafrost_engine_tpu/render/raster.py``, plain PyTorch on the
device of its inputs, with the same static shapes, tile binning (``TILE``,
``SPAN``, ``ZQ``), per-tile K cap, big-triangle path and first-match z
ties. Where a plain transcription would not give JAX's answer:

* the bin sort is stable (``jax.lax.sort`` is), and the big path's
  ``top_k`` is a stable sort on (-score, index): XLA's ``top_k`` returns
  the lower index first among equal scores, ``torch.topk`` promises no
  order on ties;
* a chunk's z-min is the first minimum over its candidates
  (``torch.min`` returns the first index on ties) folded into the carry
  where strictly nearer: the JAX unrolled update's result, in three ops;
* every small contraction (4x4 transforms, the barycentric blends, dot
  products) is written out as products and sums, so no matmul runs and
  TF32 can never round a projected vertex;
* float -> int32 conversions clamp first (XLA saturates, a plain torch
  cast of an out-of-range value is undefined).
"""

from __future__ import annotations

import numpy as np
import torch

TILE = 16          # pixels per tile side
SPAN = 4           # max tile span on the fast path (else brute-force path)
ZQ = 1024          # depth quantization buckets inside the sort key
_I32_MAX = 2147483520.0   # the largest f32 below 2**31


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """f32 -> i32 truncating toward zero, saturating as XLA's convert
    does (NaN -> 0)."""
    return torch.nan_to_num(x, nan=0.0).clamp(-_I32_MAX, _I32_MAX).to(
        torch.int32)


def transform(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rows of m [R, C] applied to the last axis of v [..., C]: out[..., r] =
    sum_c m[r, c] * v[..., c], summed in c order (no matmul, no TF32)."""
    cols = []
    for r in range(m.shape[0]):
        acc = v[..., 0] * m[r, 0]
        for c in range(1, m.shape[1]):
            acc = acc + v[..., c] * m[r, c]
        cols.append(acc)
    return torch.stack(cols, -1)


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sum of a * b over the last axis, in order."""
    acc = a[..., 0] * b[..., 0]
    for c in range(1, a.shape[-1]):
        acc = acc + a[..., c] * b[..., c]
    return acc


# ---------------------------------------------------------------------------
# Projection
# ---------------------------------------------------------------------------


def project(tris: torch.Tensor, vp: torch.Tensor, w: int, h: int):
    """World-space triangles -> screen space.

    tris: f32[T, 3, 3] world xyz. vp: f32[4, 4] view-projection.
    Returns (xy f32[T,3,2] pixel coords, z f32[T,3] ndc depth,
    inv_w f32[T,3], valid bool[T], flip bool[T]). Callers that may see
    geometry straddling the near plane run `clip_near` first (below);
    triangles still holding a behind-plane vertex here are rejected.
    Winding is normalized to CCW so mirrored passes (water reflection)
    need no state flip.
    """
    hom = torch.cat([tris, torch.ones(tris.shape[:2] + (1,), dtype=tris.dtype,
                                      device=tris.device)], -1)   # [T,3,4]
    clip = transform(vp, hom)                             # [T,3,4]
    cw = clip[..., 3]
    valid = torch.all(cw > 1e-4, dim=1)
    inv_w = 1.0 / torch.clamp(cw, min=1e-6)
    ndc = clip[..., :3] * inv_w[..., None]                # [T,3,3]
    x = (ndc[..., 0] * 0.5 + 0.5) * w
    y = (0.5 - ndc[..., 1] * 0.5) * h                     # y down
    xy = torch.stack([x, y], -1)                          # [T,3,2]
    z = ndc[..., 2]

    # normalize winding to CCW in screen space (y-down): signed area > 0
    area = _edge(xy[:, 0], xy[:, 1], xy[:, 2])
    flip = area < 0
    xy = torch.where(flip[:, None, None], xy.flip(1), xy)
    z = torch.where(flip[:, None], z.flip(1), z)
    inv_w = torch.where(flip[:, None], inv_w.flip(1), inv_w)
    valid = valid & (torch.abs(area) > 1e-6)
    # cull fully off-screen triangles early (keeps bins dense)
    xs, ys = xy[..., 0], xy[..., 1]
    off = ((xs.amax(1) < 0) | (xs.amin(1) >= w)
           | (ys.amax(1) < 0) | (ys.amin(1) >= h))
    return xy, z, inv_w, valid & ~off, flip


def _edge(a, b, p):
    """Signed edge function: >0 when p is left of a->b (y-down CCW)."""
    return ((p[..., 0] - a[..., 0]) * (b[..., 1] - a[..., 1])
            - (p[..., 1] - a[..., 1]) * (b[..., 0] - a[..., 0]))


def clip_near(verts: torch.Tensor, attrs: torch.Tensor, vp: torch.Tensor,
              eps: float = 1e-3):
    """Clip triangles against the near plane (clip-space w = eps).

    OpenGL clips mid-pipeline (ref: the fixed-function stage feeding
    shaders/); `project` instead rejects whole triangles
    with any vertex behind the eye, which drops near geometry when a
    low-angle RTS camera sits inside it. This pre-pass splits each
    crossing triangle into its in-front part — 1 or 2 sub-triangles —
    branch-free at static shape [2T].

    The intersection parameter t along an edge is computed on clip-space
    w, and the same t lerps WORLD positions and attributes: the vertex
    transform is affine, so clip-space and world-space edge parameters
    coincide (this is why we can clip before projecting).

    verts f32[T,3,3], attrs f32[T,3,A] -> (verts2 f32[2T,3,3],
    attrs2 f32[2T,3,A], ok2 bool[2T]).
    """
    cw = dot(verts, vp[3, :3].expand_as(verts)) + vp[3, 3]          # [T,3]
    inside = cw > eps
    n_in = inside.sum(1)                                            # [T]

    # rotate vertex order to a canonical pattern: one inside -> it sits at
    # slot 0; one outside -> it sits at slot 2 (rotation preserves winding)
    first_in = torch.argmax(inside.to(torch.int32), 1)
    first_out = torch.argmax((~inside).to(torch.int32), 1)
    rot = torch.where(n_in == 1, first_in,
                      torch.where(n_in == 2, (first_out + 1) % 3,
                                  torch.zeros_like(first_in)))
    idx = (torch.arange(3, device=verts.device)[None, :] + rot[:, None]) % 3
    # the JAX package contracts a one-hot matrix here; a row gather is the
    # same selection, exactly
    vr = torch.gather(verts, 1, idx[..., None].expand_as(verts))
    ar = torch.gather(attrs, 1, idx[..., None].expand_as(attrs))
    wr = torch.gather(cw, 1, idx)

    def lerp_to(i, j):
        den = wr[:, j] - wr[:, i]
        den = torch.where(torch.abs(den) < 1e-12,
                          torch.full_like(den, 1e-12), den)
        t = torch.clamp((eps - wr[:, i]) / den, 0.0, 1.0)[:, None]
        return (vr[:, i] + t * (vr[:, j] - vr[:, i]),
                ar[:, i] + t * (ar[:, j] - ar[:, i]))

    v01, a01 = lerp_to(0, 1)      # crossing on edge a->b (n_in==1 case)
    v02, a02 = lerp_to(0, 2)      # crossing on edge a->c (both cases)
    v12, a12 = lerp_to(1, 2)      # crossing on edge b->c (n_in==2 case)

    one = (n_in == 1)[:, None, None]
    two = (n_in == 2)[:, None, None]
    tri1_v = torch.where(one, torch.stack([vr[:, 0], v01, v02], 1),
                         torch.where(two, torch.stack([vr[:, 0], vr[:, 1], v12],
                                                      1), vr))
    tri1_a = torch.where(one, torch.stack([ar[:, 0], a01, a02], 1),
                         torch.where(two, torch.stack([ar[:, 0], ar[:, 1], a12],
                                                      1), ar))
    tri2_v = torch.stack([vr[:, 0], v12, v02], 1)
    tri2_a = torch.stack([ar[:, 0], a12, a02], 1)

    verts2 = torch.cat([tri1_v, tri2_v], 0)
    attrs2 = torch.cat([tri1_a, tri2_a], 0)
    ok2 = torch.cat([n_in >= 1, n_in == 2], 0)
    return verts2, attrs2, ok2


# ---------------------------------------------------------------------------
# Binning + raster -> G-buffer
# ---------------------------------------------------------------------------


def stable_top(score: torch.Tensor, k: int):
    """(values, indices) of the k largest scores, ties by lower index
    first, as XLA's ``top_k`` orders them."""
    order = torch.sort(-score, stable=True).indices[:k]
    return score[order], order


def raster_gbuffer(xy: torch.Tensor, z: torch.Tensor, valid: torch.Tensor,
                   *, h: int, w: int, k: int = 96, kbig: int = 64,
                   kc: int = 16):
    """Rasterize screen-space triangles into a G-buffer.

    xy f32[T,3,2], z f32[T,3] (ndc), valid bool[T]. h, w multiples of 16.
    Returns (zbuf f32[h,w] (+inf empty), tri i32[h,w] (-1 empty),
    bary f32[h,w,3] screen-space barycentrics).
    """
    dev = xy.device
    t_n = xy.shape[0]
    kc = min(kc, k)
    k = max(kc, (k // kc) * kc)              # k must chunk evenly
    kbig = min(kbig, t_n)                    # top_k bound
    nbig = -(-kbig // kc)                    # big chunks (ids padded)
    th, tw = h // TILE, w // TILE
    tiles = th * tw
    i32 = torch.int32

    xs, ys = xy[..., 0], xy[..., 1]
    tx0 = torch.clamp(torch.floor(xs.amin(1) / TILE), 0, tw - 1).to(i32)
    tx1 = torch.clamp(torch.floor(xs.amax(1) / TILE), 0, tw - 1).to(i32)
    ty0 = torch.clamp(torch.floor(ys.amin(1) / TILE), 0, th - 1).to(i32)
    ty1 = torch.clamp(torch.floor(ys.amax(1) / TILE), 0, th - 1).to(i32)
    small = valid & (tx1 - tx0 < SPAN) & (ty1 - ty0 < SPAN)
    big = valid & ~small

    # near depth -> sort bucket (ndc z in [-1, 1])
    nearz = z.amin(1)
    zq = torch.clamp((nearz * 0.5 + 0.5) * (ZQ - 1), 0, ZQ - 1).to(i32)

    # --- fast path: emit SPAN*SPAN (tile, depth) keys per triangle ------------
    dr = torch.arange(SPAN, dtype=i32, device=dev)
    tr = ty0[:, None] + dr[None, :]                         # [T, S]
    tc = tx0[:, None] + dr[None, :]
    ok_r = small[:, None] & (tr <= ty1[:, None])
    ok_c = tc <= tx1[:, None]
    pair_ok = ok_r[:, :, None] & ok_c[:, None, :]           # [T, S, S]
    tile_id = tr[:, :, None] * tw + tc[:, None, :]
    tile_id = torch.where(pair_ok, tile_id, tiles)          # sentinel sorts last
    key = (tile_id * ZQ + zq[:, None, None]).reshape(-1)
    key, order = torch.sort(key, stable=True)
    tri_sorted = (order // (SPAN * SPAN)).to(i32)
    tile_sorted = key // ZQ

    # rank within each tile's run
    p_n = key.shape[0]
    idx = torch.arange(p_n, dtype=torch.int64, device=dev)
    changed = torch.ones(p_n, dtype=torch.bool, device=dev)
    changed[1:] = tile_sorted[1:] != tile_sorted[:-1]
    run_start = torch.cummax(torch.where(changed, idx, 0), 0).values
    rank = idx - run_start
    keep = (rank < k) & (tile_sorted < tiles)
    slot = torch.where(keep, tile_sorted * k + rank, tiles * k)
    # rows that miss the cap all land on the extra last slot, cut below
    table = torch.full((tiles * k + 1,), -1, dtype=i32, device=dev)
    table[slot] = tri_sorted
    table = table[:-1].reshape(tiles, k)

    # --- per-tile raster over K candidates, in chunks of kc --------------------
    v01 = xy.reshape(t_n, 6)                                 # row-gather source
    zrow = z                                                 # [T,3]

    lx = torch.arange(TILE, dtype=torch.float32, device=dev) + 0.5
    px = torch.arange(tw, dtype=torch.float32, device=dev)[:, None] * TILE + lx
    py = torch.arange(th, dtype=torch.float32, device=dev)[:, None] * TILE + lx
    # pixel centers per tile: [tiles, TILE*TILE]
    pix_x = px[None, :, None, :].expand(th, tw, TILE, TILE).reshape(
        tiles, TILE * TILE)
    pix_y = py[:, None, :, None].expand(th, tw, TILE, TILE).reshape(
        tiles, TILE * TILE)

    zb = torch.full((tiles, TILE * TILE), float("inf"), device=dev)
    tb = torch.full((tiles, TILE * TILE), -1, dtype=i32, device=dev)
    bb = torch.zeros((3, tiles, TILE * TILE), device=dev)
    carry = (zb, tb, bb)

    for c in range(k // kc):
        ids = table[:, c * kc:(c + 1) * kc]
        safe = torch.clamp(ids, min=0).long()
        carry = _cover_update(carry, v01[safe], zrow[safe], ids, pix_x, pix_y)

    # --- big-triangle brute-force path -----------------------------------------
    big_score = torch.where(big, ZQ - zq, 0)   # nearest-first, 0 = invalid
    big_val, big_idx = stable_top(big_score, kbig)
    big_ids = torch.where(big_val > 0, big_idx.to(i32), -1)
    big_ids = torch.cat([big_ids, torch.full((nbig * kc - kbig,), -1,
                                             dtype=i32, device=dev)])

    for c in range(nbig):
        ids = big_ids[c * kc:(c + 1) * kc]
        safe = torch.clamp(ids, min=0).long()
        carry = _cover_update(carry, v01[safe][None].expand(tiles, kc, 6),
                              zrow[safe][None].expand(tiles, kc, 3),
                              ids[None].expand(tiles, kc), pix_x, pix_y)
    zb, tb, bb = carry

    def untile(a):
        s = a.shape[2:]
        return (a.reshape((th, tw, TILE, TILE) + s)
                .permute((0, 2, 1, 3) + tuple(4 + i for i in range(len(s))))
                .reshape((h, w) + s))

    return untile(zb), untile(tb), untile(bb.permute(1, 2, 0))


def _cover_update(carry, vv, zz, ids, pix_x, pix_y):
    """Fold a [tiles, kc] triangle chunk into the per-pixel
    (z, tri, bary) carry: candidate j beats the carry iff strictly nearer,
    and among the chunk's candidates the first minimum wins (first-match
    ties, the JAX package's unrolled update)."""
    zb, tb, bb = carry
    ax, ay = vv[..., 0, None], vv[..., 1, None]              # [tiles,kc,1]
    bx, by = vv[..., 2, None], vv[..., 3, None]
    cx, cy = vv[..., 4, None], vv[..., 5, None]
    px = pix_x[:, None, :]                                   # [tiles,1,P]
    py = pix_y[:, None, :]
    e0 = (px - bx) * (cy - by) - (py - by) * (cx - bx)       # opp. vertex a
    e1 = (px - cx) * (ay - cy) - (py - cy) * (ax - cx)       # opp. vertex b
    e2 = (px - ax) * (by - ay) - (py - ay) * (bx - ax)       # opp. vertex c
    area = torch.clamp(e0 + e1 + e2, min=1e-9)
    inside = (e0 >= 0) & (e1 >= 0) & (e2 >= 0) & (ids >= 0)[..., None]
    b0, b1, b2 = e0 / area, e1 / area, e2 / area
    zpix = (b0 * zz[..., 0, None] + b1 * zz[..., 1, None]
            + b2 * zz[..., 2, None])
    zpix = torch.where(inside, zpix, float("inf"))           # [tiles,kc,P]
    zmin, j = zpix.min(1)                                    # first minimum
    better = zmin < zb
    jj = j[:, None, :]
    tri_j = torch.gather(ids, 1, j)
    b = torch.stack([torch.gather(x, 1, jj)[:, 0] for x in (b0, b1, b2)])
    return (torch.where(better, zmin, zb), torch.where(better, tri_j, tb),
            torch.where(better[None], b, bb))


# ---------------------------------------------------------------------------
# Deferred shading
# ---------------------------------------------------------------------------


def shade_gbuffer(tri: torch.Tensor, bary: torch.Tensor, inv_w: torch.Tensor,
                  attrs: torch.Tensor, light_dir: torch.Tensor,
                  shadow_z: torch.Tensor, light_vp: torch.Tensor,
                  fog_grid: torch.Tensor, fog_scale: torch.Tensor,
                  sky_params: torch.Tensor, cam_rays: torch.Tensor,
                  atlas: torch.Tensor | None = None,
                  tex_table: torch.Tensor | None = None,
                  tex_size: int = 64):
    """Shade the G-buffer.

    tri i32[h,w], bary f32[h,w,3], inv_w f32[T,3],
    attrs f32[T,3,9|14] per-vertex (world xyz, normal xyz, rgb tint
    [, uv, tex_a, tex_b, blend] — texture ids index `tex_table` rows into
    `atlas`, sampled wrapped and mixed by blend; id < 0 samples white),
    shadow_z f32[sh,sw] light-space depth map, light_vp f32[4,4],
    fog_grid u8[fh,fw] (0 unexplored / 1 fogged / 2 visible; all-2 when
    fog is off), fog_scale f32[2] world->fog-grid scale,
    sky_params f32[2,3] (zenith rgb, horizon rgb), cam_rays f32[h,w,3].
    Returns f32[h,w,3] linear color.
    """
    h, w = tri.shape
    t_n, _, c_n = attrs.shape
    flat_tri = tri.reshape(-1)
    safe = torch.clamp(flat_tri, 0, t_n - 1).long()
    av = attrs.reshape(t_n, 3 * c_n)[safe].reshape(-1, 3, c_n)  # row gather
    iw = inv_w[safe]                                         # [HW,3]
    b = bary.reshape(-1, 3)
    pw = b * iw
    pw = pw / torch.clamp(pw.sum(-1, keepdim=True), min=1e-9)
    a = (pw[:, 0, None] * av[:, 0] + pw[:, 1, None] * av[:, 1]
         + pw[:, 2, None] * av[:, 2])                        # [HW,C]
    wpos, nrm, rgb = a[:, 0:3], a[:, 3:6], a[:, 6:9]
    nrm = nrm / torch.clamp(torch.sqrt(dot(nrm, nrm))[:, None], min=1e-6)

    if c_n >= 14 and atlas is not None:
        # wrapped nearest-sample of the shared atlas (ref: terrain splat +
        # model texture sampling in the GLSL passes; quilting feeds the
        # terrain tiles like gl_image_quilt.c)
        uv = a[:, 9:11]
        blend = torch.clamp(a[:, 13:14], 0.0, 1.0)
        aw = atlas.shape[1]
        flat_atlas = atlas.reshape(-1, 3)
        fu = uv[:, 0] - torch.floor(uv[:, 0])
        fv = uv[:, 1] - torch.floor(uv[:, 1])
        du = torch.clamp(to_i32(fu * tex_size), max=tex_size - 1)
        dv = torch.clamp(to_i32(fv * tex_size), max=tex_size - 1)

        def sample(tid):
            base = tex_table[torch.clamp(tid, 0, tex_table.shape[0] - 1).long()]
            s = flat_atlas[((base[:, 0] + dv) * aw + base[:, 1] + du).long()]
            return torch.where((tid >= 0)[:, None], s, 1.0)

        tex_a = to_i32(av[:, 0, 11])   # constant per triangle
        tex_b = to_i32(av[:, 0, 12])
        rgb = rgb * (sample(tex_a) * (1 - blend) + sample(tex_b) * blend)

    # directional light + shadow-map test (ref: gl_shadows.c depth pass)
    lam = torch.clamp(-dot(nrm, light_dir.expand_as(nrm)), min=0.0)
    lh = torch.cat([wpos, torch.ones_like(wpos[:, :1])], -1)
    lc = transform(light_vp, lh)
    sh, sw = shadow_z.shape
    sx = torch.clamp(to_i32((lc[:, 0] * 0.5 + 0.5) * sw), 0, sw - 1)
    sy = torch.clamp(to_i32((0.5 - lc[:, 1] * 0.5) * sh), 0, sh - 1)
    smp = shadow_z.reshape(-1)[(sy * sw + sx).long()]
    # bias ~3 texels of depth slope: ndc depth spans 2 over the ortho box,
    # so one texel of a 45-degree slope is ~2/res in ndc (res-dependent,
    # extent-independent); the reference uses glPolygonOffset equivalently
    bias = 6.0 / sw
    lit = (lc[:, 2] <= smp + bias) | (lam <= 0.0)
    shade = 0.42 + 0.58 * lam * torch.where(lit, 1.0, 0.25)
    col = rgb * shade[:, None]

    # fog-of-war tint (ref: map tinting via R_GL_MapUpdateFog)
    fh, fw = fog_grid.shape
    fr = torch.clamp(to_i32(wpos[:, 2] * fog_scale[0]), 0, fh - 1)
    fc = torch.clamp(to_i32(wpos[:, 0] * fog_scale[1]), 0, fw - 1)
    fs = fog_grid.reshape(-1)[(fr * fw + fc).long()].to(torch.float32)
    col = col * torch.clamp(fs * 0.5, 0.0, 1.0)[:, None]

    # sky background (ref: gl_skybox.c): gradient over the view-ray
    ray = cam_rays.reshape(-1, 3)
    up = torch.clamp(ray[:, 1] * 2.0 + 0.35, 0.0, 1.0)[:, None]
    sky = sky_params[1][None, :] * (1 - up) + sky_params[0][None, :] * up
    col = torch.where((flat_tri >= 0)[:, None], col, sky)
    return col.reshape(h, w, 3)


def camera_rays(cam, w: int, h: int) -> np.ndarray:
    """Per-pixel world-space view directions (for the sky gradient)."""
    front, right, up = cam.basis()
    tan = np.tan(cam.fov / 2)
    xs = (np.arange(w) + 0.5) / w * 2 - 1
    ys = 1 - (np.arange(h) + 0.5) / h * 2
    d = (front[None, None] + right[None, None] * (xs[None, :, None] * tan * cam.aspect)
         + up[None, None] * (ys[:, None, None] * tan))
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)

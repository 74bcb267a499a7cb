"""Height-aware shadowcasting visibility: the ring-ordered horizon DP.

Port of ``permafrost_engine_tpu/ops/shadowcast.py`` in its default mode
(ref: src/game/fog_of_war.c:427-541 cast_light). Every viewer owns a fixed
(2R+1)^2 window; for each Chebyshev ring k = 1..R, every window offset t
takes its horizon from the two ring-(k-1) tiles straddling the exact ray
to the viewer:

  horizon[t] = max(horizon[parent], block_slope[parent]) of the nearer
               parent (the max of both on a dead tie)
  visible[t] = see_slope[t] >= horizon[t] - 1e-6

where slope(x) = (height(x) - eye) / distance(x) and only terrain above the
viewer's eye blocks. The JAX code gathers the height window with row
fetches and a one-hot einsum, and ORs the windows into the per-faction
plane with a row scatter-add, both to avoid TPU element gathers; here a
plain element gather and a boolean scatter compute the same values (no
matmul, so no TF32 question on the card). The exact ray-march mode
(``exact=True``, ``PFTPU_EXACT_FOG``) stays a JAX oracle and is not ported.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

EYE_HEIGHT = 2.0     # viewer eye above its tile, world units
SEE_TOL = 0.5        # target tiles count as slightly raised (see ridgetops)


@functools.cache
def _window_tables(radius: int):
    """Static DP tables for a (2R+1)^2 window, as the JAX tables: (offsets
    i64[W2, 2], pa i64[W2], pb i64[W2], wb f32[W2], rings: tuple of index
    arrays, ring 1 first, dist f32[W2]). Offset t's parents pa/pb are the
    two ring-(k-1) tiles the ray to the viewer crosses between; wb is where
    it crosses (0 at pa, 1 at pb)."""
    r = radius
    offs = [(dr, dc) for dr in range(-r, r + 1) for dc in range(-r, r + 1)]
    idx_of = {o: i for i, o in enumerate(offs)}
    w2 = len(offs)
    pa = np.zeros(w2, np.int64)
    pb = np.zeros(w2, np.int64)
    wb = np.zeros(w2, np.float32)
    rings: dict[int, list[int]] = {}
    for i, (dr, dc) in enumerate(offs):
        k = max(abs(dr), abs(dc))
        rings.setdefault(k, []).append(i)
        if k == 0:
            pa[i] = pb[i] = i
            continue
        if abs(dr) >= abs(dc):
            pr = dr - int(np.sign(dr))
            cx = dc * (abs(dr) - 1) / abs(dr)
            lo, hi = int(np.floor(cx)), int(np.ceil(cx))
            pa[i], pb[i] = idx_of[(pr, lo)], idx_of[(pr, hi)]
            wb[i] = cx - lo
        else:
            pc = dc - int(np.sign(dc))
            rx = dr * (abs(dc) - 1) / abs(dc)
            lo, hi = int(np.floor(rx)), int(np.ceil(rx))
            pa[i], pb[i] = idx_of[(lo, pc)], idx_of[(hi, pc)]
            wb[i] = rx - lo
    dist = np.array([max(np.hypot(dr, dc), 1e-6) for dr, dc in offs],
                    np.float32)
    ring_list = tuple(np.asarray(rings[k], np.int64)
                      for k in sorted(rings) if k > 0)
    return (np.asarray(offs, np.int64), pa, pb, wb, ring_list, dist)


def shadowcast_visibility(pos_rc, viewer_ok, faction, vision_tiles,
                          tile_height, *, radius: int, tiles_h: int,
                          tiles_w: int, max_factions: int) -> torch.Tensor:
    """Per-faction visible mask with terrain occlusion, bool[F, TH, TW].

    pos_rc i32[N, 2] viewer tile (row, col); viewer_ok bool[N]; faction
    i32[N]; vision_tiles f32[N] vision radius in tiles; tile_height f32[TH,
    TW]."""
    offs_np, pa_np, pb_np, wb_np, rings, dist_np = _window_tables(radius)
    dev = pos_rc.device
    offs = torch.from_numpy(offs_np).to(dev)
    pa_t = torch.from_numpy(pa_np).to(dev)
    pb_t = torch.from_numpy(pb_np).to(dev)
    wb_t = torch.from_numpy(wb_np).to(dev)
    dist = torch.from_numpy(dist_np).to(dev)
    n, w2 = pos_rc.shape[0], offs_np.shape[0]

    rr = pos_rc[:, 0:1].long() + offs[None, :, 0]            # [N, W2]
    cc = pos_rc[:, 1:2].long() + offs[None, :, 1]
    in_bounds = (rr >= 0) & (rr < tiles_h) & (cc >= 0) & (cc < tiles_w)
    # out-of-map offsets read the clamped edge tile, as the JAX row gather
    h = tile_height[rr.clamp(0, tiles_h - 1), cc.clamp(0, tiles_w - 1)]
    eye = (tile_height[pos_rc[:, 0].long(), pos_rc[:, 1].long()]
           + EYE_HEIGHT)[:, None]
    # only terrain HIGHER than the viewer occludes (looking down a cliff
    # sees the floor; a ridge above the viewer shadows the tiles behind it)
    block = torch.where(h > eye + 0.01, (h - eye) / dist[None, :], -1e9)
    see_slope = (h + SEE_TOL - eye) / dist[None, :]
    block[:, w2 // 2] = -1e9          # the viewer's own tile never occludes

    horizon = torch.full((n, w2), -1e9, dtype=torch.float32, device=dev)
    for ring_np in rings:
        ri = torch.from_numpy(ring_np).to(dev)
        pa, pb, w = pa_t[ri], pb_t[ri], wb_t[ri][None, :]
        va = torch.maximum(horizon[:, pa], block[:, pa])
        vb = torch.maximum(horizon[:, pb], block[:, pb])
        # the parent the ray passes nearest; dead ties shadow conservatively
        near = torch.where(w < 0.5, va, vb)
        tie = (w - 0.5).abs() < 1e-6
        horizon[:, ri] = torch.where(tie, torch.maximum(va, vb), near)

    visible = (viewer_ok[:, None] & in_bounds
               & (dist[None, :] <= vision_tiles[:, None])
               & (see_slope >= horizon - 1e-6))
    fac = torch.clamp(faction, 0, max_factions - 1).long()[:, None]
    flat = torch.where(visible, (fac * tiles_h + rr) * tiles_w + cc,
                       max_factions * tiles_h * tiles_w)
    out = torch.zeros(max_factions * tiles_h * tiles_w + 1, dtype=torch.bool,
                      device=dev)
    out[flat.reshape(-1)] = True
    return out[:-1].reshape(max_factions, tiles_h, tiles_w)

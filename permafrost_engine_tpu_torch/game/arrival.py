"""Group-arrival ring slots.

The port's own copy of ``permafrost_engine_tpu/game/arrival.py`` (numpy
on the host, as there).

The reference fills a per-flock arrival footprint of up to 4096 slots in
geodesic ring order around the goal, handing slots to units as they get
close, with APPROACH/SEEK substates, a debounced LOS latch and stuck/wedge
counters (ref: src/game/arrival.h:49-120, arrival.c).

The TPU-native redesign assigns every unit its own ring slot AT ORDER
TIME instead of on arrival: the flock shares flow fields toward the goal
(the APPROACH phase = field following + LOS latch, already in the
movement substep) and each unit arrive-steers onto its private slot once
close (the SEEK phase). Arrival becomes exact per unit — distance to its
own slot — with no neighbour-propagation heuristics. Slot order matches
the reference's ring fill: innermost slots go to the units nearest the
goal.
"""

from __future__ import annotations

import numpy as np

from permafrost_engine_tpu_torch.core.config import (
    COST_IMPASSABLE,
    NAV_TILE_SIZE,
)


def ring_offsets(n: int, spacing: float) -> np.ndarray:
    """>= n packed offsets around the origin in ring-fill order
    (ref: arrival.c geodesic ring fill): ring k has radius k*spacing and
    ~2*pi*k slots, so density stays constant. f32[>=n, 2]."""
    out = [(0.0, 0.0)]
    k = 1
    while len(out) < n:
        r = k * spacing
        m = max(6, int(round(2.0 * np.pi * k)))
        ang = 2.0 * np.pi * np.arange(m) / m + 0.5 * k  # stagger rings
        out.extend(zip(r * np.cos(ang), r * np.sin(ang)))
        k += 1
    return np.asarray(out, np.float32)


def assign_ring_slots(
    unit_pos: np.ndarray,        # f32[N,2]
    goal: np.ndarray,            # f32[2]
    spacing: float,
    cost_layer: np.ndarray,      # u8[H,W] static effective cost of the layer
) -> np.ndarray:
    """Per-unit arrival destinations: pathable ring slots around `goal`,
    innermost slots to the units nearest the goal. f32[N,2]."""
    n = unit_pos.shape[0]
    offs = ring_offsets(2 * n + 16, spacing)
    cand = goal[None, :] + offs
    h, w = cost_layer.shape
    # floor, not int-truncation: candidates just past the west/north map
    # edge must index tile -1 (rejected), not clamp onto tile 0
    r = np.floor(cand[:, 1] / NAV_TILE_SIZE).astype(np.int64)
    c = np.floor(cand[:, 0] / NAV_TILE_SIZE).astype(np.int64)
    ok = (r >= 0) & (r < h) & (c >= 0) & (c < w)
    ok[ok] = cost_layer[r[ok], c[ok]] != COST_IMPASSABLE
    cand = cand[ok]
    if cand.shape[0] < n:       # degenerate goal area: reuse the goal
        pad = np.broadcast_to(goal, (n - cand.shape[0], 2))
        cand = np.concatenate([cand, pad], axis=0)
    # ring order is preserved by the boolean filter. Units claim slots in
    # approach order (nearest unit first, the reference's first-come ring
    # fill); each unit takes the closest slot among the next WINDOW free
    # slots in ring order, so it claims a slot facing its approach side
    # instead of crossing the crowd to a far-side slot of the same ring.
    order = np.argsort(np.linalg.norm(unit_pos - goal[None, :], axis=1),
                       kind="stable")
    window = 64
    free = list(range(min(cand.shape[0], n + window)))
    dest = np.empty((n, 2), np.float32)
    for u in order:
        look = free[:window]
        d = np.linalg.norm(cand[look] - unit_pos[u][None, :], axis=1)
        pick = int(np.argmin(d))
        dest[u] = cand[free.pop(pick)]
    return dest

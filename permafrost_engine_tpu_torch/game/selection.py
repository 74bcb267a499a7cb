"""Unit selection: click / drag-box selection over entity hit circles.

The port's own copy of ``permafrost_engine_tpu/game/selection.py``, on the
port's ``core/config.py`` and ``core/events.py``.

The reference ray-tests the camera frustum of the drag box against visible
entity OBBs (ref: src/game/selection.c, G_Sel_Update selection.h:56). The
top-down equivalent selects by world-space point/box against selection
radii — vectorized over the arena snapshot. Hovered entity = nearest hit
under the cursor ray.
"""

from __future__ import annotations

from enum import IntEnum

import numpy as np

from permafrost_engine_tpu_torch.core.config import EntityFlags
from permafrost_engine_tpu_torch.core.events import EventBus, EventType


class SelectionType(IntEnum):
    CONTEXTUAL = 0
    ALLIED = 1
    ENEMY = 2


class SelectionSystem:
    def __init__(self, bus: EventBus | None = None):
        self.enabled = True
        self.selection: list[int] = []
        self.hovered: int | None = None
        self.bus = bus

    def _selectable(self, flags: np.ndarray, alive: np.ndarray) -> np.ndarray:
        return alive & ((flags & int(EntityFlags.SELECTABLE)) != 0)

    def click_select(self, point_xz, uids, pos, sel_radius, flags, alive,
                     additive: bool = False) -> list[int]:
        ok = self._selectable(flags, alive)
        d = np.linalg.norm(pos - np.asarray(point_xz), axis=-1)
        hits = np.nonzero(ok & (d <= sel_radius))[0]
        picked = [int(uids[hits[np.argmin(d[hits])]])] if hits.size else []
        self._set(picked if not additive else sorted(set(self.selection) | set(picked)))
        return self.selection

    def box_select(self, lo_xz, hi_xz, uids, pos, flags, alive,
                   additive: bool = False) -> list[int]:
        ok = self._selectable(flags, alive)
        lo, hi = np.minimum(lo_xz, hi_xz), np.maximum(lo_xz, hi_xz)
        inside = ok & (pos[:, 0] >= lo[0]) & (pos[:, 0] <= hi[0]) \
                    & (pos[:, 1] >= lo[1]) & (pos[:, 1] <= hi[1])
        picked = [int(u) for u in uids[inside]]
        self._set(picked if not additive else sorted(set(self.selection) | set(picked)))
        return self.selection

    def update_hovered(self, point_xz, uids, pos, sel_radius, flags, alive):
        ok = self._selectable(flags, alive)
        d = np.linalg.norm(pos - np.asarray(point_xz), axis=-1)
        hits = np.nonzero(ok & (d <= sel_radius))[0]
        self.hovered = int(uids[hits[np.argmin(d[hits])]]) if hits.size else None
        return self.hovered

    def set_selection(self, uids: list[int]) -> None:
        self._set(list(uids))

    def clear(self) -> None:
        self._set([])

    def prune_dead(self, live_uids: set[int]) -> None:
        kept = [u for u in self.selection if u in live_uids]
        if kept != self.selection:
            self._set(kept)

    def _set(self, sel: list[int]) -> None:
        if sel != self.selection:
            self.selection = sel
            if self.bus:
                self.bus.notify(EventType.SELECTION_CHANGED, list(sel))

"""Named dynamic regions with enter/exit events.

The port's own copy of ``permafrost_engine_tpu/game/region.py``, on the
port's ``core/events.py``; ``update`` takes host arrays.

Mirrors src/game/region.c: circle/rect regions, per-frame membership
tracking, ENTERED/EXITED events to scripts (ref: region.c:164-357, driven
from G_Update at game.c:2223). Membership tests run vectorized over the
arena snapshot; the host keeps previous membership sets to diff.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from permafrost_engine_tpu_torch.core.events import EventBus, EventType


@dataclasses.dataclass
class Region:
    name: str
    shape: str                  # 'circle' | 'rect'
    pos: tuple[float, float]
    radius: float = 0.0         # circle
    half_x: float = 0.0         # rect half-extents
    half_z: float = 0.0
    shown: bool = False
    members: set[int] = dataclasses.field(default_factory=set)

    def contains(self, pos_xy: np.ndarray) -> np.ndarray:
        d = pos_xy - np.asarray(self.pos)
        if self.shape == "circle":
            return (d ** 2).sum(-1) <= self.radius ** 2
        return (np.abs(d[..., 0]) <= self.half_x) & (np.abs(d[..., 1]) <= self.half_z)


class RegionSystem:
    def __init__(self, bus: EventBus | None = None):
        self.regions: dict[str, Region] = {}
        self.bus = bus

    def add_circle(self, name: str, pos, radius: float) -> Region:
        r = Region(name, "circle", tuple(pos), radius=radius)
        self.regions[name] = r
        return r

    def add_rect(self, name: str, pos, dim_x: float, dim_z: float) -> Region:
        r = Region(name, "rect", tuple(pos), half_x=dim_x / 2, half_z=dim_z / 2)
        self.regions[name] = r
        return r

    def remove(self, name: str) -> None:
        self.regions.pop(name, None)

    def update(self, uids: np.ndarray, pos: np.ndarray, alive: np.ndarray) -> None:
        """Diff membership and fire ENTERED/EXITED (ref: G_Region_Update)."""
        live_uids = uids[alive]
        live_pos = pos[alive]
        for r in self.regions.values():
            inside = r.contains(live_pos)
            now = set(int(u) for u in live_uids[inside])
            for u in now - r.members:
                if self.bus:
                    self.bus.notify(EventType.REGION_ENTERED,
                                    {"region": r.name, "uid": u})
            for u in r.members - now:
                if self.bus:
                    self.bus.notify(EventType.REGION_EXITED,
                                    {"region": r.name, "uid": u})
            r.members = now

    def ents_in(self, name: str) -> list[int]:
        return sorted(self.regions[name].members)

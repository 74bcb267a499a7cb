"""Engine structural constants and static configuration.

The benchmark's frozen copy of
``permafrost_engine_tpu_torch/core/config.py``, taken when the benchmark was
defined and kept as it was: part of the plain reference that
``benchmark/check.py`` holds the program against. It imports nothing of the
program and nothing of JAX.

The port's own copy of ``permafrost_engine_tpu/core/config.py``: the same
names and values, verbatim (``tests/test_torch_integrate_map.py`` holds
every constant and enum value against the JAX package's).

These mirror the reference engine's workload-defining constants so that
behaviour and scale match at tick boundaries:

* map geometry: 32x32 tiles/chunk, 8x8 world units/tile
  (ref: src/map/public/tile.h:43-48)
* nav field resolution: 64x64 nav tiles/chunk (2x map tile resolution),
  <=64 portals/chunk (ref: src/navigation/nav_data.h:44-46)
* 12 nav layers: {ground, water, air} x {1x1, 3x3, 5x5, 7x7} unit footprints
  (ref: src/navigation/public/nav.h:78-92)
* movement constants (ref: src/game/movement.c:90-96, 418-437)

Everything in :class:`EngineConfig` is *static*: Python ints/floats that
fix the shapes of the state's tensors. Dynamic state lives in `state/`.
"""

from __future__ import annotations

import dataclasses
from enum import IntEnum

# ---------------------------------------------------------------------------
# Map / nav geometry (ref: src/map/public/tile.h:43-48, nav_data.h:44-46)
# ---------------------------------------------------------------------------

TILES_PER_CHUNK = 32          # map tiles per chunk side
UNITS_PER_TILE = 8.0          # world units per map tile side
FIELD_RES = 64                # nav tiles per chunk side (2x map resolution)
NAV_TILE_SIZE = UNITS_PER_TILE / 2.0   # world units per nav tile = 4.0
CHUNK_SIZE_UNITS = TILES_PER_CHUNK * UNITS_PER_TILE  # 256 world units

MAX_PORTALS_PER_CHUNK = 64    # ref: src/navigation/nav_data.h:44

# Cost-field encoding (ref: src/navigation/nav_data.h:47-71)
COST_IMPASSABLE = 0xFF        # u8 cost value meaning "blocked"
PORTAL_COST_UNREACHABLE = 0xFFFF

# Integration-field "infinity" (f32 fields on device)
INF_COST = 3.0e38

# ---------------------------------------------------------------------------
# Nav layers (ref: src/navigation/public/nav.h:78-92)
# ---------------------------------------------------------------------------


class NavDomain(IntEnum):
    GROUND = 0
    WATER = 1
    AIR = 2


# Footprint radii in nav tiles: 1x1, 3x3, 5x5, 7x7
FOOTPRINTS = (1, 3, 5, 7)
NUM_DOMAINS = 3
NUM_FOOTPRINTS = 4
NUM_LAYERS = NUM_DOMAINS * NUM_FOOTPRINTS  # 12


def nav_layer(domain: NavDomain, footprint_idx: int) -> int:
    """Layer index for (movement domain, footprint bucket)."""
    return int(domain) * NUM_FOOTPRINTS + footprint_idx


def footprint_for_radius(radius: float) -> int:
    """Footprint bucket for a unit radius, mirroring the reference's
    radius->layer classification (ref: src/entity.c:554)."""
    diameter_tiles = (2.0 * radius) / NAV_TILE_SIZE
    if diameter_tiles <= 1.0:
        return 0
    if diameter_tiles <= 3.0:
        return 1
    if diameter_tiles <= 5.0:
        return 2
    return 3


# ---------------------------------------------------------------------------
# Flow-field direction encoding (ref: src/navigation/public/nav.h:94-104)
# ---------------------------------------------------------------------------


class FlowDir(IntEnum):
    NONE = 0
    NW = 1
    N = 2
    NE = 3
    W = 4
    E = 5
    SW = 6
    S = 7
    SE = 8


# (dr, dc) per FlowDir; row 0 = north edge of a chunk, col 0 = west edge.
FLOW_DIR_OFFSETS = (
    (0, 0),    # NONE
    (-1, -1),  # NW
    (-1, 0),   # N
    (-1, 1),   # NE
    (0, -1),   # W
    (0, 1),    # E
    (1, -1),   # SW
    (1, 0),    # S
    (1, 1),    # SE
)

# ---------------------------------------------------------------------------
# Tick cadence (ref: src/game/timer_events.c:107-122, movement.h:45-50)
# ---------------------------------------------------------------------------

FRAME_HZ = 60
MOVE_HZ_CHOICES = (20, 10, 5, 1)
COMBAT_HZ_CHOICES = (10, 5, 1)    # plus 0.5Hz corpse tick handled separately
PROJECTILE_HZ = 30

# ---------------------------------------------------------------------------
# Movement / boids / ClearPath constants
# (ref: src/game/movement.c:90-96, 418-437; Appendix C of SURVEY.md)
# ---------------------------------------------------------------------------

MAX_FORCE = 0.75
VEL_HIST_LEN = 14
MAX_NEIGHBOURS = 32          # ClearPath neighbour cap (movement.c:437)
SEPARATION_FORCE = 0.6
SEPARATION_RADIUS = 30.0
ARRIVE_FORCE = 0.5
ARRIVE_SLOWING_RADIUS = 10.0
COHESION_FORCE = 0.15
# NOTE: cohesion is computed from per-(flock, cell) sums box-filtered
# over 7x7 spatial cells (ops/boids.flock_cohesion_centroids), reaching
# 48-64u — a cell-rectangle approximation of this 50u disc, with no
# neighbour-cap truncation (every flockmate counts). The per-pair kernel
# (`cohesion_force`) honours the constant exactly and remains for
# callers with explicit neighbour sets. The reference's own GPU path
# truncates at its neighbour caps too (movement.glsl:95-120).
COHESION_RADIUS = 50.0
ALIGNMENT_FORCE = 0.15
ALIGNMENT_RADIUS = 10.0
CELL_ARRIVAL_RADIUS = 30.0
# Formation-specific steering (ref: movement.c:1524-2023 formation
# cohesion/alignment/drag force builders): units with formation cells
# steer to hold their CELL OFFSET relative to the moving flock centroid,
# and velocity is dragged down near the cell to stop oscillation.
FORMATION_COHESION_FORCE = 0.35
FORMATION_DRAG = 0.15
MAX_TURN_RATE_DEG = 15.0     # per tick at 20 Hz (movement.c:433-434)
HEADING_HALT_DEG = 90.0      # halt to re-aim beyond this error
HEADING_RESUME_DEG = 10.0
WAIT_TICKS = 60
ARRIVAL_THRESHOLD = 5.0      # world units to consider "at destination"

# Spatial grid: 16-world-unit cells like the reference bitmap grid
# (ref: src/lib/public/bitmap_grid.h:36-120)
SPATIAL_CELL_SIZE = 16.0

# Fine contact grid: 4-unit cells used ONLY for de-penetration/contact
# constraints. The coarse grid's 16u cells saturate at choke density
# (a 16u cell tangent-packs ~74 radius-1 units vs cap 16), leaving most
# of a dense crowd invisible to contact resolution; a 4u cell tangent-
# packs ~5, so the same cap never saturates physically.
CONTACT_CELL_SIZE = 4.0

# ---------------------------------------------------------------------------
# Simulation / engine states (ref: src/game/public/game.h:90-95)
# ---------------------------------------------------------------------------


class MoveState(IntEnum):
    """Per-entity movement FSM (ref: src/game/movement.c:118-144)."""
    ARRIVED = 0
    MOVING = 1
    WAITING = 2
    TURNING = 3
    SEEK_ENEMIES = 4
    ARRIVING_TO_CELL = 5
    SURROUND_ENTITY = 6
    # (the reference's ENTERING_PORTAL state has no counterpart: union flow
    #  fields span every chunk of the path, so there is no per-portal
    #  hand-off stage — movement.c:118-144 vs ops/flowfield.py union fields)


class CombatState(IntEnum):
    """Per-entity combat FSM (ref: src/game/combat.c:142-175)."""
    NOT_IN_COMBAT = 0
    MOVING_TO_TARGET = 1
    CAN_ATTACK = 2
    ATTACK_ANIM = 3
    DEATH_ANIM = 4
    CORPSE = 5


class CombatStance(IntEnum):
    AGGRESSIVE = 0
    HOLD_POSITION = 1
    NO_ENGAGEMENT = 2


# Entity flag bits (ref: src/entity.h:55-83)
class EntityFlags(IntEnum):
    ANIMATED = 1 << 0
    COLLISION = 1 << 1
    SELECTABLE = 1 << 2
    MOVABLE = 1 << 3
    COMBATABLE = 1 << 4
    INVISIBLE = 1 << 5
    ZOMBIE = 1 << 6           # scheduled for removal
    MARKER = 1 << 7
    BUILDING = 1 << 8
    BUILDER = 1 << 9
    TRANSLUCENT = 1 << 10
    RESOURCE = 1 << 11
    HARVESTER = 1 << 12
    STORAGE_SITE = 1 << 13
    WATER = 1 << 14
    AIR = 1 << 15
    GARRISON = 1 << 16
    GARRISONABLE = 1 << 17
    GARRISONED = 1 << 18
    DYING = 1 << 19


# Fog-of-war per-tile 2-bit states (ref: src/game/fog_of_war.c:163-177)
class FogState(IntEnum):
    UNEXPLORED = 0
    IN_FOG = 1
    VISIBLE = 2


MAX_FACTIONS = 16  # reference supports <=15 + 1 spare for packing into u32


class DiplomacyState(IntEnum):
    NEUTRAL = 0
    PEACE = 1
    WAR = 2


# ---------------------------------------------------------------------------
# Static engine configuration
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static (shape-defining) engine configuration.

    All fields are compile-time constants of the jitted step function;
    changing any of them triggers recompilation. Defaults size a
    10k-entity battle on a 4x4-chunk map (the north-star workload).
    """

    max_ents: int = 16384            # entity arena capacity
    chunks_r: int = 4                # map chunks (rows)
    chunks_c: int = 4                # map chunks (cols)
    num_layers: int = NUM_LAYERS     # nav layers materialised on device
    max_flocks: int = 64             # concurrent movement groups
    max_projectiles: int = 2048      # projectile arena capacity
    max_factions: int = MAX_FACTIONS
    field_slab_slots: int = 256      # device-resident flow-field LRU slab
    los_slab_slots: int = 256        # device-resident LOS-field slab
    global_field_slots: int = 16     # whole-map fields (enemy-seek/surround/
                                     # chase); sized ~max_factions so warring
                                     # factions' chase fields never thrash
    spatial_cell_cap: int = 16       # entities per spatial-grid cell bucket
    contact_cell_cap: int = 16       # per fine contact cell (3x hex-pack
                                     # bound of a 4u cell, never saturates)
    move_hz: int = 20
    combat_hz: int = 10
    fog_hz: int = 6                  # vision/fog flush rate (the reference
                                     # flushes lazily/batched per update)
    vision_radius_buckets: int = 4   # distinct vision radii for fog stamps
    skin_joints: int = 0             # joints per rig for the device skinning
                                     # stage (ops/skin.py); 0 disables it and
                                     # the state carries no AnimArena. The
                                     # reference caps rigs at 96 joints
                                     # (src/entity.h:50).
    skin_hz: int = FRAME_HZ          # palette rebuild cadence (the reference
                                     # re-bakes the anim texture per rendered
                                     # frame, anim_texture.c:93-145)
    clearpath_exact: bool = True     # reference-exact ClearPath candidates
                                     # (cone-edge intersections + true HRVO
                                     # apexes, clearpath.c:176-367); False =
                                     # the cheaper rotated-vdes fan

    # ---- derived geometry -------------------------------------------------

    @property
    def field_h(self) -> int:
        return self.chunks_r * FIELD_RES

    @property
    def field_w(self) -> int:
        return self.chunks_c * FIELD_RES

    @property
    def tiles_h(self) -> int:
        return self.chunks_r * TILES_PER_CHUNK

    @property
    def tiles_w(self) -> int:
        return self.chunks_c * TILES_PER_CHUNK

    @property
    def world_h(self) -> float:
        return self.chunks_r * CHUNK_SIZE_UNITS

    @property
    def world_w(self) -> float:
        return self.chunks_c * CHUNK_SIZE_UNITS

    @property
    def num_chunks(self) -> int:
        return self.chunks_r * self.chunks_c

    @property
    def grid_cells_r(self) -> int:
        import math
        return math.ceil(self.world_h / SPATIAL_CELL_SIZE)

    @property
    def grid_cells_c(self) -> int:
        import math
        return math.ceil(self.world_w / SPATIAL_CELL_SIZE)

    @property
    def contact_cells_r(self) -> int:
        import math
        return math.ceil(self.world_h / CONTACT_CELL_SIZE)

    @property
    def contact_cells_c(self) -> int:
        import math
        return math.ceil(self.world_w / CONTACT_CELL_SIZE)

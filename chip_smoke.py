#!/usr/bin/env python3
"""Smoke run of permafrost_engine_tpu_torch on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py``. It needs one CUDA
device and ``nvcc`` (``$CUDA_HOME/bin``, ``PATH`` or ``/usr/local/cuda``);
it exits non-zero, printing no result, without them or without the
package beside it. Phases, each printing its own line:

0. the device: card name and power limit (``nvidia-smi``), torch, CUDA
   and nvcc versions;
1. build both hand-written kernels (``csrc/*.cu``) from source;
2. kernel K2 (flow-field integration, one thread-block cluster per field)
   against its plain PyTorch version on the 4x4-chunk battle map: the
   move path's 64x64 chunk batches, with and without seed costs, and the
   whole-map 256x256 shapes: layer 0 at K = 2 seeded at the phase-4 spawn
   tiles (the chase fields), all 12 layers at K = 12, and a serpentine
   where the 1,024-sweep cap binds. The fields must be bit-equal; prints
   both times, the sweeps the plain run took and the cluster size
   (``tools/profile_k2.py`` compares other cuts);
3. kernel K1 (HRVO select) against its plain version, exact and fan mode,
   bit-equal on every row: of the edge scenes (``k1_edge_scene``: ties at
   the 32nd neighbour, zero and NaN preferred velocities, static and
   colliding neighbours, short and empty windows, C2 from 1 to 512, N 1 to
   1,025) and of a real 3x3 window of the 10,256-slot battle scene (which
   implies the parity tests' bounds); on the real window both times, the
   bound at the shares of (candidate, cone) pairs these inputs take past
   the sign test (the sqrt share) and inside;
4. the march: two 5,000-unit armies spawned and ordered across the
   battle map (as ``bench.py``'s ``build_battle(5000, terrain=True)``,
   with no war), 360 frames stepped; both kernels' launch counters (reset
   just before) must be above 0, K1's equal to the movement substeps, no
   NaN, and both armies closer to their goals; ms per frame and per
   substep;
5. the war: the same scene with factions 0 and 1 at war (20% ranged, 80%
   melee), run twice from the same spawn in 60-frame ``step`` calls: per
   frame (``micro_batching = False``) and micro-batched, each fused segment
   one CUDA graph replay. Each run goes to the first drained death (within
   1,800 frames), then 120 contact frames; both must print the same digest
   of every position and velocity at first death and at the end, and drain
   the same events at the same frames. The per-frame engine then steps 60
   frames with every substep bracketed by synchronizations and times the
   chase-field rebuild; the graphed one runs three ``step_scan(120)``
   windows.
   Fails unless K1's launches equal the movement substeps in each run (graph
   replays add the launches their capture recorded), K2 launched for chunks
   and for whole maps (the chase fields), deaths, attack starts and
   projectile hits occurred, each faction holds a chase field and sees
   ``VISIBLE`` fog tiles, and no position, velocity or hp is NaN. Prints ms
   per frame in each mode (march, contact, ``step_scan``), the graph
   captures, capture ms, replays and launches per segment, ms per substep
   kind at contact, the chase-field rebuild through K2 (ms and field
   count), the nav cadence's counters and peak memory;
6. the combined-arms battle (BASELINE #5: ``bench.py``'s
   ``build_battle(5000, terrain=True, full=True)``, 32-joint skinning
   included, driven as its ``run_battle`` drives it, with
   ``place_midfight_structures``): per side a 4,360-unit ground corps
   (3,200 melee, 1,000 archers, 160 radius-2.5 siege) in one
   ``move_in_formation(RANK)``, 384 navy on the water layer and 256 air, at
   war from the start. Micro-batched ``step``: a warm-up second and three
   timed 120-frame windows on the march; ``step_scan(300)`` until a corpse
   is removed (first blood), where side 0's air gets ``seek_enemies`` and
   side 1's air ``surround`` on side 0's first siege unit, and one
   ``step_scan(300)`` more; six radius-10 buildings drop at the chokes
   (``set_structure_blocking``); three ``step(120)`` and three
   ``step_scan(120)`` contact windows. Fails unless every corps unit holds
   a distinct passable cell of its block and its flock is RANK, K2 launched
   for chunks during each formation order and at the structure commit, K2
   is bit-equal to its plain version on the captured inputs of the first
   formation install and of the structure relink, the footprints are
   impassable on ground and water layers and untouched on air, chunks were
   relinked and the nav version bumped, the seek flock holds a whole-map
   field, whole-map K2 launches grew with the orders, the surround flock
   closed on its target, K1's launches equal the movement substeps, deaths,
   attack starts and projectile hits occurred, the clips show RUN on the
   march and DIE at contact (ATTACK never: the combat FSM, as the JAX
   package's, never enters ``ATTACK_ANIM``), the palettes are finite, the
   formation keep force is bit-equal over repeated evaluations on the march,
   and no position, velocity or hp is NaN. Prints digests of every position
   and velocity after the march and at the end and of every palette at the
   end (equal across runs of the same code), each formation order's seconds
   (layout, auction, field install; the auction's rounds, bidders, cells
   and whether the greedy fill ran), the structure commit's ms,
   ``fps_march``, ``fps_contact`` and ``fps_contact_scan`` in ``bench.py``'s
   sense, the skin stage's ms at 10,256 x 32 joints, the seek and surround
   order ms, the graph cache and peak memory;
7. the economy at war (the host layer: scheduler, pause, economy, regions,
   animation system, profiling, sessions): phase 5's two armies (4,800 a
   side) on the same map and slots, and behind each an economy
   (``spawn_economy``: 8 resource nodes, 16 harvesters registered with the
   animation system, 2 storage sites, a founded and supplied building with
   2 builders, a garrison tower and a transport taking 4 scouts to it) and
   two regions. Two script tasks wait on 10 deaths each and a third pauses
   the game for 30 frames, so ``step(60)`` runs frame by frame (eagerly)
   until no task lives; then micro-batched ``step(60)`` and
   ``step_scan(120)`` windows (6-frame graph segments), ``profile_tick(60)``
   twice and ``tick_cost_analysis``, a session saved and loaded on the
   card, both engines stepped 240 frames, and a ``SubsessionStack`` push
   and pop. Fails unless the pause held the state, both sides delivered
   Wood and Stone, both buildings completed, each tower holds its scouts,
   the transport missions ended, the regions reported enters, deaths were
   drained, the loaded engine matches the original (state, economy and
   event digests), a dropped engine's memory (the loaded one, the popped
   one and their graph pools) is freed, K1's launches equal the movement
   substeps, K2 launched, and nothing is NaN. Prints ms per frame in each stepping mode, the
   profile classes, save and load ms, blob bytes, memory with two engines
   and after the pop, and the host systems' counters;
8. the war battle driven through the ``pf`` script surface, as a game
   script drives it (``phase_pf``): ``pf.init`` (on the card by default)
   with 10,256 slots, the battle map loaded from PFMAP text
   (``pf.load_map_string(write_pfmap(make_battle_map()))``, its cost grid
   held equal to ``compile_nav_costs``), two factions at war through
   ``pf``, phase 5's 10,000 units spawned as script objects, one
   constructor call each (a melee ``Footman`` and a ranged ``Archer``
   class, 20% archers), and each side ordered by one right click
   (``pf.inject_mouse_click(x, y, 3)``) at the screen point of the other
   side's centroid through the active RTS camera. A death handler and a
   ``pf.Task`` that waits for 10 deaths; ``pf.step(60)`` frame by frame
   (eagerly) until a death is drained and the task has ended, then three
   graphed ``pf.step(120)`` contact windows with ``pf.disable_fog_of_war``
   and ``pf.enable_fog_of_war`` between them. After every window the
   ``hp`` and ``pos`` properties of 64 fixed entities are read and held
   equal to ``Engine.ents_host``; at contact ``pf.nearest_ent``,
   ``pf.ents_in_circle`` and ``pf.get_idle_units`` are timed, and a
   session saved and loaded through ``pf``; the original and the loaded
   engine each step 240 frames. Fails unless K1's launches equal the
   movement substeps, K2 launched for chunks and whole maps, deaths,
   attack starts and projectile hits occurred, the handler saw every
   drained death and the task ended, every property read equals the host
   copy, the fog toggles showed in windows of graph replays alone, the
   loaded session prints the original's digests and nothing is NaN. Then
   ``pf.dump_framebuffer`` writes the battle from the active camera
   (turned to the densest 64x64 cell of living units; ``render_log_mask`` 2
   counts the live triangles of each pass) and, with
   ``minimap=True``, the
   minimap, both as ``.npy`` under ``chiprun_out/``; it fails unless the
   frame is u8 640x384 and not flat, the units draw over 1,000 of its
   pixels (against the same frame drawn with no instances) and both
   armies' dots show on the minimap. Prints spawn ms per entity, ms per
   frame eager and graphed, ms per property read and per query, save and
   load ms, blob bytes, the digests, the dumps' ms and peak memory;
9. the render cell (``phase_render``): ``bench.py``'s ``measure_render``
   scene through the port, nothing cut: the battle map,
   ``EngineConfig(max_ents=1064, skin_joints=32)``, 500 units a side at
   war with move orders, ``step(30)``, and a ``SceneRenderer`` at 1280x720
   with ``maxi=1000``, shadows and water (reflection and refraction), from
   faction 0's fog point of view. Prints the first frame's seconds,
   ``render_ms_p50``, ``render_ms_p90`` and ``render_fps`` over 12 frames
   (the frame counter bumped so the shadow pass reruns),
   ``sim_plus_render_fps_dec4`` (60 frames: ``step(4)`` and one render,
   15 times), the per-pass split (soup, shadow, raster, shade, water,
   overlays; the median of 8 frames with ``pf.debug.render_log_mask`` 1),
   the live triangles of each pass against ``raster_budget``
   (``render_log_mask`` 2) and peak memory. Then the same state is copied
   to a CPU engine (``state/convert``) and one frame rendered there too.
   Fails unless TF32 matmuls are off, the frames are u8 1280x720 and not
   flat, the logged path draws the fused path's frame, the units draw over
   1,000 pixels, K1's launches equal the movement substeps, K2 launched
   for the move orders, every pass counted live triangles, and at least
   99.5% of the card frame's pixels lie within 2 levels of the CPU frame's
   (``tests/test_torch_scene.py``'s tolerance). Both frames go to
   ``chiprun_out/`` as ``.npy``.
10. the multi-rank mode (``phase_parallel``, ``parallel/``): phase 5's war
   battle stepped (micro-batched) to the first drained death and saved as a
   session; only then, with both kernels built, ``parallel.spawn`` starts 4
   rank processes on this one card (ranks share ``cuda:0``, so the
   exchange is gloo staged through the host; the transport is printed).
   Each loads the session on its device, calls ``sharded_engine(...,
   map_sharded=True)`` (2,564 entity rows a rank, bands of 64 nav rows and
   32 fog rows) and steps 120 contact frames, then orders ``seek_enemies``
   for 512 living units of side 0 (a whole-map field through the row-banded
   halo integrator) and steps 60 more. The single-device engine continues
   from the same session with the same calls, frame by frame. Fails unless
   every rank prints the single-device digests of positions and
   velocities, hp, fog, blockers and whole-map fields after the contact
   frames and at the end, each rank launched K1 once per movement substep,
   all-gathered and exchanged halos, loaded no JAX module and ran no nvcc,
   no rank outlived the timeout, K1 on each rank's row band of the live
   window equals the whole launch's rows (inputs and outputs, bit for bit)
   and its plain version, and the band integrator's seek field equals K2's
   on the same inputs. Prints the digests of every rank and of the
   single-device engine, K1 launches and rows per rank, collective calls
   and bytes per tick by kind, ms per sharded frame against the
   single-device eager frame, the band integrator's ms and sweeps against
   K2's time for the same field, and each rank's peak memory.

11. the system's entry points (``phase_entry``, ``demos/`` and ``tools/``
   of the port), all on the card: ``demos/stress.py --units 5000`` (build
   and ``main``'s loop, 20 simulated seconds of ``step_scan(60)``, fps per
   second, alive and deaths; fails unless K1 and K2, chunks and whole maps,
   launched, no position or hp is NaN and living units plus deaths are
   10,000); ``grid.knn_query`` (k=32, window 5) over the battle's final
   10,256 positions, equal to the same call on a CPU copy (idx, and dist
   within 1e-5 relative) and to a brute force on 256 rows, with its ms;
   ``preferred_velocity``'s fallbacks (arena gathers, per-pair cohesion)
   against its CPU result; ``rts_demo``, ``campaign``, ``pong``,
   ``editor`` and ``viewer`` (3 s at 64 units) through their ``main``;
   ``scripts/rts/main.py`` and ``scripts/editor/main.py`` through ``python
   -m permafrost_engine_tpu_torch.tools.launcher`` in subprocesses (rc 0,
   their completion lines, no JAX module loaded there); the live viewer
   behind its HTTP handler on 127.0.0.1 (a ``POST /input`` click selects a
   unit and a right click orders it; ``GET /frame.png``); and
   ``export_replay`` over 120 frames. Where Pillow is absent (printed),
   the frame route and the replay stop at the rendered u8 frame.

The script imports only the port and fails if any ``jax``/``jaxlib``/
``flax`` module or anything of the JAX package (``permafrost_engine_tpu``)
was loaded, in this process or in the launcher's. Before the last line come one JSON object with per-kernel
numbers (time, plain time, the card's least time for the work and what
sets it, launches on the main path) and the card's name and power limit;
the last is ``{"ok": true, "device": {...}}``. Details go to
``chiprun_out/``.
"""

import concurrent.futures
import contextlib
import copy
import hashlib
import importlib.metadata
import json
import os
import subprocess
import sys
import time
import types

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out")
N_PER_SIDE = 5000
FRAMES = 360
WAR_MAX_FRAMES = 1800       # the first death must come within this
CONTACT_FRAMES = 120
SUBSTEP_FRAMES = 60
WAR_WINDOW = 60             # frames per step() call in phase 5
SCAN_WINDOW = 120           # frames per step_scan() call at contact
# phase 6, as bench.py's run_battle: a warm-up second, then timed windows of
# step() calls; step_scan() chunks fast-forward to first blood
BENCH_WARMUP = 60
BENCH_WINDOW = 120
BENCH_WINDOWS = 3
FF_CHUNK = 300
# the card's peak rates for a kernel's least time (NVIDIA's H100 SXM data
# sheet): device memory bytes/s, and f32 operations/s outside the tensor
# cores for operations that are not FMAs (adds, multiplies, mins, compares):
# half the sheet's 67e12 flop/s, which counts an FMA as two
HBM_BYTES_S = 3.35e12
F32_OPS_S = 33.5e12
# K2's work per tile per sweep: 8 candidate adds and 8 mins (the diagonal
# step cost is computed once). K1's per (candidate, valid cone) pair with the
# cone-only terms hoisted (csrc/hrvo.cu): operations every pair needs, more
# where the sign test lets it be inside (|w| and its sqrt), more where it is
# inside (the violation term); none fused
K2_OPS_PER_TILE_SWEEP = 16
K1_OPS_PER_CONE_TEST = {"exact": (10, 16, 3), "fan": (5, 11, 2)}


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of fn() in ms, CUDA events around `iters` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """The card's least time for the work (ms) and what sets it: each
    input read once and each output written once at the memory rate, or
    the operations at the f32 rate for unfused operations, whichever is
    longer."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S, ops / F32_OPS_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def block(rng, x0, z0, n, files, dx=4.0, dz=3.0):
    """bench.py's spawn block: `files` columns dx apart, rows dz apart,
    each position jittered by up to half a unit from `rng`."""
    fx = (np.arange(n) % files) * dx
    fz = (np.arange(n) // files) * dz
    x = x0 + fx + (rng.random(n) - 0.5)
    z = z0 + fz + (rng.random(n) - 0.5)
    return np.stack([x, z], 1).astype(np.float32)


def spawn_blocks():
    """The two armies' spawn positions and ranged mask (rng seed 0), as
    bench.py's build_battle(5000, terrain=True) spawns them."""
    rng = np.random.default_rng(0)
    ranged = rng.random(N_PER_SIDE) < 0.2
    return (block(rng, 200.0, 212.0, N_PER_SIDE, 25),
            block(rng, 820.0, 212.0, N_PER_SIDE, 25), ranged)


def build_battle(dev, war: bool = False):
    """bench.py's build_battle(5000, terrain=True): the 4x4-chunk battle
    map, two factions (at war if `war`), two 5,000-unit blocks (rng seed 0,
    20% ranged) ordered to the far side."""
    from permafrost_engine_tpu_torch import DiplomacyState, EngineConfig
    from permafrost_engine_tpu_torch.assets.mapgen import make_battle_map
    from permafrost_engine_tpu_torch.game.engine import Engine

    cfg = EngineConfig(max_ents=2 * N_PER_SIDE + 256)
    eng = Engine(cfg, device=dev)
    eng.load_map_data(make_battle_map())
    eng.add_faction(0)
    eng.add_faction(1)
    if war:
        eng.set_diplomacy(0, 1, DiplomacyState.WAR)
    pos_a, pos_b, ranged = spawn_blocks()
    kw = dict(max_speed=20.0, is_ranged=ranged,
              attack_range=np.where(ranged, 40.0, 5.0), vision_range=80.0,
              hp=200.0)
    a = eng.spawn_batch(pos_a, faction=0, **kw)
    b = eng.spawn_batch(pos_b, faction=1, **kw)
    goals = {"a": (820.0, 512.0), "b": (200.0, 512.0)}
    check(eng.move(a, goals["a"]), "army a path request")
    check(eng.move(b, goals["b"]), "army b path request")
    return eng, a, b, goals


def k2_batches(cost):
    """K2's inputs at the main path's shapes. Chunks (64x64): the
    portal-graph build batch (every portal span of layer 0 seeded), the
    same chunks as a union-field install (random costs on the seeds), and
    a goal batch (one random passable tile per chunk, all 16 chunks of all
    12 layers). Whole maps (256x256): layer 0 at K = 2 seeded at the
    phase-4 spawn tiles of the other army (the two chase fields), all 12
    layers at K = 12 seeded likewise, and a serpentine (walls every 4 rows,
    gaps at alternating ends) where the 1,024-sweep cap binds."""
    from permafrost_engine_tpu_torch import COST_IMPASSABLE, FIELD_RES
    from permafrost_engine_tpu_torch.core.config import NAV_TILE_SIZE
    from permafrost_engine_tpu_torch.nav.portals import find_portals, span_seed_batch

    rng = np.random.default_rng(0)
    portals, _ = find_portals(cost[0], 4, 4)
    pc, ps = span_seed_batch(portals, cost[0])
    pv = np.where(ps, rng.random(ps.shape) * 500.0, 0.0).astype(np.float32)
    chunks = cost.reshape(cost.shape[0], 4, FIELD_RES, 4, FIELD_RES
                          ).transpose(0, 1, 3, 2, 4).reshape(-1, FIELD_RES, FIELD_RES)
    goal = np.zeros(chunks.shape, bool)
    for i, ch in enumerate(chunks):
        rr, cc = np.nonzero(ch != COST_IMPASSABLE)
        if rr.size:
            j = rng.integers(rr.size)
            goal[i, rr[j], cc[j]] = True

    layers, h, w = cost.shape
    army = np.zeros((2, h, w), bool)
    for f, pos in enumerate(spawn_blocks()[:2]):
        t = (pos / NAV_TILE_SIZE).astype(np.int64)
        army[f, np.clip(t[:, 1], 0, h - 1), np.clip(t[:, 0], 0, w - 1)] = True
    enemy = army[::-1]                     # field f chases the other army
    serp = np.ones((1, h, w), np.uint8)
    for i, r in enumerate(range(4, h, 4)):
        serp[0, r, :] = COST_IMPASSABLE
        serp[0, r, (w - 1) if i % 2 == 0 else 0] = 1
    serp_seed = np.zeros((1, h, w), bool)
    serp_seed[0, 0, 0] = True
    return {
        "portal_spans": (pc, ps, None),
        "union_install": (pc, ps, pv),
        "goal_tiles": (np.ascontiguousarray(chunks), goal, None),
        "map_layer0": (np.ascontiguousarray(np.broadcast_to(cost[0], (2, h, w))),
                       np.ascontiguousarray(enemy), None),
        "map_12_layers": (np.ascontiguousarray(cost),
                          np.ascontiguousarray(enemy[np.arange(layers) % 2]),
                          None),
        "map_serpentine": (serp, serp_seed, None),
    }


K1_ROW_KINDS = ("random", "ties", "vpref_zero", "static", "colliding",
                "ten_valid", "none_valid", "vpref_nan")
# (rows N, window width C2, kind of row 0); row i is of kind (first + i) % 8
K1_EDGE_SHAPES = ((1, 1, 0), (1, 144, 7), (7, 20, 0), (7, 160, 1),
                  (7, 512, 2), (1025, 144, 0), (1025, 512, 3))


def k1_edge_scene(n: int, c2: int, first: int = 0, seed: int = 0):
    """K1's positional arguments (numpy) for N rows of window width C2,
    built to corner the kernel: row i is of kind ``K1_ROW_KINDS[(first + i)
    % 8]``. ``random``: neighbours within 15 u, 85% valid, 20% static;
    ``ties``: integer offsets at squared distances 25 or 100 (exact in any
    rounding), so equal distances straddle the 32nd/33rd neighbour and
    duplicate positions abound; ``vpref_zero``: every fan candidate is the
    same zero velocity (score ties go to the lowest index); ``static``: every
    neighbour static; ``colliding``: every neighbour nearer than the combined
    radius; ``ten_valid``: 10 valid candidates; ``none_valid``: none;
    ``vpref_nan``: a NaN preferred velocity (every score NaN)."""
    rng = np.random.default_rng(seed)
    pos = np.round(rng.uniform(20.0, 80.0, (n, 2))).astype(np.float32)
    vel = rng.uniform(-1.0, 1.0, (n, 2)).astype(np.float32)
    radius = np.ones(n, np.float32)
    vpref = rng.uniform(-1.5, 1.5, (n, 2)).astype(np.float32)
    max_speed = np.full(n, 2.0, np.float32)
    ang = rng.uniform(0.0, 2.0 * np.pi, (n, c2))
    dist = 15.0 * np.sqrt(rng.uniform(0.0, 1.0, (n, c2)))
    off = np.stack([dist * np.cos(ang), dist * np.sin(ang)], -1)
    cand_vel = rng.uniform(-1.0, 1.0, (n, c2, 2)).astype(np.float32)
    cand_rad = rng.uniform(0.5, 1.5, (n, c2)).astype(np.float32)
    cand_valid = rng.random((n, c2)) < 0.85
    cand_static = rng.random((n, c2)) < 0.2
    ring = np.array([(3, 4), (4, 3), (5, 0), (0, 5)], np.float64)
    ring = np.concatenate([ring * s for s in ((1, 1), (-1, 1), (1, -1), (-1, -1))])
    for i in range(n):
        kind = K1_ROW_KINDS[(first + i) % len(K1_ROW_KINDS)]
        if kind == "ties":
            pick = ring[rng.integers(0, len(ring), c2)]
            off[i] = pick * np.where(rng.random(c2) < 0.2, 1.0, 2.0)[:, None]
            cand_rad[i] = 1.0
        elif kind == "vpref_zero":
            vpref[i] = 0.0
        elif kind == "static":
            cand_static[i] = True
        elif kind == "colliding":
            off[i] *= (rng.uniform(0.3, 1.9, c2) / np.maximum(dist[i], 1e-3))[:, None]
        elif kind == "ten_valid":
            cand_valid[i] = False
            cand_valid[i, rng.permutation(c2)[:10]] = True
        elif kind == "none_valid":
            cand_valid[i] = False
        elif kind == "vpref_nan":
            vpref[i] = np.nan
    cand_pos = (pos[:, None, :] + off).astype(np.float32)
    return (pos, vel, radius, vpref, max_speed, cand_pos, cand_vel, cand_rad,
            cand_valid, cand_static)


def phase_k2(dev, cost):
    """K2 vs plain at the main path's shapes (see ``k2_batches``), through
    the wrapper the path calls, at its cut (``plan``: 4 blocks per chunk,
    16 per map, above 8 a non-portable cluster size)."""
    from permafrost_engine_tpu_torch.ops.flowfield import integrate_plain
    from permafrost_engine_tpu_torch.ops.flowfield_cuda import integrate, plan

    out = {}
    for name, (c, s, v) in k2_batches(cost).items():
        ct = torch.from_numpy(c).to(dev)
        st = torch.from_numpy(s).to(dev)
        vt = None if v is None else torch.from_numpy(v).to(dev)
        k, h, w = c.shape
        cut = plan(h, w)
        stats = {}
        want = integrate_plain(ct, st, vt, max_iters=4 * max(h, w), stats=stats)
        plain_ms = cuda_ms(lambda: integrate_plain(
            ct, st, vt, max_iters=4 * max(h, w)), 3, warmup=1)
        finite = want < 1e30
        got = integrate(ct, st, vt)
        torch.cuda.synchronize()
        check(torch.equal(finite, got < 1e30), f"K2 {name}: reachability")
        err = float((got - want)[finite].abs().max()) if finite.any() else 0.0
        check(torch.equal(got, want), f"K2 {name}: bit-equal (max err {err})")
        ms = cuda_ms(lambda: integrate(ct, st, vt), 20)
        nbytes = k * h * w * (1 + 1 + 4 + (0 if v is None else 4))
        b_ms, b_by = bound(nbytes, stats["sweeps"] * k * h * w
                           * K2_OPS_PER_TILE_SWEEP)
        out[name] = dict(k=k, h=h, w=w, plain_sweeps=stats["sweeps"],
                         plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                         reachable=int(finite.sum()), cluster=cut[0],
                         plan=cut, ms=ms, max_abs_err=err)
        log(f"phase 2 K2 {name}: K={k} {h}x{w} cluster={cut[0]} "
            f"threads={cut[2]} bit-equal max_abs_err={err} "
            f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"plain_sweeps={stats['sweeps']} bound_ms={b_ms:.5f} ({b_by})")
    return out


def k1_live_window(dev):
    """K1's exact inputs on a real window: the battle scene 60 frames into
    the march. Returns (args, moving mask)."""
    from permafrost_engine_tpu_torch.game.step import crowd_inputs

    eng, _a, _b, _g = build_battle(dev)
    eng.step(60)
    x = crowd_inputs(eng.cfg, eng.state)
    return x["hrvo_args"], x["moving_mask"]


def rows_differ(a, b):
    """bool[N]: rows that differ, comparing as torch.equal does (-0 equals
    +0) with NaN equal to NaN."""
    return ~((a == b) | (torch.isnan(a) & torch.isnan(b))).all(1)


def phase_k1(dev):
    """K1 vs plain, exact and fan mode, on every row: the edge scenes
    (``K1_EDGE_SHAPES``) and a real window; times and the bound on the
    real window."""
    from permafrost_engine_tpu_torch.ops.crowd_cuda import (
        hrvo_select_cuda, hrvo_select_plain)

    edge_rows = 0
    for n, c2, first in K1_EDGE_SHAPES:
        eargs = [torch.from_numpy(a).to(dev)
                 for a in k1_edge_scene(n, c2, first, seed=n + c2)]
        for exact in (True, False):
            got = hrvo_select_cuda(*eargs, exact=exact)
            want = hrvo_select_plain(*eargs, exact=exact)
            torch.cuda.synchronize()
            bad = int(rows_differ(got, want).sum())
            check(bad == 0, f"K1 edge scene N={n} C2={c2} exact={exact}: "
                  f"{bad} rows differ from the plain version")
        edge_rows += n
    log(f"phase 3 K1 edge scenes: {len(K1_EDGE_SHAPES)} shapes "
        f"(N, C2 in {[s[:2] for s in K1_EDGE_SHAPES]}), {edge_rows} rows, "
        f"exact and fan: bit-equal on every row")

    args, moving = k1_live_window(dev)
    rows = int(moving.sum())
    check(rows > 0, "K1: moving rows in the window")
    n, c2 = args[5].shape[0], args[5].shape[1]
    nbytes = sum(a.numel() * a.element_size() for a in args) + n * 2 * 4
    out = dict(edge_shapes=[list(s) for s in K1_EDGE_SHAPES], edge_rows=edge_rows)
    # candidate velocities per row (csrc/hrvo.cu): 377 exact, 57 fan
    for mode, exact, nc in (("exact", True, 377), ("fan", False, 57)):
        stats = {}
        got = hrvo_select_cuda(*args, exact=exact)
        want = hrvo_select_plain(*args, exact=exact, stats=stats)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), f"K1 {mode}: finite")
        differ = rows_differ(got, want)
        diff_moving = int(differ[moving].sum())
        diff_still = int(differ[~moving].sum())
        err = torch.linalg.vector_norm(got - want, dim=1)
        share = float((err[moving] < 1e-4).float().mean())
        max_err = float(err.max())
        check(diff_moving == 0 and diff_still == 0,
              f"K1 {mode}: bit-equal on every row ({diff_moving} moving and "
              f"{diff_still} other rows differ, max err {max_err})")
        ms = cuda_ms(lambda: hrvo_select_cuda(*args, exact=exact), 20)
        plain_ms = cuda_ms(lambda: hrvo_select_plain(*args, exact=exact), 3,
                           warmup=1)
        # every row: distances and 32 arg-min rounds over the window; then
        # each candidate against each valid cone, at the shares of pairs
        # these inputs take past the sign test and inside (csrc/hrvo.cu)
        every, passed, inside = K1_OPS_PER_CONE_TEST[mode]
        ops = (n * (5 * c2 + 32 * c2) + stats["pairs"] * every
               + stats["passed"] * passed + stats["inside"] * inside)
        b_ms, b_by = bound(nbytes, ops)
        pass_share = stats["passed"] / max(stats["pairs"], 1)
        warp_share = stats["slots_passed"] / max(stats["slots"], 1)
        out[mode] = dict(rows=rows, share_1e4=share, max_abs_err=max_err,
                         rows_differ_moving=diff_moving,
                         rows_differ_other=diff_still, ms=ms,
                         plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                         ops=ops, bytes=nbytes, pair_stats=stats,
                         sqrt_share=pass_share, sqrt_share_warp=warp_share)
        log(f"phase 3 K1 {mode}: N={n} C2={c2} candidates={nc} "
            f"moving={rows} bit-equal on all {n} rows, "
            f"max_abs_err={max_err} kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"bound_ms={b_ms:.5f} ({b_by}, {ops / 1e9:.3f} GOP) "
            f"pairs={stats['pairs']} sqrt_share={pass_share:.4f} "
            f"(of 32-candidate slots {warp_share:.4f}) inside_share="
            f"{stats['inside'] / max(stats['pairs'], 1):.4f}")
    return out


def reset_counts():
    from permafrost_engine_tpu_torch.ops import crowd_cuda, flowfield_cuda

    flowfield_cuda.launches_chunk = 0
    flowfield_cuda.launches_map = 0
    crowd_cuda.launches = 0


def read_counts() -> dict:
    from permafrost_engine_tpu_torch.ops import crowd_cuda, flowfield_cuda

    return dict(k1=crowd_cuda.launches, k2_chunk=flowfield_cuda.launches_chunk,
                k2_map=flowfield_cuda.launches_map)


def phase_slice(dev):
    from permafrost_engine_tpu_torch import FRAME_HZ
    from permafrost_engine_tpu_torch.ops import flowfield_cuda

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    eng, a, b, goals = build_battle(dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    k2_move = flowfield_cuda.launches_chunk
    chunks = eng.nav.stats["chunks_built"]
    sa = torch.as_tensor([eng.uid_to_slot[u] for u in a], device=dev)
    sb = torch.as_tensor([eng.uid_to_slot[u] for u in b], device=dev)

    def mean_dist():
        p = eng.state.ents.pos
        ga = torch.tensor(goals["a"], device=dev)
        gb = torch.tensor(goals["b"], device=dev)
        return (float(torch.linalg.vector_norm(p[sa] - ga, dim=1).mean()),
                float(torch.linalg.vector_norm(p[sb] - gb, dim=1).mean()))

    d0 = mean_dist()
    period = FRAME_HZ // eng.cfg.move_hz
    frame_s, sub_s = [], []
    for _ in range(FRAMES):
        torch.cuda.synchronize()
        t = time.perf_counter()
        eng.step(1)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        frame_s.append(dt)
        if eng.state.tick % period == 0:
            sub_s.append(dt)
    counts = read_counts()
    k1 = counts["k1"]
    d1 = mean_dist()
    e = eng.state.ents
    check(bool(torch.isfinite(e.pos).all() and torch.isfinite(e.vel).all()),
          "no NaN in pos/vel")
    check(counts["k2_chunk"] > 0, "K2 launched on the main path")
    check(k1 == len(sub_s) and k1 > 0, f"K1 launches {k1} == substeps {len(sub_s)}")
    check(d1[0] < d0[0] and d1[1] < d0[1], f"armies closed on goals {d0} -> {d1}")
    res = dict(setup_s=setup_s, k2_launches_move=k2_move, chunks_built=chunks,
               counts=counts, substeps=len(sub_s),
               ms_per_frame=1e3 * sum(frame_s) / FRAMES,
               ms_per_substep=1e3 * sum(sub_s) / len(sub_s),
               ms_per_other_frame=1e3 * (sum(frame_s) - sum(sub_s))
               / max(FRAMES - len(sub_s), 1),
               max_memory_allocated=torch.cuda.max_memory_allocated(),
               mean_goal_dist_before=d0, mean_goal_dist_after=d1)
    log(f"phase 4 slice: {2 * N_PER_SIDE} units, {FRAMES} frames, "
        f"setup_s={setup_s:.3f} k2_launches_during_move={k2_move} "
        f"chunks_built={chunks} launches={counts} substeps={len(sub_s)} "
        f"ms_per_frame={res['ms_per_frame']:.4f} "
        f"ms_per_substep={res['ms_per_substep']:.4f} "
        f"max_memory_allocated={res['max_memory_allocated']} "
        f"goal_dist a {d0[0]:.1f}->{d1[0]:.1f} b {d0[1]:.1f}->{d1[1]:.1f}")
    return res


def _timed_substeps(times: dict):
    """Wrap the tick's substep functions (looked up at call time) so each
    call is bracketed by synchronizations; returns a restore function."""
    from permafrost_engine_tpu_torch.game import step
    from permafrost_engine_tpu_torch.ops import combat, projectile

    targets = [(step, "movement_substep", "movement"),
               (step, "combat_substep", "combat"),
               (projectile, "projectile_substep", "projectile"),
               (combat, "corpse_substep", "corpse"),
               (step, "fog_substep", "fog")]
    saved = []
    for mod, attr, kind in targets:
        fn = getattr(mod, attr)
        saved.append((mod, attr, fn))

        def timed(*args, _fn=fn, _kind=kind):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = _fn(*args)
            torch.cuda.synchronize()
            times.setdefault(_kind, []).append(time.perf_counter() - t)
            return out

        setattr(mod, attr, timed)

    def restore():
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
    return restore


def record_drains(eng) -> list:
    """Wrap the engine's drain: (frame, events it emitted) of every drain
    that emitted any."""
    log = []
    drain = eng._drain

    def recorded(h):
        n0 = len(eng.events)
        drain(h)
        if len(eng.events) > n0:
            log.append((eng._frame, tuple((k, tuple(sorted(p.items())))
                                          for k, p in eng.events[n0:])))
    eng._drain = recorded
    return log


def synced_call(fn, *args) -> float:
    """Host seconds of fn(*args) between two synchronizations."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn(*args)
    torch.cuda.synchronize()
    return time.perf_counter() - t


def graph_summary(eng) -> dict:
    """The engine's CUDA graph cache: captures, capture ms, replays, and
    the kernel launches one replay of each segment (k frames from frame
    f mod 60) makes."""
    g = eng._scan_fn
    names = {"crowd_cuda.launches": "k1", "flowfield_cuda.launches_chunk":
             "k2_chunk", "flowfield_cuda.launches_map": "k2_map"}
    return dict(g.stats, keys=len(g.launches), launches_per_segment={
        f"k{k}@{f}": {names[n]: v for n, v in c.items() if v}
        for (k, f), c in sorted(g.launches.items())})


def war_run(dev, micro: bool):
    """The battle at war in `WAR_WINDOW`-frame ``step`` calls, per frame
    (``micro_batching=False``) or micro-batched through CUDA graphs: to the
    first drained death, then `CONTACT_FRAMES` more. Returns the engine
    and the run's numbers (digests at first death and at the end, the
    drains with their frames, ms per frame)."""
    from permafrost_engine_tpu_torch import FRAME_HZ

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    eng, _a, _b, _goals = build_battle(dev, war=True)
    eng.micro_batching = micro
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    drains = record_drains(eng)
    march = []
    while not any(k == "entity_death" for k, _ in eng.events):
        check(eng._frame < WAR_MAX_FRAMES,
              f"no death within {WAR_MAX_FRAMES} frames at war")
        march.append(synced_call(eng.step, WAR_WINDOW))
    death = dict(frame=eng._frame, digest=state_digest(eng))
    contact = [synced_call(eng.step, WAR_WINDOW)
               for _ in range(CONTACT_FRAMES // WAR_WINDOW)]
    counts = read_counts()
    substeps = eng.state.tick // (FRAME_HZ // eng.cfg.move_hz)
    check(counts["k1"] == substeps and substeps > 0,
          f"K1 launches {counts['k1']} == substeps {substeps} "
          f"({'graphed' if micro else 'per frame'})")
    drains = list(drains)    # the engine steps on after this run
    log_hash = hashlib.sha256(repr(drains).encode()).hexdigest()[:16]
    return eng, dict(
        setup_s=setup_s, death=death, end_digest=state_digest(eng),
        drains=len(drains), drained_events=sum(len(e) for _, e in drains),
        drain_frames=[f for f, _ in drains], drain_log_sha=log_hash,
        log=drains, counts=counts, substeps=substeps,
        ms_per_frame_march=1e3 * sum(march) / (WAR_WINDOW * len(march)),
        ms_per_frame_contact=1e3 * sum(contact) / CONTACT_FRAMES,
        max_memory_allocated=torch.cuda.max_memory_allocated())


def phase_war(dev):
    """The battle at war, twice from the same spawn: per frame, then
    micro-batched through CUDA graphs; both must print the same digests
    and drain the same events at the same frames. The per-frame engine
    then runs the per-substep split and the chase-field rebuild; the
    graphed one `step_scan` windows at contact (see the module
    docstring)."""
    from permafrost_engine_tpu_torch import FogState

    eager, er = war_run(dev, micro=False)
    sub_s: dict = {}
    restore = _timed_substeps(sub_s)
    try:
        for _ in range(SUBSTEP_FRAMES):
            eager.step(1)
    finally:
        restore()
    eager_counts = read_counts()

    def count(kind):
        return sum(1 for k, _ in eager.events if k == kind)

    e = eager.state.ents
    check(bool(torch.isfinite(e.pos).all() and torch.isfinite(e.vel).all()
               and not torch.isnan(e.hp).any()), "no NaN in pos/vel/hp")
    check(eager_counts["k1"] == eager.state.tick // 3,
          f"K1 launches {eager_counts['k1']} == substeps")
    check(eager_counts["k2_chunk"] > 0,
          f"K2 launched for chunks at war: {eager_counts}")
    check(eager_counts["k2_map"] > 0,
          f"K2 launched for the whole-map chase fields at war: {eager_counts}")
    ev = {k: count(k) for k in ("entity_death", "attack_start",
                                "projectile_hit", "entity_removed")}
    for k in ("entity_death", "attack_start", "projectile_hit"):
        check(ev[k] > 0, f"{k} events at war: {ev}")
    chase = eager.state.factions.chase_slot.cpu().numpy()
    check(chase[0].max() >= 0 and chase[1].max() >= 0,
          f"each faction holds a chase field: {chase[:2].tolist()}")
    fog = eager.state.fog.state
    visible = [int((fog[f] == FogState.VISIBLE).sum()) for f in (0, 1)]
    check(min(visible) > 0, f"each faction sees VISIBLE fog tiles: {visible}")
    check(eager._tile_height is not None, "the battle map has fog heights")

    # the chase-field rebuild through K2, alone, on the live state
    specs = [(f, lay, slot, None)
             for (f, lay), slot in sorted(eager._chase_gslot.items())]
    seek = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        eager.state = eager.nav.build_enemy_seek_fields_batch(eager.state, specs)
        torch.cuda.synchronize()
        seek.append(time.perf_counter() - t)
    counters = dict(eager.counters)
    nav_stats = dict(eager.nav.stats)
    del eager, e, fog
    torch.cuda.empty_cache()

    graphed, gr = war_run(dev, micro=True)
    check(gr["death"] == er["death"] and gr["end_digest"] == er["end_digest"],
          f"graphed run digests {gr['death']}, {gr['end_digest']} equal the "
          f"per-frame run's {er['death']}, {er['end_digest']}")
    check(gr["log"] == er["log"], "graphed and per-frame runs drain the "
          "same events at the same frames")
    # bench.py's measure_phase(scan=True): three windows (the first also
    # captures the 30-frame segments), their median
    scan = [synced_call(graphed.step_scan, SCAN_WINDOW) for _ in range(3)]
    graph_counts = read_counts()
    check(graph_counts["k1"] == graphed.state.tick // 3,
          f"K1 launches {graph_counts['k1']} == substeps after step_scan")
    e = graphed.state.ents
    check(bool(torch.isfinite(e.pos).all() and torch.isfinite(e.vel).all()),
          "no NaN in pos/vel after step_scan")
    graphs = graph_summary(graphed)
    check(graphs["replays"] > 0 and graphs["captures"] > 0,
          f"the graphed run replayed CUDA graphs: {graphs}")
    for r in (er, gr):
        r.pop("log")
    res = dict(
        per_frame=er, graphed=gr, graphs=graphs,
        ms_per_frame_scan=1e3 * float(np.median(scan)) / SCAN_WINDOW,
        scan_windows_s=scan,
        ms_per_substep_contact={k: 1e3 * sum(v) / len(v)
                                for k, v in sub_s.items()},
        substep_calls={k: len(v) for k, v in sub_s.items()},
        seek_build_ms=[1e3 * x for x in seek], seek_build_fields=len(specs),
        seek_batches=nav_stats["seek_batches"],
        seek_fields=nav_stats["seek_fields"], counters=counters, events=ev,
        counts={k: eager_counts[k] + graph_counts[k] for k in eager_counts},
        visible_tiles=visible, chase_slots=chase[:2].tolist())
    for name, r in (("per frame", er), ("graphed", gr)):
        log(f"phase 5 war ({name}): {2 * N_PER_SIDE} units, setup_s="
            f"{r['setup_s']:.3f}, first death drained at frame "
            f"{r['death']['frame']}, digest {r['death']['digest']}, at the end "
            f"(frame {r['death']['frame'] + CONTACT_FRAMES}) {r['end_digest']}; "
            f"{r['drains']} drains ({r['drained_events']} events, log sha "
            f"{r['drain_log_sha']}, frames {r['drain_frames'][:4]}...); "
            f"ms_per_frame march={r['ms_per_frame_march']:.4f} contact="
            f"{r['ms_per_frame_contact']:.4f}; launches={r['counts']} "
            f"(k1 = substeps {r['substeps']}); max_memory_allocated="
            f"{r['max_memory_allocated']}")
    log(f"phase 5 graphed = per frame: digests and drains equal; step_scan"
        f"({SCAN_WINDOW}) at contact ms_per_frame={res['ms_per_frame_scan']:.4f} "
        f"(median; windows s " + ",".join(f"{x:.3f}" for x in scan) + "); "
        f"graphs: captures={graphs['captures']} capture_ms="
        f"{graphs['capture_ms']:.1f} replays={graphs['replays']} keys="
        f"{graphs['keys']}; launches per segment "
        + " ".join(f"{k}:{v}" for k, v in graphs["launches_per_segment"].items()
                   if v))
    log("phase 5 substeps at contact (ms, sync-bracketed, per frame): " + " ".join(
        f"{k}={v:.4f}x{res['substep_calls'][k]}"
        for k, v in res["ms_per_substep_contact"].items())
        + f"; events={ev}")
    log(f"phase 5 chase-field rebuild (K2, 256x256): {len(specs)} fields, ms="
        + ",".join(f"{x:.3f}" for x in res["seek_build_ms"])
        + f"; batches={res['seek_batches']} fields={res['seek_fields']}")
    log("phase 5 cadence counters (ms, per frame run): " + " ".join(
        f"{k}={v:.3f}" for k, v in counters.items()))
    return res


@contextlib.contextmanager
def patched(*targets):
    """Replace each (object, attribute, make) attribute by make(original)
    for the block's duration."""
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in targets]
    for obj, name, make in targets:
        setattr(obj, name, make(getattr(obj, name)))
    try:
        yield
    finally:
        for obj, name, fn in saved:
            setattr(obj, name, fn)


def synced(times: dict, key: str, fn):
    """fn, with each call's host time between two synchronizations added to
    times[key] (seconds)."""
    def run(*args, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        times[key] = times.get(key, 0.0) + time.perf_counter() - t
        return out
    return run


class K2Capture:
    """Keeps the inputs and output of the first K2 call made while a label
    is armed (``arm``), to hold K2 against its plain version on the path's
    own inputs."""

    def __init__(self):
        self.armed = None
        self.calls = {}

    def wrap(self, fn):
        def integrate(cost, seed_mask, seed_cost=None, *, max_iters=None):
            out = fn(cost, seed_mask, seed_cost, max_iters=max_iters)
            if self.armed is not None and self.armed not in self.calls:
                self.calls[self.armed] = (
                    cost.clone(), seed_mask.clone(),
                    None if seed_cost is None else seed_cost.clone(),
                    max_iters, out.clone())
            return out
        return integrate

    def arm(self, label, fn):
        def run(*args, **kw):
            self.armed = label
            try:
                return fn(*args, **kw)
            finally:
                self.armed = None
        return run

    def check(self, label) -> dict:
        from permafrost_engine_tpu_torch.ops.flowfield import integrate_plain

        check(label in self.calls, f"K2 inputs of the {label} captured")
        cost, seed, seed_cost, max_iters, got = self.calls[label]
        k, h, w = cost.shape
        want = integrate_plain(cost, seed, seed_cost,
                               max_iters=max_iters or 4 * max(h, w))
        torch.cuda.synchronize()
        finite = want < 1e30
        err = float((got - want)[finite].abs().max()) if finite.any() else 0.0
        check(torch.equal(got, want),
              f"K2 on the {label}'s inputs: bit-equal (max err {err})")
        return dict(k=k, h=h, w=w, max_abs_err=err)


def spawn_combined(eng):
    """bench.py's build_battle(5000, terrain=True, full=True) spawns (rng
    seed 0), per side: a ground corps of 3,200 melee, 1,000 archers and
    160 radius-2.5 siege (the 3x3-footprint layer), 384 navy on the water
    layer and 256 air."""
    from permafrost_engine_tpu_torch.core.config import NavDomain

    rng = np.random.default_rng(0)
    n_melee = int(N_PER_SIDE * 0.64)
    n_arch = int(N_PER_SIDE * 0.20)
    n_siege = int(N_PER_SIDE * 0.032)
    n_navy = int(N_PER_SIDE * 0.0768)
    n_air = N_PER_SIDE - n_melee - n_arch - n_siege - n_navy

    def side(f, x_inf, x_siege, x_air, navy_z0):
        archer = np.arange(n_melee + n_arch) >= n_melee
        inf = eng.spawn_batch(
            block(rng, x_inf, 212.0, n_melee + n_arch, 25), faction=f,
            max_speed=20.0, is_ranged=archer,
            attack_range=np.where(archer, 40.0, 5.0), vision_range=80.0,
            hp=200.0)
        siege = eng.spawn_batch(
            block(rng, x_siege, 380.0, n_siege, 8, dx=7.0, dz=7.0), faction=f,
            radius=2.5, max_speed=10.0, is_ranged=True, attack_range=50.0,
            base_dmg=30.0, vision_range=90.0, hp=400.0)
        navy = eng.spawn_batch(
            block(rng, 452.0, navy_z0, n_navy, 8), faction=f,
            domain=NavDomain.WATER, radius=1.5, max_speed=24.0,
            is_ranged=True, attack_range=45.0, base_dmg=15.0,
            vision_range=90.0, hp=300.0)
        air = eng.spawn_batch(
            block(rng, x_air, 420.0, n_air, 16), faction=f,
            domain=NavDomain.AIR, radius=1.2, max_speed=32.0, is_ranged=True,
            attack_range=30.0, vision_range=100.0, hp=150.0)
        return dict(inf=inf, siege=siege, navy=navy, air=air)

    return (side(0, x_inf=200.0, x_siege=160.0, x_air=120.0, navy_z0=400.0),
            side(1, x_inf=820.0, x_siege=930.0, x_air=880.0, navy_z0=560.0))


# bench.py's place_midfight_structures: six radius-10 buildings at the chokes
STRUCTURE_SPOTS = np.array([[356.0, 280.0], [356.0, 744.0], [470.0, 330.0],
                            [470.0, 700.0], [590.0, 512.0], [420.0, 512.0]],
                           np.float32)
STRUCTURE_RADIUS = 10.0


def check_formation(eng, corps: list[int]) -> dict:
    """Every unit of a corps holds a cell; per (layer, unit type) block the
    cells are distinct and lie on passable tiles of the layer; the corps'
    flocks are RANK formations."""
    from permafrost_engine_tpu_torch import COST_IMPASSABLE
    from permafrost_engine_tpu_torch.core.config import NAV_TILE_SIZE
    from permafrost_engine_tpu_torch.game.formation import FormationType

    e = eng.state.ents
    slots = np.array([eng.uid_to_slot[u] for u in corps])
    check(bool(e.has_formation_cell[torch.as_tensor(slots)].all()),
          "every corps unit has a formation cell")
    cells = e.formation_cell.cpu().numpy()[slots]
    layers = e.layer.cpu().numpy()[slots]
    types = np.array([eng.unit_type[u][1] for u in corps])
    blocks = {}
    for key in sorted(set(zip(layers.tolist(), types.tolist()))):
        sel = (layers == key[0]) & (types == key[1])
        c = cells[sel]
        check(len(np.unique(c, axis=0)) == len(c),
              f"block {key}: {len(c)} distinct cells")
        r = (c[:, 1] // NAV_TILE_SIZE).astype(int)
        k = (c[:, 0] // NAV_TILE_SIZE).astype(int)
        check(bool((eng.nav.cost_base[key[0]][r, k] != COST_IMPASSABLE).all()),
              f"block {key}: cells on passable tiles of layer {key[0]}")
        blocks[f"layer{key[0]}_type{key[1]}"] = int(sel.sum())
    fids = np.unique(e.flock.cpu().numpy()[slots])
    check(bool((fids >= 0).all()) and bool(
        (eng.state.flocks.formation.cpu().numpy()[fids]
         == int(FormationType.RANK)).all()),
          f"the corps' flocks {fids.tolist()} are RANK formations")
    return blocks


def check_structures(eng, rects) -> None:
    """cost_base impassable over every footprint on the ground and water
    layers, the terrain's on the air layers (device copy and host mirror)."""
    from permafrost_engine_tpu_torch import COST_IMPASSABLE
    from permafrost_engine_tpu_torch.core.config import NUM_FOOTPRINTS, NavDomain

    cost = eng.state.nav.cost_base.cpu().numpy()
    check(np.array_equal(cost, eng.nav.cost_base), "cost_base pushed")
    air0 = int(NavDomain.AIR) * NUM_FOOTPRINTS
    for r0, r1, c0, c1 in rects:
        fp = cost[:air0, r0:r1 + 1, c0:c1 + 1]
        check(bool((fp == COST_IMPASSABLE).all()),
              f"footprint {(r0, r1, c0, c1)} impassable on ground and water")
    check(np.array_equal(cost[air0:], eng.nav.terrain_cost[air0:]),
          "air layers keep the terrain cost")


def state_digest(eng) -> str:
    """The first 16 hex digits of the SHA-256 of every slot's position and
    velocity bits: equal across runs when the battle is reproducible."""
    e = eng.state.ents
    data = torch.cat([e.pos, e.vel], dim=1).cpu().numpy().tobytes()
    return hashlib.sha256(data).hexdigest()[:16]


def check_keep_force_repeats(eng, evals: int = 8) -> int:
    """The formation keep force (per-flock sums over a 4,360-unit corps)
    evaluated ``evals`` times on the live state must be bit-equal: its sums
    must not depend on the order the card adds them in."""
    from permafrost_engine_tpu_torch.ops.boids import formation_keep_force

    e, f = eng.state.ents, eng.state.flocks
    args = (e.pos, e.vel, e.flock, e.formation_cell, e.has_formation_cell,
            f.formation, eng.cfg.max_flocks)
    outs = [formation_keep_force(*args).view(torch.int32) for _ in range(evals)]
    check(bool((outs[0] != 0).any()), "the keep force acts on the march")
    check(all(torch.equal(o, outs[0]) for o in outs[1:]),
          f"the formation keep force is bit-equal over {evals} evaluations")
    return evals


def clip_counts(eng) -> list[int]:
    """Living slots per clip (idle, run, attack, die)."""
    e, anim = eng.state.ents, eng.state.anim
    return torch.bincount(anim.clip[e.alive].long(), minlength=4).tolist()


def palette_digest(eng) -> str:
    """The first 16 hex digits of the SHA-256 of every palette's bits."""
    data = eng.state.anim.palettes.cpu().numpy().tobytes()
    return hashlib.sha256(data).hexdigest()[:16]


def fps(windows: list[float]) -> float:
    """bench.py's measure_phase: the median of the windows' frame rates."""
    return float(np.median([BENCH_WINDOW / w for w in windows]))


def phase_combined(dev):
    """The combined-arms battle (BASELINE #5, bench.py's build_battle(5000,
    terrain=True, full=True) with skin_joints=32, driven as run_battle
    drives it, with place_midfight_structures) through the port's Engine:
    see the module docstring."""
    from permafrost_engine_tpu_torch import DiplomacyState, EngineConfig, FRAME_HZ
    from permafrost_engine_tpu_torch.assets.mapgen import make_battle_map
    from permafrost_engine_tpu_torch.core.config import EntityFlags
    from permafrost_engine_tpu_torch.game import engine as engine_mod
    from permafrost_engine_tpu_torch.game.engine import Engine
    from permafrost_engine_tpu_torch.game.formation import FormationType
    from permafrost_engine_tpu_torch.nav import portals, service
    from permafrost_engine_tpu_torch.ops import flowfield_cuda
    from permafrost_engine_tpu_torch.ops.skin import (
        CLIP_DIE, CLIP_RUN, skin_substep)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    cap = K2Capture()
    t0 = time.perf_counter()
    cfg = EngineConfig(max_ents=2 * N_PER_SIDE + 256, skin_joints=32)  # bench.py:63
    eng = Engine(cfg, device=dev)
    check(eng.micro_batching, "phase 6 steps micro-batched")
    eng.load_map_data(make_battle_map())
    eng.add_faction(0)
    eng.add_faction(1)
    eng.set_diplomacy(0, 1, DiplomacyState.WAR)
    a, b = spawn_combined(eng)
    n0 = int(eng.state.ents.alive.sum())
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    commits = []

    def timed_commit(fn):
        """Time the commits that have stamps to apply (the others are
        host-only no-ops and stay unsynchronized)."""
        def run():
            if not eng.nav._pending_dirty:
                return fn()
            k2 = flowfield_cuda.launches_chunk
            commits.append(dict(s=synced_call(fn),
                                k2_chunk=flowfield_cuda.launches_chunk - k2))
        return run

    with patched((service, "integrate", cap.wrap),
                 (portals, "integrate", cap.wrap),
                 (portals, "update_portal_graph",
                  lambda fn: cap.arm("structure relink", fn)),
                 (eng, "_commit_nav", timed_commit)):
        # -- the orders: two formation moves, navies and air squadrons -------
        orders = []
        for side, goal in ((a, (820.0, 512.0)), (b, (200.0, 512.0))):
            times, blocks = {}, []

            def auction(fn, _blocks=blocks):
                def run(units, cells, *, device, stats=None):
                    st = {}
                    t = time.perf_counter()
                    out = fn(units, cells, device=device, stats=st)
                    _blocks.append(dict(bidders=len(units), cells=len(cells),
                                        rounds=st["rounds"],
                                        greedy=st["greedy"],
                                        s=time.perf_counter() - t))
                    return out
                return run

            install = synced(times, "install", eng.nav.install_formation_field)
            if not orders:
                install = cap.arm("formation install", install)
            k2 = flowfield_cuda.launches_chunk
            with patched((engine_mod, "layout_cells",
                          lambda fn: synced(times, "layout", fn)),
                         (engine_mod, "assign_cells",
                          lambda fn: synced(times, "auction", auction(fn))),
                         (eng.nav, "install_formation_field",
                          lambda fn, _i=install: _i)):
                ok = synced(times, "total", eng.move_in_formation)(
                    side["inf"] + side["siege"], goal, FormationType.RANK)
            check(ok, "formation order laid cells")
            k2_order = flowfield_cuda.launches_chunk - k2
            check(k2_order > 0, f"K2 launched for chunks during the "
                  f"formation order ({k2_order})")
            blocks_n = check_formation(eng, side["inf"] + side["siege"])
            orders.append(dict(s=times, blocks=blocks, k2_chunk=k2_order,
                               cells_per_block=blocks_n))
        check(eng.move(a["navy"], (468.0, 620.0)), "navy a order")
        check(eng.move(b["navy"], (468.0, 404.0)), "navy b order")
        check(eng.move(a["air"], (900.0, 512.0)), "air a order")
        check(eng.move(b["air"], (140.0, 512.0)), "air b order")
        formation_k2 = cap.check("formation install")

        # -- the march: a warm-up second, then timed step() windows ----------
        warmup_s = synced_call(eng.step, BENCH_WARMUP)
        march = [synced_call(eng.step, BENCH_WINDOW)
                 for _ in range(BENCH_WINDOWS)]
        clips_march = clip_counts(eng)
        check(clips_march[CLIP_RUN] > 0, f"RUN clips on the march: {clips_march}")
        keep_evals = check_keep_force_repeats(eng)
        digest_march = state_digest(eng)
        march_frame = eng._frame

        # -- step_scan to first blood (bench's fast_forward_until) and on -----
        ff = []
        while True:
            check(eng._frame < march_frame + WAR_MAX_FRAMES,
                  f"no corpse removed within {WAR_MAX_FRAMES} scan frames")
            ff.append(synced_call(eng.step_scan, FF_CHUNK))
            if int(eng.state.ents.alive.sum()) < n0:
                break
        first_blood = eng._frame

        # -- at first blood: seek and surround orders ------------------------
        live = [u for u in a["air"] if u in eng.uid_to_slot]
        pack = [u for u in b["air"] if u in eng.uid_to_slot]
        target = a["siege"][0]
        check(target in eng.uid_to_slot, "the surround target lives")
        k2_map = flowfield_cuda.launches_map
        seek_ms = 1e3 * synced_call(eng.seek_enemies, live)
        surround_ms = 1e3 * synced_call(eng.surround, pack, target)
        check(flowfield_cuda.launches_map > k2_map,
              "K2 launched for whole maps by the orders")
        seek_fid = int(eng.state.ents.flock[eng.uid_to_slot[live[0]]])
        sur_fid = int(eng.state.ents.flock[eng.uid_to_slot[pack[0]]])
        check(seek_fid in eng._seek_flocks
              and int(eng.state.flocks.global_slot[seek_fid]) >= 0,
              "the seek flock holds a whole-map field")
        sur_slots = torch.as_tensor([eng.uid_to_slot[u] for u in pack],
                                    device=dev)
        tslot = eng.uid_to_slot[target]

        def surround_dist():
            p = eng.state.ents.pos
            return float(torch.linalg.vector_norm(p[sur_slots] - p[tslot],
                                                  dim=1).mean())

        d0 = surround_dist()
        ff.append(synced_call(eng.step_scan, FF_CHUNK))

        # -- the buildings drop at the chokes (place_midfight_structures) ----
        sid = eng.spawn_batch(
            STRUCTURE_SPOTS, faction=0, radius=STRUCTURE_RADIUS,
            flags=int(EntityFlags.COLLISION | EntityFlags.BUILDING),
            max_speed=0.0, hp=1000.0)
        for u in sid:
            eng.set_structure_blocking(u, True)
        rects = [eng._structures[u] for u in sid]
        ver, rebuilt = eng._nav_version, eng.nav.stats["chunks_rebuilt"]

        # -- contact: step() windows, then step_scan() windows ---------------
        contact, clips_contact = [], []
        for _ in range(BENCH_WINDOWS):
            contact.append(synced_call(eng.step, BENCH_WINDOW))
            clips_contact.append(clip_counts(eng))
        check(eng._nav_version > ver and commits,
              f"the structure commit bumped _nav_version ({len(commits)})")
        check(eng.nav.stats["chunks_rebuilt"] > rebuilt,
              f"chunks relinked: {eng.nav.stats['chunks_rebuilt']}")
        check(commits[0]["k2_chunk"] > 0,
              f"K2 launched for chunks at the commit ({commits[0]})")
        check_structures(eng, rects)
        relink_k2 = cap.check("structure relink")
        contact_scan = []
        for _ in range(BENCH_WINDOWS):
            contact_scan.append(synced_call(eng.step_scan, BENCH_WINDOW))
            clips_contact.append(clip_counts(eng))
        d1 = surround_dist()
    counts = read_counts()
    e, anim = eng.state.ents, eng.state.anim
    check(bool(torch.isfinite(e.pos).all() and torch.isfinite(e.vel).all()
               and not torch.isnan(e.hp).any()), "no NaN in pos/vel/hp")
    substeps = eng.state.tick // (FRAME_HZ // cfg.move_hz)
    check(counts["k1"] == substeps and substeps > 0,
          f"K1 launches {counts['k1']} == substeps {substeps}")
    check(d1 < d0, f"the surround flock closed on its target {d0} -> {d1}")
    check(bool(torch.isfinite(anim.palettes).all()), "palettes are finite")
    check(int(anim.tick) == eng.state.tick, "anim.tick follows the frame")
    # DIE after the contact windows; the ATTACK clip stays unused, as in the
    # JAX package, whose combat FSM never enters ATTACK_ANIM
    check(max(c[CLIP_DIE] for c in clips_contact) > 0,
          f"DIE clips after the contact windows: {clips_contact}")
    digest_end = state_digest(eng)
    pal_digest = palette_digest(eng)
    ev = {k: sum(1 for kk, _ in eng.events if kk == k)
          for k in ("entity_death", "attack_start", "projectile_hit",
                    "entity_removed")}
    for k in ("entity_death", "attack_start", "projectile_hit"):
        check(ev[k] > 0, f"{k} events: {ev}")
    # the skin stage alone at 10,256 x 32, on a copy of the arena
    scratch = types.SimpleNamespace(ents=e, anim=copy.deepcopy(anim))
    skin_ms = cuda_ms(lambda: skin_substep(cfg, eng._skin_bank, scratch), 10)
    graphs = graph_summary(eng)
    res = dict(
        setup_s=setup_s, orders=orders, formation_k2=formation_k2,
        relink_k2=relink_k2, commits=commits,
        chunks_rebuilt=eng.nav.stats["chunks_rebuilt"],
        invalidations=eng.nav.stats["invalidations"],
        warmup_s=warmup_s, march_s=march, ff_s=ff, contact_s=contact,
        contact_scan_s=contact_scan, fps_march=fps(march),
        fps_contact=fps(contact), fps_contact_scan=fps(contact_scan),
        first_blood_frame=first_blood, frames=eng._frame,
        seek_order_ms=seek_ms, surround_order_ms=surround_ms,
        seek_fid=seek_fid, surround_fid=sur_fid,
        surround_dist=[d0, d1], events=ev, counts=counts, substeps=substeps,
        keep_force_evals=keep_evals, digest_march=digest_march,
        digest_end=digest_end, palette_digest=pal_digest,
        clips_march=clips_march, clips_contact=clips_contact,
        skin_stage_ms=skin_ms, graphs=graphs,
        counters=dict(eng.counters), nav_stats=dict(eng.nav.stats),
        max_memory_allocated=torch.cuda.max_memory_allocated())
    for side, o in zip("ab", orders):
        s = o["s"]
        log(f"phase 6 formation order {side}: total_s={s['total']:.3f} "
            f"(layout {s['layout']:.3f}, auction {s['auction']:.3f}, install "
            f"{s['install']:.3f}, the move and the rest "
            f"{s['total'] - s['layout'] - s['auction'] - s['install']:.3f}) "
            "blocks " + "; ".join(
                f"bidders={x['bidders']} cells={x['cells']} s={x['s']:.3f} "
                f"rounds={x['rounds']} greedy_fallback={x['greedy'] > 0} "
                f"(units {x['greedy']})"
                for x in o["blocks"]) + f" k2_chunk={o['k2_chunk']}")
    log(f"phase 6 combined arms: {eng.cfg.max_ents} slots, skin_joints=32, "
        f"micro-batched; setup_s={setup_s:.3f}; K2 bit-equal to plain on the "
        f"first formation install (K={formation_k2['k']}) and the structure "
        f"relink (K={relink_k2['k']}); first blood (a corpse removed) by "
        f"frame {first_blood}; structure commit {1e3 * commits[0]['s']:.3f} ms "
        f"(K2 chunk launches {commits[0]['k2_chunk']}, chunks_rebuilt="
        f"{res['chunks_rebuilt']}); {eng._frame} frames")
    log(f"phase 6 bench.py's sense: fps_march={res['fps_march']:.2f} "
        f"fps_contact={res['fps_contact']:.2f} "
        f"fps_contact_scan={res['fps_contact_scan']:.2f} (median of "
        f"{BENCH_WINDOWS} windows of {BENCH_WINDOW} frames; windows s march "
        + ",".join(f"{x:.3f}" for x in march) + " contact "
        + ",".join(f"{x:.3f}" for x in contact) + " scan "
        + ",".join(f"{x:.3f}" for x in contact_scan)
        + f"; step_scan({FF_CHUNK}) s " + ",".join(f"{x:.3f}" for x in ff)
        + f"); seek order {seek_ms:.3f} ms, surround order {surround_ms:.3f} "
        f"ms; launches={counts} (k1 = substeps {substeps}), events={ev}; "
        f"max_memory_allocated={res['max_memory_allocated']}")
    log(f"phase 6 skinning: skin stage {skin_ms:.4f} ms at "
        f"{cfg.max_ents} x 32 joints; clips (idle, run, attack, die) march "
        f"{clips_march}, after each contact window {clips_contact}; palette "
        f"digest {pal_digest}")
    log(f"phase 6 determinism: formation keep force bit-equal over "
        f"{keep_evals} evaluations; pos/vel digest at frame {march_frame} "
        f"{digest_march}, at the end {digest_end}; projectile hits "
        f"{ev['projectile_hit']}, surround distance {d0!r}->{d1!r}")
    log(f"phase 6 graphs: captures={graphs['captures']} capture_ms="
        f"{graphs['capture_ms']:.1f} replays={graphs['replays']} keys="
        f"{graphs['keys']}")
    log("phase 6 cadence counters (ms): " + " ".join(
        f"{k}={v:.3f}" for k, v in res["counters"].items()))
    return res


# phase 7: an economy at war, with live tasks, a pause and a session
ECO_PER_SIDE = 4800          # army units per side, as phase 5's blocks
ECO_MAX_FRAMES = 2400        # the tasks must all end within this
PAUSE_AT, PAUSE_FRAMES = 180, 30
DEATHS_PER_WATCHER = 10


def spawn_economy(eng, f: int, back_x: float, inward: float) -> dict:
    """One side's economy behind its army, at x = back_x + inward * offset
    (offsets 0-80 world units): 4 replenishable Wood nodes and 4 Stone
    nodes of 400, 16 harvesters (alternately ordered to a Wood and a Stone
    node, every one registered with the animation system), 2 storage
    sites, a founded and supplied building with 2 builders, a garrison
    tower (capacity 4) and a transport carrying 4 scouts to it."""
    from permafrost_engine_tpu_torch.core.config import EntityFlags as F
    from permafrost_engine_tpu_torch.game import economy as E

    eco = eng.economy

    def at(off, z):
        return np.array([[back_x + inward * off, z]], np.float32)

    def one(off, z, **kw):
        return eng.spawn_batch(at(off, z), faction=f, **kw)[0]

    nodes = []
    for i, z in enumerate(np.linspace(150.0, 870.0, 8)):
        r = one(0.0, z, flags=int(F.RESOURCE), max_speed=0.0)
        eco.resources[r] = (E.ResourceComp("Wood", 300, 300, True, 3)
                            if i % 2 == 0 else E.ResourceComp("Stone", 400, 400))
        nodes.append(r)
    stores = []
    for z in (330.0, 690.0):
        s = one(55.0, z, flags=int(F.STORAGE_SITE), max_speed=0.0, radius=3.0)
        eco.storages[s] = E.StorageComp(capacity={"Wood": 10000,
                                                  "Stone": 10000})
        stores.append(s)
    harvesters = []
    for i, z in enumerate(np.linspace(170.0, 850.0, 16)):
        h = one(25.0, z, max_speed=60.0)
        eco.harvesters[h] = E.HarvesterComp(
            gather_speeds={"Wood": 5, "Stone": 5},
            max_carry={"Wood": 20, "Stone": 20})
        eng.anim.register(h, model="worker")
        harvesters.append(h)
    building = one(40.0, 510.0, flags=int(F.BUILDING | F.COLLISION),
                   radius=4.0, max_speed=0.0, hp=500.0)
    eco.buildings[building] = E.BuildingComp(required={"Wood": 50,
                                                       "Stone": 50})
    eco.found_building(building)
    eco.supply_building(building, "Wood", 50)
    eco.supply_building(building, "Stone", 50)
    builders = [one(25.0, z, max_speed=60.0) for z in (480.0, 540.0)]
    for w in builders:
        eco.builders[w] = E.BuilderComp(build_speed=0.1)
    tower = one(80.0, 110.0, flags=int(F.GARRISONABLE | F.COLLISION),
                radius=3.0, max_speed=0.0)
    eco.garrisons[tower] = E.GarrisonComp(capacity=4)
    transport = one(10.0, 900.0, max_speed=40.0,
                    flags=int(F.MOVABLE | F.GARRISONABLE | F.COLLISION
                              | F.SELECTABLE))
    eco.garrisons[transport] = E.GarrisonComp(capacity=4)
    scouts = eng.spawn_batch(np.concatenate([at(12.0 + 3 * i, 905.0)
                                             for i in range(4)]),
                             faction=f, max_speed=40.0)
    return dict(nodes=nodes, stores=stores, harvesters=harvesters,
                building=building, builders=builders, tower=tower,
                transport=transport, scouts=scouts)


def economy_digest(eng) -> str:
    """The first 16 hex digits of the SHA-256 of the economy's state:
    stored amounts per faction, each harvester's state and carried
    amounts, building states and progress, garrisoned uids."""
    eco = eng.economy
    fac = eng.ents_host("faction")["faction"]
    stored = {}
    for u, s in sorted(eco.storages.items()):
        f = int(fac[eng.uid_to_slot[u]])
        for k, v in sorted(s.stored.items()):
            stored[(f, k)] = stored.get((f, k), 0) + v
    data = (sorted(stored.items()),
            [(u, int(h.state), sorted(h.carried.items()))
             for u, h in sorted(eco.harvesters.items())],
            [(u, int(b.state), b.progress)
             for u, b in sorted(eco.buildings.items())],
            [(u, list(g.held)) for u, g in sorted(eco.garrisons.items())])
    return hashlib.sha256(repr(data).encode()).hexdigest()[:16]


def pos_digest(eng) -> str:
    """The first 16 hex digits of the SHA-256 of every position, hp and
    liveness bit and the device tick: what only the tick (or a teleport)
    changes."""
    e = eng.state.ents
    data = (e.pos.cpu().numpy().tobytes() + e.hp.cpu().numpy().tobytes()
            + e.alive.cpu().numpy().tobytes() + str(eng.state.tick).encode())
    return hashlib.sha256(data).hexdigest()[:16]


def phase_economy(dev, n_per_side: int = ECO_PER_SIDE):
    """Phase 7 (see the module docstring): the economy at war on the battle
    map, with script tasks, a pause, profiling and a session round trip."""
    import gc

    from permafrost_engine_tpu_torch import DiplomacyState, EngineConfig, FRAME_HZ
    from permafrost_engine_tpu_torch.assets.mapgen import make_battle_map
    from permafrost_engine_tpu_torch.core.config import SimState
    from permafrost_engine_tpu_torch.core.events import EventType
    from permafrost_engine_tpu_torch.core.sched import AwaitEvent, Sleep
    from permafrost_engine_tpu_torch.core.session import (
        SubsessionStack, load_session_bytes, save_session_bytes)
    from permafrost_engine_tpu_torch.game.economy import BuildingState
    from permafrost_engine_tpu_torch.game.engine import Engine

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    cfg = EngineConfig(max_ents=2 * N_PER_SIDE + 256)
    eng = Engine(cfg, device=dev)
    eng.load_map_data(make_battle_map())
    eng.add_faction(0)
    eng.add_faction(1)
    eng.set_diplomacy(0, 1, DiplomacyState.WAR)
    rng = np.random.default_rng(0)
    ranged = rng.random(2 * n_per_side) < 0.2
    kw = dict(max_speed=20.0, vision_range=80.0, hp=200.0)
    armies = []
    for f, x0 in ((0, 200.0), (1, 820.0)):
        r = ranged[f * n_per_side:(f + 1) * n_per_side]
        armies.append(eng.spawn_batch(
            block(rng, x0, 212.0, n_per_side, 25), faction=f, is_ranged=r,
            attack_range=np.where(r, 40.0, 5.0), **kw))
    sides = [spawn_economy(eng, 0, 40.0, 1.0), spawn_economy(eng, 1, 1000.0, -1.0)]
    n_ents = int(eng.state.ents.alive.sum())
    entered = []
    eng.bus.subscribe(EventType.REGION_ENTERED, entered.append)
    eng.regions.add_circle("north_gate", (360.0, 264.0), 40.0)
    eng.regions.add_rect("north_bridge", (468.0, 336.0), 48.0, 96.0)
    check(eng.move(armies[0], (820.0, 512.0)), "army a path request")
    check(eng.move(armies[1], (200.0, 512.0)), "army b path request")
    eco = eng.economy
    for s in sides:
        for i, h in enumerate(s["harvesters"]):
            # two harvesters a node: even nodes are Wood, odd Stone
            eco.gather(h, s["nodes"][2 * ((i // 2) % 4) + i % 2])
        for w in s["builders"]:
            eco.build(w, s["building"])
        eco.transport(s["transport"], s["scouts"],
                      tuple(eng.pos_of(s["tower"])))

    # -- script tasks: a death watcher per side, and a pause ---------------
    woken = []     # (frame, watcher, dead uid) of every watcher wake

    def death_watcher(task, f):
        seen = 0
        while seen < DEATHS_PER_WATCHER:
            ev = yield AwaitEvent(EventType.ENTITY_DEATH)
            woken.append((eng._frame, f, ev["uid"]))
            seen += 1

    pause = {}

    def pauser(task):
        yield Sleep(PAUSE_AT)
        pause["from"] = (eng._frame, eng.state.tick, pos_digest(eng))
        eng.sim_state = SimState.PAUSED_FULL
        yield Sleep(PAUSE_FRAMES)
        pause["to"] = (eng._frame, eng.state.tick, pos_digest(eng))
        eng.sim_state = SimState.RUNNING

    for f in (0, 1):
        eng.sched.create(death_watcher, f, name=f"deaths_{f}")
    eng.sched.create(pauser, name="pause")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    # -- 1. step(60) while tasks live: frame by frame (eager) ----------------
    # (ms per frame counts the windows that tasks lived through; in the one
    # where the last task ends, the frames after it fuse into graph replays)
    tasks_s, replays0 = [], eng._scan_fn.stats["replays"]
    while eng.sched.tasks:
        check(eng._frame < ECO_MAX_FRAMES,
              f"tasks still live at frame {eng._frame}: "
              f"{[t.name for t in eng.sched.tasks.values()]}")
        replays = eng._scan_fn.stats["replays"]
        s = synced_call(eng.step, WAR_WINDOW)
        if eng.sched.tasks:
            check(eng._scan_fn.stats["replays"] == replays,
                  "no graph replay while tasks live")
            tasks_s.append(s)
    tasks_frames = eng._frame
    check("from" in pause and "to" in pause
          and pause["from"][1:] == pause["to"][1:]
          and pause["to"][0] - pause["from"][0] == PAUSE_FRAMES,
          f"the pause holds the digest: {pause}")
    # the scouts, dropped off at the tower, enter it; these windows, and one
    # more, capture the economy's 6-frame graphs, so they are not timed
    for _ in range(20):
        for s in sides:
            for u in s["scouts"]:
                if u not in eco.garrisons[s["tower"]].held:
                    eco.garrison(u, s["tower"])
        if all(len(eco.garrisons[s["tower"]].held) == 4 for s in sides):
            break
        eng.step(WAR_WINDOW)
    eng.step(WAR_WINDOW)
    check(len(woken) == 2 * DEATHS_PER_WATCHER,
          f"each watcher woke on {DEATHS_PER_WATCHER} deaths: {len(woken)}")
    first_death = woken[0][0]

    # -- 2. no task left: micro-batched step() and step_scan() windows -------
    graphed = [synced_call(eng.step, WAR_WINDOW) for _ in range(2)]
    scanned = [synced_call(eng.step_scan, SCAN_WINDOW) for _ in range(2)]
    graphs = graph_summary(eng)
    check(graphs["replays"] > replays0, "graph replays once no task lives")

    # -- 3. profile_tick twice (bench.run_battle), tick_cost_analysis --------
    profiles = [eng.profile_tick(60) for _ in range(2)]
    cost = profiles[-1]
    check(cost["tick_flops_upper"] > 0 and cost["tick_hbm_bytes_upper"] > 0,
          f"tick_cost_analysis counted the tick: {cost}")

    # -- 4. a session round trip on the card -----------------------------------
    t0 = time.perf_counter()
    blob = save_session_bytes(eng)
    save_ms = 1e3 * (time.perf_counter() - t0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loaded = load_session_bytes(blob, device=dev)
    torch.cuda.synchronize()
    load_ms = 1e3 * (time.perf_counter() - t0)
    check(loaded._inflight is None and loaded.device == eng.device,
          "the loaded engine has no window in flight, on the card")
    check(state_digest(loaded) == state_digest(eng)
          and economy_digest(loaded) == economy_digest(eng),
          "the loaded engine starts where the original stands")
    move_period = FRAME_HZ // cfg.move_hz

    def substeps_between(t0, t1):
        return t1 // move_period - t0 // move_period

    def run_240(e):
        t0 = time.perf_counter()
        e.step(WAR_WINDOW)
        e.step(WAR_WINDOW)
        e.step_scan(SCAN_WINDOW)
        torch.cuda.synchronize()
        return dict(s=time.perf_counter() - t0, digest=state_digest(e),
                    economy=economy_digest(e),
                    events=hashlib.sha256(repr(e.events).encode())
                    .hexdigest()[:16], n_events=len(e.events), frame=e._frame)

    tick_at_load = eng.state.tick
    runs = [run_240(eng), run_240(loaded)]
    check(runs[0]["digest"] == runs[1]["digest"]
          and runs[0]["economy"] == runs[1]["economy"]
          and runs[0]["events"] == runs[1]["events"]
          and loaded.events == eng.events,
          f"the loaded engine matches the original: {runs}")
    loaded_graphs = graph_summary(loaded)
    substeps = substeps_between(tick_at_load, loaded.state.tick)
    mem_two = torch.cuda.memory_allocated()
    del loaded
    gc.collect()
    mem_one = torch.cuda.memory_allocated()

    # -- 5. a subsession push and pop -------------------------------------------
    stack = SubsessionStack(device=dev)
    stack.push(eng)
    popped = stack.pop()
    check(state_digest(popped) == state_digest(eng), "the popped session")
    tick_at_pop = popped.state.tick
    popped.step(WAR_WINDOW)              # the popped engine captures graphs
    substeps += substeps_between(tick_at_pop, popped.state.tick)
    mem_popped = torch.cuda.memory_allocated()
    del popped
    gc.collect()
    torch.cuda.synchronize()
    mem_after_pop = torch.cuda.memory_allocated()
    check(mem_one < mem_two and mem_after_pop < mem_popped,
          "a dropped engine's state, buffers and graph pool are freed: "
          f"{mem_two} -> {mem_one} B, {mem_popped} -> {mem_after_pop} B")
    counts_pop = read_counts()
    substeps += substeps_between(0, eng.state.tick)

    # -- the checks -------------------------------------------------------------
    e = eng.state.ents
    check(bool(torch.isfinite(e.pos).all() and torch.isfinite(e.vel).all()
               and not torch.isnan(e.hp).any()), "no NaN in pos/vel/hp")
    check(counts_pop["k1"] == substeps and substeps > 0,
          f"K1 launches {counts_pop['k1']} == movement substeps {substeps}")
    check(counts_pop["k2_chunk"] > 0, f"K2 launched: {counts_pop}")
    delivered = {f"{f}:{r}": eco.stored_of(f, r) for f in (0, 1)
                 for r in ("Wood", "Stone")}
    check(min(delivered.values()) > 0,
          f"both sides delivered Wood and Stone: {delivered}")
    check(all(eco.buildings[s["building"]].state == BuildingState.COMPLETED
              for s in sides), "both buildings completed")
    held = [sorted(eco.garrisons[s["tower"]].held) for s in sides]
    check(held == [sorted(s["scouts"]) for s in sides],
          f"each tower holds its 4 scouts: {held}")
    check(not any(t.name.startswith("transport") for t in
                  eng.sched.tasks.values()), "the transport missions ended")
    check(len(entered) > 0, "the regions reported enters")
    ev = {k: sum(1 for kk, _ in eng.events if kk == k)
          for k in ("entity_death", "attack_start", "motion_end")}
    check(ev["entity_death"] > 0, f"deaths drained: {ev}")
    wall_s = time.perf_counter() - t_phase
    counters = {k: eng.counters[k] for k in (
        "sched_tick_ms", "economy_tick_ms", "region_update_ms",
        "blk_snapshot_ms", "blk_update_ms")}
    res = dict(
        entities=n_ents, setup_s=setup_s, tasks_frames=tasks_frames,
        tasks_windows_s=tasks_s,
        ms_per_frame_tasks=1e3 * sum(tasks_s) / (WAR_WINDOW * len(tasks_s)),
        ms_per_frame_graphed=1e3 * sum(graphed) / (WAR_WINDOW * len(graphed)),
        ms_per_frame_scan=1e3 * sum(scanned) / (SCAN_WINDOW * len(scanned)),
        graphed_windows_s=graphed, scan_windows_s=scanned, pause=pause,
        first_death_frame=first_death, watcher_wakes=woken,
        profiles=profiles, save_ms=save_ms, load_ms=load_ms,
        blob_bytes=len(blob), runs=runs, loaded_graphs=loaded_graphs,
        graphs=graphs, delivered=delivered, held=held,
        region_enters=len(entered), events=ev, counts=counts_pop,
        substeps=substeps, counters=counters,
        mem_two_engines=mem_two, mem_one_engine=mem_one,
        mem_popped_stepped=mem_popped, mem_after_pop=mem_after_pop,
        max_memory_allocated=torch.cuda.max_memory_allocated(), wall_s=wall_s)
    log(f"phase 7 economy at war: {n_ents} entities ({n_per_side} army units "
        f"a side), setup_s={setup_s:.3f}; tasks lived to frame {tasks_frames}"
        f" (frame by frame, ms_per_frame={res['ms_per_frame_tasks']:.4f}; first"
        f" death drained at frame {first_death}); "
        f"pause {pause['from'][:2]}->{pause['to'][:2]} digest "
        f"{pause['from'][2]} held; then graphed step({WAR_WINDOW}) "
        f"ms_per_frame={res['ms_per_frame_graphed']:.4f}, step_scan"
        f"({SCAN_WINDOW}) ms_per_frame={res['ms_per_frame_scan']:.4f}; "
        f"graphs: captures={graphs['captures']} replays={graphs['replays']}")
    for i, p in enumerate(profiles):
        log(f"phase 7 profile_tick(60) #{i + 1}: " + " ".join(
            f"{k}={c['ms_p50']:.3f}ms(n={c['n']})"
            for k, c in p["classes"].items())
            + f" repeat_spread_pct={p['repeat_spread_pct']} ms_mean="
            f"{p['ms_mean']:.3f} tick_flops_upper={p['tick_flops_upper']:.4g} "
            f"tick_hbm_bytes_upper={p['tick_hbm_bytes_upper']:.4g} "
            f"mfu_upper_pct={p['mfu_upper_pct']}")
    log(f"phase 7 session: save {save_ms:.1f} ms, {len(blob)} B; load on the "
        f"card {load_ms:.1f} ms; 240 frames each: original {runs[0]['digest']}"
        f" economy {runs[0]['economy']} events {runs[0]['events']} "
        f"({runs[0]['n_events']}), loaded {runs[1]['digest']} economy "
        f"{runs[1]['economy']} events {runs[1]['events']}: equal; loaded "
        f"engine's graphs: captures={loaded_graphs['captures']} "
        f"capture_ms={loaded_graphs['capture_ms']:.1f}")
    log(f"phase 7 memory: two engines {mem_two} B, one {mem_one} B; a "
        f"subsession popped and stepped {mem_popped} B, dropped "
        f"{mem_after_pop} B; peak {res['max_memory_allocated']} B")
    log(f"phase 7 checks: delivered {delivered}; buildings completed; towers "
        f"hold {held}; transports done; region enters {len(entered)}; "
        f"events {ev}; launches={counts_pop} (k1 = substeps {substeps}); "
        f"host ms " + " ".join(f"{k}={v:.1f}" for k, v in counters.items())
        + f"; wall_s={wall_s:.1f}")
    return res


# phase 8: the battle driven through the pf script surface
PF_PROBES = 64               # entities whose properties are read each window
PF_DEATHS = 10               # the script task waits for this many deaths
PF_QUERY_REPEATS = 5


def _pf_classes(pf):
    """The script's unit classes, as ``demos/rts_demo.py`` defines Knight."""

    class Footman(pf.MovableEntity, pf.CombatableEntity):
        """Melee infantry, with phase 5's melee reach."""

        def __init__(self, *args, **kw):
            super().__init__(*args, attack_range=5.0, **kw)

    class Archer(pf.MovableEntity, pf.CombatableEntity):
        """Ranged infantry."""

        def __init__(self, *args, **kw):
            super().__init__(*args, attack_range=40.0, is_ranged=True, **kw)

    return Footman, Archer


def phase_pf(dev):
    """Phase 8 (see the module docstring): the war battle at full width,
    driven as a game script drives it through ``pf``."""
    import gc
    import tempfile

    from permafrost_engine_tpu_torch import EngineConfig, FRAME_HZ, FogState
    from permafrost_engine_tpu_torch.assets.mapgen import make_battle_map
    from permafrost_engine_tpu_torch.assets.pfmap import (compile_nav_costs,
                                                          write_pfmap)
    from permafrost_engine_tpu_torch.script import pf

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    cfg = EngineConfig(max_ents=2 * N_PER_SIDE + 256)
    ctx = pf.init(cfg)                       # on the card: the default
    eng = ctx.engine
    check(eng.device.type == dev.type, f"pf.init's engine is on {eng.device}")
    eng.prewarm_nav()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    battle_map = make_battle_map()
    check(pf.load_map_string(write_pfmap(battle_map)), "pf.load_map_string")
    cost, _ = compile_nav_costs(battle_map)
    check(np.array_equal(eng.state.nav.cost_base.cpu().numpy(),
                         cost[:cfg.num_layers]),
          "the engine's cost grid equals compile_nav_costs(make_battle_map())")
    torch.cuda.synchronize()
    map_s = time.perf_counter() - t0
    sides = [pf.add_faction("West", (60, 120, 255)),
             pf.add_faction("East", (230, 60, 60))]
    pf.set_diplomacy_state(sides[0], sides[1], pf.DIPLOMACY_STATE_WAR)
    check(pf.get_diplomacy_state(sides[1], sides[0]) == pf.DIPLOMACY_STATE_WAR,
          "the factions are at war")

    # -- 5,000 script objects a side, one constructor call each -------------
    Footman, Archer = _pf_classes(pf)
    pos_a, pos_b, ranged = spawn_blocks()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    armies = []
    for f, pos in zip(sides, (pos_a, pos_b)):
        armies.append([
            (Archer if r else Footman)(
                "unit.pfobj", f"{f}-{i}", pos=(float(p[0]), 0.0, float(p[1])),
                faction_id=f, speed=20.0, vision_range=80.0, hp=200.0)
            for i, (p, r) in enumerate(zip(pos, ranged))])
    torch.cuda.synchronize()
    spawn_s = time.perf_counter() - t0
    n_spawned = sum(len(a) for a in armies)
    check(n_spawned == 2 * N_PER_SIDE
          and len(pf.context().entities) == n_spawned, "every script entity")

    # -- one right click a side, through the active RTS camera ---------------
    vw, vh = ctx.ui.virtual_resolution
    cam = pf.get_active_camera()
    host = eng.ents_host("pos")["pos"]
    order_s, goals = [], []
    for army, other in ((armies[0], armies[1]), (armies[1], armies[0])):
        c = host[[eng.uid_to_slot[e.uid] for e in other]].mean(axis=0)
        pf.set_unit_selection(army)
        cam.move_within_bounds_and_face((float(c[0]), float(c[1])))
        x, y = cam.world_to_screen((float(c[0]), 0.0, float(c[1])), vw, vh)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        check(pf.inject_mouse_click(x, y, 3) == "move", "a right-click move")
        torch.cuda.synchronize()
        order_s.append(time.perf_counter() - t0)
        goals.append(c.tolist())
    check(all(e.moving for e in (armies[0][0], armies[1][-1])),
          "both armies move")
    pf.clear_unit_selection()

    # -- a death handler and a task that waits for deaths -------------------
    handled = []
    pf.register_event_handler(
        pf.EVENT_ENTITY_DEATH,
        lambda ev: handled.append((pf.context().engine._frame, ev["uid"])))

    class DeathWatch(pf.Task):
        def __run__(self):
            seen = 0
            while seen < PF_DEATHS:
                yield self.await_event(pf.EVENT_ENTITY_DEATH)
                seen += 1
            self.state["ended_at"] = pf.context().engine._frame

    watch = DeathWatch()

    # -- property reads of 64 fixed entities, against ents_host -------------
    stride = n_spawned // PF_PROBES
    probes = [e for army in armies for e in army][::stride][:PF_PROBES]
    reads = dict(n=0, s=0.0, checks=0)

    def probe():
        live = [e for e in probes if not e.zombie]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = [(e.hp, e.pos) for e in live]
        reads["s"] += time.perf_counter() - t0
        reads["n"] += 2 * len(live)
        h = eng.ents_host("hp", "pos", "height")
        for e, (hp, p) in zip(live, got):
            s = eng.uid_to_slot[e.uid]
            check(hp == float(h["hp"][s]) and p == (
                float(h["pos"][s, 0]), float(h["height"][s]),
                float(h["pos"][s, 1])),
                f"entity {e.uid}'s properties equal the host copy")
        reads["checks"] += 1

    def step(n):
        s = synced_call(pf.step, n)
        probe()
        return s

    # -- 1. pf.step(60) while the task lives: frame by frame (eager) --------
    graphs = eng._scan_fn.stats
    eager, replays0 = [], graphs["replays"]
    while (not any(k == "entity_death" for k, _ in eng.events)
           or not watch.completed):
        check(eng._frame < WAR_MAX_FRAMES,
              f"no {PF_DEATHS} deaths within {WAR_MAX_FRAMES} frames")
        replays = graphs["replays"]
        s = step(WAR_WINDOW)
        if not watch.completed:
            check(graphs["replays"] == replays, "no graph replay while tasks live")
            eager.append(s)
    task_end = watch.state["ended_at"]
    check(not eng.sched.tasks and task_end <= eng._frame, "the task ended")
    first_death = min(f for f, _ in handled)

    # -- 2. three graphed contact windows, the fog toggled between them ------
    graphed, fog = [synced_call(pf.step, SCAN_WINDOW)], []
    probe()
    for toggle, shown in ((pf.disable_fog_of_war, False),
                          (pf.enable_fog_of_war, True)):
        toggle()
        check(bool(eng.state.fog.enabled) == shown, f"fog enabled={shown}")
        captures, replays = graphs["captures"], graphs["replays"]
        graphed.append(step(SCAN_WINDOW))
        visible = [float((eng.state.fog.state[f] == FogState.VISIBLE)
                         .float().mean()) for f in sides]
        fog.append(dict(enabled=shown, visible_share=visible,
                        captures=graphs["captures"] - captures,
                        replays=graphs["replays"] - replays))
        check(graphs["replays"] > replays
              and (dev.type != "cuda" or graphs["captures"] == captures),
              f"the window after the toggle replayed captured graphs: {fog}")
        check((min(visible) == 1.0) != shown,
              f"the fog shows the toggle (enabled={shown}): {visible}")

    # -- 3. spatial queries at contact ------------------------------------------
    host = eng.ents_host("pos", "alive")
    mid = host["pos"][host["alive"]].mean(axis=0)
    queries = {}

    def timed_query(name, fn, *args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(PF_QUERY_REPEATS):
            out = fn(*args)
        queries[name] = 1e3 * (time.perf_counter() - t0) / PF_QUERY_REPEATS
        return out

    near = timed_query("nearest_ent", pf.nearest_ent, (float(mid[0]),
                                                       float(mid[1])))
    circle = timed_query("ents_in_circle", pf.ents_in_circle,
                         near.pos, 50.0)
    idle = timed_query("get_idle_units", pf.get_idle_units)
    check(near in circle, "the nearest entity lies in the circle around it")

    # -- 4. a session through pf at contact -------------------------------------
    blob_dir = tempfile.mkdtemp()
    ctx.basedir = blob_dir
    orig = ctx.engine
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    check(pf.save_session("battle.sav"), "pf.save_session")
    save_ms = 1e3 * (time.perf_counter() - t0)
    blob_bytes = os.path.getsize(os.path.join(blob_dir, "battle.sav"))
    t0 = time.perf_counter()
    check(pf.load_session("battle.sav"), "pf.load_session")
    torch.cuda.synchronize()
    load_ms = 1e3 * (time.perf_counter() - t0)
    os.remove(os.path.join(blob_dir, "battle.sav"))
    os.rmdir(blob_dir)
    loaded = ctx.engine
    check(loaded is not orig and loaded.device.type == dev.type
          and state_digest(loaded) == state_digest(orig),
          "the loaded session starts where the original stands, on the card")
    tick_at_load = orig.state.tick
    runs = []
    for e in (orig, loaded):
        ctx.engine = e
        t0 = time.perf_counter()
        for _ in range(2):
            pf.step(SCAN_WINDOW)
        torch.cuda.synchronize()
        runs.append(dict(s=time.perf_counter() - t0, digest=state_digest(e),
                         events=hashlib.sha256(repr(e.events).encode())
                         .hexdigest()[:16], frame=e._frame))
    check(runs[0]["digest"] == runs[1]["digest"]
          and runs[0]["events"] == runs[1]["events"],
          f"the loaded session matches the original: {runs}")
    loaded_graphs = graph_summary(loaded)
    ctx.engine = orig
    move_period = FRAME_HZ // cfg.move_hz
    substeps = (orig.state.tick // move_period
                + loaded.state.tick // move_period - tick_at_load // move_period)
    counts = read_counts()

    # -- the checks ---------------------------------------------------------------
    for e in (orig, loaded):
        s = e.state.ents
        check(bool(torch.isfinite(s.pos).all() and torch.isfinite(s.vel).all()
                   and not torch.isnan(s.hp).any()), "no NaN in pos/vel/hp")
    check(counts["k1"] == substeps and substeps > 0,
          f"K1 launches {counts['k1']} == movement substeps {substeps}")
    check(counts["k2_chunk"] > 0 and counts["k2_map"] > 0,
          f"K2 launched for chunks and whole-map fields: {counts}")
    ev = {k: sum(1 for kk, _ in orig.events if kk == k)
          for k in ("entity_death", "attack_start", "projectile_hit",
                    "entity_removed")}
    for k in ("entity_death", "attack_start", "projectile_hit"):
        check(ev[k] > 0, f"{k} events through pf: {ev}")
    drained = [p["uid"] for k, p in orig.events if k == "entity_death"]
    check([u for _, u in handled] == drained,
          f"the handler saw every drained death ({len(handled)} of "
          f"{len(drained)})")
    # -- pf.dump_framebuffer: the battle from the active camera, the minimap --
    # the camera on the densest 64x64 cell of living units
    host = orig.ents_host("alive", "pos")
    living = host["pos"][host["alive"]]
    _, cell, per_cell = np.unique((living // 64).astype(int), axis=0,
                                  return_inverse=True, return_counts=True)
    dense = living[cell.ravel() == per_cell.argmax()].mean(axis=0)
    pf.get_active_camera().move_within_bounds_and_face(
        (float(dense[0]), float(dense[1])))
    os.makedirs(OUT_DIR, exist_ok=True)
    dumps = {}
    for name, mm in (("pf_frame.npy", False), ("pf_minimap.npy", True)):
        path = os.path.join(OUT_DIR, name)
        pf.settings_set("pf.debug.render_log_mask", 0 if mm else 2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        check(pf.dump_framebuffer(path, minimap=mm), f"pf.dump_framebuffer {name}")
        dumps[name] = (np.load(path), 1e3 * (time.perf_counter() - t0))
    pf.settings_set("pf.debug.render_log_mask", 0)
    # the frame's live triangles per pass (render_log_mask 2), against the budget
    dump_live = dict(orig._scene_renderers[(640, 384)].render_log[-1])
    frame, minimap = dumps["pf_frame.npy"][0], dumps["pf_minimap.npy"][0]
    check(frame.shape == (384, 640, 3) and frame.dtype == np.uint8
          and frame.std() > 0, f"a u8 640x384 frame: {frame.shape}")
    check(minimap.shape == (256, 256, 3) and minimap.dtype == np.uint8,
          f"a u8 256x256 minimap: {minimap.shape}")
    frame_px = unit_pixels(orig._scene_renderers[(640, 384)],
                           pf.get_active_camera(), frame)
    check(frame_px > 1000, f"units show in the frame: {frame_px} pixels")
    dots = [int((minimap == np.array(c, np.uint8)).all(-1).sum())
            for c in ((60, 120, 255), (255, 60, 60))]
    check(min(dots) > 100, f"both armies' dots on the minimap: {dots}")
    wall_s = time.perf_counter() - t_phase
    res = dict(
        entities=n_spawned, init_s=init_s, map_s=map_s, spawn_s=spawn_s,
        spawn_ms_per_entity=1e3 * spawn_s / n_spawned,
        order_ms=[1e3 * s for s in order_s], goals=goals,
        first_death_frame=first_death, task_end_frame=task_end,
        eager_windows_s=eager,
        ms_per_frame_eager=1e3 * sum(eager) / (WAR_WINDOW * len(eager)),
        graphed_windows_s=graphed,
        # the first window captures the segments; the other two replay
        ms_per_frame_graphed=1e3 * sum(graphed[1:]) / (SCAN_WINDOW * 2),
        ms_per_frame_capture_window=1e3 * graphed[0] / SCAN_WINDOW,
        property_reads=reads["n"], property_checks=reads["checks"],
        ms_per_property_read=1e3 * reads["s"] / max(reads["n"], 1),
        query_ms=queries, circle=len(circle), idle=len(idle), fog=fog,
        save_ms=save_ms, load_ms=load_ms, blob_bytes=blob_bytes, runs=runs,
        loaded_graphs=loaded_graphs, graphs=graph_summary(orig), events=ev,
        handled=len(handled), counts=counts, substeps=substeps,
        dump_ms={k: v[1] for k, v in dumps.items()}, unit_pixels=frame_px,
        dump_live=dump_live,
        minimap_dots=dots,
        max_memory_allocated=torch.cuda.max_memory_allocated(), wall_s=wall_s)
    log(f"phase 8 pf battle: {n_spawned} script entities (Footman, Archer), "
        f"init {init_s:.3f} s, map {map_s:.3f} s, spawn "
        f"{res['spawn_ms_per_entity']:.4f} ms per "
        f"entity ({spawn_s:.2f} s), right-click orders ms "
        + ",".join(f"{x:.1f}" for x in res["order_ms"])
        + f"; first death at frame {first_death}, the task ended at frame "
        f"{task_end}; pf.step({WAR_WINDOW}) eager ms_per_frame="
        f"{res['ms_per_frame_eager']:.4f} ({len(eager)} windows), graphed "
        f"pf.step({SCAN_WINDOW}) ms_per_frame={res['ms_per_frame_graphed']:.4f}"
        f" (the window that captures "
        f"{res['ms_per_frame_capture_window']:.4f})")
    log(f"phase 8 reads: {reads['n']} property reads (hp, pos) in "
        f"{reads['checks']} probes of {PF_PROBES} entities, "
        f"ms_per_property_read={res['ms_per_property_read']:.4f}, all equal "
        f"to ents_host; queries ms " + " ".join(
            f"{k}={v:.3f}" for k, v in queries.items())
        + f" (circle {len(circle)}, idle {len(idle)}); fog toggle in graph "
        f"replays: " + "; ".join(
            f"enabled={f['enabled']} visible={f['visible_share'][0]:.3f},"
            f"{f['visible_share'][1]:.3f} replays={f['replays']} "
            f"captures={f['captures']}" for f in fog))
    log(f"phase 8 session through pf: save {save_ms:.1f} ms, {blob_bytes} B; "
        f"load {load_ms:.1f} ms; 240 frames each: original {runs[0]['digest']}"
        f" events {runs[0]['events']}, loaded {runs[1]['digest']} events "
        f"{runs[1]['events']}: equal; events {ev}, handler saw {len(handled)}; "
        f"pf.dump_framebuffer ms frame={dumps['pf_frame.npy'][1]:.1f} minimap="
        f"{dumps['pf_minimap.npy'][1]:.1f} (units draw {frame_px} pixels, "
        f"minimap dots {dots}; live triangles {dump_live}); "
        f"launches={counts} (k1 = substeps {substeps}); max_memory_allocated="
        f"{res['max_memory_allocated']}; wall_s={wall_s:.1f}")
    return res


# phase 9: bench.py's measure_render scene through the port's renderer
RENDER_W, RENDER_H = 1280, 720
RENDER_PER_SIDE = 500
RENDER_FRAMES = 12          # timed frames, the shadow pass rerun each
RENDER_SIM_FRAMES = 60      # step(4) and one render, 15 times
RENDER_LOG_FRAMES = 8       # pass-by-pass frames (render_log_mask 1)
RENDER_PASSES = ("soup_ms", "shadow_ms", "raster_ms", "shade_ms", "water_ms",
                 "overlays_ms")
FRAME_SHARE, FRAME_LEVELS = 0.995, 2     # tests/test_torch_scene.py's


def frame_agreement(a: np.ndarray, b: np.ndarray) -> dict:
    """The share of pixels within FRAME_LEVELS u8 levels, and the worst."""
    d = np.abs(a.astype(int) - b.astype(int)).max(-1)
    return dict(share=float((d <= FRAME_LEVELS).mean()), max=int(d.max()),
                differ=int((d > 0).sum()))


def unit_pixels(renderer, cam, img: np.ndarray, **kw) -> int:
    """The pixels of `img` (a frame `renderer` drew from `cam`) that the
    entity instances draw: `img` against the same frame drawn with no
    instances (and the same cached shadow map)."""
    maxi, renderer.maxi = renderer.maxi, 0
    try:
        bare = renderer.render(cam, **kw)
    finally:
        renderer.maxi = maxi
    return int((img != bare).any(-1).sum())


def phase_render(dev):
    """Phase 9 (see the module docstring): bench.py's measure_render scene
    (bench.py:386-452), rendered at 1280x720 on the card; one frame of its
    state rendered again on the CPU."""
    import gc

    from permafrost_engine_tpu_torch import DiplomacyState, EngineConfig, FRAME_HZ
    from permafrost_engine_tpu_torch.assets.mapgen import make_battle_map
    from permafrost_engine_tpu_torch.core.settings import SettingType
    from permafrost_engine_tpu_torch.game.engine import Engine
    from permafrost_engine_tpu_torch.render.camera import Camera
    from permafrost_engine_tpu_torch.render.scene import SceneRenderer
    from permafrost_engine_tpu_torch.state.convert import (state_from_numpy,
                                                           state_to_numpy)

    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmuls are off")
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    # -- bench.py's scene: 500 units a side at war with move orders ---------
    battle_map = make_battle_map()
    cfg = EngineConfig(max_ents=2 * RENDER_PER_SIDE + 64, skin_joints=32)
    eng = Engine(cfg)
    eng.load_map_data(battle_map)
    eng.add_faction(0)
    eng.add_faction(1)
    eng.set_diplomacy(0, 1, DiplomacyState.WAR)
    rng = np.random.default_rng(0)
    for f, x0 in ((0, 250.0), (1, 600.0)):
        pos = np.stack([rng.uniform(x0, x0 + 160, RENDER_PER_SIDE),
                        rng.uniform(300, 700, RENDER_PER_SIDE)],
                       1).astype(np.float32)
        uids = eng.spawn_batch(pos, faction=f, max_speed=20.0,
                               vision_range=80.0, hp=200.0)
        check(eng.move(uids, (850.0 - x0, 512.0)), "a move order")
    cam = Camera()
    cam.pos = np.array([eng.cfg.world_w / 2, 220.0,
                        eng.cfg.world_h / 2 + 180.0])
    cam.pitch, cam.yaw = -50.0, 90.0
    eng.step(30)
    eng.settings.create("pf.debug.render_log_mask", SettingType.INT, 0)
    r = SceneRenderer(eng, w=RENDER_W, h=RENDER_H, maxi=2 * RENDER_PER_SIDE,
                      shadows=True, reflections=True)
    check(r.reflections, "the battle map has water: the mirror pass runs")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    first = r.render(cam, faction_pov=0)
    first_frame_s = time.perf_counter() - t0

    # -- bench's timed frames: render() ends in the u8 fetch ----------------
    times = []
    for _ in range(RENDER_FRAMES):
        eng._frame += 1          # the shadow cache keys on the frame counter
        t0 = time.perf_counter()
        r.render(cam, faction_pov=0)
        times.append((time.perf_counter() - t0) * 1e3)
    p50 = float(np.median(times))

    # -- sim + render, a render every 4th frame ------------------------------
    g0 = dict(eng._scan_fn.stats)
    t0 = time.perf_counter()
    for _ in range(RENDER_SIM_FRAMES // 4):
        eng.step(4)
        r.render(cam, faction_pov=0)
    torch.cuda.synchronize()
    combined_fps = RENDER_SIM_FRAMES / (time.perf_counter() - t0)
    # the graph captures the window paid (segments new to the cache)
    sim_graphs = {k: eng._scan_fn.stats[k] - g0.get(k, 0)
                  for k in eng._scan_fn.stats}

    # -- the pass-by-pass path: per-pass times, then live triangles ----------
    eng.settings.set("pf.debug.render_log_mask", 1)
    passes = []
    for _ in range(RENDER_LOG_FRAMES):
        eng._frame += 1
        r.render(cam, faction_pov=0)
        passes.append(r.render_log[-1])
    split = {k: float(np.median([p[k] for p in passes])) for k in RENDER_PASSES}
    eng.settings.set("pf.debug.render_log_mask", 2)
    eng._frame += 1
    card = r.render(cam, faction_pov=0)
    live = dict(r.render_log[-1])
    eng.settings.set("pf.debug.render_log_mask", 0)
    check((card == r.render(cam, faction_pov=0)).all(),
          "the logged and the fused path draw the same frame")
    torch.cuda.synchronize()
    max_mem = torch.cuda.max_memory_allocated()
    counts = read_counts()
    substeps = eng.state.tick // (FRAME_HZ // cfg.move_hz)

    # -- the same state on the CPU -------------------------------------------
    t0 = time.perf_counter()
    cpu = Engine(cfg, device="cpu")
    cpu.state = state_from_numpy(state_to_numpy(eng.state), "cpu")
    cpu.heights, cpu.map_data = eng.heights, eng.map_data
    cpu.uid_to_slot = dict(eng.uid_to_slot)
    cpu._frame = eng._frame
    cpu_frame = SceneRenderer(cpu, w=RENDER_W, h=RENDER_H,
                              maxi=2 * RENDER_PER_SIDE, shadows=True,
                              reflections=True).render(cam, faction_pov=0)
    cpu_s = time.perf_counter() - t0
    agree = frame_agreement(card, cpu_frame)
    os.makedirs(OUT_DIR, exist_ok=True)
    np.save(os.path.join(OUT_DIR, "render_card.npy"), card)
    np.save(os.path.join(OUT_DIR, "render_cpu.npy"), cpu_frame)

    # -- the checks ------------------------------------------------------------
    s = eng.state.ents
    check(bool(torch.isfinite(s.pos).all() and not torch.isnan(s.hp).any()),
          "no NaN in pos/hp")
    check(card.shape == (RENDER_H, RENDER_W, 3) and card.dtype == np.uint8
          and first.shape == card.shape, "u8 frames at 1280x720")
    check(len(np.unique(card.reshape(-1, 3), axis=0)) > 1000,
          "the frame is a rendered scene, not a flat fill")
    units_px = unit_pixels(r, cam, card, faction_pov=0)
    check(units_px > 1000, f"units show: {units_px} pixels")
    check(counts["k1"] == substeps and substeps > 0,
          f"K1 launches {counts['k1']} == movement substeps {substeps}")
    check(counts["k2_chunk"] > 0, f"K2 launched for the move orders: {counts}")
    check(agree["share"] >= FRAME_SHARE,
          f"the card's frame agrees with the CPU's: {agree}")
    for k in ("live_main", "live_mirror", "live_shadow"):
        check(live.get(k, 0) > 0, f"{k} counted: {live}")
    wall_s = time.perf_counter() - t_phase
    res = dict(
        resolution=f"{RENDER_W}x{RENDER_H}", entities=2 * RENDER_PER_SIDE,
        first_frame_s=first_frame_s, render_ms=times, render_ms_p50=p50,
        render_ms_p90=float(np.percentile(times, 90)),
        render_fps=1000.0 / p50, sim_plus_render_fps_dec4=combined_fps,
        sim_graphs=sim_graphs,
        pass_ms_p50=split, passes=passes, live=live, cpu_frame_s=cpu_s,
        agreement=agree, unit_pixels=units_px, counts=counts,
        substeps=substeps, max_memory_allocated=max_mem, wall_s=wall_s)
    log(f"phase 9 render: bench.py's measure_render scene, "
        f"{2 * RENDER_PER_SIDE} units at war, {RENDER_W}x{RENDER_H}, maxi="
        f"{2 * RENDER_PER_SIDE}, shadows and water: first_frame_s="
        f"{first_frame_s:.3f} render_ms_p50={p50:.2f} render_ms_p90="
        f"{res['render_ms_p90']:.2f} render_fps={res['render_fps']:.2f} "
        f"sim_plus_render_fps_dec4={combined_fps:.2f} (its window: graph "
        f"captures={sim_graphs.get('captures', 0)} capture_ms="
        f"{sim_graphs.get('capture_ms', 0.0):.1f} replays="
        f"{sim_graphs.get('replays', 0)})")
    log(f"phase 9 passes (ms, median of {RENDER_LOG_FRAMES} pass-by-pass "
        "frames): " + " ".join(
        f"{k}={v:.2f}" for k, v in split.items())
        + f"; live triangles: soup={live['triangles']} main="
        f"{live['live_main']} mirror={live['live_mirror']} shadow="
        f"{live['live_shadow']} (compacted to raster_budget="
        f"{live['raster_budget']} in the main and mirror passes; the shadow "
        f"pass is not compacted)")
    log(f"phase 9 card vs CPU frame: {agree['share']:.6f} of pixels within "
        f"{FRAME_LEVELS} levels ({agree['differ']} differ, worst "
        f"{agree['max']}); the CPU frame took {cpu_s:.1f} s; units draw "
        f"{units_px} pixels; launches={counts} (k1 = substeps "
        f"{substeps}); max_memory_allocated={max_mem}; wall_s={wall_s:.1f}")
    return res


PAR_RANKS = 4                # phase 10's ranks, all on one card
PAR_CONTACT_FRAMES = 120     # sharded frames at contact
PAR_SEEK_FRAMES = 60         # frames after the seek order
PAR_SEEKERS = 512            # living side-0 units given seek_enemies
PAR_TIMEOUT_S = 480.0        # a rank still running then fails the phase
PAR_THREADS = 2              # torch threads per rank (8 host cores)


def parallel_digests(eng) -> dict:
    """16-hex-digit SHA-256 digests of every position and velocity, hp,
    fog plane, blocker grid and whole-map field."""
    s = eng.state

    def h(t):
        return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]

    return dict(pos_vel=state_digest(eng), hp=h(s.ents.hp),
                fog=h(s.fog.state), blockers=h(s.nav.blockers),
                global_flow=h(s.fields.global_flow))


def order_seek(eng, side: list) -> int:
    """``seek_enemies`` for the first `PAR_SEEKERS` living units of `side`
    (uids); returns how many were ordered."""
    alive = eng.state.ents.alive.cpu().numpy()
    uids = [u for u in side if u in eng.uid_to_slot
            and alive[eng.uid_to_slot[u]]][:PAR_SEEKERS]
    check(bool(uids) and eng.seek_enemies(uids), "the seek order")
    return len(uids)


def parallel_rank(blob_path: str, side: list) -> dict:
    """One rank of phase 10 (run by ``parallel.spawn``): load the contact
    session on the rank's device, shard it with the map row-banded, step
    the contact frames, order the seek and step on. Returns its digests,
    launches, rows, collectives, times, the band integrator's calls and,
    on rank 0, the seek order's first field with its inputs."""
    from permafrost_engine_tpu_torch import FRAME_HZ
    from permafrost_engine_tpu_torch.core.session import load_session_bytes
    from permafrost_engine_tpu_torch.ops import cuda_build
    from permafrost_engine_tpu_torch.parallel import make_mesh, sharded_engine

    mesh = make_mesh()
    with open(blob_path, "rb") as f:
        eng = load_session_bytes(f.read(), device=mesh.device)
    sharded_engine(eng, mesh, map_sharded=True)
    hook = eng.nav.sharded_integrate
    torch.cuda.synchronize(mesh.device)
    torch.cuda.reset_peak_memory_stats(mesh.device)
    reset_counts()
    mesh.reset_counters()
    contact_s = synced_call(eng.step, PAR_CONTACT_FRAMES)
    contact = parallel_digests(eng)
    coll_contact = copy.deepcopy(mesh.counters)
    mesh.reset_counters()
    fields = []

    def recording(cost, seeds):
        calls, sweeps = hook.stats["calls"], hook.stats["sweeps"]
        t = time.perf_counter()
        out = hook(cost, seeds)
        ms = (time.perf_counter() - t) * 1e3
        fields.append(dict(ms=ms, sweeps=hook.stats["sweeps"] - sweeps,
                           call=calls))
        if mesh.rank == 0 and len(fields) == 1:
            fields[0].update(cost=cost.cpu().numpy(), seeds=seeds.cpu().numpy(),
                             field=out.cpu().numpy())
        return out

    eng.nav.sharded_integrate = recording
    torch.cuda.synchronize(mesh.device)
    t = time.perf_counter()
    seekers = order_seek(eng, side)
    torch.cuda.synchronize(mesh.device)
    order_s = time.perf_counter() - t
    eng.nav.sharded_integrate = hook
    seek_s = synced_call(eng.step, PAR_SEEK_FRAMES)
    counts = read_counts()
    return dict(
        rank=mesh.rank, transport=mesh.transport, device=str(mesh.device),
        contact=contact, end=parallel_digests(eng), counts=counts,
        substeps=(PAR_CONTACT_FRAMES + PAR_SEEK_FRAMES)
        // (FRAME_HZ // eng.cfg.move_hz),
        k1_rows=mesh.rows(eng.cfg.max_ents),
        field_rows=mesh.rows(eng.cfg.field_h),
        fog_rows=mesh.rows(eng.cfg.tiles_h),
        collectives_contact=coll_contact,
        collectives_seek=copy.deepcopy(mesh.counters),
        ms_per_frame_contact=1e3 * contact_s / PAR_CONTACT_FRAMES,
        ms_per_frame_seek=1e3 * seek_s / PAR_SEEK_FRAMES,
        seekers=seekers, seek_order_ms=1e3 * order_s, seek_fields=fields,
        band_calls=dict(hook.stats),
        global_slots=int((eng.state.flocks.global_slot >= 0).sum()),
        max_memory_allocated=torch.cuda.max_memory_allocated(mesh.device),
        nvcc_builds=sorted(cuda_build.BUILD_INFO),
        jax_modules=sorted(m for m in sys.modules if m.split(".")[0] in (
            "jax", "jaxlib", "flax", "permafrost_engine_tpu")))


def k1_rows_check(eng, world: int) -> dict:
    """K1 on each rank's row band of the live window against the whole
    arena's launch: the band's inputs equal the whole inputs' rows and its
    output equals the whole output's rows, bit for bit; the band launch
    against its plain version, both timed."""
    from permafrost_engine_tpu_torch.game.step import crowd_inputs
    from permafrost_engine_tpu_torch.ops.crowd_cuda import (
        hrvo_select_cuda, hrvo_select_plain)

    cfg = eng.cfg
    exact = cfg.clearpath_exact
    whole = crowd_inputs(cfg, eng.state)
    raw = hrvo_select_cuda(*whole["hrvo_args"], exact=exact)
    per = cfg.max_ents // world
    out = dict(rows=per, bands=world, max_abs_err=0.0)
    for r in range(world):
        lo, hi = r * per, (r + 1) * per
        band = crowd_inputs(cfg, eng.state, (lo, hi))
        for a, b in zip(band["hrvo_args"], whole["hrvo_args"]):
            check(torch.equal(a.view(torch.int8) if a.dtype == torch.bool
                              else a.view(torch.int32),
                              (b[lo:hi].view(torch.int8) if b.dtype == torch.bool
                               else b[lo:hi].view(torch.int32))),
                  f"K1 band {r}: inputs equal the whole window's rows")
        got = hrvo_select_cuda(*band["hrvo_args"], exact=exact)
        check(torch.equal(got.view(torch.int32), raw[lo:hi].view(torch.int32)),
              f"K1 band {r}: output bit-equal to the whole launch's rows")
        if r == 0:
            stats = {}
            want = hrvo_select_plain(*band["hrvo_args"], exact=exact,
                                     stats=stats)
            differ = int(rows_differ(got, want).sum())
            check(differ == 0, f"K1 band 0: {differ} rows differ from plain")
            out["max_abs_err"] = float((got - want).abs().max())
            args = band["hrvo_args"]
            out["ms"] = cuda_ms(lambda: hrvo_select_cuda(*args, exact=exact),
                                20)
            out["plain_ms"] = cuda_ms(
                lambda: hrvo_select_plain(*args, exact=exact), 3, warmup=1)
            n, c2 = args[5].shape[0], args[5].shape[1]
            nbytes = sum(a.numel() * a.element_size() for a in args) + n * 8
            every, passed, inside = K1_OPS_PER_CONE_TEST[
                "exact" if exact else "fan"]
            ops = (n * (5 * c2 + 32 * c2) + stats["pairs"] * every
                   + stats["passed"] * passed + stats["inside"] * inside)
            out["bound_ms"], out["bound_by"] = bound(nbytes, ops)
            out["whole_ms"] = cuda_ms(
                lambda: hrvo_select_cuda(*whole["hrvo_args"], exact=exact), 20)
    return out


def phase_parallel(dev):
    """Phase 10: phase 5's war battle at contact, split over `PAR_RANKS`
    rank processes (on this card; on a card each where there are as many,
    over NCCL) with the map row-banded
    (``parallel.sharded_engine(map_sharded=True)``), against the
    single-device engine continuing from the same session (see the module
    docstring)."""
    import tempfile

    from permafrost_engine_tpu_torch.core.session import (
        load_session_bytes, save_session_bytes)
    from permafrost_engine_tpu_torch.ops.flowfield_cuda import integrate
    from permafrost_engine_tpu_torch.parallel import spawn

    t_phase = time.perf_counter()
    eng, a, _b, _goals = build_battle(dev, war=True)
    while not any(k == "entity_death" for k, _ in eng.events):
        check(eng._frame < WAR_MAX_FRAMES,
              f"no death within {WAR_MAX_FRAMES} frames at war")
        eng.step(WAR_WINDOW)
    frame0 = eng._frame
    blob = save_session_bytes(eng)
    del eng
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory(prefix="pf_phase10_") as tmp:
        path = os.path.join(tmp, "contact.session")
        with open(path, "wb") as f:
            f.write(blob)
        t_ranks = time.perf_counter()
        ranks = spawn(parallel_rank, PAR_RANKS, path, list(a),
                      timeout_s=PAR_TIMEOUT_S, threads=PAR_THREADS, log=log)
        ranks_s = time.perf_counter() - t_ranks

    # the single-device engine from the same session, with the same calls
    ref = load_session_bytes(blob, device=dev)
    ref.micro_batching = False
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    contact_s = synced_call(ref.step, PAR_CONTACT_FRAMES)
    ref_contact = parallel_digests(ref)
    k1 = k1_rows_check(ref, PAR_RANKS)
    seekers = order_seek(ref, list(a))
    synced_call(ref.step, PAR_SEEK_FRAMES)
    ref_end = parallel_digests(ref)
    ref_mem = torch.cuda.max_memory_allocated()

    for r in ranks:
        check(r["jax_modules"] == [], f"rank {r['rank']} loaded no JAX "
              f"module: {r['jax_modules'][:5]}")
        check(r["nvcc_builds"] == [], f"rank {r['rank']} ran no nvcc: "
              f"{r['nvcc_builds']}")
        check(r["seekers"] == seekers > 0, f"rank {r['rank']} ordered "
              f"{r['seekers']} seekers, as the single-device engine {seekers}")
        check(r["contact"] == ref_contact and r["end"] == ref_end,
              f"rank {r['rank']} digests {r['contact']} / {r['end']} equal "
              f"the single-device engine's {ref_contact} / {ref_end}")
        check(r["counts"]["k1"] == r["substeps"] > 0,
              f"rank {r['rank']}: K1 launches {r['counts']['k1']} == "
              f"substeps {r['substeps']}")
        check(r["k1_rows"][1] - r["k1_rows"][0] == k1["rows"],
              f"rank {r['rank']} K1 rows {r['k1_rows']}")
        check(r["collectives_contact"]["all_gather"]["calls"] > 0,
              f"rank {r['rank']} all-gathered at contact")
        check(r["collectives_seek"]["halo"]["calls"] > 0
              and r["band_calls"]["calls"] > 0,
              f"rank {r['rank']} built whole-map fields over the bands")
    first = ranks[0]["seek_fields"][0]
    cost = torch.from_numpy(first["cost"]).to(dev)[None].contiguous()
    seeds = torch.from_numpy(first["seeds"]).to(dev)[None].contiguous()
    k2_field = integrate(cost, seeds)
    check(torch.equal(k2_field[0].cpu(), torch.from_numpy(first["field"])),
          "the band integrator's seek field equals K2's bit for bit")
    k2_ms = cuda_ms(lambda: integrate(cost, seeds), 20)
    wall_s = time.perf_counter() - t_phase
    per_tick = {k: {q: v / PAR_CONTACT_FRAMES for q, v in c.items()}
                for k, c in ranks[0]["collectives_contact"].items()}
    for r in ranks:
        for f in r["seek_fields"]:
            f.pop("cost", None), f.pop("seeds", None), f.pop("field", None)
    res = dict(
        ranks=ranks, transport=ranks[0]["transport"], frame0=frame0,
        seekers=seekers, ref_contact=ref_contact, ref_end=ref_end,
        ref_ms_per_frame_contact=1e3 * contact_s / PAR_CONTACT_FRAMES,
        ref_max_memory_allocated=ref_mem, k1_rows=k1,
        collectives_per_tick_contact=per_tick, k2_same_field_ms=k2_ms,
        band_seek_field_ms=first["ms"], band_seek_field_sweeps=first["sweeps"],
        ranks_s=ranks_s, wall_s=wall_s,
        counts={k: sum(r["counts"][k] for r in ranks)
                for k in ranks[0]["counts"]})
    cards = "a card each" if res["transport"] == "nccl" else "one card"
    log(f"phase 10 parallel: {PAR_RANKS} ranks on {cards}, transport "
        f"{res['transport']}; the war battle at contact (session saved at "
        f"frame {frame0}), map_sharded: entity rows "
        + " ".join(str(r["k1_rows"]) for r in ranks) + ", field rows "
        + " ".join(str(r["field_rows"]) for r in ranks) + ", fog rows "
        + " ".join(str(r["fog_rows"]) for r in ranks)
        + " (fog: whole planes on every rank, the map has heights)")
    for r in ranks:
        log(f"phase 10 rank {r['rank']} ({r['device']}): contact {r['contact']}"
            f" end {r['end']}; K1 launches {r['counts']['k1']} on "
            f"{r['k1_rows'][1] - r['k1_rows'][0]} rows (substeps "
            f"{r['substeps']}), K2 chunk {r['counts']['k2_chunk']} map "
            f"{r['counts']['k2_map']}; ms_per_frame contact="
            f"{r['ms_per_frame_contact']:.3f} after seek="
            f"{r['ms_per_frame_seek']:.3f}; seek order "
            f"{r['seek_order_ms']:.1f} ms; band integrator "
            f"{r['band_calls']['calls']} fields, "
            f"{r['band_calls']['sweeps']} sweeps, "
            f"{r['band_calls']['ms']:.1f} ms; max_memory_allocated="
            f"{r['max_memory_allocated']}")
    log(f"phase 10 single-device (eager): contact {ref_contact} end {ref_end};"
        f" ms_per_frame contact={res['ref_ms_per_frame_contact']:.3f}; "
        f"max_memory_allocated={ref_mem}; digests equal on all "
        f"{PAR_RANKS} ranks")
    log("phase 10 collectives per tick at contact (rank 0): " + " ".join(
        f"{k}={v['calls']:.4f} calls {v['bytes']:.1f} B"
        for k, v in per_tick.items()) + "; after the seek order "
        + " ".join(f"{k}={v['calls']} calls {v['bytes']} B" for k, v in
                   ranks[0]["collectives_seek"].items()))
    log(f"phase 10 K1 on {k1['rows']}-row bands: inputs and output bit-equal "
        f"to the whole launch's rows in all {k1['bands']} bands, bit-equal to "
        f"plain; band kernel_ms={k1['ms']:.4f} whole_ms={k1['whole_ms']:.4f} "
        f"plain_ms={k1['plain_ms']:.4f} bound_ms={k1['bound_ms']:.5f} "
        f"({k1['bound_by']})")
    log(f"phase 10 seek field (256x256): band integrator "
        f"{first['ms']:.1f} ms, {first['sweeps']} sweeps; K2 on the same field "
        f"{k2_ms:.4f} ms, bit-equal; ranks_s={ranks_s:.1f} wall_s={wall_s:.1f}")
    return res


# phase 11: the system's entry points on the card
ENTRY_UNITS = 5000           # demos/stress.py --units 5000: BASELINE #5's battle
ENTRY_SECONDS = 20           # its default simulated seconds
KNN_K, KNN_WINDOW, KNN_SAMPLE = 32, 5, 256
PV_ROW_ATOL, PV_ROW_SHARE = 1e-5, 0.999


def _launcher_modules(out: str) -> dict:
    line = [ln for ln in out.splitlines() if ln.startswith("launcher modules: ")]
    check(len(line) == 1, "the launcher printed its module check")
    return json.loads(line[0][len("launcher modules: "):])


def knn_checks(dev, eng) -> dict:
    """``grid.knn_query`` over the stress battle's final positions on the
    card against the same call on a CPU copy (idx equal, dist within 1e-5
    relative), the brute-force check of ``tests/test_grid.py`` on a sample
    of rows, its time; and ``preferred_velocity``'s fallback branch (arena
    gathers, per-pair cohesion) on the card against its CPU result."""
    from permafrost_engine_tpu_torch.core.config import SPATIAL_CELL_SIZE
    from permafrost_engine_tpu_torch.ops import boids, grid

    cfg = eng.cfg
    e = eng.state.ents
    pos, alive = e.pos.contiguous(), e.alive & (e.hp > 0)
    n = pos.shape[0]
    slots = torch.arange(n, dtype=torch.int32, device=dev)

    # the brute force holds where no bucket overflows: a cap of at least
    # tests/test_grid.py's 64 and the fullest cell's count
    r, c = grid.cell_coords(pos, cfg.grid_cells_r, cfg.grid_cells_c)
    fullest = int(torch.bincount((r * cfg.grid_cells_c + c)[alive]).max())
    cap = max(64, 1 << (fullest - 1).bit_length())

    def knn(p, a, s):
        g = grid.build_grid(p, a, cells_r=cfg.grid_cells_r,
                            cells_c=cfg.grid_cells_c, cap=cap)
        return grid.knn_query(g, p, p, s, k=KNN_K, window=KNN_WINDOW)

    got = knn(pos, alive, slots)
    want = knn(pos.cpu(), alive.cpu(), slots.cpu())
    idx, dist, valid, npos = (t.cpu() for t in got)
    check(torch.equal(idx, want[0]) and torch.equal(valid, want[2]),
          "knn_query idx and valid on the card equal the CPU's")
    fin = torch.isfinite(want[1])
    rel = ((dist[fin] - want[1][fin]).abs()
           / want[1][fin].abs().clamp(min=1e-30)).max().item() if fin.any() else 0.0
    check(rel <= 1e-5 and torch.equal(torch.isfinite(dist), fin),
          f"knn_query dist within 1e-5 relative of the CPU's: {rel}")
    # tests/test_grid.py's brute force: within the window's guaranteed
    # radius the k nearest distances, and every returned slot alive, not self
    p_np, a_np = pos.cpu().numpy(), alive.cpu().numpy()
    rows = np.nonzero(a_np)[0]
    rows = rows[np.linspace(0, len(rows) - 1, KNN_SAMPLE).astype(int)]
    guaranteed = (KNN_WINDOW // 2) * SPATIAL_CELL_SIZE
    for q in rows:
        d = np.linalg.norm(p_np - p_np[q], axis=1)
        d[~a_np] = np.inf
        d[q] = np.inf
        close = np.sort(d[d < guaranteed])[:KNN_K]
        g = dist[q][valid[q]].numpy()
        g = g[g < guaranteed]
        check(len(g) == len(close) and np.allclose(np.sort(g), close, rtol=1e-5),
              f"knn_query row {q} equals the brute force")
        check(all(j != q and a_np[j] for j in idx[q][valid[q]].tolist()),
              f"knn_query row {q} returns living others only")
    times = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        knn(pos, alive, slots)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    # preferred_velocity with neigh_* and the centroid left to its fallbacks
    mst = e.max_speed / float(cfg.move_hz)
    args = (pos, e.vel, e.flock, e.dest, torch.zeros_like(pos),
            torch.ones_like(alive), mst, got[0], got[2], alive)
    pv = boids.preferred_velocity(*args)
    pv_cpu = boids.preferred_velocity(*[a.cpu() for a in args])
    err = (pv.cpu() - pv_cpu).abs().amax(1)
    share = float((err <= PV_ROW_ATOL).float().mean())
    check(bool(torch.isfinite(pv).all()) and share >= PV_ROW_SHARE,
          f"preferred_velocity's fallbacks on the card agree with the CPU: "
          f"{share} of rows within {PV_ROW_ATOL}")
    return dict(rows=n, cap=cap, fullest=fullest, valid=int(valid.sum()),
                dist_rel_err=rel,
                brute_rows=len(rows), ms_median=float(np.median(times)),
                ms=times, pv_rows_within=share,
                pv_max_abs_err=float(err.max()),
                pv_rows_beyond=int((err > PV_ROW_ATOL).sum()))


def _live_viewer_check(dev) -> dict:
    """The live viewer's scenario on the card behind its HTTP handler on
    127.0.0.1: a click selects a unit of side 0 and a right click orders
    it; then the frame route (PNG when Pillow is there, else the rendered
    u8 frame)."""
    import threading
    import urllib.request
    from http.server import ThreadingHTTPServer

    from permafrost_engine_tpu_torch.core.config import MoveState
    from permafrost_engine_tpu_torch.script import pf
    from permafrost_engine_tpu_torch.tools import live_viewer

    eng, cam, side0 = live_viewer.default_scenario(64)
    check(eng.device.type == "cuda", "the live viewer runs on the card")
    live = live_viewer.LiveServer(eng, cam)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), live_viewer.make_handler(live))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    vw, vh = pf.context().ui.virtual_resolution
    target = eng.pos_of(side0[3])

    def at(x, z):
        s = cam.world_to_screen((float(x), 0.0, float(z)), vw, vh)
        return dict(x=s[0] / vw, y=s[1] / vh)

    try:
        for msg in (dict(type="click", button=1, **at(*target)),
                    dict(type="click", button=3, **at(target[0] + 40.0,
                                                      target[1]))):
            req = urllib.request.Request(url + "/input", method="POST",
                                         data=json.dumps(msg).encode())
            with urllib.request.urlopen(req, timeout=120) as r:
                check(r.status == 204, f"POST /input answered {r.status}")
        selected = [x.uid for x in pf.get_unit_selection()]
        ms = eng.ents_host("movestate")["movestate"]
        moving = [u for u in selected
                  if ms[eng.uid_to_slot[u]] == int(MoveState.MOVING)]
        check(len(selected) >= 1 and moving == selected,
              f"the click was consumed as an order: selected {selected}, "
              f"moving {moving}")
        if _pillow():
            t0 = time.perf_counter()
            with urllib.request.urlopen(url + "/frame.png", timeout=300) as r:
                png = r.read()
            frame_s = time.perf_counter() - t0
            check(png[:8] == b"\x89PNG\r\n\x1a\n", "GET /frame.png is a PNG")
            frame = dict(route="GET /frame.png", bytes=len(png))
        else:
            t0 = time.perf_counter()
            img = live.render_frame()
            frame_s = time.perf_counter() - t0
            check(img.shape == (384, 640, 3) and img.dtype == np.uint8,
                  "the frame route's u8 frame")
            frame = dict(route="render_frame (no Pillow)", shape=img.shape)
    finally:
        live.stop()
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
        pf._context = None
    return dict(selected=selected, moving=moving, frame_s=frame_s, **frame)


def _pillow() -> bool:
    try:
        importlib.metadata.version("pillow")
    except importlib.metadata.PackageNotFoundError:
        return False
    return True


@contextlib.contextmanager
def _quiet(name: str):
    """Send an entry point's own printing (per-second reports, the viewer's
    terminal frames) to ``chiprun_out/phase11_<name>.log``."""
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, f"phase11_{name}.log"), "w") as f, \
            contextlib.redirect_stdout(f):
        yield


def phase_entry(dev):
    """Phase 11 (see the module docstring): the port's entry points on the
    card, the stress battle uncut as their main path; what they print goes
    to ``chiprun_out/phase11_*.log``."""
    import tempfile

    from permafrost_engine_tpu_torch.demos import (campaign, editor, pong,
                                                   rts_demo, stress, viewer)
    from permafrost_engine_tpu_torch.render.draw import minimap_raster
    from permafrost_engine_tpu_torch.script import pf
    from permafrost_engine_tpu_torch.tools import export_replay

    t_phase = time.perf_counter()
    pillow = _pillow()
    log(f"phase 11 pillow={'present' if pillow else 'absent'}"
        + ("" if pillow else ": the frame route and the replay are driven up "
           "to the rendered u8 frame, which Pillow would encode"))
    torch.cuda.synchronize()
    reset_counts()
    # -- demos/stress.py --units 5000, its main loop of 20 seconds ---------
    t0 = time.perf_counter()
    eng = stress.build(ENTRY_UNITS)
    check(eng.device.type == "cuda", "the stress battle runs on the card")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    with _quiet("stress"):
        first_s, rows = stress.run(eng, ENTRY_SECONDS)
    counts = read_counts()
    h = eng.ents_host("pos", "hp", "alive")
    living = int((h["alive"] & (h["hp"] > 0)).sum())
    deaths = rows[-1]["deaths"]
    check(counts["k1"] > 0 and counts["k2_chunk"] > 0 and counts["k2_map"] > 0,
          f"K1 and K2 (chunks and whole maps) launched in the battle: {counts}")
    check(bool(np.isfinite(h["pos"]).all() and np.isfinite(h["hp"]).all()),
          "no NaN in position or hp")
    check(living + deaths == 2 * ENTRY_UNITS,
          f"living {living} + deaths {deaths} == {2 * ENTRY_UNITS}")
    graphs = graph_summary(eng)
    log(f"phase 11 stress battle: demos/stress.py --units {ENTRY_UNITS}, "
        f"{eng.cfg.max_ents} slots, build_s={build_s:.3f} capture+first "
        f"second {first_s:.3f} s, then fps per simulated second: "
        + " ".join(f"{r['fps']:.1f}" for r in rows)
        + f"; alive={rows[-1]['alive']} living={living} deaths={deaths} "
        f"launches={counts} graphs: captures={graphs.get('captures', 0)} "
        f"capture_ms={graphs.get('capture_ms', 0.0):.1f}")
    knn = knn_checks(dev, eng)
    log(f"phase 11 knn_query: {knn['rows']} positions, k={KNN_K}, window="
        f"{KNN_WINDOW}, cap={knn['cap']} (fullest cell {knn['fullest']}): idx equal to the CPU's, dist within "
        f"{knn['dist_rel_err']:.3g} relative, brute force equal on "
        f"{knn['brute_rows']} rows; ms_median={knn['ms_median']:.4f} "
        f"(synced, 10 calls); preferred_velocity fallbacks: "
        f"{knn['pv_rows_within']:.6f} of rows within {PV_ROW_ATOL} of the "
        f"CPU's ({knn['pv_rows_beyond']} beyond, max {knn['pv_max_abs_err']:.3g})")
    del eng
    # -- the demos through their mains ---------------------------------------
    demo_s = {}
    with tempfile.TemporaryDirectory(prefix="pf_phase11_") as tmp:
        t0 = time.perf_counter()
        with _quiet("rts_demo"):
            r = rts_demo.main([])
        check(r["frame"].shape == (384, 640, 3) and r["deaths"] > 0,
              f"rts_demo: {r['deaths']} deaths, a frame")
        demo_s["rts_demo"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        with _quiet("campaign"):
            camp = campaign.main([])
        demo_s["campaign"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        with _quiet("pong"):
            game = pong.main(600)
        check(game.paddles != {0: pong.H / 2, 1: pong.H / 2},
              f"pong's paddle tasks ran: {game.paddles}")
        demo_s["pong"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        with _quiet("editor"):
            ed = editor.main([os.path.join(tmp, "generated.pfmap")])
        check(ed["reachable"] and ed["device"] == "cuda",
              "editor: a path across the generated map on the card")
        demo_s["editor"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        with _quiet("viewer"):
            frames = viewer.main(["--units", "64", "--seconds", "3"])
        check(len(frames) == 3 and frames[-1].shape == (128, 128, 3),
              "viewer: three minimaps")
        demo_s["viewer"] = time.perf_counter() - t0
        pf._context = None
        # -- the game through the launcher, each in its own interpreter -----
        launched = {}
        for script, done in (("scripts/rts/main.py", "RTS GAME COMPLETE"),
                             ("scripts/editor/main.py", "EDITOR SESSION COMPLETE")):
            t0 = time.perf_counter()
            res = subprocess.run(
                [sys.executable, "-m",
                 "permafrost_engine_tpu_torch.tools.launcher", script],
                cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
                capture_output=True,
                text=True, timeout=300)
            with open(os.path.join(OUT_DIR, "phase11_launcher_"
                                   + script.split("/")[1] + ".log"), "w") as f:
                f.write(res.stdout + "\n--- stderr ---\n" + res.stderr)
            check(res.returncode == 0 and done in res.stdout,
                  f"launcher {script}: rc {res.returncode}, "
                  f"{res.stderr[-2000:]}")
            launched[script] = dict(s=time.perf_counter() - t0,
                                    modules=_launcher_modules(res.stdout))
        live = _live_viewer_check(dev)
        # -- export_replay over 120 frames -----------------------------------
        t0 = time.perf_counter()
        reng = export_replay.build(400)
        t_pos, t_state = export_replay.record(reng, 120)
        check(t_pos.shape == (20, reng.cfg.max_ents, 2)
              and t_state[-1, :, 2].sum() > 0, "export_replay recorded 20 frames")
        if pillow:
            html = export_replay.build_html(reng, t_pos, t_state, fps=10.0)
            check("data:image/png;base64," in html, "the replay's HTML")
            replay = dict(html_bytes=len(html))
        else:
            mm = minimap_raster(reng, size=512)
            check(mm.shape == (512, 512, 3), "the replay's minimap backdrop")
            replay = dict(minimap=mm.shape)
        demo_s["export_replay"] = time.perf_counter() - t0
    phase_counts = read_counts()
    wall_s = time.perf_counter() - t_phase
    res = dict(stress=dict(build_s=build_s, first_s=first_s, seconds=rows,
                           living=living, deaths=deaths, counts=counts,
                           graphs=graphs),
               knn=knn, demo_s=demo_s, campaign=camp, launched=launched,
               live=live, replay=replay, pillow=pillow, counts=phase_counts,
               wall_s=wall_s)
    log(f"phase 11 demos (s): " + " ".join(f"{k}={v:.1f}"
                                             for k, v in demo_s.items())
        + f"; campaign {camp}")
    log("phase 11 launcher: " + " ".join(
        f"{k} rc 0 in {v['s']:.1f} s, modules {v['modules']}"
        for k, v in launched.items()))
    log(f"phase 11 live viewer: POST /input selected {live['selected']}, "
        f"ordered {live['moving']}; {live['route']} in {live['frame_s']:.3f} s")
    log(f"phase 11 launches={phase_counts} (the stress battle's {counts}); "
        f"wall_s={wall_s:.1f}")
    return res


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from permafrost_engine_tpu_torch import compile_nav_costs
    from permafrost_engine_tpu_torch.assets.mapgen import make_battle_map
    from permafrost_engine_tpu_torch.ops import cuda_build

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    nvcc_ver = subprocess.run([cuda_build.nvcc(), "--version"],
                              capture_output=True, text=True, check=True
                              ).stdout.strip().splitlines()[-1]
    log(smi[0])
    try:
        triton_ver = importlib.metadata.version("triton")
    except importlib.metadata.PackageNotFoundError:
        triton_ver = "absent"
    log(f"phase 0 device: {torch.cuda.get_device_name(0)} "
        f"count={torch.cuda.device_count()} torch={torch.__version__} "
        f"cuda={torch.version.cuda} nvcc=[{nvcc_ver}] triton={triton_ver}")

    # one nvcc per source, all started together
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor() as pool:
        futures = {name: pool.submit(cuda_build.load, name)
                   for name in ("integrate", "hrvo")}
        for fut in futures.values():
            fut.result()
    builds = {name: cuda_build.BUILD_INFO[name][0]
              if name in cuda_build.BUILD_INFO else 0.0 for name in futures}
    builds["wall"] = time.perf_counter() - t0
    log("phase 1 build: " + " ".join(f"{k}={v:.2f}s" for k, v in builds.items()))

    cost, _ = compile_nav_costs(make_battle_map())
    k2 = phase_k2(dev, cost)
    k1 = phase_k1(dev)
    sl = phase_slice(dev)
    war = phase_war(dev)
    combined = phase_combined(dev)
    economy = phase_economy(dev)
    pf_battle = phase_pf(dev)
    render = phase_render(dev)
    parallel = phase_parallel(dev)
    entry = phase_entry(dev)

    wall_s = time.perf_counter() - t_start
    log(f"phases 0-11 wall_s={wall_s:.1f}")
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(dict(device=smi[0], torch=torch.__version__,
                       cuda=torch.version.cuda, nvcc=nvcc_ver, triton=triton_ver,
                       build_s=builds, k2=k2, k1=k1, slice=sl, war=war,
                       combined=combined, economy=economy,
                       pf_battle=pf_battle, render=render,
                       parallel=parallel, entry=entry, wall_s=wall_s,
                       ptxas={k: v[1] for k, v in cuda_build.BUILD_INFO.items()}),
                  f, indent=1)
    # phase 6's captured K2 calls (formation install, structure relink)
    captured = [combined["formation_k2"], combined["relink_k2"]]

    def k2_row(shape_class, batch, launches):
        b = k2[batch]
        errs = [v["max_abs_err"] for v in list(k2.values()) + captured
                if (v["h"], v["w"]) == (b["h"], b["w"])]
        return dict(name=f"K2 flow-field integration ({shape_class})",
                    route="cuda",
                    source="permafrost_engine_tpu_torch/csrc/integrate.cu",
                    replaces="permafrost_engine_tpu/ops/flowfield_pallas.py:110",
                    launches=launches, max_abs_err=max(errs), ms=b["ms"],
                    plain_ms=b["plain_ms"], bound_ms=b["bound_ms"],
                    bound_by=b["bound_by"], library_ms=None)

    # phases 4-9 and 11 in this process; phase 10's launches are its ranks'
    # (the whole-map fields there go through the band integrator, not K2)
    launches = {k: sl["counts"][k] + war["counts"][k] + combined["counts"][k]
                + economy["counts"][k] + pf_battle["counts"][k]
                + render["counts"][k] + entry["counts"][k]
                for k in sl["counts"]}
    par, kb = parallel["counts"], parallel["k1_rows"]
    kernels = [
        k2_row("64x64 chunks", "portal_spans",
               launches["k2_chunk"] + par["k2_chunk"]),
        k2_row("256x256 map", "map_layer0", launches["k2_map"] + par["k2_map"]),
        dict(name="K1 HRVO select", route="cuda",
             source="permafrost_engine_tpu_torch/csrc/hrvo.cu",
             replaces="permafrost_engine_tpu/ops/crowd_pallas.py:315",
             launches=launches["k1"],
             max_abs_err=max(k1[m]["max_abs_err"] for m in ("exact", "fan")),
             ms=k1["exact"]["ms"], plain_ms=k1["exact"]["plain_ms"],
             bound_ms=k1["exact"]["bound_ms"], bound_by=k1["exact"]["bound_by"],
             library_ms=None),
        dict(name=f"K1 HRVO select ({kb['rows']}-row rank bands)",
             route="cuda", source="permafrost_engine_tpu_torch/csrc/hrvo.cu",
             replaces="permafrost_engine_tpu/ops/crowd_pallas.py:315",
             launches=par["k1"], max_abs_err=kb["max_abs_err"], ms=kb["ms"],
             plain_ms=kb["plain_ms"], bound_ms=kb["bound_ms"],
             bound_by=kb["bound_by"], library_ms=None),
    ]
    # no PyTorch call computes either kernel's function, so no library_ms
    jax_mods = sorted(m for m in sys.modules if m.split(".")[0] in (
        "jax", "jaxlib", "flax", "permafrost_engine_tpu"))
    for v in entry["launched"].values():   # the launcher's interpreters
        jax_mods += v["modules"]["jax"] + v["modules"]["jax_pkg"]
    check(not jax_mods, f"no JAX module or JAX package imported: {jax_mods[:5]}")
    log(json.dumps({"kernels": kernels}))
    log(smi[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

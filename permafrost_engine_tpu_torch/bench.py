"""North-star benchmark: sim frames/sec at a 10k-unit battle, on the card.

Port of the repository's ``bench.py``, function for function and under its
names, driving the port's ``Engine`` on an explicit device. Scenario (the
full BASELINE config #5): two 5,000-unit combined-arms armies at war on the
4x4-chunk obstacle map (``assets/mapgen.make_battle_map``): ground corps in
``move_in_formation(RANK)`` with 3x3-footprint siege, navies on the river,
air squadrons, and 32-joint skinning every frame; movement, combat,
projectiles and fog at the reference's cadences. Six buildings drop at the
chokes mid-fight.

Each battle is measured in three phases, each the median fps of three
120-frame windows: ``march`` (the armies closing), ``contact`` (the melee)
and ``late`` (after most units are dead). The headline ``value`` is the
worst phase of the obstacle battle. ``step`` windows run micro-batched
through the engine's CUDA graphs, ``step_scan`` windows in segments. Also
measured: the plain flat-map battle, the flow-field rebuild (kernel K2 on
one chunk and on a 64-chunk batch), the 1280x720 render cell with the sim
at a render every 4th frame, and the synchronized round trip of a trivial
dispatch at the start and the end.

Output: a ``bench detail:`` line with each battle's per-cadence-class tick
profile and nav counters, then, as the last line, one compact JSON object
with ``bench.py``'s keys (under 2,048 characters). The JAX bench's
``relay_rtt_floor_ms_*`` keys are ``sync_rtt_floor_ms_*`` here: the card
has no relay, and what is timed is a dispatch and a device synchronize.

Runs on the card; ``--cpu`` asks for the CPU. Without a CUDA device and
without ``--cpu`` it exits non-zero.

Run: ``python -m permafrost_engine_tpu_torch.bench``
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from permafrost_engine_tpu_torch.core.config import DiplomacyState, EngineConfig
from permafrost_engine_tpu_torch.game.engine import Engine

# the sizes bench.py writes as literals
N_PER_SIDE = 5000
FF_MAX_FRAMES = 6000
RENDER_W, RENDER_H = 1280, 720
RENDER_ENTS = 1000
RENDER_FRAMES = 12
# and its frame counts: the warm-up, the timed windows, the fast-forward
# chunk, the frames that let the melee thicken, each tick profile, and the
# sim frames of the render cell's sim+render window
WARMUP_FRAMES = 60
PHASE_WINDOWS, PHASE_FRAMES = 3, 120
FF_CHUNK = 300
THICKEN_FRAMES = 300
PROFILE_FRAMES = 60
RENDER_SIM_FRAMES = 60
# the armies' goals: side a marches to side b's start, side b to side a's
GOALS = ((820.0, 512.0), (200.0, 512.0))

# the battles' members that go on the ``bench detail:`` line
DETAIL_KEYS = ("tick_classes", "tick_classes_rerun", "nav_stats")


def _sync(device) -> None:
    """Wait for the device's work to finish (a no-op on the CPU)."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def spawn_block(rng, x0: float, z0: float, n: int, files: int,
                dx: float = 4.0, dz: float = 3.0) -> np.ndarray:
    """`n` spawn positions from (x0, z0): `files` columns dx apart, rows dz
    apart, each position jittered by up to half a unit from `rng`."""
    fx = (np.arange(n) % files) * dx
    fz = (np.arange(n) // files) * dz
    x = x0 + fx + (rng.random(n) - 0.5)
    z = z0 + fz + (rng.random(n) - 0.5)
    return np.stack([x, z], 1).astype(np.float32)


def plain_blocks(n_per_side: int, rng) -> tuple:
    """The plain battle's draws from `rng`, in bench.py's order: the ranged
    mask (20% archers), then side a's block, then side b's."""
    ranged = rng.random(n_per_side) < 0.2
    return (spawn_block(rng, 200.0, 212.0, n_per_side, 25),
            spawn_block(rng, 820.0, 212.0, n_per_side, 25), ranged)


def battle_engine(n_per_side: int, terrain: bool, full: bool, device,
                  war: bool = True) -> Engine:
    """The battle's engine before the spawns: capacity for both armies and
    projectile headroom, the battle map if `terrain`, two factions (at war
    if `war`), both kernels built."""
    cfg = EngineConfig(max_ents=2 * n_per_side + 256,
                       skin_joints=32 if full else 0)
    eng = Engine(cfg, device=device)
    if terrain:
        from permafrost_engine_tpu_torch.assets.mapgen import make_battle_map
        eng.load_map_data(make_battle_map())
    eng.add_faction(0)
    eng.add_faction(1)
    if war:
        eng.set_diplomacy(0, 1, DiplomacyState.WAR)
    # both kernels built before the first order, as the JAX bench compiles
    # its nav kernels here
    eng.prewarm_nav()
    return eng


def spawn_armies(eng: Engine, n_per_side: int, full: bool) -> tuple:
    """Both armies (rng seed 0, bench.py's draws in its order): side a's
    and side b's uids, or with `full` each side's dict of uids by arm."""
    rng = np.random.default_rng(0)
    if not full:
        pos_a, pos_b, ranged = plain_blocks(n_per_side, rng)
        kw = dict(max_speed=20.0, is_ranged=ranged,
                  attack_range=np.where(ranged, 40.0, 5.0),
                  vision_range=80.0, hp=200.0)
        return (eng.spawn_batch(pos_a, faction=0, **kw),
                eng.spawn_batch(pos_b, faction=1, **kw))

    # per side at n=5000: a ground corps of 4,360 (3,200 melee, 1,000
    # archers, 160 radius-2.5 siege on the 3x3-footprint layer), 384 navy on
    # the water layer (the river's mid reach) and 256 air
    from permafrost_engine_tpu_torch.core.config import NavDomain

    n_melee = int(n_per_side * 0.64)
    n_arch = int(n_per_side * 0.20)
    n_siege = int(n_per_side * 0.032)
    n_navy = int(n_per_side * 0.0768)
    n_air = n_per_side - n_melee - n_arch - n_siege - n_navy

    def spawn_side(f: int, x_inf: float, x_siege: float, x_air: float,
                   navy_z0: float) -> dict:
        archer = np.arange(n_melee + n_arch) >= n_melee
        inf = eng.spawn_batch(
            spawn_block(rng, x_inf, 212.0, n_melee + n_arch, 25), faction=f,
            max_speed=20.0, is_ranged=archer,
            attack_range=np.where(archer, 40.0, 5.0),
            vision_range=80.0, hp=200.0)
        siege = eng.spawn_batch(
            spawn_block(rng, x_siege, 380.0, n_siege, 8, dx=7.0, dz=7.0),
            faction=f, radius=2.5, max_speed=10.0, is_ranged=True,
            attack_range=50.0, base_dmg=30.0, vision_range=90.0, hp=400.0)
        # the navy holds the river between the bridges: 8 files of hulls
        navy = eng.spawn_batch(
            spawn_block(rng, 452.0, navy_z0, n_navy, 8), faction=f,
            domain=NavDomain.WATER, radius=1.5, max_speed=24.0,
            is_ranged=True, attack_range=45.0, base_dmg=15.0,
            vision_range=90.0, hp=300.0)
        air = eng.spawn_batch(
            spawn_block(rng, x_air, 420.0, n_air, 16), faction=f,
            domain=NavDomain.AIR, radius=1.2, max_speed=32.0,
            is_ranged=True, attack_range=30.0, vision_range=100.0,
            hp=150.0)
        return {"inf": inf, "siege": siege, "navy": navy, "air": air}

    return (spawn_side(0, x_inf=200.0, x_siege=160.0, x_air=120.0,
                       navy_z0=400.0),
            spawn_side(1, x_inf=820.0, x_siege=930.0, x_air=880.0,
                       navy_z0=560.0))


def order_armies(eng: Engine, a, b, full: bool) -> bool:
    """The battle's orders: each army to the other's side (with `full`, the
    corps in RANK formation, the navies across the mid reach, the air
    squadrons over the map). True if the engine took every order."""
    if not full:
        return all([eng.move(a, GOALS[0]), eng.move(b, GOALS[1])])
    from permafrost_engine_tpu_torch.game.formation import FormationType

    return all([
        eng.move_in_formation(a["inf"] + a["siege"], GOALS[0],
                              FormationType.RANK),
        eng.move_in_formation(b["inf"] + b["siege"], GOALS[1],
                              FormationType.RANK),
        eng.move(a["navy"], (468.0, 620.0)),
        eng.move(b["navy"], (468.0, 404.0)),
        eng.move(a["air"], (900.0, 512.0)),
        eng.move(b["air"], (140.0, 512.0))])


def build_battle(n_per_side: int = N_PER_SIDE, terrain: bool = False,
                 full: bool = False, device="cuda") -> Engine:
    """`full=False`: the plain battle (two ground armies, no skinning).
    `full=True`: the complete BASELINE config #5 workload: RANK formations,
    navies on the river, air squadrons, siege footprints and 32-joint
    skinning at 60 Hz. `terrain` loads the 4x4-chunk battle map (choke
    walls, a river with bridges, a plateau with ramps)."""
    eng = battle_engine(n_per_side, terrain, full, device)
    a, b = spawn_armies(eng, n_per_side, full)
    order_armies(eng, a, b, full)
    return eng


def place_midfight_structures(eng: Engine) -> None:
    """Drop six blocking buildings at the battle's choke points mid-fight:
    nav cutouts, a dirty-chunk portal rebuild, field invalidation and
    replans land inside the measured windows."""
    from permafrost_engine_tpu_torch.core.config import EntityFlags

    spots = np.array([[356.0, 280.0], [356.0, 744.0],
                      [470.0, 330.0], [470.0, 700.0],
                      [590.0, 512.0], [420.0, 512.0]], np.float32)
    uids = eng.spawn_batch(
        spots, faction=0, radius=10.0,
        flags=int(EntityFlags.COLLISION | EntityFlags.BUILDING),
        max_speed=0.0, hp=1000.0)
    for u in uids:
        eng.set_structure_blocking(u, True)


def measure_rebuild(device="cuda") -> tuple[float, float]:
    """The flow-field rebuild: p50 ms of one chunk (integration, then flow
    directions) over 21 seeds, and the amortized ms per chunk of a 64-chunk
    batch, on a chunk with 15% of its tiles impassable. On the card the
    integration is kernel K2; on the CPU its plain version."""
    from permafrost_engine_tpu_torch.core.config import COST_IMPASSABLE, FIELD_RES
    from permafrost_engine_tpu_torch.ops import flowfield, flowfield_cuda

    device = torch.device(device)
    rng = np.random.default_rng(1)
    cost = np.ones((1, FIELD_RES, FIELD_RES), np.uint8)
    cost[0, rng.random((FIELD_RES, FIELD_RES)) < 0.15] = COST_IMPASSABLE
    # a copy: the seed tiles below are written into `cost` after it is taken
    cj = torch.from_numpy(cost.copy()).to(device)
    # a distinct seed per repetition
    seed_list = []
    for _ in range(21):
        r, c = rng.integers(4, FIELD_RES - 4, 2)
        cost[0, r, c] = 1
        s = np.zeros_like(cost, bool)
        s[0, r, c] = True
        seed_list.append(torch.from_numpy(s).to(device))

    def rebuild(s):
        integ = flowfield_cuda.integrate(cj, s)
        return flowfield.flow_dirs(integ, cj)

    rebuild(seed_list[0])
    _sync(device)
    times = []
    for s in seed_list:
        t0 = time.perf_counter()
        rebuild(s)
        _sync(device)
        times.append((time.perf_counter() - t0) * 1e3)
    p50_single = float(np.median(times))

    # the batched build, as the engine rebuilds: 64 chunks at once
    costs = np.repeat(cost, 64, axis=0)
    seeds_k = np.zeros_like(costs, bool)
    seeds_k[np.arange(64), rng.integers(4, 60, 64), rng.integers(4, 60, 64)] = True
    ck = torch.from_numpy(costs).to(device)
    sk = torch.from_numpy(seeds_k).to(device)

    def rebuild_k():
        integ = flowfield_cuda.integrate(ck, sk)
        return flowfield.flow_dirs(integ, ck)

    rebuild_k()
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(5):
        rebuild_k()
        _sync(device)
    per_chunk = (time.perf_counter() - t0) / 5 / 64 * 1e3
    return p50_single, per_chunk


def measure_rtt_floor(n: int = 21, device="cuda") -> float:
    """The synchronized round-trip floor (ms): the p50 of a chained trivial
    dispatch (x -> x + 1), each waited on. Reported at the bench's start
    and end, it separates fps changes from drift in the host's dispatch
    cost."""
    device = torch.device(device)
    x = torch.zeros((), device=device) + 1.0
    _sync(device)
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        x = x + 1.0
        _sync(device)
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def _class_spread(a: dict, b: dict):
    """Worst per-cadence-class p50 disagreement (%) between two
    consecutive profile_tick runs: the attribution's own error bar."""
    worst = None
    for key, ca in (a.get("classes") or {}).items():
        cb = (b.get("classes") or {}).get(key)
        if cb is None or ca["n"] < 6 or cb["n"] < 6:
            continue
        m = (ca["ms_p50"] + cb["ms_p50"]) / 2
        d = abs(ca["ms_p50"] - cb["ms_p50"]) / max(m, 1e-9) * 100
        worst = d if worst is None else max(worst, d)
    return round(worst, 1) if worst is not None else None


def alive_count(eng: Engine) -> int:
    return int(eng.ents_host("alive")["alive"].sum())


def overlap_fraction(eng: Engine) -> float:
    """Crowd-quality check: the share of living units that interpenetrate a
    neighbour by more than 50% of the combined radius (the reference's
    ClearPath keeps units apart; so must the port)."""
    from permafrost_engine_tpu_torch.core.config import CombatState

    h = eng.ents_host("alive", "combatstate", "pos", "radius")
    live = h["alive"] & (h["combatstate"] != CombatState.CORPSE)
    pos = h["pos"][live]
    rad = h["radius"][live]
    n = len(pos)
    if n < 2:
        return 0.0
    bad = np.zeros(n, bool)
    block = 2048
    for s in range(0, n, block):
        d = np.linalg.norm(pos[s:s + block, None] - pos[None, :], axis=-1)
        comb = (rad[s:s + block, None] + rad[None, :]) * 0.5
        np.fill_diagonal(d[:, s:s + block], np.inf)
        bad[s:s + block] |= (d < comb).any(axis=1)
    return float(bad.mean())


def measure_phase(eng: Engine, windows: int = PHASE_WINDOWS,
                  frames: int = PHASE_FRAMES, scan: bool = False) -> float:
    """Median fps over `windows` timed windows of `frames` frames, each
    ending in a device synchronize. scan=False drives ``step`` (the
    interactive mode the headline uses: micro-batched, each fused segment a
    CUDA graph replay on the card); scan=True drives ``step_scan`` (whole
    windows in segments)."""
    drive = eng.step_scan if scan else eng.step
    vals = []
    for _ in range(windows):
        t0 = time.perf_counter()
        drive(frames)
        _sync(eng.device)
        vals.append(frames / (time.perf_counter() - t0))
    return float(np.median(vals))


def fast_forward_until(eng: Engine, pred, chunk: int = FF_CHUNK,
                       max_frames: int = FF_MAX_FRAMES) -> int:
    """step_scan in `chunk`-frame windows until pred(alive) or the cap."""
    total = 0
    while total < max_frames:
        eng.step_scan(chunk)
        total += chunk
        if pred(alive_count(eng)):
            break
    return total


def run_battle(terrain: bool, full: bool = False, device="cuda") -> dict:
    """Drive one battle (flat or obstacle map); returns its phase stats."""
    eng = build_battle(N_PER_SIDE, terrain=terrain, full=full, device=device)
    n0 = alive_count(eng)
    # warm-up: the first second (graph captures on the card)
    eng.step(WARMUP_FRAMES)

    def phase(scan: bool = False) -> float:
        return measure_phase(eng, PHASE_WINDOWS, PHASE_FRAMES, scan=scan)

    # -- phase 1: march (the armies closing, no contact yet) ------------------
    fps_march = phase()
    alive_march = alive_count(eng)

    # -- fast-forward to contact (the first deaths), then let it thicken ------
    ff1 = fast_forward_until(eng, lambda a: a < n0, FF_CHUNK, FF_MAX_FRAMES)
    eng.step_scan(THICKEN_FRAMES)
    if terrain:
        # structures dropped mid-fight: dirty-chunk rebuilds and replans land
        # inside the measured contact windows
        place_midfight_structures(eng)
    fps_contact = phase()
    fps_contact_scan = phase(scan=True)
    alive_contact = alive_count(eng)
    overlap_frac = overlap_fraction(eng)
    # two consecutive probes: per-cadence-class p50s must agree run to run
    tick_stats = eng.profile_tick(PROFILE_FRAMES)
    tick_rerun = eng.profile_tick(PROFILE_FRAMES)

    # -- late phase: most of one side dead ------------------------------------
    fast_forward_until(eng, lambda a: a < 0.55 * n0, FF_CHUNK, FF_MAX_FRAMES)
    fps_late = phase()
    alive_end = alive_count(eng)

    return {
        "fps_min": min(fps_march, fps_contact, fps_late),
        "fps_march": round(fps_march, 2),
        "fps_contact": round(fps_contact, 2),
        "fps_contact_scan": round(fps_contact_scan, 2),
        "fps_late": round(fps_late, 2),
        "alive_after_march": alive_march,
        "alive_after_contact": alive_contact,
        "overlap_frac_contact": round(overlap_frac, 4),
        "alive_at_end": alive_end,
        "frames_to_contact": (WARMUP_FRAMES + PHASE_WINDOWS * PHASE_FRAMES
                              + ff1),
        "tick_ms_amortized": round(tick_stats.get("ms_mean", 0.0), 3),
        "tick_classes": tick_stats.get("classes"),
        "tick_classes_rerun": tick_rerun.get("classes"),
        "tick_rerun_spread_pct": _class_spread(tick_stats, tick_rerun),
        "tick_flops_upper": tick_stats.get("tick_flops_upper"),
        "tick_hbm_bytes_upper": tick_stats.get("tick_hbm_bytes_upper"),
        "mfu_upper_pct": tick_stats.get("mfu_upper_pct"),
        "nav_stats": {k: v for k, v in eng.nav.stats.items()},
    }


def render_scene(n_ents: int = RENDER_ENTS, device="cuda") -> tuple:
    """The render cell's scene and view: the battle map (32-joint skinning)
    with `n_ents` units in two blocks at war (rng seed 0), each ordered
    across, and a camera over the map's middle, 50 degrees down. Returns
    (engine, camera)."""
    from permafrost_engine_tpu_torch.assets.mapgen import make_battle_map
    from permafrost_engine_tpu_torch.render.camera import Camera

    cfg = EngineConfig(max_ents=n_ents + 64, skin_joints=32)
    eng = Engine(cfg, device=device)
    eng.load_map_data(make_battle_map())
    eng.add_faction(0)
    eng.add_faction(1)
    eng.set_diplomacy(0, 1, DiplomacyState.WAR)
    rng = np.random.default_rng(0)
    half = n_ents // 2
    for f, x0 in ((0, 250.0), (1, 600.0)):
        pos = np.stack([rng.uniform(x0, x0 + 160, half),
                        rng.uniform(300, 700, half)], 1).astype(np.float32)
        uids = eng.spawn_batch(pos, faction=f, max_speed=20.0,
                               vision_range=80.0, hp=200.0)
        eng.move(uids, (850.0 - x0, 512.0))

    cam = Camera()
    cam.pos = np.array([eng.cfg.world_w / 2, 220.0,
                        eng.cfg.world_h / 2 + 180.0])
    cam.pitch, cam.yaw = -50.0, 90.0
    return eng, cam


def measure_render(w: int = RENDER_W, h: int = RENDER_H,
                   n_ents: int = RENDER_ENTS, frames: int = RENDER_FRAMES,
                   device="cuda") -> dict:
    """The render cell: ms per frame at WxH of the battle map with ~1k units
    at war, water reflection and refraction, the light-ortho shadow pass
    and the overlays. ``render`` ends in the u8 frame's host copy, so each
    call is a true wall-clock frame. Also the sim at a render every 4th
    frame (the demos' 15 Hz presentation)."""
    from permafrost_engine_tpu_torch.render.scene import SceneRenderer

    eng, cam = render_scene(n_ents, device)
    eng.step(30)
    r = SceneRenderer(eng, w=w, h=h, maxi=n_ents,
                      shadows=True, reflections=True)
    t0 = time.perf_counter()
    r.render(cam, faction_pov=0)
    compile_s = time.perf_counter() - t0

    times = []
    for _ in range(frames):
        eng._frame += 1          # the shadow cache keys on the frame counter
        t0 = time.perf_counter()
        r.render(cam, faction_pov=0)
        times.append((time.perf_counter() - t0) * 1e3)
    p50 = float(np.median(times))

    t0 = time.perf_counter()
    sim_frames = RENDER_SIM_FRAMES
    for _ in range(sim_frames // 4):
        eng.step(4)
        r.render(cam, faction_pov=0)
    _sync(eng.device)
    combined_fps = sim_frames / (time.perf_counter() - t0)

    return {
        "resolution": f"{w}x{h}",
        "render_ms_p50": round(p50, 1),
        "render_fps": round(1000.0 / p50, 2),
        "render_ms_p90": round(float(np.percentile(times, 90)), 1),
        "sim_plus_render_fps_dec4": round(combined_fps, 2),
        "first_frame_compile_s": round(compile_s, 1),
        "scene": f"battle map, {n_ents} entities, water refl+refr, "
                 "shadows, HUD",
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m permafrost_engine_tpu_torch.bench",
        description="The 10k-unit battle benchmark on the card.")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        print("bench: no CUDA device (pass --cpu to run on the CPU)",
              file=sys.stderr)
        raise SystemExit(1)
    device = "cpu" if args.cpu else "cuda"

    rtt_start = measure_rtt_floor(device=device)
    rebuild_p50, rebuild_batched = measure_rebuild(device)
    render = measure_render(RENDER_W, RENDER_H, RENDER_ENTS, RENDER_FRAMES,
                            device=device)

    # the headline: the full BASELINE config #5 battle on the obstacle map;
    # the plain flat-map battle is reported beside it
    obstacle = run_battle(terrain=True, full=True, device=device)
    flat = run_battle(terrain=False, device=device)
    rtt_end = measure_rtt_floor(device=device)

    fps_min = obstacle["fps_min"]
    out = {
        "metric": "sim_fps_10k_skinned_formation_battle_worst_phase",
        "value": round(fps_min, 2),
        "unit": "frames/s (60Hz frames, 10k skinned units, RANK "
                "formations, ground+water+air layers, worst phase, "
                "obstacle map)",
        "vs_baseline": round(fps_min / 60.0, 3),
        "flat_map_worst_phase_fps": round(flat["fps_min"], 2),
        # the synchronized round-trip floor at the start and the end: fps
        # changes smaller than its drift are the host's, not the engine's
        "sync_rtt_floor_ms_start": round(rtt_start, 2),
        "sync_rtt_floor_ms_end": round(rtt_end, 2),
        "obstacle": obstacle,
        "flat": flat,
        "flow_field_rebuild_ms_p50": round(rebuild_p50, 3),
        "flow_field_rebuild_ms_per_chunk_batched": round(rebuild_batched, 3),
        "rebuild_vs_2ms_target": round(2.0 / max(rebuild_p50, 1e-6), 1),
        "render": render,
    }
    detail = {name: {k: battle[k] for k in DETAIL_KEYS}
              for name, battle in (("obstacle", obstacle), ("flat", flat))}
    line = {k: ({kk: vv for kk, vv in v.items() if kk not in DETAIL_KEYS}
                if k in ("obstacle", "flat") else v)
            for k, v in out.items()}
    print("bench detail: " + json.dumps(detail, separators=(",", ":")),
          flush=True)
    print(json.dumps(line, separators=(",", ":")), flush=True)
    return out


if __name__ == "__main__":
    main()

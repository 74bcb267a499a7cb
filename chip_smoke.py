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
   melee), stepped until the first death (which must come within 1,800
   frames), then a 120-frame contact window timed frame by frame, then 60
   frames with every substep bracketed by synchronizations. Fails unless
   K1's launches equal the movement substeps, K2 launched for chunks and
   for whole maps (the chase fields), deaths, attack starts and
   projectile hits occurred, each faction holds a chase field and sees
   ``VISIBLE`` fog tiles, and no position, velocity or hp is NaN. Prints
   ms per frame (march, contact, worst contact frame), ms per substep
   kind at contact, the chase-field rebuild through K2 (ms and field
   count), the nav cadence's counters and peak memory;
6. the combined-arms battle (BASELINE #5: ``bench.py``'s
   ``build_battle(5000, terrain=True, full=True)`` then
   ``place_midfight_structures``, with ``skin_joints=0``, the one cut):
   per side a 4,360-unit ground corps (3,200 melee, 1,000 archers, 160
   radius-2.5 siege) in one ``move_in_formation(RANK)``, 384 navy on the
   water layer and 256 air, at war from the start. After 300 frames six
   radius-10 buildings drop at the chokes (``set_structure_blocking``);
   at the first death (within 1,800 frames) side 0's air gets
   ``seek_enemies`` and side 1's air ``surround`` on side 0's first siege
   unit; then 120 contact frames. Fails unless every corps unit holds a
   distinct passable cell of its block and its flock is RANK, K2 launched
   for chunks during each formation order and at the structure commit,
   K2 is bit-equal to its plain version on the captured inputs of the
   first formation install and of the structure relink, the footprints
   are impassable on ground and water layers and untouched on air, chunks
   were relinked and the nav version bumped, the seek flock holds a
   whole-map field, whole-map K2 launches grew with the orders, the
   surround flock closed on its target, K1's launches equal the movement
   substeps, deaths, attack starts and projectile hits occurred, the
   formation keep force is bit-equal over repeated evaluations on the
   frame-300 state, and no position, velocity or hp is NaN. Prints a
   digest of every position and velocity at frame 300 and at the end
   (equal across runs of the same code), each formation order's seconds
   (layout, auction, field install; the auction's rounds, bidders, cells
   and whether the greedy fill ran), the commit frame's ms, ms per frame
   (march, contact, worst contact frame), the seek and surround order
   ms and peak memory.

The script imports only the port and fails if any ``jax``/``jaxlib``/
``flax`` module or anything of the JAX package (``permafrost_engine_tpu``)
was loaded. Before the last line come one JSON object with per-kernel
numbers (time, plain time, the card's least time for the work and what
sets it, launches on the main path) and the card's name and power limit;
the last is ``{"ok": true, "device": {...}}``. Details go to
``chiprun_out/``.
"""

import concurrent.futures
import contextlib
import hashlib
import importlib.metadata
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out")
N_PER_SIDE = 5000
FRAMES = 360
WAR_MAX_FRAMES = 1800       # the first death must come within this
CONTACT_FRAMES = 120
SUBSTEP_FRAMES = 60
COMBINED_MARCH_FRAMES = 300  # phase 6: frames before the buildings drop
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


def phase_war(dev):
    """The battle at war through the port's Engine: march to first blood,
    a timed contact window, then the per-substep split (see the module
    docstring)."""
    from permafrost_engine_tpu_torch import FRAME_HZ, FogState

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    eng, _a, _b, _goals = build_battle(dev, war=True)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    period = FRAME_HZ // eng.cfg.move_hz
    substeps = 0

    def frame():
        nonlocal substeps
        torch.cuda.synchronize()
        t = time.perf_counter()
        eng.step(1)
        torch.cuda.synchronize()
        substeps += eng.state.tick % period == 0
        return time.perf_counter() - t

    def count(kind):
        return sum(1 for k, _ in eng.events if k == kind)

    march = []
    while count("entity_death") == 0:
        check(len(march) < WAR_MAX_FRAMES,
              f"no death within {WAR_MAX_FRAMES} frames at war")
        march.append(frame())
    contact = [frame() for _ in range(CONTACT_FRAMES)]
    sub_s: dict = {}
    restore = _timed_substeps(sub_s)
    try:
        for _ in range(SUBSTEP_FRAMES):
            frame()
    finally:
        restore()
    counts = read_counts()
    k1 = counts["k1"]

    e = eng.state.ents
    check(bool(torch.isfinite(e.pos).all() and torch.isfinite(e.vel).all()
               and not torch.isnan(e.hp).any()), "no NaN in pos/vel/hp")
    check(k1 == substeps and k1 > 0, f"K1 launches {k1} == substeps {substeps}")
    check(counts["k2_chunk"] > 0, f"K2 launched for chunks at war: {counts}")
    check(counts["k2_map"] > 0,
          f"K2 launched for the whole-map chase fields at war: {counts}")
    ev = {k: count(k) for k in ("entity_death", "attack_start",
                                "projectile_hit", "entity_removed")}
    for k in ("entity_death", "attack_start", "projectile_hit"):
        check(ev[k] > 0, f"{k} events at war: {ev}")
    chase = eng.state.factions.chase_slot.cpu().numpy()
    check(chase[0].max() >= 0 and chase[1].max() >= 0,
          f"each faction holds a chase field: {chase[:2].tolist()}")
    fog = eng.state.fog.state
    visible = [int((fog[f] == FogState.VISIBLE).sum()) for f in (0, 1)]
    check(min(visible) > 0, f"each faction sees VISIBLE fog tiles: {visible}")
    check(eng._tile_height is not None, "the battle map has fog heights")

    # the chase-field rebuild through K2, alone, on the live state
    specs = [(f, lay, slot, None)
             for (f, lay), slot in sorted(eng._chase_gslot.items())]
    seek = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        eng.state = eng.nav.build_enemy_seek_fields_batch(eng.state, specs)
        torch.cuda.synchronize()
        seek.append(time.perf_counter() - t)
    res = dict(
        setup_s=setup_s, march_frames=len(march),
        ms_per_frame_march=1e3 * sum(march) / len(march),
        ms_per_frame_contact=1e3 * sum(contact) / len(contact),
        max_ms_frame_contact=1e3 * max(contact),
        ms_per_substep_contact={k: 1e3 * sum(v) / len(v)
                                for k, v in sub_s.items()},
        substep_calls={k: len(v) for k, v in sub_s.items()},
        seek_build_ms=[1e3 * x for x in seek], seek_build_fields=len(specs),
        seek_batches=eng.nav.stats["seek_batches"],
        seek_fields=eng.nav.stats["seek_fields"],
        counters=dict(eng.counters), events=ev, counts=counts,
        substeps=substeps, visible_tiles=visible,
        chase_slots=chase[:2].tolist(),
        max_memory_allocated=torch.cuda.max_memory_allocated())
    log(f"phase 5 war: {2 * N_PER_SIDE} units at war, setup_s={setup_s:.3f} "
        f"first death after {len(march)} frames, "
        f"ms_per_frame march={res['ms_per_frame_march']:.4f} "
        f"contact={res['ms_per_frame_contact']:.4f} "
        f"(max {res['max_ms_frame_contact']:.4f}), launches={counts} "
        f"(k1 = substeps), events={ev}")
    log("phase 5 substeps at contact (ms, sync-bracketed): " + " ".join(
        f"{k}={v:.4f}x{res['substep_calls'][k]}"
        for k, v in res["ms_per_substep_contact"].items()))
    log(f"phase 5 chase-field rebuild (K2, 256x256): {len(specs)} fields, ms="
        + ",".join(f"{x:.3f}" for x in res["seek_build_ms"])
        + f"; batches={res['seek_batches']} fields={res['seek_fields']}")
    log("phase 5 cadence counters (ms): " + " ".join(
        f"{k}={v:.3f}" for k, v in res["counters"].items())
        + f"; max_memory_allocated={res['max_memory_allocated']}")
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
    check(bool((outs[0] != 0).any()), "the keep force acts at frame 300")
    check(all(torch.equal(o, outs[0]) for o in outs[1:]),
          f"the formation keep force is bit-equal over {evals} evaluations")
    return evals


def phase_combined(dev):
    """The combined-arms battle (BASELINE #5, bench.py's build_battle(5000,
    terrain=True, full=True) with place_midfight_structures) through the
    port's Engine, with skin_joints=0: see the module docstring."""
    from permafrost_engine_tpu_torch import DiplomacyState, EngineConfig, FRAME_HZ
    from permafrost_engine_tpu_torch.assets.mapgen import make_battle_map
    from permafrost_engine_tpu_torch.core.config import EntityFlags
    from permafrost_engine_tpu_torch.game import engine as engine_mod
    from permafrost_engine_tpu_torch.game.engine import Engine
    from permafrost_engine_tpu_torch.game.formation import FormationType
    from permafrost_engine_tpu_torch.nav import portals, service
    from permafrost_engine_tpu_torch.ops import flowfield_cuda

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    cap = K2Capture()
    t0 = time.perf_counter()
    cfg = EngineConfig(max_ents=2 * N_PER_SIDE + 256)   # skin_joints=0
    check(cfg.skin_joints == 0, "phase 6 runs without skinning")
    eng = Engine(cfg, device=dev)
    eng.load_map_data(make_battle_map())
    eng.add_faction(0)
    eng.add_faction(1)
    eng.set_diplomacy(0, 1, DiplomacyState.WAR)
    a, b = spawn_combined(eng)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    period = FRAME_HZ // cfg.move_hz
    substeps = 0
    seen = {"events": 0, "first_death": None}

    def frame():
        nonlocal substeps
        torch.cuda.synchronize()
        t = time.perf_counter()
        eng.step(1)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        substeps += eng.state.tick % period == 0
        if seen["first_death"] is None and any(
                k == "entity_death" for k, _ in eng.events[seen["events"]:]):
            seen["first_death"] = eng.state.tick
        seen["events"] = len(eng.events)
        return dt

    def count(kind):
        return sum(1 for k, _ in eng.events if k == kind)

    with patched((service, "integrate", cap.wrap),
                 (portals, "integrate", cap.wrap),
                 (portals, "update_portal_graph",
                  lambda fn: cap.arm("structure relink", fn))):
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

        # -- march, then the buildings drop at the chokes --------------------
        march = [frame() for _ in range(COMBINED_MARCH_FRAMES)]
        keep_evals = check_keep_force_repeats(eng)
        digest_300 = state_digest(eng)
        sid = eng.spawn_batch(
            STRUCTURE_SPOTS, faction=0, radius=STRUCTURE_RADIUS,
            flags=int(EntityFlags.COLLISION | EntityFlags.BUILDING),
            max_speed=0.0, hp=1000.0)
        for u in sid:
            eng.set_structure_blocking(u, True)
        rects = [eng._structures[u] for u in sid]
        ver, rebuilt = eng._nav_version, eng.nav.stats["chunks_rebuilt"]
        k2 = flowfield_cuda.launches_chunk
        commit_ms = 1e3 * frame()
        k2_commit = flowfield_cuda.launches_chunk - k2
        check(eng._nav_version == ver + 1, "the commit bumped _nav_version")
        check(eng.nav.stats["chunks_rebuilt"] > rebuilt,
              f"chunks relinked: {eng.nav.stats['chunks_rebuilt']}")
        check(k2_commit > 0, f"K2 launched for chunks at the commit ({k2_commit})")
        check_structures(eng, rects)
        relink_k2 = cap.check("structure relink")

        while seen["first_death"] is None:
            check(len(march) + 1 < WAR_MAX_FRAMES,
                  f"no death within {WAR_MAX_FRAMES} frames")
            march.append(frame())

        # -- at first blood: seek and surround orders ------------------------
        live = [u for u in a["air"] if u in eng.uid_to_slot]
        pack = [u for u in b["air"] if u in eng.uid_to_slot]
        target = a["siege"][0]
        k2_map = flowfield_cuda.launches_map
        torch.cuda.synchronize()
        t = time.perf_counter()
        check(eng.seek_enemies(live), "seek_enemies order")
        torch.cuda.synchronize()
        seek_ms = 1e3 * (time.perf_counter() - t)
        t = time.perf_counter()
        check(eng.surround(pack, target), "surround order")
        torch.cuda.synchronize()
        surround_ms = 1e3 * (time.perf_counter() - t)
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
        contact = [frame() for _ in range(CONTACT_FRAMES)]
        d1 = surround_dist()
    counts = read_counts()
    e = eng.state.ents
    check(bool(torch.isfinite(e.pos).all() and torch.isfinite(e.vel).all()
               and not torch.isnan(e.hp).any()), "no NaN in pos/vel/hp")
    check(counts["k1"] == substeps and substeps > 0,
          f"K1 launches {counts['k1']} == substeps {substeps}")
    check(d1 < d0, f"the surround flock closed on its target {d0} -> {d1}")
    digest_end = state_digest(eng)
    ev = {k: count(k) for k in ("entity_death", "attack_start",
                                "projectile_hit", "entity_removed")}
    for k in ("entity_death", "attack_start", "projectile_hit"):
        check(ev[k] > 0, f"{k} events: {ev}")
    res = dict(
        setup_s=setup_s, orders=orders, formation_k2=formation_k2,
        relink_k2=relink_k2, commit_frame_ms=commit_ms, k2_commit=k2_commit,
        chunks_rebuilt=eng.nav.stats["chunks_rebuilt"],
        invalidations=eng.nav.stats["invalidations"],
        march_frames=len(march), first_death_frame=seen["first_death"],
        ms_per_frame_march=1e3 * sum(march) / len(march),
        ms_per_frame_contact=1e3 * sum(contact) / len(contact),
        max_ms_frame_contact=1e3 * max(contact),
        seek_order_ms=seek_ms, surround_order_ms=surround_ms,
        seek_fid=seek_fid, surround_fid=sur_fid,
        surround_dist=[d0, d1], events=ev, counts=counts, substeps=substeps,
        keep_force_evals=keep_evals, digest_frame_300=digest_300,
        digest_end=digest_end,
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
    log(f"phase 6 combined arms: {eng.cfg.max_ents} slots, skin_joints=0 "
        f"(the one cut), setup_s={setup_s:.3f}; K2 bit-equal to plain on the "
        f"first formation install (K={formation_k2['k']}) and the structure "
        f"relink (K={relink_k2['k']}); structure commit frame "
        f"{commit_ms:.3f} ms (K2 chunk launches {k2_commit}, chunks_rebuilt="
        f"{res['chunks_rebuilt']}); first death at frame "
        f"{res['first_death_frame']}, orders after frame {len(march) + 1}")
    log(f"phase 6 ms_per_frame march={res['ms_per_frame_march']:.4f} "
        f"contact={res['ms_per_frame_contact']:.4f} (max "
        f"{res['max_ms_frame_contact']:.4f}); seek order {seek_ms:.3f} ms, "
        f"surround order {surround_ms:.3f} ms, surround distance "
        f"{d0:.1f}->{d1:.1f}; launches={counts} (k1 = substeps), events={ev}; "
        f"max_memory_allocated={res['max_memory_allocated']}")
    log(f"phase 6 determinism: formation keep force bit-equal over "
        f"{keep_evals} evaluations; pos/vel digest at frame "
        f"{COMBINED_MARCH_FRAMES} {digest_300}, at the end {digest_end}; "
        f"projectile hits {ev['projectile_hit']}, surround distance "
        f"{d0!r}->{d1!r}")
    log("phase 6 cadence counters (ms): " + " ".join(
        f"{k}={v:.3f}" for k, v in res["counters"].items()))
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

    wall_s = time.perf_counter() - t_start
    log(f"phases 0-6 wall_s={wall_s:.1f}")
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(dict(device=smi[0], torch=torch.__version__,
                       cuda=torch.version.cuda, nvcc=nvcc_ver, triton=triton_ver,
                       build_s=builds, k2=k2, k1=k1, slice=sl, war=war,
                       combined=combined, wall_s=wall_s,
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

    launches = {k: sl["counts"][k] + war["counts"][k] + combined["counts"][k]
                for k in sl["counts"]}
    kernels = [
        k2_row("64x64 chunks", "portal_spans", launches["k2_chunk"]),
        k2_row("256x256 map", "map_layer0", launches["k2_map"]),
        dict(name="K1 HRVO select", route="cuda",
             source="permafrost_engine_tpu_torch/csrc/hrvo.cu",
             replaces="permafrost_engine_tpu/ops/crowd_pallas.py:315",
             launches=launches["k1"],
             max_abs_err=max(k1[m]["max_abs_err"] for m in ("exact", "fan")),
             ms=k1["exact"]["ms"], plain_ms=k1["exact"]["plain_ms"],
             bound_ms=k1["exact"]["bound_ms"], bound_by=k1["exact"]["bound_by"],
             library_ms=None),
    ]
    # no PyTorch call computes either kernel's function, so no library_ms
    jax_mods = sorted(m for m in sys.modules if m.split(".")[0] in (
        "jax", "jaxlib", "flax", "permafrost_engine_tpu"))
    check(not jax_mods, f"no JAX module or JAX package imported: {jax_mods[:5]}")
    log(json.dumps({"kernels": kernels}))
    log(smi[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

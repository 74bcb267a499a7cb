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
   count), the nav cadence's counters and peak memory.

The script imports only the port and fails if any ``jax``/``jaxlib``/
``flax`` module or anything of the JAX package (``permafrost_engine_tpu``)
was loaded. Before the last line come one JSON object with per-kernel
numbers (time, plain time, the card's least time for the work and what
sets it, launches on the main path) and the card's name and power limit;
the last is ``{"ok": true, "device": {...}}``. Details go to
``chiprun_out/``.
"""

import concurrent.futures
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


def spawn_blocks():
    """The two armies' spawn positions and ranged mask (rng seed 0), as
    bench.py's build_battle(5000, terrain=True) spawns them."""
    rng = np.random.default_rng(0)

    def block(x0, z0, n, files, dx=4.0, dz=3.0):
        fx = (np.arange(n) % files) * dx
        fz = (np.arange(n) // files) * dz
        x = x0 + fx + (rng.random(n) - 0.5)
        z = z0 + fz + (rng.random(n) - 0.5)
        return np.stack([x, z], 1).astype(np.float32)

    ranged = rng.random(N_PER_SIDE) < 0.2
    return (block(200.0, 212.0, N_PER_SIDE, 25),
            block(820.0, 212.0, N_PER_SIDE, 25), ranged)


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


def main() -> int:
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

    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(dict(device=smi[0], torch=torch.__version__,
                       cuda=torch.version.cuda, nvcc=nvcc_ver, triton=triton_ver,
                       build_s=builds, k2=k2, k1=k1, slice=sl, war=war,
                       ptxas={k: v[1] for k, v in cuda_build.BUILD_INFO.items()}),
                  f, indent=1)
    def k2_row(shape_class, batch, launches):
        b = k2[batch]
        errs = [v["max_abs_err"] for v in k2.values()
                if (v["h"], v["w"]) == (b["h"], b["w"])]
        return dict(name=f"K2 flow-field integration ({shape_class})",
                    route="cuda",
                    source="permafrost_engine_tpu_torch/csrc/integrate.cu",
                    replaces="permafrost_engine_tpu/ops/flowfield_pallas.py:110",
                    launches=launches, max_abs_err=max(errs), ms=b["ms"],
                    plain_ms=b["plain_ms"], bound_ms=b["bound_ms"],
                    bound_by=b["bound_by"], library_ms=None)

    launches = {k: sl["counts"][k] + war["counts"][k] for k in sl["counts"]}
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

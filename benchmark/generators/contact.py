"""The contact generator: builds a cell's battle from its configuration
file and drives it as its traffic file says. Its ``Cell`` is the
interface every generator keeps (``benchmark/generators/__init__.py``).

A traffic file (``benchmark/traffic/<mix>.json``) with ``"generator":
"contact"`` holds only parameters:

- ``stepping``: ``"scan"`` (headless: the window loops
  ``Engine.step_scan(call_frames)``) or ``"frame"`` (the game loop: one
  ``Engine.step(1)`` a frame, with the orders due that frame first);
- ``march``: the set-up's march, ``step_scan(chunk_frames)`` for at least
  ``min_frames`` and, with ``until_death``, until the first death (at
  most ``max_frames``, else set-up fails), then ``thicken_frames`` more;
- ``warm_frames``: frames of the window's own stepping run in set-up;
- ``waves`` (or null): every ``period_frames`` frames of the window each
  side gets back the units it lost since the last wave (the slots expired
  corpses freed), at its spawn blocks, in the configuration's arm mix;
  they and the living units of the side's earlier waves take the side's
  standing order together, so a side holds one reinforcement flock per
  nav layer and the engine's flock table does not fill;
- ``orders`` (frame stepping, or null): side ``side``'s army split, from
  the seed, into ``groups`` control groups of one nav layer each; every
  ``period_frames`` frames the player orders the next group, whole, to
  one of ``rally_points`` points of its layer drawn from the seed within
  ``front_radius`` world units of the front;
- ``trace_frames``: the traced stretch of a ``--trace 1`` run;
- ``check_frames``: the frames recorded for the comparison after the
  window (scan stepping records calls of ``check_call_frames``).

Everything random is drawn from ``numpy.random.default_rng(seed)`` in a
fixed order, so a seed gives the same battle, groups, points and orders.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from benchmark import scene
from benchmark.check import FormationRecorder

# entity columns the nav cadence's replans write on the host
HOST_COLUMNS = ("dest", "flock", "formation_cell", "has_formation_cell")


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Cell:
    """One cell's battle on `device`: ``setup()``, then ``window(s)``,
    optionally ``drive(frames)`` (the traced stretch), then
    ``record(frames, rec)``. A generator with other traffic subclasses it
    and extends the hooks: ``prepare()`` (set-up after the march),
    ``before_call(n)`` and ``after_call(n)`` (around each call of the
    engine's stepping), ``goal(arm)`` (where the player's next order
    goes); and for the check ``recorders()``, ``judge_extra(device)`` and
    ``host_columns(n)``."""

    def __init__(self, conf: dict, traffic: dict, seed: int, device):
        self.conf, self.traffic = conf, traffic
        self.device = torch.device(device)
        self.rng = np.random.default_rng(seed)
        self.map_data = scene.make_battle_map() if conf["terrain"] else None
        self.eng = None
        self.split: dict[str, float] = {}
        self.frames_since_wave = 0
        self.order_count = 0
        self.order_times: list[float] = []
        self.orders_failed = 0
        self.orders_attempted = 0
        self.cache_hits = [0, 0]
        self.wave_log: list[list[int]] = []
        # each side's reinforcements by arm, rallied at every wave
        self.reinforcements: list[dict] = [{}, {}]
        self.frame = 0          # frames this cell has stepped
        self.events_seen = 0
        # the formation auctions of the standing orders, for the check
        self.formations = FormationRecorder()

    # -- set-up ---------------------------------------------------------------

    def _lap(self, key: str, t0: float) -> float:
        now = time.perf_counter()
        self.split[key] = self.split.get(key, 0.0) + now - t0
        return now

    def setup(self) -> None:
        conf, tr = self.conf, self.traffic
        t = time.perf_counter()
        self.eng = eng = scene.build_engine(conf, self.device, self.map_data)
        _sync(self.device)
        t = self._lap("engine_kernels_s", t)
        self.sides = scene.spawn_armies(eng, self.rng, conf)
        self.strength = [sum(len(v) for v in s.values()) for s in self.sides]
        _sync(self.device)
        t = self._lap("spawn_s", t)
        with self.formations:
            ok = scene.order_armies(eng, self.sides, conf["full"])
        _sync(self.device)
        t = self._lap("standing_orders_s", t)
        if not all(ok):
            raise RuntimeError("the engine refused a standing order")
        self._march(tr["march"])
        _sync(self.device)
        t = self._lap("march_s", t)
        self.split["captures_s"] = self._captures_s()
        self.split["march_s"] -= self.split["captures_s"]
        self.prepare()
        t = self._lap("traffic_plan_s", t)
        self.drive(tr["warm_frames"])
        _sync(self.device)
        self._lap("warm_frames_s", t)
        self.split["captures_s"] = self._captures_s()
        self.frames_since_wave = 0
        self.order_times.clear()
        self.orders_failed = 0
        self.orders_attempted = 0
        self.cache_hits = [0, 0]
        self.wave_log.clear()
        self.events_seen = 0

    def _march(self, c: dict) -> None:
        """``step_scan(chunk_frames)`` for at least ``min_frames`` and, with
        ``until_death``, until the first death, then ``thicken_frames``."""
        eng = self.eng
        start = scene.alive_by_side(eng).sum()
        marched = 0
        march_alive = []
        while True:
            self._scan(c["chunk_frames"])
            marched += c["chunk_frames"]
            march_alive.append(int(scene.alive_by_side(eng).sum()))
            if marched >= c["min_frames"] and (
                    not c["until_death"] or march_alive[-1] < start):
                break
            if marched >= c["max_frames"]:
                raise RuntimeError(f"no death in {marched} frames of march")
        self._scan(c["thicken_frames"])
        self.split["frames_marched"] = marched
        self.split["alive_on_the_march"] = march_alive + [
            int(scene.alive_by_side(eng).sum())]

    def prepare(self) -> None:
        """Set-up of the traffic after the march: the player's control
        groups and rally points where the mix gives orders."""
        if self.traffic.get("orders"):
            self._plan_orders(self.traffic["orders"])

    def _scan(self, n: int) -> None:
        self.eng.step_scan(n)
        self.frame += n
        self._consume_events()

    def _consume_events(self) -> None:
        """Take the engine's host events after every call, as a game's host
        loop or a replay recorder does (``Engine.events`` is a log the host
        drains; left to grow, its millions of entries cost the collector
        more every frame)."""
        self.events_seen += len(self.eng.events)
        self.eng.events.clear()

    def _captures_s(self) -> float:
        """Seconds the engine's segment stepper spent capturing CUDA
        graphs, where it reports them."""
        stats = getattr(getattr(self.eng, "_scan_fn", None), "stats", None)
        return (stats or {}).get("capture_ms", 0.0) / 1e3

    # -- the player's orders -------------------------------------------------------

    def _plan_orders(self, o: dict) -> None:
        """Control groups (``_control_groups``) and each layer's rally
        points near the front."""
        eng, rng = self.eng, self.rng
        self.groups = groups = self._control_groups(o)
        h = eng.ents_host("pos", "alive", "faction")
        live = h["alive"]
        cents = [h["pos"][live & (h["faction"] == s)].mean(0) for s in (0, 1)]
        front = (cents[0] + cents[1]) / 2.0
        cost = self._layer_costs()
        self.rally = {}
        for arm in dict.fromkeys(a for a, _ in groups):
            self.rally[arm] = self._points(cost[scene.arm_layer(arm)], front,
                                           o["front_radius"],
                                           o["rally_points"])
        # the whole order sequence, fixed by the seed
        self.order_plan = rng.integers(0, o["rally_points"], 1 << 16)

    def _control_groups(self, o: dict) -> list:
        """Side ``o["side"]``'s army as ``o["groups"]`` control groups of
        one nav layer each: the infantry split from the seed, then each
        other arm whole. Returns (arm, uids) pairs."""
        arms = self.sides[o["side"]]
        present = [a for a in ("siege", "navy", "air") if arms.get(a)]
        n_inf = o["groups"] - len(present)
        groups = []
        inf = np.asarray(arms["inf"], np.int64)
        for part in np.array_split(self.rng.permutation(inf), n_inf):
            groups.append(("inf", [int(u) for u in part]))
        for a in present:
            groups.append((a, list(arms[a])))
        return groups

    def _layer_costs(self) -> np.ndarray:
        from benchmark.reference.config import EngineConfig, NUM_LAYERS

        cfg = EngineConfig(**self.conf["engine"])
        if self.map_data is None:
            return np.ones((NUM_LAYERS, cfg.field_h, cfg.field_w), np.uint8)
        from benchmark.reference.pfmap import compile_nav_costs

        return compile_nav_costs(self.map_data)[0]

    def _points(self, cost: np.ndarray, front, radius: float, n: int):
        """`n` passable nav-tile centres of a layer within `radius` of
        `front`, drawn from the seed."""
        from benchmark.reference.config import (
            COST_IMPASSABLE, NAV_TILE_SIZE)

        rr, cc = np.nonzero(cost != COST_IMPASSABLE)
        xz = np.stack([cc, rr], 1).astype(np.float64) * NAV_TILE_SIZE \
            + NAV_TILE_SIZE / 2.0
        near = np.linalg.norm(xz - front, axis=1) <= radius
        xz = xz[near]
        if len(xz) < n:
            raise RuntimeError("too few passable tiles near the front")
        return xz[self.rng.choice(len(xz), n, replace=False)].astype(
            np.float32)

    def goal(self, arm: str):
        """The world point the next order sends `arm`'s group to: the
        plan's next rally point of its layer."""
        return self.rally[arm][self.order_plan[self.order_count
                                               % len(self.order_plan)]]

    def _order(self) -> None:
        """The next order of the plan: the next group, whole, to its
        ``goal``; timed from the call to the device's completion."""
        eng = self.eng
        arm, uids = self.groups[self.order_count % len(self.groups)]
        goal = self.goal(arm)
        self.order_count += 1
        uids = [u for u in uids if u in eng.uid_to_slot]
        if not uids:
            return
        stats = eng.nav.stats
        hits, misses, failed = stats["hits"], stats["misses"], stats["failed"]
        self.orders_attempted += 1
        t0 = time.perf_counter()
        ok = eng.move(uids, (float(goal[0]), float(goal[1])))
        _sync(self.device)
        self.order_times.append(time.perf_counter() - t0)
        self.cache_hits[0] += stats["hits"] - hits
        self.cache_hits[1] += stats["misses"] - misses
        if not ok or stats["failed"] != failed:
            self.orders_failed += 1

    # -- reinforcements ---------------------------------------------------------------

    def _wave(self) -> None:
        """Each side gets back the units it lost, into the slots expired
        corpses freed; with its earlier reinforcements still living they
        take the side's standing order."""
        eng, conf = self.eng, self.conf
        alive = scene.alive_by_side(eng)
        lost = np.maximum(np.asarray(self.strength) - alive, 0)
        free = eng.cfg.max_ents - len(eng.uid_to_slot)
        if lost.sum() > free:
            lost = (lost * free) // max(int(lost.sum()), 1)
        self.wave_log.append([int(x) for x in lost])
        for side in (0, 1):
            counts = scene.arm_counts(conf, int(lost[side]))
            new = {arm: scene.spawn_arm(eng, self.rng, conf, side, arm,
                                        counts[arm])
                   for arm in ("inf", "siege", "navy", "air")
                   if counts.get(arm, 0) > 0}
            old = self.reinforcements[side]
            living = scene.living(eng, [u for v in old.values() for u in v])
            arms = {arm: [u for u in old.get(arm, []) if u in living]
                    + new.get(arm, []) for arm in ("inf", "siege", "navy", "air")
                    if arm in old or arm in new}
            self.reinforcements[side] = arms
            for ok in scene.standing_orders(eng, side, arms):
                self.orders_attempted += 1
                self.orders_failed += not ok

    # -- stepping ----------------------------------------------------------------------

    def drive(self, frames: int, on_frame=None) -> int:
        """Run the traffic for at least `frames` frames (whole calls);
        returns the frames run."""
        done = 0
        while done < frames:
            done += self.advance(on_frame)
        return done

    def before_call(self, n: int) -> None:
        """What falls due before a call of `n` frames: a wave, and in
        frame stepping the order of that frame."""
        tr = self.traffic
        w = tr.get("waves")
        if w and self.frames_since_wave >= w["period_frames"]:
            self._wave()
            self.frames_since_wave = 0
        o = tr.get("orders")
        if o and tr["stepping"] == "frame" \
                and self.frame % o["period_frames"] == 0:
            self._order()

    def after_call(self, n: int) -> None:
        """What follows a call of `n` frames: the host takes the engine's
        events."""
        self._consume_events()

    def advance(self, on_frame=None, around=None, call_frames=None) -> int:
        """One call of the cell's stepping (in scan stepping of
        `call_frames`, by default the traffic's) between ``before_call``
        and ``after_call``. `around`, if given, is called with "before"
        just before the engine's call and with "after" and the frames just
        after it. Returns the frames advanced."""
        tr, eng = self.traffic, self.eng
        scan = tr["stepping"] == "scan"
        n = (call_frames or tr["call_frames"]) if scan else 1
        self.before_call(n)
        if around:
            around("before", n)
        if scan:
            eng.step_scan(n)
        else:
            eng.step(1)
        self.frame += n
        self.after_call(n)
        if around:
            around("after", n)
        if on_frame is not None:
            on_frame()
        self.frames_since_wave += n
        return n

    # -- the check ----------------------------------------------------------------------

    def recorders(self) -> list:
        """Context managers that ``check.verify`` enters beside its
        ``Recorder`` while ``record`` runs, each copying what this
        generator's own numbers need (``judge_extra``); the cell keeps
        them. They only copy, and take their patches off on exit. None
        here."""
        return []

    def judge_extra(self, device) -> dict:
        """This generator's own numbers, each computed from what its
        ``recorders`` copied by reference code under
        ``benchmark/reference/``, with the program's state freed. Each is
        named in the configuration's limits file. None here."""
        return {}

    def host_columns(self, n: int) -> tuple:
        """The entity columns the host rewrote during the call of `n`
        frames just made, after the tick: the check leaves them out of
        that call's tick comparison. The nav cadence's replans rewrite
        ``HOST_COLUMNS`` on a call that ends in it."""
        if self.frame % self.eng.seek_refresh_period == 0:
            return HOST_COLUMNS
        return ()

    def record(self, frames: int, rec) -> None:
        """Go on with the traffic for `frames` frames, recording into
        `rec` (a ``check.Recorder``, entered) each call of the timed path:
        a copy of the state handed to it and of the state it hands back,
        and the columns the host rewrote during it (``host_columns``).
        Scan stepping records calls of ``check_call_frames``."""
        from benchmark.check import clone_tree

        held = {}

        def around(when, n):
            if when == "before":
                held["before"] = clone_tree(self.eng.state)
            else:
                rec.segments.append((held.pop("before"), n,
                                     clone_tree(self.eng.state),
                                     self.host_columns(n)))

        done = 0
        while done < frames:
            done += self.advance(
                around=around,
                call_frames=self.traffic.get("check_call_frames"))

    def window(self, seconds: float) -> dict:
        """The measured window: the traffic for `seconds` of wall time,
        ended by a device synchronize. Returns its host-clock readings and
        the deltas of the engine's counters."""
        eng = self.eng
        c0 = dict(eng.counters)
        n0 = dict(eng.nav.stats)
        frame_times: list[float] = []
        host_ms = [0.0]

        def scopes():
            for e in eng.perf.prev_frame_perfstats():
                if e["name"] in ("device_tick", "host_systems"):
                    host_ms[0] += e["ms"]

        # the collector's passes in the window: per generation, and their
        # seconds (a reading printed beside the metrics, not one of them)
        gcs = {"collections": [0, 0, 0], "s": 0.0, "start": 0.0}

        def on_gc(phase, info):
            if phase == "start":
                gcs["start"] = time.perf_counter()
            else:
                gcs["s"] += time.perf_counter() - gcs["start"]
                gcs["collections"][info["generation"]] += 1

        frames, f0 = 0, self.frame
        per_frame = self.traffic["stepping"] == "frame"
        _sync(self.device)
        gc.callbacks.append(on_gc)
        t0 = last = time.perf_counter()
        try:
            while True:
                frames += self.advance(scopes if per_frame else None)
                now = time.perf_counter()
                frame_times.append(now - last)
                last = now
                if now - t0 >= seconds:
                    break
            _sync(self.device)
            wall = time.perf_counter() - t0
        finally:
            gc.callbacks.remove(on_gc)
        return {
            "frames": frames, "wall_s": wall, "call_s": frame_times,
            "stepping": self.traffic["stepping"],
            "order_s": list(self.order_times),
            "orders_failed": self.orders_failed,
            "orders_attempted": self.orders_attempted,
            "cache_hits": list(self.cache_hits),
            "host_scope_ms": host_ms[0],
            "events": self.events_seen,
            "gc": {"collections": gcs["collections"], "s": gcs["s"]},
            "cadences": (self.frame // eng.seek_refresh_period
                         - f0 // eng.seek_refresh_period),
            "counters": {k: eng.counters.get(k, 0.0) - c0.get(k, 0.0)
                         for k in eng.counters},
            "nav_stats": {k: v - n0.get(k, 0) for k, v in eng.nav.stats.items()
                          if isinstance(v, (int, float))},
        }

"""What the probes (``tools/probe_*.py``) share: the device choice, the
synchronize, fps windows, the raw-tick timer, counter deltas, the snapshot
of a state and the last line.

Every probe runs on the card unless given ``--cpu``; without a CUDA device
and without ``--cpu`` it exits non-zero and never falls back to the CPU.
It prints what its JAX original prints, then one compact JSON line last,
and writes that line to a file only when given ``--out PATH``.
"""

from __future__ import annotations

import argparse
import copy
import functools
import gc
import json
import sys
import time

import numpy as np
import torch

from permafrost_engine_tpu_torch import bench


def parser(prog: str, doc: str) -> argparse.ArgumentParser:
    """An argument parser with the flags every probe takes: ``--cpu`` and
    ``--out``."""
    ap = argparse.ArgumentParser(
        prog=f"python -m permafrost_engine_tpu_torch.tools.{prog}",
        description=doc.strip().splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    ap.add_argument("--out", default=None,
                    help="also write the last JSON line to this file")
    return ap


def device_of(args, prog: str) -> str:
    """``"cpu"`` with ``--cpu``, else ``"cuda"``; exits 1 (printing why on
    standard error) when there is no CUDA device."""
    if args.cpu:
        return "cpu"
    if not torch.cuda.is_available():
        print(f"{prog}: no CUDA device (pass --cpu to run on the CPU)",
              file=sys.stderr)
        raise SystemExit(1)
    return "cuda"


def sync(device) -> None:
    """Wait for the device's work to finish (a no-op on the CPU)."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def fps_of(eng, fn, frames: int = 120, windows: int = 3) -> tuple[list, float]:
    """fps of `windows` timed calls ``fn(frames)``, each ending in a
    synchronize: (every window's fps, their median)."""
    vals = []
    for _ in range(windows):
        t0 = time.perf_counter()
        fn(frames)
        sync(eng.device)
        vals.append(frames / (time.perf_counter() - t0))
    return vals, float(np.median(vals))


def snapshot(state):
    """A copy of `state` with every tensor cloned (on its device)."""
    return copy.deepcopy(state)


@functools.cache
def const(shape: tuple, dtype: torch.dtype, fill, device) -> torch.Tensor:
    """A constant tensor, built once per (shape, dtype, fill, device): an
    ablation's stand-in returns it instead of building it inside the tick.
    A stand-in's first call is the eager warm-up before a capture, so the
    constant is built outside every capture. Read-only."""
    return torch.full(shape, fill, dtype=dtype, device=device)


def make_graphs(eng):
    """A fresh one-frame stepper of `eng`'s tick as the engine builds it
    (``game/step.make_tick`` with the engine's tile heights and skin bank)
    in a ``TickGraphs``: on the card each distinct set of substeps a frame
    fires (7 at the defaults) is captured on first use and replayed after;
    on the CPU the tick runs."""
    from permafrost_engine_tpu_torch.game.graphs import TickGraphs
    from permafrost_engine_tpu_torch.game.step import cadence_period, make_tick
    from permafrost_engine_tpu_torch.state.schema import empty_deltas

    cfg = eng.cfg
    return TickGraphs(make_tick(cfg, eng._tile_height, skin_bank=eng._skin_bank),
                      cadence_period(cfg),
                      lambda device: empty_deltas(cfg, device=device))


def timed_fps(graphs, state0, frames: int = 120, windows: int = 3,
              warm: int | None = None) -> tuple[list, float]:
    """Throughput of a raw tick (no host systems): a copy of `state0` is
    stepped one frame per call of `graphs` (``make_graphs``: on the card
    each frame is one graph replay, as the engine replays its segments).
    `warm` frames (default one cadence period, so every frame key is
    captured before the timed windows) run first, untimed; then `windows`
    windows of `frames` frames, each ending in a synchronize. Returns
    (every window's fps, their median)."""
    state = snapshot(state0)
    dev = state.ents.pos.device
    acc = graphs.new_acc(dev)
    for _ in range(graphs.period if warm is None else warm):
        state, acc = graphs(state, 1, acc)
    sync(dev)
    vals = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(frames):
            state, acc = graphs(state, 1, acc)
        sync(dev)
        vals.append(frames / (time.perf_counter() - t0))
    return vals, float(np.median(vals))


def _counting(calls: dict, name: str, fn):
    def run(*args, **kw):
        calls[name] = calls.get(name, 0) + 1
        return fn(*args, **kw)
    return run


def label(mod, attr: str) -> str:
    """A patch point's name in the ablations' output: ``step.hrvo_select``."""
    return f"{mod.__name__.rsplit('.', 1)[1]}.{attr}"


def run_variants(eng, state0, variants, points, frames: int = 120,
                 windows: int = 3, warm: int | None = None, log=print) -> dict:
    """Time each ablation variant of the raw tick from the snapshot
    `state0` (``timed_fps`` on a fresh ``make_graphs(eng)``, so each
    variant is captured anew with its patches in place).

    `points` lists every patch point ``(module, attribute)`` of the probe;
    `variants` is ``[(name, {(module, attribute): stand_in})]``. In every
    variant each point is wrapped in a call counter, around its stand-in
    where the variant replaces it and around the original otherwise; the
    originals are put back in ``finally``. Per variant: the fps, the calls
    of each original and of each stand-in (Python calls: on the card the
    eager warm-up and the capture of each frame key call them, a replay
    calls nothing) and the K1 launches (``ops/crowd_cuda.launches``,
    replays included; 0 on the CPU)."""
    from permafrost_engine_tpu_torch.ops import crowd_cuda

    orig = {p: getattr(*p) for p in points}
    res = {}
    for name, patches in variants:
        calls, standin_calls = {}, {}
        graphs = None
        try:
            for (mod, attr), fn in orig.items():
                if (mod, attr) in patches:
                    fn = _counting(standin_calls, label(mod, attr),
                                   patches[(mod, attr)])
                else:
                    fn = _counting(calls, label(mod, attr), fn)
                setattr(mod, attr, fn)
            k1 = crowd_cuda.launches
            graphs = make_graphs(eng)
            vals, fps = timed_fps(graphs, state0, frames, windows, warm)
            k1 = crowd_cuda.launches - k1
        finally:
            for (mod, attr), fn in orig.items():
                setattr(mod, attr, fn)
            del graphs
            gc.collect()
            if eng.device.type == "cuda":
                torch.cuda.empty_cache()
        res[name] = {"fps": fps, "fps_all": vals, "k1_launches": k1,
                     "calls": {label(*p): calls.get(label(*p), 0)
                               for p in points},
                     "standin_calls": standin_calls}
        log(f"{name}: {fps:.1f} fps")
    return res


def restored(points, originals: dict) -> bool:
    """Whether every patch point holds its original again."""
    return all(getattr(*p) is originals[p] for p in points)


def delta(after: dict, before: dict, min_abs: float = 0.05) -> dict:
    """``after - before`` of every numeric entry that moved by more than
    `min_abs`, rounded to 0.1."""
    out = {}
    for k, v in after.items():
        if not isinstance(v, (int, float)) or isinstance(v, bool):
            continue
        d = v - before.get(k, 0)
        if abs(d) > min_abs:
            out[k] = round(d, 1)
    return out


def contact_flags(ap: argparse.ArgumentParser) -> None:
    """The frame counts of the way into the melee, as flags whose defaults
    are the JAX probes' (the bench's): ``--warmup`` frames of ``step``
    after the build, then ``--ff-chunk``-frame ``step_scan`` windows until
    a unit dies (at most ``--ff-max-frames``), then ``--thicken``."""
    ap.add_argument("--warmup", type=int, default=bench.WARMUP_FRAMES)
    ap.add_argument("--ff-chunk", type=int, default=bench.FF_CHUNK)
    ap.add_argument("--ff-max-frames", type=int, default=bench.FF_MAX_FRAMES)
    ap.add_argument("--thicken", type=int, default=bench.THICKEN_FRAMES)


def to_contact(eng, n0: int, chunk: int = bench.FF_CHUNK,
               max_frames: int = bench.FF_MAX_FRAMES,
               thicken: int = bench.THICKEN_FRAMES) -> int:
    """The bench's way into the melee: ``step_scan`` in `chunk`-frame
    windows until fewer than `n0` units live or `max_frames` have run
    (``bench.fast_forward_until``), then `thicken` frames more. Returns
    the frames of the fast-forward."""
    frames = bench.fast_forward_until(eng, lambda a: a < n0, chunk, max_frames)
    eng.step_scan(thicken)
    return frames


def battle_to_contact(args, device, terrain: bool):
    """``bench.build_battle(args.n_per_side, terrain)`` on `device`, the
    warm-up, and ``to_contact`` with the ``contact_flags``."""
    eng = bench.build_battle(args.n_per_side, terrain=terrain, device=device)
    n0 = bench.alive_count(eng)
    eng.step(args.warmup)
    to_contact(eng, n0, args.ff_chunk, args.ff_max_frames, args.thicken)
    return eng


def emit(out: dict, path: str | None) -> dict:
    """Print `out` as one compact JSON line (the probe's last) and write it
    to `path` when given."""
    line = json.dumps(out, separators=(",", ":"))
    print(line, flush=True)
    if path:
        with open(path, "w") as f:
            f.write(line + "\n")
    return out

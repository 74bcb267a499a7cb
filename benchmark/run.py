"""The benchmark of ``permafrost_engine_tpu_torch`` on the card.

Run from the root of a checkout:

    python -m benchmark.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

It builds the workload's battle from its configuration and traffic files
(with the generator the traffic file names, ``benchmark/generators/``),
measures the traffic for ``--seconds`` of wall time, checks what the timed path produced against the plain reference
(``benchmark/check.py``), and prints, as the last line of standard
output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics, each from its reader in ``benchmark/metrics``),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
number that the configuration's limits file (``benchmark/limits/
<config>.json``) names, with its limit; a named number that the check
did not report reads "missing" and makes the run not correct. The same
numbers end standard error.
Earlier lines give the card, the set-up split, the synchronized round
trip at the start and the end (a drift guard, not a metric) and the
window's counts.

It exits non-zero without a CUDA device (or with fewer than the cell's
chips); before set-up where the configuration has no limits file; where
the check reports a number that its limits file does not name; and if a
module of ``jax``, ``jaxlib``, ``flax`` or ``permafrost_engine_tpu`` is
loaded once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

# transformers and its kind must not pull JAX in by themselves
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")
# load from one process with few threads: the host's share of the card's
# machine is what the frame cells time
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, "1")

FORBIDDEN = ("jax", "jaxlib", "flax", "permafrost_engine_tpu")
# the value in ``checks`` of a limited number that the check did not report
MISSING = "missing"


class RunError(Exception):
    """A run that cannot give a result; the message says why."""


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    of ``FORBIDDEN``, compared whole."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def rtt_floor(device, n: int = 21) -> float:
    """The synchronized round trip of a trivial dispatch (ms, the p50 of
    `n`): ``bench.measure_rtt_floor``'s arithmetic."""
    import numpy as np
    import torch

    x = torch.zeros((), device=device) + 1.0
    torch.cuda.synchronize(device)
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        x = x + 1.0
        torch.cuda.synchronize(device)
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def load_limits(config: str) -> dict:
    """Configuration `config`'s limits: ``benchmark/limits/<config>.json``,
    each number that decides ``correct`` with its limit."""
    from benchmark.spec import ROOT, limits_file

    path = limits_file(config)
    if not path.exists():
        raise RunError(f"no limits file {path.relative_to(ROOT)} for "
                       f"configuration {config!r}")
    with open(path) as f:
        return json.load(f)


def compare(numbers: dict, limits: dict, config: str) -> dict:
    """Each limited number beside its limit, in the limits file's order:
    a number the check did not report reads ``MISSING``. A reported number
    with no limit stops the run."""
    unlimited = sorted(set(numbers) - set(limits))
    if unlimited:
        raise RunError(f"the check reported {unlimited}, which the limits "
                       f"file of {config!r} does not name")
    return {k: {"value": numbers.get(k, MISSING), "limit": v}
            for k, v in limits.items()}


def measure(spec, wl: dict, seed: int, seconds: float, trace: bool,
            device, t_start: float, log=print) -> dict:
    """One run of workload `wl` on `device`: set-up, window, (traced
    stretch), the comparison. Returns the result line's fields."""
    import torch

    from benchmark import check
    from benchmark.spec import reader

    conf, traffic = spec.config(wl), spec.traffic(wl)
    limits = load_limits(wl["config"])
    cuda = torch.device(device).type == "cuda"
    rtt_start = rtt_floor(device) if cuda else None
    cell = spec.generator(wl)(conf, traffic, seed, device)
    cell.setup()
    setup_s = time.perf_counter() - t_start
    log("set-up split: " + json.dumps(
        {"setup_s": setup_s, **cell.split,
         "reference_s": "0 (the reference runs after the window)"}))
    win = cell.window(seconds)
    mem_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    m = {"setup_s": setup_s, "window": win}
    log("window: " + json.dumps(
        {"frames": win["frames"], "wall_s": win["wall_s"],
         "orders": len(win["order_s"]), "orders_failed": win["orders_failed"],
         "waves": cell.wave_log, "cadences": win["cadences"],
         "events": win["events"], "gc": win["gc"],
         "flocks_active": int(cell.eng.state.flocks.active.sum())}))
    if trace:
        from benchmark.reference.config import EngineConfig
        from benchmark.reference.tick import crowd_inputs
        from benchmark.trace import run_traced

        frames = [0]
        k2 = check.Recorder()

        def stretch():
            frames[0] = cell.drive(traffic["trace_frames"])

        with k2:
            m["trace"] = run_traced(stretch, device) if cuda else None
            if not cuda:
                stretch()
        m["trace_frames"] = frames[0]
        m["k2_launches"] = k2.k2
        ref_cfg = EngineConfig(**conf["engine"])
        x = crowd_inputs(ref_cfg, check.clone_tree(cell.eng.state))
        m["k1_args"], m["k1_exact"] = x["hrvo_args"], ref_cfg.clearpath_exact
    rtt_end = rtt_floor(device) if cuda else None
    log(f"drift guard: sync_rtt_floor_ms start={rtt_start} end={rtt_end}")

    # -- correct: the timed path's frames after the window ------------------------
    attempted = win["orders_attempted"]
    failed = win["orders_failed"]
    numbers, _ = check.verify(cell, traffic["check_frames"], log=log)
    checks = compare(numbers, limits, wl["config"])
    correct = all(v["value"] != MISSING and v["value"] <= v["limit"]
                  for v in checks.values())

    metrics = {}
    for mdef in spec.metrics(wl, trace):
        value = reader(mdef["name"])(m)
        if value is not None:
            metrics[mdef["name"]] = {"value": value, "unit": mdef["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(mem_peak)}
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": dev}
    if trace and m.get("trace"):
        t = m["trace"]
        dev["busy_s"], dev["window_s"] = t["busy_s"], t["window_s"]
        out["breakdown"] = {"device_ops": t["device_ops"],
                            "idle_gaps": t["idle_gaps"]}
    out["checks"] = {k: {"value": _finite(v["value"]), "limit": v["limit"]}
                     for k, v in checks.items()}
    return out


def _finite(x):
    """A number for JSON: an infinite gap as the string "inf"."""
    return "inf" if isinstance(x, float) and math.isinf(x) else x


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m benchmark.run",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchmark.spec import Spec

    torch.set_num_threads(1)
    spec = Spec.load()
    wl = spec.workload(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < wl["chips"]:
        print(f"benchmark: the cell needs {wl['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    print("card: " + card_line(), flush=True)
    try:
        return report(spec, wl, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0))
    except RunError as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2


def report(spec, wl: dict, seed: int, seconds: float, trace: bool,
           device) -> int:
    """Measure one run and print its result: every number compared on
    standard error, then the result line as the last line of standard
    output. Returns the exit code: non-zero, with no result, where a
    forbidden module is loaded."""
    out = measure(spec, wl, seed, seconds, trace, device, T_START,
                  log=lambda s: print(s, flush=True))
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    for k, v in out["checks"].items():
        print(f"check {k}: {v['value']} (limit {v['limit']})",
              file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The control of the comparison that decides ``correct``, on the card at a
cell's own size.

    python -m benchmark.control --workload <name> --seeds 11,22,33 \\
        --seconds 3

For each seed it builds the cell's battle, runs its traffic for a short
window, records the frames and fields the check records after a run's
window, and reads each number twice: the program against the reference
(a sound run: the lower reading), and the reference computed with every
float column of the state held in bfloat16, the nearest precision below
the configuration's float32, in the program's place (the control: the
upper reading). One JSON line a seed, then a summary line with each
number's largest sound reading and smallest control reading. The
control reads the numbers every cell shares, not a generator's own. The
benchmark's own runs do not run it; ``PERF.md`` gives its readings and
the limits in ``benchmark/limits/<config>.json`` set from them.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def readings(spec, wl: dict, seed: int, seconds: float, device) -> dict:
    """(sound, control) numbers of one seed of a workload."""
    from benchmark import check

    traffic = spec.traffic(wl)
    cell = spec.generator(wl)(spec.config(wl), traffic, seed, device)
    cell.setup()
    cell.window(seconds)
    sound, control = check.verify(cell, traffic["check_frames"], control=True)
    return {"sound": sound, "control": control}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m benchmark.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds, three or more")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)

    import torch

    from benchmark.spec import Spec

    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    spec = Spec.load()
    wl = spec.workload(args.workload)
    device = torch.device("cuda", 0)
    lower: dict = {}
    upper: dict = {}
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        r = readings(spec, wl, seed, args.seconds, device)
        for k, v in r["sound"].items():
            lower[k] = max(lower.get(k, 0), v)
        for k, v in r["control"].items():
            upper[k] = min(upper.get(k, float("inf")), v)
        print(json.dumps({"workload": wl["name"], "seed": seed,
                          "seconds": time.perf_counter() - t0,
                          **{k: {n: str(x) for n, x in v.items()}
                             for k, v in r.items()}}), flush=True)
    print(json.dumps({"workload": wl["name"], "seeds": args.seeds,
                      "largest_sound": {k: str(v) for k, v in lower.items()},
                      "smallest_control": {k: str(v)
                                           for k, v in upper.items()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

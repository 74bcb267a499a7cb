"""The traced window: ``torch.profiler`` around a stretch of the traffic,
reduced to what the per-layer readers need.

From the trace: the union of the device's busy intervals (the arithmetic
of ``tools/profile_torch_slice.py``'s busy share, copied here), each
kernel's total time and launches by name, the longest idle gaps labelled
by what the host was doing, and the device operations that took most
time. Nothing else of the trace is kept, so a long window costs memory
only while it is reduced.
"""

from __future__ import annotations

import time
from collections import defaultdict

import numpy as np
import torch

# idle gaps shorter than this are launch spacing, not a host stall
SHORT_GAP_NS = 20_000
SHORT_GAP = "between device activities (< 20 us)"
# bins of the host-event index that labels gaps
BIN_NS = 100_000


def run_traced(fn, device) -> dict:
    """Run fn() under the profiler, ending in a device synchronize, and
    return its summary (``summarize``) with ``window_s`` on the host
    clock."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(device)
        window_s = time.perf_counter() - t0
    out = summarize(prof.profiler.kineto_results.events())
    out["window_s"] = window_s
    return out


def _union(starts: np.ndarray, ends: np.ndarray) -> list[tuple[int, int]]:
    """Merged [start, end) intervals of a set of intervals."""
    order = np.argsort(starts, kind="stable")
    merged: list[list[int]] = []
    for s, e in zip(starts[order].tolist(), ends[order].tolist()):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def summarize(events) -> dict:
    """Reduce kineto events to: ``busy_s`` (the union of device
    intervals), ``span_s`` (first device start to last device end),
    ``kernels`` {name: [seconds, launches]} of every device operation,
    ``device_ops`` (the ten longest by total time) and ``idle_gaps`` (the
    ten largest totals of idle time between device operations, by the
    host event that overlaps the gap most, the innermost on a tie)."""
    dev_s, dev_e, host = [], [], []
    kernels: dict[str, list] = defaultdict(lambda: [0.0, 0])
    for ev in events:
        s, e = ev.start_ns(), ev.end_ns()
        if e <= s:
            continue
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            dev_s.append(s)
            dev_e.append(e)
            k = kernels[ev.name()]
            k[0] += (e - s) * 1e-9
            k[1] += 1
        else:
            host.append((s, e, ev.name()))
    if not dev_s:
        return {"busy_s": 0.0, "span_s": 0.0, "kernels": {},
                "device_ops": [], "idle_gaps": []}
    busy = _union(np.asarray(dev_s, np.int64), np.asarray(dev_e, np.int64))
    busy_ns = sum(e - s for s, e in busy)

    # index the host events by 100 us bins for the gap labels
    bins: dict[int, list[int]] = defaultdict(list)
    for i, (s, e, _) in enumerate(host):
        for b in range(s // BIN_NS, e // BIN_NS + 1):
            bins[b].append(i)
    gaps: dict[str, float] = defaultdict(float)
    for (_, e0), (s1, _) in zip(busy[:-1], busy[1:]):
        g = s1 - e0
        if g < SHORT_GAP_NS:
            gaps[SHORT_GAP] += g * 1e-9
            continue
        best, best_key = "none", (0, 0)
        seen = set()
        for b in range(e0 // BIN_NS, s1 // BIN_NS + 1):
            for i in bins.get(b, ()):
                if i in seen:
                    continue
                seen.add(i)
                hs, he, name = host[i]
                ov = min(he, s1) - max(hs, e0)
                if ov <= 0:
                    continue
                key = (ov, -(he - hs))
                if key > best_key:
                    best, best_key = name, key
        gaps[best] += g * 1e-9

    short: dict[str, float] = defaultdict(float)
    for k, v in kernels.items():
        short[k[:96]] += v[0]

    def top(d, n=10):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]

    return {
        "busy_s": busy_ns * 1e-9,
        "span_s": (busy[-1][1] - busy[0][0]) * 1e-9,
        "kernels": {k: v for k, v in kernels.items()},
        "device_ops": top(short),
        "idle_gaps": top(gaps),
    }


def kernel_time(summary: dict, pattern: str) -> tuple[float, int]:
    """Total seconds and launches of the device kernels whose name holds
    `pattern`."""
    secs, n = 0.0, 0
    for name, (s, c) in summary["kernels"].items():
        if pattern in name:
            secs += s
            n += c
    return secs, n

"""Kernel K2's share of its roofline in the traced stretch: the card's
least time for every K2 launch's work in it (``benchmark/roofline.py``,
counted from each launch's recorded inputs) over the profiler's time of
the K2 kernels (``integrate_kernel``). The launches come from the nav
cadence's field batches and the orders that miss the field cache."""

from benchmark import roofline

KERNEL = "integrate_kernel"


def read(m):
    t = m.get("trace")
    if not t or not m.get("k2_launches"):
        return None
    secs = launches = 0
    for name, (s, n) in t["kernels"].items():
        if KERNEL in name:
            secs += s
            launches += n
    if launches != len(m["k2_launches"]) or secs <= 0:
        return None
    least_ms = 0.0
    for cost, seeds, seed_cost, max_iters, _out in m["k2_launches"]:
        ops, nbytes = roofline.k2_work(cost, seeds, seed_cost, max_iters)
        least_ms += roofline.bound(nbytes, ops)[0]
    return 100.0 * least_ms / (1e3 * secs)

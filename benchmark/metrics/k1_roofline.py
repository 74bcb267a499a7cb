"""Kernel K1's share of its roofline in the traced stretch: the card's
least time for one launch's work (``benchmark/roofline.py``, counted from
the inputs of a launch at the stretch's end) times the launches, over the
profiler's time of the K1 kernels (``hrvo_kernel``, ``hrvo_persistent``)."""

from benchmark import roofline

KERNELS = ("hrvo_kernel", "hrvo_persistent")


def read(m):
    t = m.get("trace")
    if not t or m.get("k1_args") is None:
        return None
    secs = launches = 0
    for name, (s, n) in t["kernels"].items():
        if any(k in name for k in KERNELS):
            secs += s
            launches += n
    if not launches or secs <= 0:
        return None
    ops, nbytes = roofline.k1_work(m["k1_args"], m["k1_exact"])
    least_ms, _ = roofline.bound(nbytes, ops)
    return 100.0 * least_ms * launches / (1e3 * secs)

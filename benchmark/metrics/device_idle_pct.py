"""100 minus the share of the traced window in which an operation ran on
the device (the union of the profiler's device intervals)."""


def read(m):
    t = m.get("trace")
    if not t or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])

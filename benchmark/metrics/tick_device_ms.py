"""The device's busy time per simulated frame in the traced stretch: the
union of the profiler's device intervals over the frames traced."""


def read(m):
    t = m.get("trace")
    if not t or t["busy_s"] <= 0:
        return None
    return 1e3 * t["busy_s"] / m["trace_frames"]

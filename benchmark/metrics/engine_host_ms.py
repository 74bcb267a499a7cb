"""The engine loop's host time per frame: the ``Perf`` scopes
``device_tick`` (the tick's enqueue) and ``host_systems`` (the host systems
and the nav cadence) summed over the window's frames."""


def read(m):
    w = m["window"]
    if w["stepping"] != "frame" or not w["frames"]:
        return None
    return w["host_scope_ms"] / w["frames"]

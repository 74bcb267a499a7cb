"""The game loop's device waits per frame: the ``Perf`` scope ``step``'s
``wait_ms`` (its waits ``step.drain`` and ``step.flush``, the drain's
event synchronize and the closing copies of the deltas) summed over the
window, over its frames."""


def read(m):
    w = m["window"]
    c = w["counters"]
    if not c.get("step.n") or not w["frames"]:
        return None
    return c["step.wait_ms"] / w["frames"]

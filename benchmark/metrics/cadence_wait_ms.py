"""The nav cadence's device waits per cadence: the ``Perf`` scope
``cadence``'s ``wait_ms`` (its ``cadence.fetch`` waits: the lagged
snapshot's fetches, the first of which waits for the work queued before
it) summed over the window, over ``cadence.n``."""


def read(m):
    c = m["window"]["counters"]
    if not c.get("cadence.n"):
        return None
    return c["cadence.wait_ms"] / c["cadence.n"]

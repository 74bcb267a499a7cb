"""The nav cadence's time outside its device fetches per cadence: the
``Perf`` scope ``cadence`` less its ``wait_ms``, summed over the window,
over ``cadence.n``. A kernel launch that blocks because the stream's
queue is full (the snapshot's launches right after a segment's graph
replay) is not a fetch, so it counts here."""


def read(m):
    c = m["window"]["counters"]
    if not c.get("cadence.n"):
        return None
    return (c["cadence.ms"] - c["cadence.wait_ms"]) / c["cadence.n"]

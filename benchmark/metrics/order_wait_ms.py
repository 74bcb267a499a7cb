"""An order's device waits: the ``Perf`` scope ``order``'s ``wait_ms``
(its ``order.fetch`` waits) summed over the window, over the orders
(``order.n``: each ``Engine.move``, the waves' standing orders among
them)."""


def read(m):
    c = m["window"]["counters"]
    if not c.get("order.n"):
        return None
    return c["order.wait_ms"] / c["order.n"]

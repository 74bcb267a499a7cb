"""The orders an order batch carries: ``counters["order.batch.orders"]``
(the ``Engine.move`` and ``Engine.stop`` calls queued in an
``Engine.order_batch``, one an economy tick) over the flushes that gave
them (the ``Perf`` scope ``order.batch``), summed over the window. None
where the program gives no batches."""


def read(m):
    c = m["window"]["counters"]
    if not c.get("order.batch.n"):
        return None
    return c["order.batch.orders"] / c["order.batch.n"]

"""An order's host time installing fields: the ``Perf`` scope
``order.install`` (``NavService._install_fields_batch``: flow and LOS
jobs, K2 launches, the flock tables' push) less its device waits, summed
over the window, over the orders (``order.n``)."""


def read(m):
    c = m["window"]["counters"]
    if not c.get("order.n") or "order.install.ms" not in c:
        return None
    return (c["order.install.ms"] - c["order.install.wait_ms"]) / c["order.n"]

"""An order's host time planning paths: the ``Perf`` scope
``order.plan`` (``NavService.plan_paths``: islands, the start and goal
integration, portal A*) less its device waits, summed over the window,
over the orders (``order.n``)."""


def read(m):
    c = m["window"]["counters"]
    if not c.get("order.n") or "order.plan.ms" not in c:
        return None
    return (c["order.plan.ms"] - c["order.plan.wait_ms"]) / c["order.n"]

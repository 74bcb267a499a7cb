"""The orders' share of an economy tick: the ``Perf`` scope
``economy.order`` (each ``Engine.move`` or ``Engine.stop`` the economy
gives, with the read of its target's position) summed over the window,
over the economy's ticks (``economy.n``); ``economy_ms`` less this is the
economy's own Python. None where the program has no such scope."""


def read(m):
    c = m["window"]["counters"]
    if not c.get("economy.n"):
        return None
    return c.get("economy.order.ms", 0.0) / c["economy.n"]

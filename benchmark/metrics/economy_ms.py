"""An economy tick's host time: the ``Perf`` scope ``economy``
(``Economy.tick``, its orders included) summed over the window, over the
ticks (``economy.n``). None where the program has no such scope."""


def read(m):
    c = m["window"]["counters"]
    if not c.get("economy.n"):
        return None
    return c["economy.ms"] / c["economy.n"]

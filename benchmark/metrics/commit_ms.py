"""A structure commit's host time: the ``Perf`` scope ``nav.commit``
(``Engine._commit_nav`` with stamps to apply: the cost push, the portal
relink, the field invalidation and the replans, ``nav.replan``) summed over
the window, over the commits (``nav.commit.n``). None where the program
has no such scope or the window made no commit."""


def read(m):
    c = m["window"]["counters"]
    if not c.get("nav.commit.n"):
        return None
    return c["nav.commit.ms"] / c["nav.commit.n"]

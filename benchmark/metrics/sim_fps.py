"""Frames simulated in the window over the window's wall time, ended by a
device synchronize (headless stepping)."""


def read(m):
    w = m["window"]
    if w["stepping"] != "scan":
        return None
    return w["frames"] / w["wall_s"]

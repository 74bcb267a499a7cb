"""The window's wall time over all its frames, each one ``Engine.step(1)``
with the orders due that frame (the game loop)."""


def read(m):
    w = m["window"]
    if w["stepping"] != "frame":
        return None
    return 1e3 * w["wall_s"] / w["frames"]

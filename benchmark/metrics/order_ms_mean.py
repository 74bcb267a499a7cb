"""The sum of all the player's orders' times in the window over their
count; each from the ``Engine.move`` call to its return and a device
synchronize."""


def read(m):
    t = m["window"]["order_s"]
    if not t:
        return None
    return 1e3 * sum(t) / len(t)

"""The 99th percentile of every frame's wall time in the window, the
frame's order and wave included: the hitch a player sees."""

import numpy as np


def read(m):
    w = m["window"]
    if w["stepping"] != "frame" or not w["call_s"]:
        return None
    return 1e3 * float(np.percentile(np.asarray(w["call_s"]), 99))

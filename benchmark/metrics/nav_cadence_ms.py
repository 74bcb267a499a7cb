"""The nav cadence's host timers in ``Engine.counters`` summed over the
window, per cadence (every ``Engine.seek_refresh_period`` frames). Each
``.cpu()`` fetch among them includes a wait for the device."""

COUNTERS = ("blk_snapshot_ms", "blk_sig_fetch_ms", "seek_refresh_ms",
            "chase_refresh_ms", "field_batch_ms", "blk_occ_fetch_ms",
            "blk_extend_ms")


def read(m):
    w = m["window"]
    if not w["cadences"]:
        return None
    return sum(w["counters"].get(k, 0.0) for k in COUNTERS) / w["cadences"]

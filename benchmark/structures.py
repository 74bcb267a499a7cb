"""Structure footprints in the traffic: what the generators that cut
buildings into the nav map (``generators/drop.py``,
``generators/economy.py``) share."""


def lift_structures(eng) -> None:
    """Lift every footprint cut into the nav map and commit the lift:
    after the recorded frames, so that ``map_differ`` holds the nav costs
    the stamps and lifts leave against the map's own compilation."""
    for uid in list(eng._structures):
        eng.set_structure_blocking(uid, False)
    eng._commit_nav()

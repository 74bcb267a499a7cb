"""The formation check: the layouts that set-up's
``Engine.move_in_formation`` makes, recorded and held against the
reference's layout, and the reading of how far an assignment is from the
least total squared distance, at a tiny size on the CPU."""

import numpy as np
import pytest

from benchmark import check, run, scene
from benchmark.tests.tiny import CONF, use_tiny

# the limits of the configuration whose cells make formations
LIMITS = run.load_limits("battle10k_combined")


@pytest.fixture
def recorded(monkeypatch):
    """The formation records of a tiny battle whose side a moves in RANK
    formation."""
    from permafrost_engine_tpu_torch.game.formation import FormationType

    use_tiny(monkeypatch)
    eng = scene.build_engine(CONF, "cpu", None)
    sides = scene.spawn_armies(eng, np.random.default_rng(77), CONF)
    rec = check.FormationRecorder()
    with rec:
        assert eng.move_in_formation(sides[0]["inf"], (160.0, 140.0),
                                     FormationType.RANK)
    return rec


def test_a_sound_formation_is_within_the_limits(recorded):
    """At this size the auction converges: within its 2 eps."""
    assert recorded.layouts and recorded.assigns
    got, gain = check.judge_formations(recorded, "cpu")
    assert got["formation_cells_differ"] <= LIMITS["formation_cells_differ"]
    assert 0.0 <= gain <= 1.0, gain


def test_a_moved_cell_and_a_worse_assignment_are_caught(recorded):
    units_pos, cells, assign = recorded.assigns[0]
    # the unit nearest each cell given the farthest one
    order = np.argsort(((units_pos[:, None] - cells[assign][None]) ** 2)
                       .sum(-1).min(1))
    worse = assign.copy()
    worse[order] = assign[order[::-1]]
    recorded.assigns[0] = (units_pos, cells, worse)
    layout = list(recorded.layouts[0])
    layout[-1] = layout[-1].copy()
    layout[-1][0, 0] += 0.5
    recorded.layouts[0] = tuple(layout)
    got, gain = check.judge_formations(recorded, "cpu")
    assert got["formation_cells_differ"] > LIMITS["formation_cells_differ"]
    assert gain > 1.0


def test_the_formation_control_is_not_correct(recorded):
    got, _ = check.judge_formations(recorded, "cpu", lowp=True)
    assert got["formation_cells_differ"] > LIMITS["formation_cells_differ"]

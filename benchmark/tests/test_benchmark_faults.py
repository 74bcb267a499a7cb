"""The comparison that decides ``correct`` fails what it has to: the
control (the reference in bfloat16 in the program's place), and a run
whose timed path is broken underneath, once for each fault a cell can
have (a step that returns its state unchanged, half the entities left
out, an answer altered where it is produced: a position in the tick, a
value of a flow field the order path integrates). One chip: no exchange
between chips to leave out."""

import pytest
import torch

from benchmark import run
from benchmark.generators import contact
from benchmark.tests.tiny import TinySpec, limits, use_tiny, workload


def _arm(monkeypatch, fault: str) -> None:
    """Break the program's tick when the window starts."""
    from permafrost_engine_tpu_torch.game import step
    from permafrost_engine_tpu_torch.ops import flowfield_cuda, projectile, \
        skin

    real_move = step.movement_substep

    def install():
        if fault == "unchanged":
            def same(cfg, state, deltas, *a, **k):
                return state, deltas
            monkeypatch.setattr(step, "movement_substep", same)
            monkeypatch.setattr(step, "combat_substep", same)
            monkeypatch.setattr(step, "fog_substep",
                                lambda cfg, state, *a, **k: state)
            monkeypatch.setattr(projectile, "projectile_substep",
                                lambda cfg, s, acc: (s, acc))
            monkeypatch.setattr(skin, "skin_substep", lambda cfg, b, s: s)
        elif fault == "half":
            def half(cfg, state, deltas, part=None):
                old = {k: getattr(state.ents, k).clone()
                       for k in ("pos", "vel", "movestate", "facing")}
                state, deltas = real_move(cfg, state, deltas, part)
                rows = torch.nonzero(state.ents.alive).flatten()[1::2]
                for k, v in old.items():
                    getattr(state.ents, k)[rows] = v[rows]
                return state, deltas
            monkeypatch.setattr(step, "movement_substep", half)
        elif fault == "field":
            real_k2 = flowfield_cuda.integrate_plain

            def field(cost, seed_mask, seed_cost=None, **kw):
                out = real_k2(cost, seed_mask, seed_cost, **kw).clone()
                reach = torch.nonzero(out < 1e30)
                out[tuple(reach[-1])] += 1.0
                return out
            monkeypatch.setattr(flowfield_cuda, "integrate_plain", field)
        else:
            def altered(cfg, state, deltas, part=None):
                state, deltas = real_move(cfg, state, deltas, part)
                state.ents.pos[0, 0] += 0.01
                return state, deltas
            monkeypatch.setattr(step, "movement_substep", altered)

    real_window = contact.Cell.window

    def window(self, seconds):
        install()
        return real_window(self, seconds)

    monkeypatch.setattr(contact.Cell, "window", window)


@pytest.mark.parametrize("fault,kind", [
    pytest.param("unchanged", "scan", id="unchanged"),
    pytest.param("half", "scan", id="half"),
    pytest.param("alter", "scan", id="alter"),
    pytest.param("field", "coldorders", id="field")])
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault, kind):
    use_tiny(monkeypatch)
    _arm(monkeypatch, fault)
    out = run.measure(TinySpec(), workload(kind), seed=987654321,
                      seconds=0.5, trace=False, device="cpu", t_start=0.0,
                      log=lambda s: None)
    assert out["correct"] is False, out["checks"]


def test_the_control_is_not_correct(monkeypatch):
    """The control at a test size: the sound reading keeps within every
    limit, the control's passes one of them."""
    from benchmark.control import readings

    use_tiny(monkeypatch)
    r = readings(TinySpec(), workload("frame"), seed=4242424242,
                 seconds=0.5, device="cpu")
    lim = limits()
    assert set(r["sound"]) == set(lim), r["sound"]
    assert all(v <= lim[k] for k, v in r["sound"].items()), r["sound"]
    assert any(v > lim[k] for k, v in r["control"].items()), r["control"]

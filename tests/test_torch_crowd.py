"""PyTorch port vs the JAX package: kernel K1 (HRVO select) and ClearPath.

On the CPU the port's ``hrvo_select`` runs its plain version,
``hrvo_select_plain``. It is held against the Pallas kernel
``hrvo_select_pallas`` in interpret mode and against the XLA path
(exact top-K + ``clearpath.new_velocities``) on the scenes of
test_crowd_pallas.py, seeds 0 and 3, in fan and exact mode, with the bounds
test_crowd_pallas.py puts on Pallas vs XLA: median error 0, never more
violations under the reference scorer, near-tie picks as good.

Measured on these four scenes: 128 of 128 rows agree within 1e-4 with
both JAX paths, so the share bound is tightened from 0.5 to 1.0.
"""

import functools

import numpy as np
import pytest
import torch
torch.set_num_threads(1)
import jax.numpy as jnp

from permafrost_engine_tpu.core.config import MAX_NEIGHBOURS
from permafrost_engine_tpu.ops import clearpath as jcp
from permafrost_engine_tpu.ops.crowd_pallas import hrvo_select_pallas
from permafrost_engine_tpu_torch.ops import clearpath as tcp
from permafrost_engine_tpu_torch.ops.crowd_cuda import (hrvo_select,
                                                        hrvo_select_plain)
from test_crowd_pallas import build_scene, hrvo_score, xla_reference
import chip_smoke

MEASURED_SHARE = 1.0
# chip_smoke.py's edge-scene shapes, at most 64 rows; the largest error
# against the Pallas kernel measured on them is 4.3e-7 (exact mode)
EDGE_SHAPES = [(min(n, 64), c2, first)
               for n, c2, first in chip_smoke.K1_EDGE_SHAPES]
EDGE_TOL = 1e-6


def _t(arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@functools.lru_cache(maxsize=None)
def _scene(seed, exact):
    scene, cand_idx = build_scene(seed=seed)
    pallas = np.asarray(hrvo_select_pallas(
        *[jnp.asarray(a) for a in scene], interpret=True, exact=exact))
    xla = xla_reference(scene, cand_idx, exact=exact)
    ours = hrvo_select(*_t(scene), exact=exact).numpy()
    return scene, cand_idx, pallas, xla, ours


@pytest.mark.parametrize("seed,exact", [(0, False), (3, False), (0, True),
                                        (3, True)])
@pytest.mark.parametrize("ref", ["pallas", "xla"])
def test_k1_plain_matches_jax(seed, exact, ref):
    scene, _, pallas, xla, ours = _scene(seed, exact)
    want = pallas if ref == "pallas" else xla
    err = np.linalg.norm(ours - want, axis=1)
    assert np.median(err) == 0.0
    assert (err < 1e-4).mean() >= MEASURED_SHARE, (err < 1e-4).mean()

    (pos, vel, radius, vpref, _ms, cand_pos, cand_vel, cand_rad,
     cand_valid, cand_static) = scene
    d2 = ((cand_pos - pos[:, None, :]) ** 2).sum(-1)
    d2 = np.where(cand_valid, d2, np.inf)
    gv, gd = hrvo_score(ours, pos, vel, radius, vpref, cand_pos, cand_vel,
                        cand_rad, cand_valid, cand_static, d2)
    wv, wd = hrvo_score(want, pos, vel, radius, vpref, cand_pos, cand_vel,
                        cand_rad, cand_valid, cand_static, d2)
    slack = 1 if exact else 0      # the scorer uses the fan-mode cones
    assert (gv <= wv + slack).all()
    ties = gv == wv
    assert (gd[ties] <= wd[ties] + 0.05).all()


@pytest.mark.parametrize("seed,exact", [(0, False), (3, True)])
def test_k1_short_window(seed, exact):
    """Fewer window candidates than K: the missing neighbours are invalid
    rows, as in the Pallas kernel."""
    scene, _ = build_scene(n=32, c2=20, seed=seed)
    want = np.asarray(hrvo_select_pallas(
        *[jnp.asarray(a) for a in scene], interpret=True, exact=exact))
    got = hrvo_select(*_t(scene), exact=exact).numpy()
    err = np.linalg.norm(got - want, axis=1)
    assert np.median(err) == 0.0
    assert np.isfinite(got).all()


def test_k1_head_on_units_deviate():
    """Two units driven head-on deviate laterally, to compatible sides
    (the HRVO property; test_crowd_pallas.py's behavioural check)."""
    pos = np.array([[0.0, 0.0], [4.0, 0.0]], np.float32)
    vel = np.array([[1.0, 0.0], [-1.0, 0.0]], np.float32)
    args = (pos, vel, np.ones(2, np.float32), vel.copy(),
            np.full(2, 1.0, np.float32), pos[::-1].reshape(2, 1, 2),
            vel[::-1].reshape(2, 1, 2), np.ones((2, 1), np.float32),
            np.ones((2, 1), bool), np.zeros((2, 1), bool))
    out = hrvo_select(*_t(args)).numpy()
    assert abs(out[0, 1]) > 1e-3 or abs(out[1, 1]) > 1e-3
    p0 = pos + out
    assert np.linalg.norm(p0[0] - p0[1]) >= np.linalg.norm(pos[0] - pos[1]) - 2.2


def test_k1_rejects_other_devices():
    args = [torch.zeros(s, dtype=d, device="meta") for s, d in (
        ((2, 2), torch.float32), ((2, 2), torch.float32), ((2,), torch.float32),
        ((2, 2), torch.float32), ((2,), torch.float32),
        ((2, 3, 2), torch.float32), ((2, 3, 2), torch.float32),
        ((2, 3), torch.float32), ((2, 3), torch.bool), ((2, 3), torch.bool))]
    with pytest.raises(RuntimeError):
        hrvo_select(*args)


@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("n,c2,first", EDGE_SHAPES)
def test_k1_edge_scenes_match_pallas(n, c2, first, exact):
    """chip_smoke.py's K1 edge scenes (ties at the 32nd/33rd neighbour,
    zero and NaN preferred velocities, static, colliding, short and empty
    windows) against the Pallas kernel in interpret mode, every row: NaN
    where it is NaN (a NaN preferred velocity), equal elsewhere up to the
    ulp-level rounding of XLA's own contractions."""
    scene = chip_smoke.k1_edge_scene(n, c2, first, seed=n + c2)
    want = np.asarray(hrvo_select_pallas(
        *[jnp.asarray(a) for a in scene], interpret=True, exact=exact))
    got = hrvo_select(*_t(scene), exact=exact).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    err = np.linalg.norm(np.nan_to_num(got - want), axis=1)
    assert np.median(err) == 0.0
    assert err.max() <= EDGE_TOL, err.max()


@pytest.mark.parametrize("exact", [False, True])
def test_k1_plain_pair_counts(exact):
    """The plain version's pair counts (the kernel's bound and sqrt share):
    the pairs of each valid cone with every tested candidate (exact mode
    leaves out the intersections that fall back to vpref: the 136 pairs
    i >= j and those whose rays do not meet), and each inside pair passed
    the sign test first, so inside <= passed <= pairs."""
    scene = chip_smoke.k1_edge_scene(16, 144, 0, seed=1)
    stats = {}
    plain = hrvo_select_plain(*_t(scene), exact=exact, stats=stats)
    again = hrvo_select(*_t(scene), exact=exact)
    np.testing.assert_array_equal(plain.numpy(), again.numpy())
    nvalid = np.minimum(scene[8].sum(1), MAX_NEIGHBOURS).sum()
    if exact:      # 57 fan and edge + 64 free always; up to 120 intersections
        assert nvalid * 121 < stats["pairs"] < nvalid * 241
    else:
        assert stats["pairs"] == nvalid * 57
    assert 0 < stats["inside"] <= stats["passed"] <= stats["pairs"]
    assert stats["pairs"] <= 32 * stats["slots"] < stats["pairs"] + 32 * nvalid
    assert stats["passed"] <= 32 * stats["slots_passed"]
    assert stats["slots_passed"] <= stats["slots"]


@pytest.mark.parametrize("seed,exact", [(0, False), (3, False), (0, True),
                                        (3, True)])
def test_clearpath_new_velocities_matches(seed, exact):
    """The port's ClearPath (the XLA-path solver) against the JAX one on
    the exact top-K of the same scenes: within 1e-6 on every row but the
    rare near-tie where the two f32 evaluations pick different, equally
    good candidates (1 of 128 rows on seed 0 fan)."""
    scene, cand_idx = build_scene(seed=seed)
    (pos, vel, radius, vpref, max_speed, cand_pos, cand_vel, cand_rad,
     cand_valid, cand_static) = scene
    n = pos.shape[0]
    d2 = ((cand_pos - pos[:, None, :]) ** 2).sum(-1)
    d2 = np.where(cand_valid, d2, np.inf)
    order = np.argsort(d2, axis=1, kind="stable")[:, :MAX_NEIGHBOURS]
    rows = np.arange(n)[:, None]
    args = (pos, vel, radius, vpref, max_speed, cand_idx[rows, order],
            np.isfinite(d2[rows, order]), cand_static[rows, order],
            np.ones(n, bool))
    kw = dict(neigh_pos=cand_pos[rows, order], neigh_vel=cand_vel[rows, order],
              neigh_rad=cand_rad[rows, order])
    want = np.asarray(jcp.new_velocities(
        *[jnp.asarray(a) for a in args],
        **{k: jnp.asarray(v) for k, v in kw.items()}, exact=exact))
    got = tcp.new_velocities(*_t(args), **dict(zip(kw, _t(kw.values()))),
                             exact=exact).numpy()
    err = np.linalg.norm(got - want, axis=1)
    assert (err < 1e-6).mean() >= 127 / 128
    assert np.median(err) < 1e-7

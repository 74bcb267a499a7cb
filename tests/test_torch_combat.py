"""PyTorch port vs the JAX package: combat, corpses and projectiles.

Random arenas are made from a seed with numpy, built as a JAX
``GameState`` and carried into the port with ``state_from_numpy``; both
sides then run the same substep. Tolerances: ``nearest_match``, the combat
and corpse substeps and both projectile functions are exactly equal, every
field and every delta, floats included. The JAX side is compiled by XLA on
the CPU, which contracts some multiply-adds into FMAs; the port contracts
the same ones (``ops/rounding.py``), so no ulp bound is needed.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
torch.set_num_threads(1)

from permafrost_engine_tpu.core.config import (
    CombatState,
    DiplomacyState,
    EngineConfig,
    EntityFlags,
)
from permafrost_engine_tpu.ops import combat as jcombat
from permafrost_engine_tpu.ops import grid as jgrid
from permafrost_engine_tpu.ops import projectile as jproj
from permafrost_engine_tpu.state.schema import empty_deltas as jempty
from permafrost_engine_tpu.state.schema import init_state as jinit
from permafrost_engine_tpu_torch.game import step as tstep
from permafrost_engine_tpu_torch.ops import combat as tcombat
from permafrost_engine_tpu_torch.ops import grid as tgrid
from permafrost_engine_tpu_torch.ops import projectile as tproj
from permafrost_engine_tpu_torch.state.convert import (
    state_from_numpy,
    state_to_numpy,
)
from permafrost_engine_tpu_torch.state.schema import empty_deltas as tempty
from permafrost_engine_tpu_torch.core.config import EngineConfig as TorchConfig

N = 384
CFG = EngineConfig(max_ents=N, chunks_r=1, chunks_c=1, num_layers=1,
                   max_flocks=4, max_projectiles=64, field_slab_slots=8,
                   los_slab_slots=8)
# the port's own EngineConfig, built from the same fields
TCFG = TorchConfig(**dataclasses.asdict(CFG))


def _arena(seed: int):
    """A JAX GameState with a random arena: three factions (0-1 and 1-2 at
    war, 0-2 at peace), clustered units so vision and range tests bind,
    a share of dead, corpse, ranged and non-combat units, and positions
    duplicated in places so nearest-target ties occur."""
    rng = np.random.default_rng(seed)
    st = jinit(CFG)
    e = st.ents
    centers = rng.random((6, 2)) * 220 + 18
    pos = (centers[rng.integers(0, 6, N)] + rng.normal(0, 14, (N, 2)))
    pos = pos.astype(np.float32)
    dup = rng.integers(0, N, 40)
    pos[dup[:20]] = pos[dup[20:]]
    flags = np.full(N, EntityFlags.COLLISION | EntityFlags.MOVABLE
                    | EntityFlags.COMBATABLE, np.uint32)
    flags[rng.random(N) < 0.08] &= ~np.uint32(EntityFlags.COMBATABLE)
    flags[rng.random(N) < 0.08] &= ~np.uint32(EntityFlags.MOVABLE)
    hp = (rng.random(N) * 120 - 10).astype(np.float32)
    cs = rng.integers(0, 6, N).astype(np.int32)
    diplo = np.zeros((CFG.max_factions, CFG.max_factions), np.int32)
    for a, b, d in ((0, 1, DiplomacyState.WAR), (1, 2, DiplomacyState.WAR),
                    (0, 2, DiplomacyState.PEACE)):
        diplo[a, b] = diplo[b, a] = int(d)
    f32 = np.float32
    e = e.replace(
        alive=jnp.asarray(rng.random(N) < 0.92),
        flags=jnp.asarray(flags),
        faction=jnp.asarray(rng.integers(0, 3, N).astype(np.int32)),
        pos=jnp.asarray(pos),
        height=jnp.asarray((rng.random(N) * 3).astype(f32)),
        vel=jnp.asarray(rng.normal(0, 1, (N, 2)).astype(f32)),
        dest=jnp.asarray((rng.random((N, 2)) * 256).astype(f32)),
        flock=jnp.asarray(rng.integers(-1, 4, N).astype(np.int32)),
        movestate=jnp.asarray(rng.integers(0, 7, N).astype(np.int32)),
        sel_radius=jnp.asarray((rng.random(N) * 2 + 0.5).astype(f32)),
        hp=jnp.asarray(hp),
        combatstate=jnp.asarray(cs),
        stance=jnp.asarray(rng.integers(0, 3, N).astype(np.int32)),
        target=jnp.asarray(rng.integers(-1, N, N).astype(np.int32)),
        attack_range=jnp.asarray((rng.random(N) * 18 + 2).astype(f32)),
        base_dmg=jnp.asarray((rng.random(N) * 30).astype(f32)),
        armour_pc=jnp.asarray((rng.random(N) * 0.5).astype(f32)),
        attack_cooldown=jnp.asarray(rng.integers(0, 3, N).astype(np.int32)),
        attack_period=jnp.asarray(rng.integers(1, 10, N).astype(np.int32)),
        is_ranged=jnp.asarray(rng.random(N) < 0.3),
        corpse_ticks=jnp.asarray(rng.integers(0, 4, N).astype(np.int32)),
        vision_range=jnp.asarray((rng.random(N) * 60 + 20).astype(f32)),
    )
    p = CFG.max_projectiles
    src = pos[rng.integers(0, N, p)] + rng.normal(0, 3, (p, 2)).astype(f32)
    pr = st.projectiles.replace(
        active=jnp.asarray(rng.random(p) < 0.7),
        pos=jnp.asarray(np.stack([src[:, 0], rng.random(p) * 8, src[:, 1]],
                                 1).astype(f32)),
        vel=jnp.asarray(rng.normal(0, 60, (p, 3)).astype(f32)),
        faction=jnp.asarray(rng.integers(0, 3, p).astype(np.int32)),
        parent=jnp.asarray(rng.integers(0, N, p).astype(np.int32)),
        cookie=jnp.asarray((rng.random(p) * 40).astype(f32)))
    st = st.replace(ents=e, projectiles=pr, factions=st.factions.replace(
        diplomacy=jnp.asarray(diplo)))
    return st


def _assert_tree_equal(jtree, ttree, what):
    for name, comp in ttree.items():
        want = np.asarray(getattr(jtree, name)) if not isinstance(jtree, dict) \
            else np.asarray(jtree[name])
        np.testing.assert_array_equal(np.asarray(comp), want,
                                      err_msg=f"{what}.{name}")


def _deltas_np(d):
    return {k: v.numpy() for k, v in vars(d).items()}


def _ents_equal(jst, tst, what):
    _assert_tree_equal(jax.device_get(jst.ents),
                       state_to_numpy(tst)["ents"], what)


@pytest.mark.parametrize("block", [64, 100, N])
def test_nearest_match_exact_with_ties(block):
    """The nearest target under the war table, blocks smaller than N (and
    not dividing it), duplicated positions forcing ties: the same index
    (global first-index argmin) and the same distance."""
    st = _arena(1)
    e = st.ents
    war = st.factions.diplomacy == DiplomacyState.WAR
    fighter = e.alive & (e.hp > 0)
    ji, jd = jgrid.nearest_match(e.pos, fighter, e.pos, fighter,
                                 (e.faction, war, e.faction), block=block)
    t = state_from_numpy(jax.device_get(st), "cpu").ents
    twar = torch.from_numpy(np.array(war))
    tfighter = t.alive & (t.hp > 0)
    ti, td = tgrid.nearest_match(t.pos, tfighter, t.pos, tfighter,
                                 (t.faction, twar, t.faction), block=block)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert (ti >= 0).sum() > N // 2
    # the ties were real: some queryer has two targets at its nearest distance
    pos = t.pos.numpy()
    tied = 0
    for q in np.nonzero(ti.numpy() >= 0)[0][:200]:
        d = np.linalg.norm(pos - pos[q], axis=1)
        tied += int((d == d[ti[q]]).sum() > 1)
    assert tied > 0


@pytest.mark.parametrize("seed", [2, 3, 4])
def test_combat_substep_exact(seed):
    st = _arena(seed)
    fn = jax.jit(functools.partial(jcombat.combat_substep, CFG))
    jst, jd, jatk = fn(st, jempty(CFG))
    tst = state_from_numpy(jax.device_get(st), "cpu")
    tst, td, tatk = tcombat.combat_substep(TCFG, tst, tempty(TCFG, device="cpu"))
    _ents_equal(jst, tst, "ents")
    _assert_tree_equal(jax.device_get(jd), _deltas_np(td), "deltas")
    np.testing.assert_array_equal(tatk.numpy(), np.asarray(jatk))
    assert tatk.any() and td.died.any() and td.motion_start.any()


def test_corpse_substep_exact():
    st = _arena(5)
    fn = jax.jit(functools.partial(jcombat.corpse_substep, CFG))
    jst, _jd, jexp = fn(st, jempty(CFG))
    tst = state_from_numpy(jax.device_get(st), "cpu")
    tst, _td, texp = tcombat.corpse_substep(TCFG, tst, tempty(TCFG, device="cpu"))
    _ents_equal(jst, tst, "ents")
    np.testing.assert_array_equal(texp.numpy(), np.asarray(jexp))
    assert texp.any()


@pytest.mark.parametrize("seed", [6, 7])
def test_spawn_projectiles_exact(seed):
    """Ranged attackers fill free pool slots in stable order; more shooters
    than free slots overflow and are dropped."""
    st = _arena(seed)
    rng = np.random.default_rng(seed)
    shooters = rng.random(N) < 0.15
    tgt = rng.integers(0, N, N)
    e = st.ents
    jp = jax.jit(functools.partial(jproj.spawn_projectiles, CFG))(
        st.projectiles, jnp.asarray(shooters), e.pos, e.pos[tgt], e.faction,
        e.base_dmg)
    tst = state_from_numpy(jax.device_get(st), "cpu")
    t = tst.ents
    tp = tproj.spawn_projectiles(TCFG, tst.projectiles, torch.from_numpy(shooters),
                                 t.pos, t.pos[torch.from_numpy(tgt)], t.faction,
                                 t.base_dmg)
    _assert_tree_equal(jax.device_get(jp), state_to_numpy(tst)["projectiles"],
                       "projectiles")
    assert shooters.sum() > int((~np.asarray(st.projectiles.active)).sum())
    assert tp.active.all()


@pytest.mark.parametrize("seed", [8, 9, 10])
def test_projectile_substep_exact(seed):
    st = _arena(seed)
    fn = jax.jit(functools.partial(jproj.projectile_substep, CFG))
    jst, jd = fn(st, jempty(CFG))
    tst = state_from_numpy(jax.device_get(st), "cpu")
    tst, td = tproj.projectile_substep(TCFG, tst, tempty(TCFG, device="cpu"))
    _ents_equal(jst, tst, "ents")
    _assert_tree_equal(jax.device_get(jst.projectiles),
                       state_to_numpy(tst)["projectiles"], "projectiles")
    _assert_tree_equal(jax.device_get(jd), _deltas_np(td), "deltas")
    assert (td.proj_hit >= 0).sum() >= 3


def test_combat_step_spawns_like_jax():
    """The tick's combat substep (combat + projectile spawn) on one arena."""
    from permafrost_engine_tpu.game import step as jstep

    st = _arena(11)
    fn = jax.jit(functools.partial(jstep.combat_substep, CFG))
    jst, jd = fn(st, jempty(CFG))
    tst = state_from_numpy(jax.device_get(st), "cpu")
    tst, td = tstep.combat_substep(TCFG, tst, tempty(TCFG, device="cpu"))
    _ents_equal(jst, tst, "ents")
    _assert_tree_equal(jax.device_get(jst.projectiles),
                       state_to_numpy(tst)["projectiles"], "projectiles")
    _assert_tree_equal(jax.device_get(jd), _deltas_np(td), "deltas")
    assert int(CombatState.CORPSE) in tst.ents.combatstate.tolist()

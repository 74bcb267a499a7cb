"""Carry a game state across between the JAX package and the port.

``state_from_numpy`` takes the JAX package's ``GameState`` as fetched to the
host (``jax.device_get``: a tree of numpy arrays whose attribute names match
this package's dataclasses), or ``state_to_numpy``'s dicts, and builds the
port's state on a device; ``state_to_numpy`` is the reverse, as nested
dicts of numpy arrays keyed by the same field names. The parity tests use
the pair to start both engines from one state, and a session blob
(``core/session.py``) holds the state as those dicts. ``anim`` (skinning) crosses both ways when present; its
device frame ``anim.tick`` is the state's ``tick``. ``bank_from_numpy``
builds the port's ``SkinBank`` from a JAX bank's arrays, so both engines
can skin with the same rig. Only numpy is needed on the JAX side, so this
module imports no JAX.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from permafrost_engine_tpu_torch.ops.skin import SkinBank
from permafrost_engine_tpu_torch.state import schema

_ANIM = ("clip", "start", "palettes")    # the JAX AnimArena's fields

_COMPONENTS = {
    "ents": schema.EntityArena,
    "flocks": schema.FlockTable,
    "fields": schema.FieldSlab,
    "nav": schema.NavState,
    "fog": schema.FogState,
    "projectiles": schema.ProjectileArena,
    "factions": schema.FactionTable,
}


def _to_tensor(a, device) -> torch.Tensor:
    a = np.array(a)                       # a writable copy
    if a.dtype == np.uint32:
        # EntityFlags: same bits, stored signed (see schema docstring)
        a = a.view(np.int32)
    return torch.from_numpy(a).to(device)


def _get(obj, name, default=None):
    """A field of a state tree given as attributes or as a dict."""
    if isinstance(obj, dict):
        return obj.get(name, default)
    return getattr(obj, name, default)


def state_from_numpy(tree, device) -> schema.GameState:
    """Port state on `device` from a host copy of the JAX ``GameState``, or
    from ``state_to_numpy``'s dicts."""
    parts = {}
    for name, cls in _COMPONENTS.items():
        src = _get(tree, name)
        parts[name] = cls(**{
            f.name: _to_tensor(_get(src, f.name), device)
            for f in dataclasses.fields(cls)})
    rng = np.asarray(_get(tree, "rng")).astype(np.int64)
    tick = int(np.asarray(_get(tree, "tick")))
    anim = _get(tree, "anim")
    if anim is not None:
        anim = schema.AnimArena(
            **{f: _to_tensor(_get(anim, f), device) for f in _ANIM},
            tick=torch.tensor(tick, dtype=torch.int32, device=device))
    return schema.GameState(
        tick=tick, rng=torch.from_numpy(rng).to(device), anim=anim, **parts)


def _component_to_numpy(obj) -> dict[str, np.ndarray]:
    out = {}
    for f in dataclasses.fields(obj):
        a = getattr(obj, f.name).detach().cpu().numpy()
        if f.name == "flags":
            a = a.view(np.uint32)
        out[f.name] = a
    return out


def state_to_numpy(state: schema.GameState) -> dict:
    """Nested dicts of numpy arrays with the JAX state's names and dtypes
    (``flags`` back to u32, ``tick`` i32, ``rng`` the u32 key words)."""
    out = {name: _component_to_numpy(getattr(state, name))
           for name in _COMPONENTS}
    out["tick"] = np.asarray(state.tick, np.int32)
    out["rng"] = state.rng.cpu().numpy().astype(np.uint32)
    if state.anim is not None:
        out["anim"] = {f: getattr(state.anim, f).cpu().numpy() for f in _ANIM}
    return out


def bank_from_numpy(bank, device) -> SkinBank:
    """The port's ``SkinBank`` on `device` from a JAX ``SkinBank`` (or any
    object with its attribute names): ``pack``, ``frames``, ``loop`` and
    ``inv_bind`` as arrays, ``parents``, ``levels`` and ``max_frames``
    as host values."""
    return SkinBank(
        pack=_to_tensor(bank.pack, device),
        frames=_to_tensor(bank.frames, device),
        loop=_to_tensor(bank.loop, device),
        inv_bind=_to_tensor(bank.inv_bind, device),
        max_frames=int(bank.max_frames),
        levels=tuple(tuple(int(j) for j in lvl) for lvl in bank.levels),
        parents=tuple(int(p) for p in bank.parents))

"""Carry a game state across between the JAX package and the port.

``state_from_numpy`` takes the JAX package's ``GameState`` as fetched to the
host (``jax.device_get``: a tree of numpy arrays whose attribute names match
this package's dataclasses) and builds the port's state on a device;
``state_to_numpy`` is the reverse, as nested dicts of numpy arrays keyed by
the same field names. The parity tests use the pair to start both engines
from one state. Only numpy is needed on the JAX side, so this module imports
no JAX.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from permafrost_engine_tpu_torch.state import schema

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


def state_from_numpy(tree, device) -> schema.GameState:
    """Port state on `device` from a host copy of the JAX ``GameState``."""
    parts = {}
    for name, cls in _COMPONENTS.items():
        src = getattr(tree, name)
        parts[name] = cls(**{
            f.name: _to_tensor(getattr(src, f.name), device)
            for f in dataclasses.fields(cls)})
    rng = np.asarray(tree.rng).astype(np.int64)
    return schema.GameState(
        tick=int(np.asarray(tree.tick)),
        rng=torch.from_numpy(rng).to(device), **parts)


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
    return out

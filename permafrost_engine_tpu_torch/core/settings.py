"""Typed settings store with validate/commit hooks and file persistence.

The port's own copy of ``permafrost_engine_tpu/core/settings.py``,
unchanged.

Mirrors the reference's Settings subsystem (ref: src/settings.h:47-108):
typed values (string/float/int/bool/vec2), per-setting validate and commit
callbacks, persistence to a settings file, and ~60 `pf.*` settings
registered by subsystems (SURVEY Appendix B). Persistence uses JSON instead
of the reference's custom text format.
"""

from __future__ import annotations

import dataclasses
import json
import os
from enum import Enum
from typing import Any, Callable


class SettingType(Enum):
    STRING = "string"
    FLOAT = "float"
    INT = "int"
    BOOL = "bool"
    VEC2 = "vec2"


_PY_TYPES = {
    SettingType.STRING: str,
    SettingType.FLOAT: (int, float),
    SettingType.INT: int,
    SettingType.BOOL: bool,
    SettingType.VEC2: (list, tuple),
}


class SettingsError(Exception):
    pass


@dataclasses.dataclass
class _Setting:
    name: str
    stype: SettingType
    value: Any
    validate: Callable[[Any], bool] | None = None
    commit: Callable[[Any], None] | None = None
    persist: bool = True


class Settings:
    def __init__(self):
        self._store: dict[str, _Setting] = {}
        self._pending_file: dict[str, Any] = {}

    def create(
        self,
        name: str,
        stype: SettingType,
        value: Any,
        *,
        validate: Callable[[Any], bool] | None = None,
        commit: Callable[[Any], None] | None = None,
        persist: bool = True,
    ) -> None:
        """Register a setting (ref: Settings_Create, settings.h:90). If the
        settings file loaded earlier carried a value for it, that value is
        applied now (the reference's priority-ordered load)."""
        s = _Setting(name, stype, value, validate, commit, persist)
        self._store[name] = s
        if name in self._pending_file:
            try:
                self.set(name, self._pending_file.pop(name))
                return
            except SettingsError:
                pass
        if commit:
            commit(s.value)

    def delete(self, name: str) -> None:
        self._store.pop(name, None)

    def get(self, name: str) -> Any:
        try:
            return self._store[name].value
        except KeyError:
            raise SettingsError(f"no such setting: {name}") from None

    def set(self, name: str, value: Any) -> None:
        try:
            s = self._store[name]
        except KeyError:
            raise SettingsError(f"no such setting: {name}") from None
        if not isinstance(value, _PY_TYPES[s.stype]):
            raise SettingsError(
                f"{name}: expected {s.stype.value}, got {type(value).__name__}")
        if s.stype == SettingType.VEC2 and len(value) != 2:
            raise SettingsError(f"{name}: vec2 needs 2 components")
        if s.validate and not s.validate(value):
            raise SettingsError(f"{name}: validation rejected {value!r}")
        s.value = value
        if s.commit:
            s.commit(value)

    def names(self) -> list[str]:
        return sorted(self._store)

    # -- persistence ---------------------------------------------------------

    def save_to_file(self, path: str) -> None:
        data = {
            s.name: {"type": s.stype.value, "value": s.value}
            for s in self._store.values() if s.persist
        }
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(data, f, indent=1, sort_keys=True)
        os.replace(tmp, path)

    def load_from_file(self, path: str) -> None:
        """Values for not-yet-registered settings are held and applied when
        the owning subsystem registers them (priority-ordered load,
        ref: settings.c)."""
        with open(path) as f:
            data = json.load(f)
        for name, rec in data.items():
            if name in self._store:
                try:
                    self.set(name, rec["value"])
                except SettingsError:
                    pass
            else:
                self._pending_file[name] = rec["value"]

    # -- snapshot for session save --------------------------------------------

    def snapshot(self) -> dict[str, Any]:
        return {s.name: s.value for s in self._store.values()}

    def restore(self, snap: dict[str, Any]) -> None:
        for name, value in snap.items():
            if name in self._store:
                try:
                    self.set(name, value)
                except SettingsError:
                    pass
            else:
                self._pending_file[name] = value

"""Attribute-access dict with recursive immutability.

Mirrors the behavior contract of the reference config container
(reference `configs/collections.py:24-65`): keys are readable/writable as
attributes, and a config tree can be frozen so later mutation raises.
Fresh implementation.
"""

from __future__ import annotations

import copy


class AttrDict(dict):
    _IMMUTABLE = "__immutable__"

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.__dict__[AttrDict._IMMUTABLE] = False

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name)

    def __setattr__(self, name, value):
        if self.__dict__.get(AttrDict._IMMUTABLE, False):
            raise AttributeError(
                f"Attempted to set '{name}' on an immutable AttrDict"
            )
        self[name] = value

    def _check_mutable(self, what):
        if self.__dict__.get(AttrDict._IMMUTABLE, False):
            raise AttributeError(
                f"Attempted to {what} an immutable AttrDict")

    def __setitem__(self, key, value):
        # every mutating dict entry point must honor the freeze (the merge
        # machinery writes via d[k] = v; a frozen config silently mutable
        # through any of these would defeat assert_and_infer_cfg's contract)
        self._check_mutable(f"set '{key}' on")
        super().__setitem__(key, value)

    def __delitem__(self, key):
        self._check_mutable(f"delete '{key}' from")
        super().__delitem__(key)

    def update(self, *args, **kwargs):
        self._check_mutable("update")
        super().update(*args, **kwargs)

    def setdefault(self, key, default=None):
        if key not in self:
            self._check_mutable(f"setdefault '{key}' on")
        return super().setdefault(key, default)

    def pop(self, *args, **kwargs):
        self._check_mutable("pop from")
        return super().pop(*args, **kwargs)

    def popitem(self):
        self._check_mutable("pop from")
        return super().popitem()

    def clear(self):
        self._check_mutable("clear")
        super().clear()

    def immutable(self, is_immutable: bool) -> None:
        """Recursively (un)freeze this dict and every nested AttrDict."""
        self.__dict__[AttrDict._IMMUTABLE] = is_immutable
        for v in self.values():
            if isinstance(v, AttrDict):
                v.immutable(is_immutable)

    def is_immutable(self) -> bool:
        return self.__dict__[AttrDict._IMMUTABLE]

    def clone(self) -> "AttrDict":
        out = AttrDict()
        for k, v in self.items():
            # deep-copy mutable leaves (lists like LR_STEPS / MESH_SHAPE):
            # a clone that shares them could corrupt the original in place
            out[k] = v.clone() if isinstance(v, AttrDict) else copy.deepcopy(v)
        return out

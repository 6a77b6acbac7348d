"""The port's flag registry — its own copy of the part of
``rocksplicator_tpu/utils/flags.py`` it uses: string flags with a default,
a process-wide override (``FLAGS.set``, ``FLAGS.reset``), and the
``RSTPU_FLAG_<NAME>`` environment variable, which, as in the JAX package,
is read once: when the flag is defined, at the import of the module that
defines it. The port defines ``sort_backend`` in
``ops/compaction_kernel.py``. ``_coerce`` is the JAX package's value
coercion, which the storage engine's ``set_options`` uses.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional


class FlagRegistry:
    def __init__(self) -> None:
        self._defaults: Dict[str, str] = {}
        self._values: Dict[str, str] = {}

    def define(self, name: str, default: str) -> None:
        """Define a flag; a second definition is a no-op, so a module can
        be imported again."""
        if name not in self._defaults:
            self._defaults[name] = default
            self._values[name] = os.environ.get(
                "RSTPU_FLAG_" + name.upper(), default)

    def get(self, name: str) -> str:
        return self._values[name]

    def set(self, name: str, value: str) -> None:
        if name not in self._defaults:
            raise KeyError(name)
        self._values[name] = str(value)

    def reset(self, name: Optional[str] = None) -> None:
        for n in [name] if name else list(self._defaults):
            self._values[n] = self._defaults[n]


def _coerce(value: Any, typ: type) -> Any:
    """``value`` as ``typ``: "false"/"0"/"no"/"off" are False for a bool,
    and a bool is not passed through for an int (the engine's
    ``set_options`` coerces with it)."""
    if isinstance(value, typ) and not (typ is not bool
                                       and isinstance(value, bool)):
        return value
    if typ is bool:
        if isinstance(value, str):
            return value.lower() in ("1", "true", "yes", "on")
        return bool(value)
    return typ(value)


FLAGS = FlagRegistry()
define_flag = FLAGS.define

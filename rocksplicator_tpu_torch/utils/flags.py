"""The port's flag registry — its own copy of the part of
``rocksplicator_tpu/utils/flags.py`` it uses: typed flags with a default,
a process-wide override (``FLAGS.set``, ``FLAGS.reset``), the status
server's ``/flags.txt`` export (``FLAGS.dump_text``), and the
``RSTPU_FLAG_<NAME>`` environment variable, which, as in the JAX package,
is read once: when the flag is defined, at the import of the module that
defines it. The port defines ``sort_backend`` in
``ops/compaction_kernel.py`` and the admin handler ``s3_direct_io``.
``_coerce`` is the JAX package's value coercion: flag values take their
default's type through it, and the storage engine's ``set_options`` uses
it.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional


class FlagRegistry:
    def __init__(self) -> None:
        self._defaults: Dict[str, Any] = {}
        self._values: Dict[str, Any] = {}

    def define(self, name: str, default: Any, help: str = "") -> None:
        """Define a flag; a second definition is a no-op, so a module can
        be imported again. The environment and ``set`` are coerced to the
        default's type, as in the JAX package."""
        if name not in self._defaults:
            self._defaults[name] = default
            env = os.environ.get("RSTPU_FLAG_" + name.upper())
            self._values[name] = (default if env is None
                                  else _coerce(env, type(default)))

    def get(self, name: str) -> Any:
        return self._values[name]

    def set(self, name: str, value: Any) -> None:
        if name not in self._defaults:
            raise KeyError(name)
        self._values[name] = _coerce(value, type(self._defaults[name]))

    def reset(self, name: Optional[str] = None) -> None:
        for n in [name] if name else list(self._defaults):
            self._values[n] = self._defaults[n]

    def dump_text(self) -> str:
        """Export in the /gflags.txt style: --name=value per line."""
        lines = [f"--{n}={self._values[n]}" for n in sorted(self._values)]
        return "\n".join(lines) + "\n"


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

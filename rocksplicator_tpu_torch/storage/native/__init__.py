"""Native (C++) storage hot paths, loaded via ctypes — the port's copy of
``rocksplicator_tpu/storage/native``.

Built with the host compiler on first *use*, never at import (see
``binding.py``). The Python implementations remain the fallbacks; the
port's binding is held to the JAX package's in
``tests/test_torch_native.py``.
"""

from .binding import NativeLib, get_native, native_available

__all__ = ["NATIVE", "NativeLib", "get_native", "native_available"]


def __getattr__(name: str):
    if name == "NATIVE":
        return get_native()
    raise AttributeError(name)

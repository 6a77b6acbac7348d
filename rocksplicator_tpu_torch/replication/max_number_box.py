"""Compatibility shim: MaxNumberBox moved to ack_window.py.
(The port's copy of ``rocksplicator_tpu/replication/max_number_box.py``.)

The leader ack path now uses :class:`~.ack_window.AckWindow` (windowed
in-flight writes with ack futures); the plain max-watermark box remains
available here for existing importers and tests.
"""

from __future__ import annotations

from .ack_window import MaxNumberBox

__all__ = ["MaxNumberBox"]

"""Graceful shutdown: signal → stop servers with pre/post hooks.
(The port's copy of ``rocksplicator_tpu/utils/graceful_shutdown.py``.)

Reference: common/graceful_shutdown_handler.{h,cpp} — folly AsyncSignalHandler
that stops the thrift server, with registered pre- and post-stop hooks.
"""

from __future__ import annotations

import inspect
import logging
import signal
import threading
from typing import Callable, List

log = logging.getLogger(__name__)


class GracefulShutdownHandler:
    """Registers SIGTERM/SIGINT handlers that run pre-hooks, stop the given
    servers (anything with a ``stop()``), run post-hooks, then set an event
    the main thread can wait on."""

    def __init__(self, drain_timeout: float = 10.0) -> None:
        self._drain_timeout = drain_timeout
        self._pre_hooks: List[Callable[[], None]] = []
        self._post_hooks: List[Callable[[], None]] = []
        self._servers: List[object] = []
        self.done = threading.Event()
        self._installed = False
        self._lock = threading.Lock()

    def add_server(self, server: object) -> None:
        self._servers.append(server)

    def register_pre_shutdown_hook(self, hook: Callable[[], None]) -> None:
        self._pre_hooks.append(hook)

    def register_post_shutdown_hook(self, hook: Callable[[], None]) -> None:
        self._post_hooks.append(hook)

    def install(self) -> None:
        signal.signal(signal.SIGTERM, self._on_signal)
        signal.signal(signal.SIGINT, self._on_signal)
        self._installed = True

    def _on_signal(self, signum, frame) -> None:
        log.info("received signal %s, shutting down", signum)
        threading.Thread(target=self.shutdown, daemon=True).start()

    def shutdown(self) -> None:
        with self._lock:
            if self.done.is_set():
                return
            for hook in self._pre_hooks:
                _safe(hook)
            for server in self._servers:
                stop = getattr(server, "stop", None)
                if callable(stop):
                    # servers supporting graceful drain get the window;
                    # others (e.g. the status server) stop immediately —
                    # decided by signature, not by catching TypeError (which
                    # would double-invoke stop() and mask real errors)
                    def _stop(s=stop):
                        try:
                            params = inspect.signature(s).parameters
                        except (TypeError, ValueError):
                            params = {}
                        if "drain_timeout" in params:
                            s(drain_timeout=self._drain_timeout)
                        else:
                            s()

                    _safe(_stop)
            for hook in self._post_hooks:
                _safe(hook)
            self.done.set()

    def wait(self, timeout: float | None = None) -> bool:
        return self.done.wait(timeout)


def _safe(fn: Callable[[], None]) -> None:
    try:
        fn()
    except Exception:  # pragma: no cover - defensive
        log.exception("shutdown hook failed")

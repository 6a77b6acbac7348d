"""Deadline + tenant propagation primitives (tail armor).
(The port's copy of ``rocksplicator_tpu/rpc/deadline.py``.)

Reference: common/thrift_client_pool.h carries per-call timeout/connect
budgets client-side only — the server never learns how long the caller
is still willing to wait, so an overloaded server happily computes
answers nobody is waiting for. Here the client's remaining budget rides
the JSON frame header exactly as the trace header does
(``DEADLINE_KEY``/``TENANT_KEY`` are reserved top-level message keys
next to ``TRACE_KEY``), each server hop decrements it by measured
queue-wait, and handlers consult :func:`current_deadline` to shed dead
work with a typed ``DEADLINE_EXCEEDED`` instead of serving it.

Wire format: the deadline travels as a RELATIVE budget in milliseconds
(``msg["deadline"] = remaining_ms``) — cross-process wall clocks are
not comparable, monotonic clocks even less so; each hop re-anchors the
budget against its own monotonic clock on receipt. The tenant tag is a
short opaque string (``msg["tenant"]``).

Both in-process carriers are contextvars, so a handler that fans out
through :class:`RpcClient` re-stamps the DECREMENTED budget and the
same tenant on every downstream hop without plumbing arguments through
every signature — the same mechanism the trace context uses.

Everything here is behind the ``RSTPU_TAIL_ARMOR`` killswitch
(default ON; ``0``/``false``/``off`` disarms): unarmed, clients stamp
nothing and servers check nothing, which is the A/B baseline the
overload bench's unarmed-overhead gate measures.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import time
from dataclasses import dataclass
from typing import Optional

__all__ = [
    "DEADLINE_KEY", "TENANT_KEY", "DEADLINE_EXCEEDED", "RETRY_LATER",
    "Deadline", "armor_enabled", "current_deadline", "current_tenant",
    "request_scope",
]

# Reserved top-level frame-header keys (siblings of TRACE_KEY — see
# rpc/serde.encode_message: the header is the whole JSON message minus
# binary chunks, so any top-level key is out-of-band metadata).
DEADLINE_KEY = "deadline"
TENANT_KEY = "tenant"

# Typed application-error codes (rpc/errors.RpcApplicationError.code).
DEADLINE_EXCEEDED = "DEADLINE_EXCEEDED"
RETRY_LATER = "RETRY_LATER"

_OFF = ("0", "false", "off", "no")


def armor_enabled() -> bool:
    """The one killswitch for all three tail-armor layers (deadlines,
    hedging, admission): ``RSTPU_TAIL_ARMOR=0`` restores the exact
    pre-tail-armor serving path. Read per call — the overload bench flips
    it per child process via env, and a cached module global would pin
    the first process's answer into every test in the suite."""
    return os.environ.get("RSTPU_TAIL_ARMOR", "1").strip().lower() \
        not in _OFF


@dataclass(frozen=True)
class Deadline:
    """An absolute point on THIS process's monotonic clock. Created
    from a relative wire budget on receipt; converted back to a
    relative budget when stamped onto a downstream call — so each hop's
    queue/service time is subtracted exactly once, wherever it accrued.
    """

    expires_at: float  # time.monotonic() instant

    @classmethod
    def after_ms(cls, budget_ms: float) -> "Deadline":
        return cls(time.monotonic() + float(budget_ms) / 1e3)

    def remaining_ms(self) -> float:
        """May be negative once expired — callers use the sign."""
        return (self.expires_at - time.monotonic()) * 1e3

    @property
    def expired(self) -> bool:
        return self.remaining_ms() <= 0.0


_deadline_var: contextvars.ContextVar[Optional[Deadline]] = \
    contextvars.ContextVar("rstpu_deadline", default=None)
_tenant_var: contextvars.ContextVar[Optional[str]] = \
    contextvars.ContextVar("rstpu_tenant", default=None)


def current_deadline() -> Optional[Deadline]:
    return _deadline_var.get()


def current_tenant() -> Optional[str]:
    return _tenant_var.get()


@contextlib.contextmanager
def request_scope(deadline: Optional[Deadline] = None,
                  tenant: Optional[str] = None):
    """Scope the ambient deadline/tenant to one request's dispatch task
    (the server sets this around the handler call; per-request tasks
    make the contextvars naturally request-local, exactly like the
    trace context in start_span)."""
    t_d = _deadline_var.set(deadline)
    t_t = _tenant_var.set(tenant)
    try:
        yield
    finally:
        _deadline_var.reset(t_d)
        _tenant_var.reset(t_t)

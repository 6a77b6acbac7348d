"""Trace context: contextvar-carried active span + wire (de)serialization.
(The port's copy of ``rocksplicator_tpu/observability/context.py``.)

The active span rides a :mod:`contextvars` ContextVar, which gives both
propagation models this codebase needs for free:

- **asyncio**: ``asyncio.create_task`` / ``ensure_future`` snapshot the
  creating task's context, so request-handler subtasks inherit the active
  span without plumbing (the fbthrift RequestContext analog);
- **threads**: each thread has its own context, so the leader write path
  (called from arbitrary writer threads) and background flush/compaction
  threads trace independently.

The one seam contextvars do NOT cross is ``loop.run_in_executor`` (asyncio
submits the bare callable). Callers that hop onto the executor capture
:func:`wire_context` on the event-loop side and reattach it via
``start_span(..., remote=ctx)`` executor-side (see admin/handler.py).

Cross-process propagation uses the same dict: a sampled caller injects
``{"trace_id", "span_id", "sampled"}`` into the RPC message's JSON frame
header under the reserved top-level key ``"trace"`` (rpc/client.py), and
the server reattaches it before dispatch (rpc/server.py).
"""

from __future__ import annotations

import contextvars
import random
from typing import Any, Dict, Optional

# Holds the active Span (sampled) or the NOOP sentinel (an unsampled root
# was opened: descendants must not re-roll sampling or they'd emit orphan
# partial traces). None = no tracing decision made yet at this point.
_current: contextvars.ContextVar = contextvars.ContextVar(
    "rstpu_active_span", default=None
)

TRACE_KEY = "trace"  # reserved top-level key in the RPC message header


def new_id() -> str:
    """64-bit random hex id. random.getrandbits is atomic under the GIL
    and ~10x cheaper than os.urandom — these ids are correlation keys,
    not secrets."""
    return f"{random.getrandbits(64):016x}"


def current_span():
    """The active span object, or None. The unsampled sentinel is
    returned as-is (callers check ``.sampled``)."""
    return _current.get()


def wire_context() -> Optional[Dict[str, Any]]:
    """The active SAMPLED context as a wire/header dict, else None.
    This is the injection half of cross-process (and cross-executor)
    propagation."""
    span = _current.get()
    if span is None or not span.sampled:
        return None
    return span.to_wire()


def valid_wire_context(ctx: Any) -> bool:
    """Defensive validation of a peer-supplied trace header: ids must be
    short alphanumeric strings — they end up verbatim in /traces JSON,
    the /traces.txt waterfall, rpcgrep lines, and the bench's
    marker-delimited trace block, so control characters/newlines would
    let a peer forge output lines in all of those sinks."""
    if not isinstance(ctx, dict) or ctx.get("sampled") is not True:
        return False
    tid, sid = ctx.get("trace_id"), ctx.get("span_id")
    return (
        isinstance(tid, str) and isinstance(sid, str)
        and 0 < len(tid) <= 64 and 0 < len(sid) <= 64
        and tid.isalnum() and sid.isalnum()
    )

"""Spans + the ``start_span`` context manager (the only tracing API most
code touches).
(The port's copy of ``rocksplicator_tpu/observability/span.py``.)

Design constraints (the read path targets ~10M Get()/s; the
reference made even *stats* optional there):

- the **unsampled** path must be near-free: one contextvar read, one
  ``random.random()`` roll (roots only), one contextvar set/reset. No
  Span object, no dict copies, no collector traffic.
- spans inside an unsampled trace short-circuit on the NOOP sentinel
  without touching the contextvar at all.
- all cost that exists only for sampled spans (id generation, wall-clock
  read, annotation dict, collector record) is paid at ~sample_rate.

Usage::

    with start_span("repl.write", db=name) as sp:
        ...
        sp.annotate(seq=seq)

``always=True`` marks control-plane operations (backup, restore, manual
compaction) that are rare enough to trace unconditionally. ``remote=ctx``
reattaches a wire/executor context captured via
:func:`~.context.wire_context` — the server-side restore half.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

from .context import _current, new_id, valid_wire_context


class Span:
    """One finished-or-running span. Mutable annotations; immutable ids."""

    __slots__ = (
        "trace_id", "span_id", "parent_id", "name",
        "start_ms", "_t0", "duration_ms", "annotations", "error",
    )

    sampled = True

    def __init__(
        self,
        name: str,
        trace_id: str,
        parent_id: Optional[str],
        annotations: Optional[Dict[str, Any]] = None,
    ):
        self.name = name
        self.trace_id = trace_id
        self.span_id = new_id()
        self.parent_id = parent_id
        self.start_ms = time.time() * 1000.0
        self._t0 = time.perf_counter()
        self.duration_ms: Optional[float] = None
        self.annotations = annotations or {}
        self.error: Optional[str] = None

    def annotate(self, **kv: Any) -> None:
        self.annotations.update(kv)

    def to_wire(self) -> Dict[str, Any]:
        """This span as a wire/header context dict — the ONE place the
        wire shape is built (context.wire_context and every injection
        site use it, so shape changes cannot drift per-site)."""
        return {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "sampled": True,
        }

    def finish(self) -> None:
        if self.duration_ms is None:
            self.duration_ms = (time.perf_counter() - self._t0) * 1000.0

    def to_dict(self, process: str) -> Dict[str, Any]:
        return {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "process": process,
            "start_ms": round(self.start_ms, 3),
            "duration_ms": round(self.duration_ms or 0.0, 3),
            "annotations": self.annotations,
            "error": self.error,
        }


class _NoopSpan:
    """Sentinel for 'tracing decided OFF for this subtree'. All methods
    are no-ops; shared singleton, never recorded."""

    __slots__ = ()
    sampled = False
    trace_id = ""
    span_id = ""

    def annotate(self, **kv: Any) -> None:
        pass


NOOP_SPAN = _NoopSpan()


class _TailRoot:
    """A head-UNSAMPLED root under tail-keep: the deferred
    sampling decision. Cheap enough for every root op — one small
    object, one wall-clock read, one perf_counter read; ``sampled`` is
    False so descendants still take the NOOP fast path (a kept tail
    trace is root-only by design — the decision can't be made until the
    duration is known, by which time the children are gone). On exit,
    a root slower than the collector's ``tail_ms`` is retained in the
    tail ring: the 1023/1024 head-unsampled p99 outlier becomes
    inspectable on /traces instead of invisible."""

    __slots__ = ("name", "t0", "tail_ms", "annotations")
    sampled = False
    trace_id = ""
    span_id = ""

    def __init__(self, name: str, tail_ms: float,
                 annotations: Optional[Dict[str, Any]]):
        self.name = name
        self.t0 = time.perf_counter()
        # threshold cached here so the (common) fast exit never touches
        # the collector singleton; wall-clock start is reconstructed at
        # keep time (start = now - duration) — one fewer syscall per
        # unsampled root
        self.tail_ms = tail_ms
        self.annotations = annotations or {}

    def annotate(self, **kv: Any) -> None:
        self.annotations.update(kv)


class start_span:
    """Context manager creating a span under the active one (or a new
    sampled/unsampled root). See module docstring for the fast-path
    contract."""

    __slots__ = ("_name", "_always", "_remote", "_ann", "_span", "_token")

    def __init__(self, name: str, always: bool = False,
                 remote: Optional[dict] = None, **annotations: Any):
        self._name = name
        self._always = always
        self._remote = remote
        self._ann = annotations
        self._span = NOOP_SPAN
        self._token = None

    def __enter__(self):
        remote = self._remote
        if remote is not None and valid_wire_context(remote) and _enabled():
            # (_enabled(): the RSTPU_TRACING=0 kill switch must silence
            # remotely-initiated spans too, or a disabled node would keep
            # recording and re-propagating peers' trace contexts)
            # An explicit remote context wins over any local parent: the
            # caller is continuing a trace that crossed a process (RPC
            # header) or executor boundary — e.g. a follower's apply span
            # joins the LEADER's write trace even while a local pull span
            # is active (replicated_db._apply_updates).
            span = Span(self._name, remote["trace_id"],
                        remote["span_id"], self._ann)
        else:
            parent = _current.get()
            if parent is not None:
                if not parent.sampled:
                    # inside an unsampled trace: nothing to set or reset
                    return NOOP_SPAN
                span = Span(self._name, parent.trace_id, parent.span_id,
                            self._ann)
            else:
                from .collector import SpanCollector

                col = SpanCollector.get()
                if (self._always and col.enabled) or col.sample():
                    span = Span(self._name, new_id(), None, self._ann)
                elif col.enabled and col.tail_ms > 0.0:
                    # head-unsampled ROOT under tail-keep: defer the
                    # decision to __exit__ (duration known). sampled is
                    # False, so descendants still take the NOOP branch.
                    root = _TailRoot(self._name, col.tail_ms, self._ann)
                    self._span = root
                    self._token = _current.set(root)
                    return root
                else:
                    # unsampled ROOT: park the sentinel so descendants
                    # take the cheap branch above instead of re-rolling
                    # sampling
                    self._token = _current.set(NOOP_SPAN)
                    return NOOP_SPAN
        self._span = span
        self._token = _current.set(span)
        return span

    def __exit__(self, exc_type, exc, tb):
        if self._token is not None:
            _current.reset(self._token)
        span = self._span
        if span is NOOP_SPAN:
            return False
        if type(span) is _TailRoot:
            duration_ms = (time.perf_counter() - span.t0) * 1000.0
            # tail_exempt: the operation declared its slowness is BY
            # DESIGN (a parked long-poll serve, a long-poll pull RTT) —
            # keeping those would fill the tail ring with waits and
            # evict the genuine outliers the ring exists for
            if duration_ms >= span.tail_ms \
                    and "tail_exempt" not in span.annotations:
                from .collector import SpanCollector

                col = SpanCollector.get()
                if col.enabled:
                    col.record_tail(
                        span, duration_ms,
                        error=repr(exc) if exc_type is not None else None)
            return False
        if exc_type is not None and span.error is None:
            span.error = repr(exc)
        span.finish()
        from .collector import SpanCollector

        SpanCollector.get().record(span)
        return False


def detached_span(name: str, parent, **annotations: Any):
    """A child span that outlives the creating stack frame — for
    operations whose completion lands on another thread (an ack-window
    waiter resolved by the loop's expiry timer or a follower ack), where
    ``with start_span(...)`` cannot scope the lifetime.

    Returns ``None`` when the parent is unsampled (callers keep the
    usual near-free unsampled path). The CALLER OWNS COMPLETION: every
    resolution path must call ``.finish()`` and hand the span to
    ``SpanCollector.get().record(...)`` — keep exactly one resolution
    funnel, as AckWindow does. This is the only sanctioned way to build
    a Span outside observability/ (rstpu-check span-manual)."""
    if parent is None or not parent.sampled:
        return None
    return Span(name, parent.trace_id, parent.span_id, dict(annotations))


def _enabled() -> bool:
    from .collector import SpanCollector

    return SpanCollector.get().enabled

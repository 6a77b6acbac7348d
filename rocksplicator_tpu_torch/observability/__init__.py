"""Distributed tracing subsystem (spans, propagation, collection, export)
— the port's own copy of ``rocksplicator_tpu/observability``: the same
span names, annotations, sampling knobs and trace shape, in a second
process-wide collector.

One trace follows one request across the rpc → replication → storage
layers (and across processes via the RPC frame header); the per-process
:class:`SpanCollector` ring retains recent sampled spans for the status
server's ``/traces`` (JSON) and ``/traces.txt`` (waterfall) endpoints.

The instrument the perf PRs cite: per-phase attribution of the semi-sync
write (leader receive → WAL fsync → follower ACK), the backup/restore
round trip (checkpoint → upload batches → download), and compaction
(plan → merge → install).
"""

from .collector import SpanCollector, render_trace
from .context import TRACE_KEY, current_span, wire_context
from .span import NOOP_SPAN, Span, start_span

__all__ = [
    "NOOP_SPAN",
    "Span",
    "SpanCollector",
    "TRACE_KEY",
    "current_span",
    "render_trace",
    "start_span",
    "wire_context",
]

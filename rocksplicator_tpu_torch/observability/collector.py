"""SpanCollector: per-process ring buffer of finished spans + exporters.
(The port's copy of ``rocksplicator_tpu/observability/collector.py``.)

Reference points: RESYSTANCE / "Characterize LSM-tree Compaction
Performance" (PAPERS.md) argue per-phase timing — not aggregate counters —
is what exposes hidden stalls; this is the in-process, sample-gated
equivalent for this stack.

Write path ("lock-free-ish"): finished spans land in a fixed-size ring via
``next(itertools.count())`` (atomic under the GIL) + a slot store — no
lock, no allocation beyond the span's export dict. Memory is bounded by
``capacity``; once the ring wraps, the oldest spans are overwritten and
counted in ``dropped`` (the read side reports it, so a truncated window
is never mistaken for complete coverage).

Head sampling: the sampling decision is made once at the trace ROOT
(``sample()``, default ~1/1024) and inherited by every descendant,
including across process hops (the wire context carries ``sampled``).
``sample_rate=0`` disables tracing; the instrumented hot paths then cost
one contextvar read + one roll per would-be root.

Read path (cold): ``traces()`` groups the ring by trace id,
``to_json_text()`` feeds the status server's ``/traces`` endpoint and
``waterfall_text()`` renders the human ``/traces.txt`` view.
"""

from __future__ import annotations

import itertools
import json
import os
import random
import threading
from typing import Any, Dict, List, Optional

DEFAULT_CAPACITY = 4096
DEFAULT_SAMPLE_RATE = 1.0 / 1024.0
# Tail-keep: a head-UNSAMPLED root whose duration exceeds
# this is retained anyway — the deferred-decision buffer that makes the
# macro-bench's knee-point p99 outliers inspectable instead of
# 1023/1024 invisible. 0 disables; RSTPU_TRACING=0 still kills all.
DEFAULT_TAIL_MS = 100.0
DEFAULT_TAIL_CAPACITY = 256


class SpanCollector:
    _instance: Optional["SpanCollector"] = None
    _instance_lock = threading.Lock()

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 sample_rate: float = DEFAULT_SAMPLE_RATE):
        self._capacity = max(1, int(capacity))
        self._ring: List[Optional[dict]] = [None] * self._capacity
        self._seq = itertools.count()
        self._recorded = 0  # highest seq observed + 1 (approximate is fine)
        env_rate = os.environ.get("RSTPU_TRACE_SAMPLE_RATE")
        if env_rate is not None:
            # the singleton is constructed lazily inside the first traced
            # hot-path op: a malformed env value must degrade to the
            # default, never raise out of an application write/RPC
            try:
                sample_rate = float(env_rate)
            except ValueError:
                pass
        self.sample_rate = float(sample_rate)
        # tail-keep threshold: env-tunable, malformed values degrade to
        # the default (same stance as the sample-rate env above)
        tail_ms = DEFAULT_TAIL_MS
        env_tail = os.environ.get("RSTPU_TRACE_TAIL_MS")
        if env_tail is not None:
            try:
                tail_ms = float(env_tail)
            except ValueError:
                pass
        self.tail_ms = tail_ms
        # separate small ring for tail-kept roots so head-sampled
        # traffic can never evict the rare slow outlier — the whole
        # point of keeping it
        self._tail_ring: List[Optional[dict]] = [None] * DEFAULT_TAIL_CAPACITY
        self._tail_seq = itertools.count()
        self._tail_recorded = 0
        # global kill switch: RSTPU_TRACING=0 disables EVERYTHING,
        # including always=True control-plane spans — the ops escape
        # hatch when any tracing overhead at all is unwanted
        self.enabled = os.environ.get("RSTPU_TRACING", "1") != "0"
        # joined into every exported span so cross-process traces remain
        # attributable after stitching; services may relabel (e.g.
        # "leader:9091") via configure()
        self.process = f"pid:{os.getpid()}"

    # -- singleton --------------------------------------------------------

    @classmethod
    def get(cls) -> "SpanCollector":
        inst = cls._instance
        if inst is None:
            with cls._instance_lock:
                if cls._instance is None:
                    cls._instance = cls()
                inst = cls._instance
        return inst

    @classmethod
    def reset_for_test(cls) -> None:
        with cls._instance_lock:
            cls._instance = cls()

    # -- config -----------------------------------------------------------

    def configure(self, sample_rate: Optional[float] = None,
                  capacity: Optional[int] = None,
                  process: Optional[str] = None,
                  tail_ms: Optional[float] = None) -> None:
        if sample_rate is not None:
            self.sample_rate = float(sample_rate)
        if tail_ms is not None:
            self.tail_ms = float(tail_ms)
        if process is not None:
            self.process = process
        if capacity is not None and int(capacity) != self._capacity:
            self._capacity = max(1, int(capacity))
            self._ring = [None] * self._capacity
            self._seq = itertools.count()
            self._recorded = 0

    # -- hot write path ---------------------------------------------------

    def sample(self) -> bool:
        rate = self.sample_rate
        return self.enabled and rate > 0.0 and random.random() < rate

    def record(self, span) -> None:
        """Called once per finished SAMPLED span (span.py __exit__)."""
        d = span.to_dict(self.process)
        i = next(self._seq)
        ring = self._ring
        ring[i % len(ring)] = d
        self._recorded = i + 1

    def record_tail(self, root, duration_ms: float,
                    error: Optional[str] = None) -> None:
        """Keep a head-unsampled root that crossed the tail threshold
        (span.py ``_TailRoot`` exit). Ids are minted HERE — only kept
        tails pay for id generation. The span dict carries a
        ``tail_kept`` annotation so /traces readers can tell a deferred
        keep (root-only by construction) from a head-sampled trace."""
        import time

        from .context import new_id

        d = {
            "trace_id": new_id(),
            "span_id": new_id(),
            "parent_id": None,
            "name": root.name,
            "process": self.process,
            # wall-clock start reconstructed at keep time — the fast
            # (discarded) path never pays the time.time() syscall
            "start_ms": round(time.time() * 1000.0 - duration_ms, 3),
            "duration_ms": round(duration_ms, 3),
            "annotations": {**root.annotations, "tail_kept": True},
            "error": error,
        }
        i = next(self._tail_seq)
        ring = self._tail_ring
        ring[i % len(ring)] = d
        self._tail_recorded = i + 1
        try:
            from ..utils.stats import Stats

            Stats.get().incr("trace.tail_kept")
        except Exception:  # pragma: no cover - defensive
            pass

    # -- cold read path ---------------------------------------------------

    @property
    def recorded(self) -> int:
        return self._recorded

    @property
    def dropped(self) -> int:
        """Spans overwritten before they could be read (ring evictions)."""
        return max(0, self._recorded - self._capacity)

    @property
    def tail_kept(self) -> int:
        """Head-unsampled roots retained by the tail path."""
        return self._tail_recorded

    @property
    def tail_dropped(self) -> int:
        return max(0, self._tail_recorded - len(self._tail_ring))

    def snapshot(self) -> List[dict]:
        """All retained spans — head-sampled AND tail-kept — oldest
        first (by wall-clock start)."""
        spans = [d for d in list(self._ring) if d is not None]
        spans.extend(d for d in list(self._tail_ring) if d is not None)
        spans.sort(key=lambda d: d["start_ms"])
        return spans

    def traces(self, trace_id: Optional[str] = None,
               limit: int = 64) -> List[Dict[str, Any]]:
        """Retained spans grouped per trace, newest trace first. Each
        entry: {trace_id, start_ms, duration_ms, span_count, spans}."""
        by_trace: Dict[str, List[dict]] = {}
        for d in self.snapshot():
            by_trace.setdefault(d["trace_id"], []).append(d)
        out = []
        for tid, spans in by_trace.items():
            if trace_id is not None and tid != trace_id:
                continue
            start = min(s["start_ms"] for s in spans)
            end = max(s["start_ms"] + s["duration_ms"] for s in spans)
            out.append({
                "trace_id": tid,
                "start_ms": start,
                "duration_ms": round(end - start, 3),
                "span_count": len(spans),
                "spans": spans,
            })
        out.sort(key=lambda t: t["start_ms"], reverse=True)
        return out[:limit]

    def slowest_trace(self, root_name: str) -> Optional[Dict[str, Any]]:
        """The retained trace whose ROOT span (a span whose parent is not
        in the trace) named ``root_name`` has the largest duration — the
        bench's slowest-shard attribution hook. Returns
        ``{"root": span_dict, "trace": trace_dict}`` or None."""
        best = None
        for tr in self.traces(limit=self._capacity):
            ids = {s["span_id"] for s in tr["spans"]}
            for s in tr["spans"]:
                if s["name"] != root_name or s["parent_id"] in ids:
                    continue
                if best is None or s["duration_ms"] > best["root"]["duration_ms"]:
                    best = {"root": s, "trace": tr}
        return best

    def phase_totals(self, prefix: str) -> Dict[str, Dict[str, float]]:
        """Aggregate retained span durations by name, for names starting
        with ``prefix``: {name: {count, total_ms, max_ms}}. Feeds the
        bench's per-phase JSON breakdown."""
        out: Dict[str, Dict[str, float]] = {}
        for d in self.snapshot():
            name = d["name"]
            if not name.startswith(prefix):
                continue
            agg = out.setdefault(
                name, {"count": 0, "total_ms": 0.0, "max_ms": 0.0})
            agg["count"] += 1
            agg["total_ms"] = round(agg["total_ms"] + d["duration_ms"], 3)
            agg["max_ms"] = max(agg["max_ms"], d["duration_ms"])
        return out

    def to_json_text(self, limit: int = 64) -> str:
        """The ``/traces`` status-server endpoint body."""
        return json.dumps({
            "process": self.process,
            "sample_rate": self.sample_rate,
            "capacity": self._capacity,
            "recorded": self.recorded,
            "dropped": self.dropped,
            "tail_ms": self.tail_ms,
            "tail_kept": self.tail_kept,
            "tail_dropped": self.tail_dropped,
            "traces": self.traces(limit=limit),
        }, indent=1, default=str)

    def waterfall_text(self, trace_id: Optional[str] = None,
                       limit: int = 16) -> str:
        """Human-readable per-trace waterfall (``/traces.txt``)."""
        lines: List[str] = [
            f"# spans recorded={self.recorded} dropped={self.dropped} "
            f"sample_rate={self.sample_rate:g} "
            f"tail_kept={self.tail_kept} tail_ms={self.tail_ms:g} "
            f"process={self.process}",
        ]
        for tr in self.traces(trace_id=trace_id, limit=limit):
            lines.append("")
            lines.append(
                f"trace {tr['trace_id']}  spans={tr['span_count']}  "
                f"total={tr['duration_ms']:.3f} ms"
            )
            lines.extend(render_trace(tr["spans"], tr["start_ms"]))
        return "\n".join(lines) + "\n"


def render_trace(spans: List[dict], t0_ms: Optional[float] = None
                 ) -> List[str]:
    """Indented waterfall lines for one trace's span dicts. Spans whose
    parent is missing from the set (e.g. evicted, or living in another
    process's collector) render as roots — a stitched multi-process trace
    passes the union of every process's spans here."""
    if not spans:
        return []
    if t0_ms is None:
        t0_ms = min(s["start_ms"] for s in spans)
    ids = {s["span_id"] for s in spans}
    children: Dict[Optional[str], List[dict]] = {}
    for s in spans:
        parent = s["parent_id"] if s["parent_id"] in ids else None
        children.setdefault(parent, []).append(s)
    for sibs in children.values():
        sibs.sort(key=lambda s: s["start_ms"])
    lines: List[str] = []

    def walk(span: dict, depth: int) -> None:
        off = span["start_ms"] - t0_ms
        ann = " ".join(
            f"{k}={v}" for k, v in sorted(span["annotations"].items()))
        err = f" ERROR={span['error']}" if span.get("error") else ""
        name = "  " * depth + span["name"]
        lines.append(
            f"  {name:<40} +{off:9.3f} ms  {span['duration_ms']:9.3f} ms"
            f"  [{span['process']}]{(' ' + ann) if ann else ''}{err}"
        )
        for c in children.get(span["span_id"], []):
            walk(c, depth + 1)

    for root in children.get(None, []):
        walk(root, 0)
    return lines

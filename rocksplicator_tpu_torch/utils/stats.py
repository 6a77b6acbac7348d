"""Stats: counters, metrics (latency histograms), and gauges — the
port's own copy of ``rocksplicator_tpu/utils/stats.py`` (same names, same
text formats), so the port counts without importing the JAX package.

Reference: common/stats/stats.{h,cpp}:89-241 — thread-local lock-free
counters/metrics flushed ~1s into global folly MultiLevelTimeSeries /
TimeseriesHistogram with 1-minute windows; dynamic string names plus
pre-registered enum names; pull-model gauges; text dump for the status
server; tag-style names like ``metric segment=x db=y``
(application_db_manager.cpp:120-125).

Design notes: the structure is the same (thread-local write path,
windowed global aggregation, pull-model text export), but implemented with
per-thread buffers drained on read rather than a background flusher thread —
Python threads are cheap to enumerate and the read path is cold.
"""

from __future__ import annotations

import bisect
import math
import threading
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

# ---------------------------------------------------------------------------
# Windowed aggregation
# ---------------------------------------------------------------------------

_WINDOW_SEC = 60          # one-minute windows, like the reference
_NUM_WINDOWS = 60         # keep an hour of per-minute buckets


class _TimeSeries:
    """Multi-level-ish time series: per-minute buckets + all-time total."""

    __slots__ = ("buckets", "total")

    def __init__(self) -> None:
        self.buckets: Dict[int, float] = {}
        self.total = 0.0

    def add(self, value: float, now: float) -> None:
        b = int(now // _WINDOW_SEC)
        self.buckets[b] = self.buckets.get(b, 0.0) + value
        self.total += value
        if len(self.buckets) > _NUM_WINDOWS + 2:
            cutoff = b - _NUM_WINDOWS
            for k in [k for k in self.buckets if k < cutoff]:
                del self.buckets[k]

    def rate_last_minute(self, now: float) -> float:
        # Sliding-window estimate: current partial bucket plus the previous
        # bucket weighted by its unexpired fraction (avoids the up-to-2x
        # over-read of naively summing both buckets).
        b = int(now // _WINDOW_SEC)
        frac_elapsed = (now - b * _WINDOW_SEC) / _WINDOW_SEC
        return self.buckets.get(b, 0.0) + self.buckets.get(b - 1, 0.0) * (
            1.0 - frac_elapsed
        )


class _Histogram:
    """Windowed histogram with percentile queries (log-spaced buckets).

    Besides the ~2-window view the percentile reads use, an ALL-TIME
    sparse bucket map (``totals``) accumulates forever: it is what the
    Prometheus ``/metrics`` export renders (native histograms must be
    monotone counters) and what the spectator's cross-replica merge
    sums — a log-bucket merge is lossless by construction (same bucket
    edges everywhere, merge = vector add)."""

    __slots__ = ("windows", "count", "sum", "totals")

    # log-spaced buckets, 8 per octave (~9% relative resolution), covering
    # 2^-4 (0.0625) .. 2^40 (~1e12) — enough for sub-ms latencies through
    # byte counts.
    _SUB = 8
    _MIN_EXP = -4 * 8
    _MAX_EXP = 40 * 8

    def __init__(self) -> None:
        self.windows: Dict[int, List[int]] = {}
        self.count = 0
        self.sum = 0.0
        self.totals: Dict[int, int] = {}

    @classmethod
    def _bucket_of(cls, value: float) -> int:
        if value <= 0:
            return 0
        e = int(math.floor(math.log2(value) * cls._SUB))
        return max(cls._MIN_EXP, min(cls._MAX_EXP, e)) - cls._MIN_EXP

    @classmethod
    def _bucket_value(cls, idx: int) -> float:
        # Upper edge of the bucket — conservative for percentile reads.
        return 2.0 ** ((idx + cls._MIN_EXP + 1) / cls._SUB)

    def add(self, value: float, now: float) -> None:
        w = int(now // _WINDOW_SEC)
        buckets = self.windows.get(w)
        if buckets is None:
            buckets = [0] * (self._MAX_EXP - self._MIN_EXP + 1)
            self.windows[w] = buckets
            if len(self.windows) > 3:
                cutoff = w - 2
                for k in [k for k in self.windows if k < cutoff]:
                    del self.windows[k]
        b = self._bucket_of(value)
        buckets[b] += 1
        self.totals[b] = self.totals.get(b, 0) + 1
        self.count += 1
        self.sum += value

    def percentile(self, pct: float, now: Optional[float] = None) -> float:
        """Percentile over the last ~2 windows."""
        now = time.time() if now is None else now
        w = int(now // _WINDOW_SEC)
        merged = [0] * (self._MAX_EXP - self._MIN_EXP + 1)
        for k in (w, w - 1):
            b = self.windows.get(k)
            if b:
                for i, c in enumerate(b):
                    merged[i] += c
        total = sum(merged)
        if total == 0:
            return 0.0
        target = total * pct / 100.0
        acc = 0
        for i, c in enumerate(merged):
            acc += c
            if acc >= target:
                return self._bucket_value(i)
        return self._bucket_value(len(merged) - 1)

    def avg(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def state(self) -> Dict:
        """Serializable all-time state: the scrape-RPC / merge shape.
        Bucket keys are stringified indices (JSON object keys)."""
        return {
            "count": self.count,
            "sum": self.sum,
            "buckets": {str(i): c for i, c in sorted(self.totals.items())},
        }


def merge_histogram_states(states: List[Dict]) -> Dict:
    """EXACT merge of histogram states (``_Histogram.state()`` shape):
    every replica buckets with the same log-spaced edges, so the merge
    is a plain per-bucket sum — no resampling, no approximation beyond
    the original per-replica bucketing."""
    buckets: Dict[int, int] = {}
    count = 0
    total = 0.0
    for st in states:
        if not st:
            continue
        count += int(st.get("count", 0))
        total += float(st.get("sum", 0.0))
        for k, c in (st.get("buckets") or {}).items():
            i = int(k)
            buckets[i] = buckets.get(i, 0) + int(c)
    return {
        "count": count,
        "sum": total,
        "buckets": {str(i): c for i, c in sorted(buckets.items())},
    }


def histogram_state_percentile(state: Dict, pct: float) -> float:
    """Percentile over a (possibly merged) histogram state. Same
    conservative upper-edge convention as ``_Histogram.percentile``."""
    buckets = [(int(k), int(c)) for k, c in (state.get("buckets") or {}).items()]
    buckets.sort()
    total = sum(c for _i, c in buckets)
    if total == 0:
        return 0.0
    target = total * pct / 100.0
    acc = 0
    for i, c in buckets:
        acc += c
        if acc >= target:
            return _Histogram._bucket_value(i)
    return _Histogram._bucket_value(buckets[-1][0])


# ---------------------------------------------------------------------------
# Thread-local write path
# ---------------------------------------------------------------------------


class _ThreadBuffer(threading.local):
    def __init__(self) -> None:
        self.counters: Dict[str, float] = defaultdict(float)
        self.metrics: Dict[str, List[float]] = defaultdict(list)
        # Guards this thread's buffers against a concurrent flush() drain.
        # Mostly uncontended (owner thread vs the occasional drainer).
        self.lock = threading.Lock()


class Stats:
    """Process-wide stats registry.

    API mirrors the reference (stats.h:89-241): ``incr`` (Incr),
    ``add_metric`` (AddMetric), gauges with pull callbacks, and
    ``dump_text`` for the status server.
    """

    _instance: Optional["Stats"] = None
    _instance_lock = threading.Lock()

    def __init__(self) -> None:
        import os
        import uuid

        self._lock = threading.Lock()
        # process-INSTANCE identity for scrape exports: pid alone is not
        # unique across hosts/containers (every containerized replica is
        # commonly pid 1), so a random token minted per registry makes
        # the aggregator's shared-registry dedup safe fleet-wide —
        # endpoints sharing one registry share the token; distinct
        # processes never do
        self._export_id = f"pid:{os.getpid()}:{uuid.uuid4().hex[:12]}"
        self._counters: Dict[str, _TimeSeries] = {}
        self._metrics: Dict[str, _Histogram] = {}
        self._gauges: Dict[str, Callable[[], float]] = {}
        self._tls = _ThreadBuffer()
        self._all_buffers: List[_ThreadBuffer] = []
        self._buffers_lock = threading.Lock()
        self._flush_interval = 1.0
        self._last_flush = 0.0
        # whole-process scrape-dump cache: at fleet shape a
        # scrape walks every registered series and evaluates every
        # shard's gauges — O(shards) per scrape per SCRAPER. One cached
        # pass with a short TTL makes concurrent/periodic scrapers
        # (spectator, /metrics pollers, stats RPC) share it.
        self._dump_ttl = 0.5
        self._dump_lock = threading.Lock()
        self._export_cache: Tuple[float, Optional[Dict]] = (0.0, None)
        self._prom_cache: Tuple[float, Optional[str]] = (0.0, None)

    # -- singleton --------------------------------------------------------

    @classmethod
    def get(cls) -> "Stats":
        if cls._instance is None:
            with cls._instance_lock:
                if cls._instance is None:
                    cls._instance = cls()
        return cls._instance

    @classmethod
    def reset_for_test(cls) -> None:
        with cls._instance_lock:
            cls._instance = cls()

    # -- write path (hot; thread-local, no lock) --------------------------

    def incr(self, name: str, value: float = 1.0) -> None:
        buf = self._buf()
        with buf.lock:
            buf.counters[name] += value
        self._maybe_flush()

    def add_metric(self, name: str, value: float) -> None:
        buf = self._buf()
        with buf.lock:
            buf.metrics[name].append(value)
        self._maybe_flush()

    def add_gauge(self, name: str, callback: Callable[[], float]) -> None:
        with self._lock:
            self._gauges[name] = callback

    def remove_gauge(self, name: str) -> None:
        with self._lock:
            self._gauges.pop(name, None)

    # -- internals --------------------------------------------------------

    def _buf(self) -> _ThreadBuffer:
        buf = self._tls
        if not getattr(buf, "_registered", False):
            with self._buffers_lock:
                self._all_buffers.append(
                    _Snapshot(buf.counters, buf.metrics, buf.lock,
                              threading.current_thread())
                )
            buf._registered = True  # type: ignore[attr-defined]
        return buf

    def _maybe_flush(self) -> None:
        now = time.time()
        if now - self._last_flush >= self._flush_interval:
            self.flush(now)

    def flush(self, now: Optional[float] = None) -> None:
        """Drain every thread's buffer into the global windowed stores."""
        now = time.time() if now is None else now
        self._last_flush = now
        with self._buffers_lock:
            snaps = list(self._all_buffers)
        dead: List[_Snapshot] = []
        with self._lock:
            for snap in snaps:
                with snap.lock:
                    counters = list(snap.counters.items())
                    snap.counters.clear()
                    metrics = list(snap.metrics.items())
                    snap.metrics.clear()
                    if not snap.owner.is_alive():
                        dead.append(snap)
                for name, v in counters:
                    ts = self._counters.get(name)
                    if ts is None:
                        ts = self._counters[name] = _TimeSeries()
                    ts.add(v, now)
                for name, vals in metrics:
                    h = self._metrics.get(name)
                    if h is None:
                        h = self._metrics[name] = _Histogram()
                    for v in vals:
                        h.add(v, now)
        if dead:
            # Prune drained buffers of exited threads so _all_buffers does
            # not grow with every short-lived worker thread.
            with self._buffers_lock:
                self._all_buffers = [
                    s for s in self._all_buffers if s not in dead
                ]

    # -- read path --------------------------------------------------------

    def get_counter(self, name: str) -> float:
        self.flush()
        with self._lock:
            ts = self._counters.get(name)
            return ts.total if ts else 0.0

    def counter_rate(self, name: str) -> float:
        self.flush()
        now = time.time()
        with self._lock:
            ts = self._counters.get(name)
            return ts.rate_last_minute(now) if ts else 0.0

    def metric_percentile(self, name: str, pct: float) -> float:
        self.flush()
        with self._lock:
            h = self._metrics.get(name)
            return h.percentile(pct) if h else 0.0

    def metric_avg(self, name: str) -> float:
        self.flush()
        with self._lock:
            h = self._metrics.get(name)
            return h.avg() if h else 0.0

    def metric_count(self, name: str) -> int:
        self.flush()
        with self._lock:
            h = self._metrics.get(name)
            return h.count if h else 0

    def dump_text(self) -> str:
        """stats.txt-style dump (status_server.cpp /stats.txt endpoint)."""
        self.flush()
        now = time.time()
        lines: List[str] = []
        with self._lock:
            for name in sorted(self._counters):
                ts = self._counters[name]
                lines.append(
                    f"counter {name} total={ts.total:.0f} "
                    f"last_minute={ts.rate_last_minute(now):.0f}"
                )
            for name in sorted(self._metrics):
                h = self._metrics[name]
                lines.append(
                    f"metric {name} count={h.count} avg={h.avg():.3f} "
                    f"p50={h.percentile(50, now):.3f} "
                    f"p90={h.percentile(90, now):.3f} "
                    f"p99={h.percentile(99, now):.3f}"
                )
            gauges = list(self._gauges.items())
        for name, cb in sorted(gauges):
            try:
                lines.append(f"gauge {name} value={cb():.3f}")
            except Exception as e:  # pragma: no cover - defensive
                lines.append(f"gauge {name} error={e!r}")
        return "\n".join(lines) + "\n"

    def gauge_values(
        self, prefixes: Optional[Tuple[str, ...]] = None
    ) -> Dict[str, float]:
        """Evaluate registered gauges (optionally filtered by base-name
        prefix). Callbacks run OUTSIDE the stats lock — a gauge is free
        to take its own subsystem's locks (the engine snapshot does)."""
        with self._lock:
            gauges = list(self._gauges.items())
        out: Dict[str, float] = {}
        for name, cb in gauges:
            if prefixes is not None and not name.startswith(prefixes):
                continue
            try:
                out[name] = float(cb())
            except Exception:  # pragma: no cover - defensive
                continue
        return out

    def export_state(self) -> Dict:
        """The scrape-RPC body: every counter (all-time total + 1-minute
        rate), every histogram's exact all-time state, every gauge's
        current value — JSON-serializable, mergeable across replicas by
        the spectator (``merge_histogram_states`` et al.). Carries the
        process identity: in-process multi-replicator topologies
        (chaos/cluster tests) share ONE registry, so an aggregator
        scraping two such endpoints must count the registry once, not
        twice (stats_aggregator dedupes on this field)."""
        self.flush()
        now = time.time()
        with self._lock:
            counters = {
                name: {"total": ts.total,
                       "rate_1m": ts.rate_last_minute(now)}
                for name, ts in self._counters.items()
            }
            metrics = {name: h.state() for name, h in self._metrics.items()}
        return {
            "time": now,
            "process": self._export_id,
            "counters": counters,
            "metrics": metrics,
            "gauges": self.gauge_values(),
        }

    def export_state_cached(self, max_age: Optional[float] = None) -> Dict:
        """``export_state`` behind the whole-process dump cache: one
        registry pass (and ONE gauge-callback sweep — the O(shards)
        cost) serves every scraper inside the TTL. Single-flight: a
        scraper finding the cache stale builds the dump under the dump
        lock while concurrent scrapers wait and reuse it. Callers must
        treat the dict as frozen (the stats-RPC handler copies the top
        level before annotating)."""
        ttl = self._dump_ttl if max_age is None else max_age
        at, cached = self._export_cache
        if cached is not None and time.monotonic() - at < ttl:
            return cached
        with self._dump_lock:
            at, cached = self._export_cache
            if cached is not None and time.monotonic() - at < ttl:
                return cached
            state = self.export_state()
            self._export_cache = (time.monotonic(), state)
            return state

    def dump_prometheus_cached(self, max_age: Optional[float] = None) -> str:
        """``dump_prometheus`` behind the same short-TTL cache (its own
        slot — the two dumps have different shapes but share the
        sub-linear-in-scrapers property)."""
        ttl = self._dump_ttl if max_age is None else max_age
        at, cached = self._prom_cache
        if cached is not None and time.monotonic() - at < ttl:
            return cached
        with self._dump_lock:
            at, cached = self._prom_cache
            if cached is not None and time.monotonic() - at < ttl:
                return cached
            text = self.dump_prometheus()
            self._prom_cache = (time.monotonic(), text)
            return text

    def dump_prometheus(self) -> str:
        """Prometheus text exposition of counters, gauges, and the
        log-bucketed histograms (classic ``_bucket``/``_sum``/``_count``
        lines over the ALL-TIME totals, so every series is the monotone
        counter Prometheus requires). Tagged names (``name k=v``) become
        labels; dotted names become underscore-joined metric names under
        the ``rstpu_`` namespace."""
        self.flush()
        now = time.time()
        with self._lock:
            counters = [(n, ts.total, ts.rate_last_minute(now))
                        for n, ts in self._counters.items()]
            metrics = [(n, h.state()) for n, h in self._metrics.items()]
        gauges = self.gauge_values()

        # family name -> (type, sample lines); one TYPE header per family
        families: Dict[str, Tuple[str, List[str]]] = {}

        def fam_of(base: str, ftype: str) -> List[str]:
            fam = _prom_name(base) + ("_total" if ftype == "counter" else "")
            return families.setdefault(fam, (ftype, []))[1]

        for name, total, _rate in sorted(counters):
            base, tags = split_tagged(name)
            fam_of(base, "counter").append(
                f"{_prom_name(base)}_total{_prom_labels(tags)} "
                f"{_prom_num(total)}")
        for name, value in sorted(gauges.items()):
            base, tags = split_tagged(name)
            fam_of(base, "gauge").append(
                f"{_prom_name(base)}{_prom_labels(tags)} "
                f"{_prom_num(value)}")
        for name, state in sorted(metrics):
            base, tags = split_tagged(name)
            fam = _prom_name(base)
            lines = fam_of(base, "histogram")
            acc = 0
            for k, c in sorted(
                    ((int(i), c) for i, c in state["buckets"].items())):
                acc += c
                le = _Histogram._bucket_value(k)
                lines.append(
                    f"{fam}_bucket"
                    f"{_prom_labels(tags, le=_prom_num(le))} {acc}")
            lines.append(
                f"{fam}_bucket{_prom_labels(tags, le='+Inf')} "
                f"{state['count']}")
            lines.append(
                f"{fam}_sum{_prom_labels(tags)} {_prom_num(state['sum'])}")
            lines.append(
                f"{fam}_count{_prom_labels(tags)} {state['count']}")

        out: List[str] = []
        for fam in sorted(families):
            ftype, lines = families[fam]
            out.append(f"# TYPE {fam} {ftype}")
            out.extend(lines)
        return "\n".join(out) + "\n"


class _Snapshot:
    """Holds references to a thread's buffers so flush() can drain them."""

    __slots__ = ("counters", "metrics", "lock", "owner")

    def __init__(self, counters, metrics, lock, owner):
        self.counters = counters
        self.metrics = metrics
        self.lock = lock
        self.owner = owner


def tagged(name: str, **tags: str) -> str:
    """Tag-style metric naming: ``tagged("db_size", db="seg00001")`` →
    ``"db_size db=seg00001"`` (reference application_db_manager.cpp:120-125)."""
    if not tags:
        return name
    return name + " " + " ".join(f"{k}={v}" for k, v in sorted(tags.items()))


def split_tagged(name: str) -> Tuple[str, Dict[str, str]]:
    """Inverse of :func:`tagged`: ``"db_size db=seg00001"`` →
    ``("db_size", {"db": "seg00001"})``. Tokens without ``=`` after the
    base name are kept verbatim in a ``_`` tag rather than dropped."""
    parts = name.split(" ")
    tags: Dict[str, str] = {}
    for tok in parts[1:]:
        k, sep, v = tok.partition("=")
        if sep:
            tags[k] = v
        elif tok:
            tags["_"] = tok
    return parts[0], tags


def _prom_name(base: str) -> str:
    """Dotted stats name → Prometheus metric name (``rstpu_`` namespace,
    ``[a-zA-Z0-9_:]`` alphabet)."""
    safe = "".join(c if (c.isalnum() or c == "_") else "_" for c in base)
    return "rstpu_" + safe


def _prom_labels(tags: Dict[str, str], **extra: str) -> str:
    items = dict(tags)
    items.update(extra)
    if not items:
        return ""
    def esc(v: str) -> str:
        return str(v).replace("\\", "\\\\").replace('"', '\\"')
    return ("{" + ",".join(
        f'{k}="{esc(v)}"' for k, v in sorted(items.items())) + "}")


def _prom_num(v: float) -> str:
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


_PROM_LINE = None  # compiled lazily (keeps `re` off the hot import path)


def parse_prometheus_text(text: str) -> Dict[str, List[Tuple[Dict[str, str], float]]]:
    """Strict-enough parser for the Prometheus text format the export
    produces: returns ``{metric_name: [(labels, value), ...]}``. Raises
    ``ValueError`` on any line that is neither a comment nor a valid
    sample — the metrics-smoke gate."""
    import re

    global _PROM_LINE
    if _PROM_LINE is None:
        _PROM_LINE = re.compile(
            r'^([a-zA-Z_:][a-zA-Z0-9_:]*)'
            r'(?:\{((?:[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*",?)*)\})?'
            r' ([0-9eE+.\-]+|\+Inf|-Inf|NaN)$')
    out: Dict[str, List[Tuple[Dict[str, str], float]]] = {}
    for lineno, line in enumerate(text.splitlines(), 1):
        if not line.strip() or line.startswith("#"):
            continue
        m = _PROM_LINE.match(line)
        if m is None:
            raise ValueError(f"unparseable metrics line {lineno}: {line!r}")
        name, rawlabels, rawval = m.groups()
        labels: Dict[str, str] = {}
        if rawlabels:
            for part in re.findall(r'([a-zA-Z_][a-zA-Z0-9_]*)='
                                   r'"((?:[^"\\]|\\.)*)"', rawlabels):
                labels[part[0]] = part[1]
        value = float("inf") if rawval == "+Inf" else (
            float("-inf") if rawval == "-Inf" else float(rawval))
        out.setdefault(name, []).append((labels, value))
    return out

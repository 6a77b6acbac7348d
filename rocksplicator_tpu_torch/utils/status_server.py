"""HTTP status server for observability.
(The port's copy of ``rocksplicator_tpu/utils/status_server.py``.)

Reference: common/stats/status_server.{h,cpp} — libmicrohttpd server on port
9999 exposing ``/stats.txt``, ``/gflags.txt``, ``/dump_heap``,
``/rocksdb_info.txt`` via a pluggable endpoint→handler map, plus an index at
``/``. Here: stdlib ThreadingHTTPServer; ``/dump_heap`` is a
tracemalloc-based heap profile (start on first hit, report+stop on the
next), ``/threads.txt`` is a Python stack dump, and ``/rocksdb_info.txt``
maps to ``/storage_info.txt``. The tracing subsystem adds ``/traces``
(recent sampled traces as JSON, for machines and cross-process stitching)
and ``/traces.txt`` (per-trace waterfall, for humans).
"""

from __future__ import annotations

import io
import sys
import threading
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional

from .flags import FLAGS
from .stats import Stats

EndpointHandler = Callable[[], str]


class StatusServer:
    _instance: Optional["StatusServer"] = None
    _instance_lock = threading.Lock()

    def __init__(
        self,
        port: int = 9999,
        extra_endpoints: Optional[Dict[str, EndpointHandler]] = None,
        host: str = "127.0.0.1",
    ):
        # Loopback by default: the endpoints expose thread stacks, flags,
        # and live counter key names. Binding all interfaces (the
        # reference's behavior) is an explicit opt-in via host="0.0.0.0".
        self._host = host
        self._port = port
        self._endpoints: Dict[str, EndpointHandler] = {
            "/stats.txt": lambda: Stats.get().dump_text(),
            # machine-readable siblings of /stats.txt: the Prometheus
            # text exposition (counters/gauges + log-bucket histograms
            # as native histogram lines) and the raw mergeable state the
            # spectator scrape consumes
            # cached (0.5s TTL): a 100-shard node's gauge sweep runs
            # once per TTL regardless of how many scrapers poll
            "/metrics": lambda: Stats.get().dump_prometheus_cached(),
            "/stats.json": _dump_stats_json,
            "/flags.txt": FLAGS.dump_text,
            "/gflags.txt": FLAGS.dump_text,  # reference-compatible alias
            "/threads.txt": _dump_threads,
            "/dump_heap": _dump_heap,
            "/traces": _dump_traces_json,
            "/traces.txt": _dump_traces_waterfall,
        }
        if extra_endpoints:
            self._endpoints.update(extra_endpoints)
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    @classmethod
    def start_status_server(
        cls,
        port: int = 9999,
        extra_endpoints: Optional[Dict[str, EndpointHandler]] = None,
        host: str = "127.0.0.1",
    ) -> "StatusServer":
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = cls(port, extra_endpoints, host=host)
                cls._instance.start()
            return cls._instance

    @classmethod
    def reset_for_test(cls) -> None:
        with cls._instance_lock:
            if cls._instance is not None:
                cls._instance.stop()
            cls._instance = None

    def register_endpoint(self, path: str, handler: EndpointHandler) -> None:
        self._endpoints[path] = handler

    def start(self) -> None:
        endpoints = self._endpoints

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self) -> None:  # noqa: N802
                path = self.path.split("?", 1)[0]
                if path == "/":
                    body = "".join(
                        f'<a href="{p}">{p}</a><br/>\n' for p in sorted(endpoints)
                    )
                    ctype = "text/html"
                elif path in endpoints:
                    try:
                        body = endpoints[path]()
                    except Exception as e:
                        self.send_response(500)
                        self.end_headers()
                        self.wfile.write(repr(e).encode())
                        return
                    ctype = "text/plain"
                else:
                    self.send_response(404)
                    self.end_headers()
                    return
                data = body.encode("utf-8")
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def log_message(self, *args) -> None:  # silence per-request logs
                pass

        self._httpd = ThreadingHTTPServer((self._host, self._port), Handler)
        self._port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="status-server", daemon=True
        )
        self._thread.start()

    @property
    def port(self) -> int:
        return self._port

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None


def _dump_stats_json() -> str:
    import json

    return json.dumps(Stats.get().export_state(), indent=1, default=str)


def _dump_traces_json() -> str:
    """Recent sampled traces as JSON (observability/collector.py). Each
    span carries its process label, so stitching a cross-process trace is
    'fetch /traces from every node, union spans, join on trace_id'."""
    from ..observability.collector import SpanCollector

    return SpanCollector.get().to_json_text()


def _dump_traces_waterfall() -> str:
    from ..observability.collector import SpanCollector

    return SpanCollector.get().waterfall_text()


def _dump_threads() -> str:
    out = io.StringIO()
    frames = sys._current_frames()
    for t in threading.enumerate():
        out.write(f"--- thread {t.name} (daemon={t.daemon}) ---\n")
        frame = frames.get(t.ident or -1)
        if frame:
            traceback.print_stack(frame, file=out)
        out.write("\n")
    return out.getvalue()


def _dump_heap() -> str:
    """Heap profile endpoint (reference: /dump_heap via gperftools,
    status_server.cpp:125-143). tracemalloc is the Python-native profiler.
    First request starts tracing; the next request reports the top
    allocation sites and STOPS tracing, so one stray probe cannot leave
    the per-allocation overhead enabled for the process lifetime."""
    import tracemalloc

    if not tracemalloc.is_tracing():
        tracemalloc.start(16)
        return (
            "tracemalloc started (16-frame traces). "
            "Request /dump_heap again for a snapshot (tracing then stops).\n"
        )
    snap = tracemalloc.take_snapshot()
    current, peak = tracemalloc.get_traced_memory()
    tracemalloc.stop()
    stats = snap.statistics("lineno")
    out = io.StringIO()
    out.write(f"traced current={current}B peak={peak}B (tracing stopped)\n")
    out.write(f"top {min(50, len(stats))} allocation sites by size:\n")
    for s in stats[:50]:
        out.write(f"{s.size:>12}B {s.count:>8}x {s.traceback}\n")
    return out.getvalue()

"""The port's copies of the observability, failpoint and Stats leaves
(``rocksplicator_tpu_torch/{observability,testing,utils/stats.py}``)
against the JAX package's modules: each case drives the same calls through
both packages, each against its own singletons, and the results must be
equal (tolerance 0). Ids come from ``random``, seeded the same for both
runs; wall-clock fields (start times, durations) are left out of the
comparison."""

import os
import random
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import pytest

import rocksplicator_tpu.observability.collector as jax_collector
import rocksplicator_tpu.observability.context as jax_context
import rocksplicator_tpu.observability.span as jax_span
import rocksplicator_tpu.testing.failpoint_registry as jax_registry
import rocksplicator_tpu.testing.failpoints as jax_fp
import rocksplicator_tpu.utils.stats as jax_stats
import rocksplicator_tpu_torch.observability.collector as collector
import rocksplicator_tpu_torch.observability.context as context
import rocksplicator_tpu_torch.observability.span as span
import rocksplicator_tpu_torch.testing.failpoint_registry as registry
import rocksplicator_tpu_torch.testing.failpoints as fp
import rocksplicator_tpu_torch.utils.stats as stats

REPO = Path(__file__).resolve().parents[1]

PACKAGES = {
    "jax": SimpleNamespace(context=jax_context, span=jax_span,
                           collector=jax_collector, fp=jax_fp,
                           stats=jax_stats),
    "port": SimpleNamespace(context=context, span=span, collector=collector,
                            fp=fp, stats=stats),
}


def _reset(m) -> None:
    m.stats.Stats.reset_for_test()
    m.collector.SpanCollector.reset_for_test()
    m.fp.reset_for_test()


@pytest.fixture(autouse=True)
def _fresh_port_singletons():
    """tests/conftest.py resets only the JAX package's singletons: reset
    the port's (and both failpoint tables) around every test here."""
    for m in PACKAGES.values():
        _reset(m)
    yield
    for m in PACKAGES.values():
        _reset(m)


def _timeless(d: dict) -> dict:
    return {k: v for k, v in d.items()
            if k not in ("start_ms", "duration_ms")}


def _traces(m, **kw) -> list:
    return [{**_timeless(t), "spans": [_timeless(s) for s in t["spans"]]}
            for t in m.collector.SpanCollector.get().traces(**kw)]


# ---------------------------------------------------------------------------
# context
# ---------------------------------------------------------------------------


def ctx_outside_any_span(m):
    return (m.context.current_span(), m.context.wire_context(),
            m.context.TRACE_KEY)


def ctx_wire_of_active_span(m):
    with m.span.start_span("op", always=True) as sp:
        wire = m.context.wire_context()
        active = m.context.current_span() is sp
    return wire, active, m.context.valid_wire_context(wire)


def ctx_valid_wire_context(m):
    cases = [None, {}, [], {"sampled": True},
             {"trace_id": "ab12", "span_id": "cd34", "sampled": True},
             {"trace_id": "ab12", "span_id": "cd34", "sampled": False},
             {"trace_id": "ab\n12", "span_id": "cd34", "sampled": True},
             {"trace_id": "a" * 65, "span_id": "cd34", "sampled": True},
             {"trace_id": "", "span_id": "cd34", "sampled": True},
             {"trace_id": 12, "span_id": "cd34", "sampled": True}]
    return [m.context.valid_wire_context(c) for c in cases]


def ctx_new_ids(m):
    return [m.context.new_id() for _ in range(4)]


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------


def span_tree(m):
    """A root with children, annotations, an error and a nested child."""
    with m.span.start_span("root", always=True, shards=3) as root:
        with m.span.start_span("child.a", rows=10) as a:
            a.annotate(kept=7)
            with m.span.start_span("grandchild"):
                pass
        try:
            with m.span.start_span("child.b"):
                raise KeyError("boom")
        except KeyError:
            pass
        root.annotate(cpu_fallbacks=1)
    return _traces(m), m.collector.SpanCollector.get().recorded


def span_unsampled_root(m):
    col = m.collector.SpanCollector.get()
    col.configure(sample_rate=0.0, tail_ms=0.0)
    with m.span.start_span("quiet") as sp:
        inner = m.span.start_span("inner")
        with inner as child:
            kinds = (sp is m.span.NOOP_SPAN, child is m.span.NOOP_SPAN)
    return kinds, col.recorded, col.snapshot()


def span_remote_parent(m):
    remote = {"trace_id": "feed01", "span_id": "beef02", "sampled": True}
    with m.span.start_span("local", always=True):
        with m.span.start_span("joined", remote=remote, peer="x"):
            pass
    with m.span.start_span("bad", always=True,
                           remote={"trace_id": "x\n", "span_id": "y",
                                   "sampled": True}):
        pass
    return _traces(m)


def span_detached(m):
    with m.span.start_span("waiter", always=True) as parent:
        det = m.span.detached_span("ack", parent, replica=2)
    det.finish()
    m.collector.SpanCollector.get().record(det)
    none = m.span.detached_span("ack", m.span.NOOP_SPAN)
    return _traces(m), none


def span_kill_switch(m):
    col = m.collector.SpanCollector.get()
    col.enabled = False
    with m.span.start_span("always", always=True) as sp:
        pass
    return sp is m.span.NOOP_SPAN, col.recorded


def span_noop_sentinel(m):
    m.span.NOOP_SPAN.annotate(x=1)
    return (m.span.NOOP_SPAN.sampled, m.span.NOOP_SPAN.trace_id,
            m.span.NOOP_SPAN.span_id)


# ---------------------------------------------------------------------------
# the collector
# ---------------------------------------------------------------------------


def collector_ring_and_dropped(m):
    col = m.collector.SpanCollector.get()
    col.configure(capacity=4)
    for i in range(10):
        with m.span.start_span(f"op{i}", always=True, i=i):
            pass
    return (col.recorded, col.dropped, [s["name"] for s in col.snapshot()],
            _traces(m, limit=2))


def collector_tail_ring(m):
    col = m.collector.SpanCollector.get()
    col.configure(sample_rate=0.0, tail_ms=1e-6)
    for i in range(3):
        with m.span.start_span("slow", n=i):
            time.sleep(0.001)
    with m.span.start_span("exempt", tail_exempt=True):
        time.sleep(0.001)
    return (col.tail_kept, col.tail_dropped, col.recorded,
            [_timeless(s) | {"span_id": None, "trace_id": None}
             for s in col.snapshot()])


def collector_slowest_and_phases(m):
    col = m.collector.SpanCollector.get()
    for i, pause in enumerate((0.0, 0.03, 0.0)):
        with m.span.start_span("job", always=True, n=i):
            with m.span.start_span("job.step"):
                time.sleep(pause)
    slow = col.slowest_trace("job")
    totals = {k: v["count"] for k, v in col.phase_totals("job").items()}
    return slow["root"]["annotations"], slow["trace"]["span_count"], totals


def collector_render_trace(m):
    spans = [
        {"trace_id": "t", "span_id": "a", "parent_id": None, "name": "root",
         "process": "p", "start_ms": 100.0, "duration_ms": 9.5,
         "annotations": {"shards": 2}, "error": None},
        {"trace_id": "t", "span_id": "b", "parent_id": "a", "name": "kid",
         "process": "p", "start_ms": 101.25, "duration_ms": 3.0,
         "annotations": {}, "error": "KeyError('x')"},
        {"trace_id": "t", "span_id": "c", "parent_id": "gone",
         "name": "orphan", "process": "q", "start_ms": 102.0,
         "duration_ms": 1.0, "annotations": {"b": 1, "a": 2},
         "error": None},
    ]
    return m.collector.render_trace(spans), m.collector.render_trace([])


@pytest.mark.parametrize("env", [
    {},
    {"RSTPU_TRACE_SAMPLE_RATE": "0.25", "RSTPU_TRACE_TAIL_MS": "7.5"},
    {"RSTPU_TRACE_SAMPLE_RATE": "many", "RSTPU_TRACE_TAIL_MS": "x"},
    {"RSTPU_TRACING": "0"},
])
def test_collector_env_knobs_match_reference(env, monkeypatch):
    for key in ("RSTPU_TRACE_SAMPLE_RATE", "RSTPU_TRACE_TAIL_MS",
                "RSTPU_TRACING"):
        monkeypatch.delenv(key, raising=False)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    got = {}
    for label, m in PACKAGES.items():
        col = m.collector.SpanCollector()
        got[label] = (col.sample_rate, col.tail_ms, col.enabled)
    assert got["port"] == got["jax"]


# ---------------------------------------------------------------------------
# failpoints
# ---------------------------------------------------------------------------


def _trips(m, site, spec, hits):
    m.fp.activate(site, spec)
    out = []
    for _ in range(hits):
        try:
            m.fp.hit(site)
            out.append(False)
        except m.fp.FailpointError as exc:
            out.append(str(exc))
    return out, m.fp.trip_counts(), m.fp.active_sites()


def fp_fail_nth(m):
    return _trips(m, "compact.stream.chunk", "fail_nth:3", 6)


def fp_fail_first(m):
    return _trips(m, "compact.stream.refill", "fail_first:2", 5)


def fp_fail_prob_seeded(m):
    return _trips(m, "compact.subcompact", "fail_prob:0.3@seed5", 40)


def fp_delay_ms(m):
    out = _trips(m, "compact.dispatch", "delay_ms:1:0.5@seed2", 12)
    m.fp.deactivate("compact.dispatch")
    return out, m.fp.trip_counts(), m.fp.is_active("compact.dispatch")


def fp_torn(m):
    m.fp.activate("t.torn", "torn:0.5@seed3")
    cuts = [m.fp.torn_point("t.torn", 100) for _ in range(12)]
    m.fp.hit("t.torn")  # a torn policy answers only torn_point
    return cuts, m.fp.trip_counts()


def fp_one_shot(m):
    out = _trips(m, "t.once", "fail_nth:2,one_shot", 4)
    return out, m.fp.is_active("t.once")


def fp_failpoint_scope_and_clear(m):
    with m.fp.failpoint("t.scoped", "fail_first:1"):
        inside = m.fp.active_sites()
        try:
            m.fp.hit("t.scoped")
        except m.fp.FailpointError:
            pass
    after = m.fp.active_sites()
    m.fp.activate("t.a", "fail_nth:1")
    m.fp.activate("t.b", "fail_nth:9")
    m.fp.clear()
    return inside, after, m.fp.active_sites(), m.fp.trip_counts()


def fp_load_env(m):
    n = m.fp.load_env(" compact.stream.chunk=fail_nth:2 ; "
                      "compact.dispatch=delay_ms:5:0.1@seed4;;"
                      "wal.fsync=fail_first:1,one_shot")
    return n, m.fp.active_sites()


def fp_spec_errors(m):
    errors = []
    for name, spec in (("no.such.site", "fail_nth:1"),
                       ("t.x", "explode:1"), ("t.x", "fail_nth:1,twice"),
                       ("t.x", "fail_nth")):
        try:
            m.fp.activate(name, spec)
            errors.append(None)
        except (ValueError, IndexError) as exc:
            errors.append((type(exc).__name__, str(exc)))
    return errors, m.fp.active_sites()


def fp_trip_counter_and_span_tag(m):
    m.fp.activate("compact.subcompact", "fail_nth:1")
    with m.span.start_span("job", always=True):
        try:
            m.fp.hit("compact.subcompact")
        except m.fp.FailpointError:
            pass
    counter = m.stats.Stats.get().get_counter(
        m.stats.tagged("failpoint.trips", site="compact.subcompact"))
    return counter, _traces(m)


# ---------------------------------------------------------------------------
# Stats
# ---------------------------------------------------------------------------

_NOW = 1_700_000_000.0


def _fill(m):
    st = m.stats.Stats.get()
    for name, value in (("compaction.stream_chunks", 3),
                        ("compaction.stream_chunks", 4.5),
                        ("compaction.subcompactions", 1),
                        (m.stats.tagged("failpoint.trips", site="a.b"), 2)):
        st.incr(name, value)
    rng = random.Random(11)
    for i in range(500):
        st.add_metric("compact.ms", rng.expovariate(0.05))
        st.add_metric(m.stats.tagged("rpc.us", db="seg1"), i * 3.5)
    st.add_gauge("live.bytes", lambda: 1234.5)
    st.flush(_NOW)
    return st


def stats_counters_and_metrics(m):
    st = _fill(m)
    return ({n: st.get_counter(n) for n in (
                "compaction.stream_chunks", "compaction.subcompactions",
                "failpoint.trips site=a.b", "never.counted")},
            st.metric_count("compact.ms"), st.metric_avg("compact.ms"),
            st.metric_count("rpc.us db=seg1"))


def stats_percentiles_fixed_now(m):
    st = _fill(m)
    out = {}
    for name in ("compact.ms", "rpc.us db=seg1"):
        h = st._metrics[name]
        out[name] = [h.percentile(p, now=_NOW) for p in (0, 50, 90, 99, 100)]
        state = h.state()
        out[name].append(m.stats.histogram_state_percentile(state, 90))
    merged = m.stats.merge_histogram_states(
        [st._metrics["compact.ms"].state(),
         st._metrics["rpc.us db=seg1"].state()])
    out["merged"] = (merged["count"],
                     m.stats.histogram_state_percentile(merged, 50))
    return out


def stats_prometheus_text(m):
    text = _fill(m).dump_prometheus()
    return text, m.stats.parse_prometheus_text(text)


def stats_tagged_names(m):
    names = [m.stats.tagged("db_size", db="seg00001", shard="3"),
             m.stats.tagged("plain"), m.stats.tagged("x", b="2", a="1")]
    return names, [m.stats.split_tagged(n) for n in names + [
        "db_size db=seg1 loose", "bare"]]


SCENARIOS = [
    ctx_outside_any_span, ctx_wire_of_active_span, ctx_valid_wire_context,
    ctx_new_ids, span_tree, span_unsampled_root, span_remote_parent,
    span_detached, span_kill_switch, span_noop_sentinel,
    collector_ring_and_dropped, collector_tail_ring,
    collector_slowest_and_phases, collector_render_trace, fp_fail_nth,
    fp_fail_first, fp_fail_prob_seeded, fp_delay_ms, fp_torn, fp_one_shot,
    fp_failpoint_scope_and_clear, fp_load_env, fp_spec_errors,
    fp_trip_counter_and_span_tag, stats_counters_and_metrics,
    stats_percentiles_fixed_now, stats_prometheus_text, stats_tagged_names,
]


@pytest.mark.parametrize("scenario", SCENARIOS,
                         ids=[s.__name__ for s in SCENARIOS])
def test_port_leaf_matches_reference(scenario):
    got = {}
    for label, m in PACKAGES.items():
        _reset(m)
        random.seed(20240611)
        got[label] = scenario(m)
    assert got["port"] == got["jax"]


def test_registry_is_the_reference_registry_whole():
    """Every site of the JAX package is registered in the port, so a
    ``RSTPU_FAILPOINTS`` spec naming any of them arms both packages."""
    assert registry.REGISTRY == jax_registry.REGISTRY
    assert fp.SITES == jax_fp.SITES


def test_env_spec_naming_an_unported_site_imports_cleanly():
    """``RSTPU_FAILPOINTS`` is read when failpoints is imported; a spec
    naming reference sites whose layers the port has not taken over
    (here the WAL and RPC seams) arms the port's table and does not
    raise."""
    child = (
        "from rocksplicator_tpu_torch.testing import failpoints as fp\n"
        "print(sorted(fp.active_sites().items()))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    env["RSTPU_FAILPOINTS"] = ("wal.fsync=fail_nth:3;"
                               "rpc.frame.send=torn:0.01@seed7;"
                               "compact.stream.chunk=fail_nth:1")
    res = subprocess.run([sys.executable, "-c", child], cwd=str(REPO),
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == str(sorted({
        "wal.fsync": "fail_nth:3", "rpc.frame.send": "torn:0.01@seed7",
        "compact.stream.chunk": "fail_nth:1"}.items()))

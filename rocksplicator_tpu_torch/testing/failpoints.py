"""Deterministic failpoint registry for fault injection at I/O/RPC seams.
(The port's copy of ``rocksplicator_tpu/testing/failpoints.py``.)

The reference runs on 4000+ hosts where disks stall, RPCs hang, and
object stores 500 as a matter of course; the recovery paths that absorb
those faults deserve the same regression coverage as the hot paths they
protect. This module gives every seam we own a NAMED site::

    from rocksplicator_tpu_torch.testing import failpoints as fp
    ...
    fp.hit("wal.fsync")          # may raise FailpointError / sleep
    os.fsync(f.fileno())

and lets tests/chaos harnesses arm those sites with DETERMINISTIC
policies — same seed, same schedule, same failure — via API::

    fp.activate("wal.fsync", "fail_nth:3")
    with fp.failpoint("rpc.frame.send", "torn:0.05@seed7"):
        ...

or environment (picked up at import, one spec per site)::

    RSTPU_FAILPOINTS="wal.fsync=fail_nth:3;rpc.frame.send=torn:0.01@seed7"

Policy grammar (``kind[:arg[:arg2]][@seedN][,one_shot]``):

- ``fail_nth:N``      raise on exactly the Nth hit of the site
- ``fail_first:N``    raise on hits 1..N, then pass (retry-path testing)
- ``fail_prob:P``     raise with probability P (per-site seeded RNG)
- ``delay_ms:D[:P]``  sleep D ms on every hit (or with probability P)
- ``torn:P``          torn write: data sites cut the payload at a
                      deterministic offset and fail (``torn_point``)
- ``@seedN``          seed the site's private RNG (default 0 — fully
                      deterministic out of the box)
- ``,one_shot``       deactivate the site after its first trip

Zero-cost when unset: every entry point checks one module-global boolean
and returns — no dict lookup, no lock (measured sub-µs per site; the
write-path A/B is recorded in PERF.md next to tracing's 11.5 µs budget).
Trips are rare by construction, so the trip path can afford stats
(``failpoint.trips site=<name>`` counters on /stats) and a span tag on
the active sampled trace, which is how a chaos run's trace tree shows
*which* injected fault each recovery path absorbed.

Registered sites live in ``testing/failpoint_registry.py`` (one entry
per seam with a one-line fault description); ``SITES`` below derives
from it and ``tools/rstpu_check.py`` lint-gates the registry against
the actual call sites and test coverage.
"""

from __future__ import annotations

import asyncio
import contextlib
import os
import random
import threading
import time
from typing import Dict, Optional, Tuple

__all__ = [
    "FailpointError", "SITES", "activate", "deactivate", "clear",
    "failpoint", "hit", "async_hit", "pending_delay", "torn_point",
    "is_active", "active_sites", "trip_counts", "load_env",
]

# The canonical registered-site list, derived from the checked-in
# registry (testing/failpoint_registry.py) so the two can never drift.
# activate() REJECTS names not on it (a typo'd site would arm silently,
# inject nothing, and let a chaos run or regression test pass
# vacuously); names starting with "t." or "test." are exempt for unit
# tests of the registry itself. Adding a seam = add its
# fp.hit()/torn_point() call AND a registry entry AND a test/chaos
# reference — tools/rstpu_check.py pass 3 enforces all three.
from .failpoint_registry import REGISTRY as _REGISTRY

SITES = frozenset(_REGISTRY)


class FailpointError(OSError):
    """Raised by a tripped fail-class policy. Subclasses OSError so the
    I/O seams' existing transient-error handling (retry, reconnect,
    degrade) engages exactly as it would for a real EIO/ECONNRESET."""


_KINDS = ("fail_nth", "fail_first", "fail_prob", "delay_ms", "torn")


class _Site:
    """One armed site. Own lock + own RNG: determinism must not depend
    on what other sites (or the global ``random``) are doing."""

    __slots__ = ("name", "spec", "kind", "n", "prob", "delay_s",
                 "one_shot", "hits", "trips", "rng", "lock")

    def __init__(self, name: str, spec: str):
        self.name = name
        self.spec = spec
        self.one_shot = False
        self.n = 0
        self.prob: Optional[float] = None
        self.delay_s = 0.0
        seed = 0
        body = spec.strip()
        for flag in body.split(",")[1:]:
            if flag.strip() == "one_shot":
                self.one_shot = True
            else:
                raise ValueError(f"unknown failpoint flag: {flag!r}")
        body = body.split(",", 1)[0]
        if "@seed" in body:
            body, seed_s = body.rsplit("@seed", 1)
            seed = int(seed_s)
        parts = body.split(":")
        self.kind = parts[0]
        if self.kind not in _KINDS:
            raise ValueError(f"unknown failpoint kind: {self.kind!r}")
        if self.kind in ("fail_nth", "fail_first"):
            self.n = int(parts[1])
        elif self.kind == "fail_prob":
            self.prob = float(parts[1])
        elif self.kind == "torn":
            self.prob = float(parts[1]) if len(parts) > 1 else 1.0
        elif self.kind == "delay_ms":
            self.delay_s = float(parts[1]) / 1000.0
            self.prob = float(parts[2]) if len(parts) > 2 else None
        self.rng = random.Random(seed)
        self.hits = 0
        self.trips = 0
        self.lock = threading.Lock()

    def decide(self) -> Tuple[bool, float]:
        """(tripped, delay_seconds). delay 0.0 means fail; >0 means
        sleep. Counts the hit; caller handles one_shot/record/raise."""
        with self.lock:
            self.hits += 1
            if self.kind == "fail_nth":
                tripped = self.hits == self.n
            elif self.kind == "fail_first":
                tripped = self.hits <= self.n
            elif self.kind in ("fail_prob", "torn"):
                tripped = self.rng.random() < (self.prob or 0.0)
            else:  # delay_ms
                tripped = (self.prob is None
                           or self.rng.random() < self.prob)
            if tripped:
                self.trips += 1
        return tripped, (self.delay_s if self.kind == "delay_ms" else 0.0)

    def torn_cut(self, nbytes: int) -> Optional[int]:
        """Deterministic cut offset in [0, nbytes) when tripped."""
        with self.lock:
            self.hits += 1
            if self.rng.random() >= (self.prob or 0.0):
                return None
            self.trips += 1
            return self.rng.randrange(0, max(1, nbytes))


# module-global fast path: the ONLY cost paid by unarmed processes
_ACTIVE = False
_lock = threading.Lock()
_sites: Dict[str, _Site] = {}
# lifetime trip counts survive deactivate() so harnesses can report
# which faults a finished schedule actually exercised
_lifetime_trips: Dict[str, int] = {}


def activate(name: str, spec: str) -> None:
    """Arm ``name`` with a policy spec (see module docstring grammar).
    Unknown site names are rejected — see :data:`SITES`."""
    global _ACTIVE
    if name not in SITES and not name.startswith(("t.", "test.")):
        raise ValueError(
            f"unknown failpoint site: {name!r} (see failpoints.SITES)")
    site = _Site(name, spec)  # parse/validate before taking the lock
    with _lock:
        _sites[name] = site
        _ACTIVE = True


def deactivate(name: str) -> None:
    global _ACTIVE
    with _lock:
        site = _sites.pop(name, None)
        if site is not None and site.trips:
            _lifetime_trips[name] = (
                _lifetime_trips.get(name, 0) + site.trips)
        if not _sites:
            _ACTIVE = False


def clear() -> None:
    """Disarm every site (lifetime trip counts are kept)."""
    global _ACTIVE
    with _lock:
        for name, site in _sites.items():
            if site.trips:
                _lifetime_trips[name] = (
                    _lifetime_trips.get(name, 0) + site.trips)
        _sites.clear()
        _ACTIVE = False


def reset_for_test() -> None:
    clear()
    with _lock:
        _lifetime_trips.clear()


def is_active(name: str) -> bool:
    return name in _sites


def active_sites() -> Dict[str, str]:
    with _lock:
        return {n: s.spec for n, s in _sites.items()}


def trip_counts() -> Dict[str, int]:
    """site -> lifetime trips (armed sites' live counts included)."""
    with _lock:
        out = dict(_lifetime_trips)
        for name, site in _sites.items():
            if site.trips:
                out[name] = out.get(name, 0) + site.trips
        return out


@contextlib.contextmanager
def failpoint(name: str, spec: str):
    """Scoped activation for tests."""
    activate(name, spec)
    try:
        yield
    finally:
        deactivate(name)


def load_env(spec: Optional[str] = None) -> int:
    """Parse ``RSTPU_FAILPOINTS`` (or an explicit spec string); returns
    the number of sites armed. Called once at import."""
    if spec is None:
        spec = os.environ.get("RSTPU_FAILPOINTS", "")
    n = 0
    for entry in spec.split(";"):
        entry = entry.strip()
        if not entry:
            continue
        name, _, policy = entry.partition("=")
        activate(name.strip(), policy)
        n += 1
    return n


# ---------------------------------------------------------------------------
# seam entry points
# ---------------------------------------------------------------------------


def hit(name: str) -> None:
    """Visit a site. No-op unless armed; a tripped fail policy raises
    :class:`FailpointError`, a tripped delay policy sleeps in place.
    ``torn`` policies respond only to :func:`torn_point` (data sites
    call both; the tear must happen at the data write, not before)."""
    if not _ACTIVE:
        return
    site = _sites.get(name)
    if site is None or site.kind == "torn":
        return
    tripped, delay = site.decide()
    if not tripped:
        return
    _record_trip(site)
    if delay > 0.0:
        time.sleep(delay)
        return
    raise FailpointError(
        f"failpoint {name} tripped ({site.spec}, hit {site.hits})")


async def async_hit(name: str) -> None:
    """``hit`` for coroutine sites: a delay policy awaits instead of
    blocking the event loop (a stuck connect stalls ONE connection, not
    every shard sharing the loop)."""
    if not _ACTIVE:
        return
    site = _sites.get(name)
    if site is None or site.kind == "torn":
        return
    tripped, delay = site.decide()
    if not tripped:
        return
    _record_trip(site)
    if delay > 0.0:
        await asyncio.sleep(delay)
        return
    raise FailpointError(
        f"failpoint {name} tripped ({site.spec}, hit {site.hits})")


def pending_delay(name: str) -> float:
    """``hit`` for sites on an event-loop thread that can reschedule
    themselves: a tripped delay policy RETURNS the delay (seconds) for
    the caller to apply via ``loop.call_later`` instead of sleeping in
    place and stalling every coroutine sharing the loop; fail policies
    raise as usual. Returns 0.0 when untripped."""
    if not _ACTIVE:
        return 0.0
    site = _sites.get(name)
    if site is None or site.kind == "torn":
        return 0.0
    tripped, delay = site.decide()
    if not tripped:
        return 0.0
    _record_trip(site)
    if delay > 0.0:
        return delay
    raise FailpointError(
        f"failpoint {name} tripped ({site.spec}, hit {site.hits})")


def torn_point(name: str, nbytes: int) -> Optional[int]:
    """Data sites: returns a deterministic cut offset in [0, nbytes)
    when a ``torn`` policy trips, else None. The caller writes the
    prefix and raises :class:`FailpointError` — the peer observes a torn
    frame/record, the writer observes a failed write."""
    if not _ACTIVE:
        return None
    site = _sites.get(name)
    if site is None or site.kind != "torn":
        return None
    cut = site.torn_cut(nbytes)
    if cut is None:
        return None
    _record_trip(site)
    return cut


def _record_trip(site: _Site) -> None:
    """Trip-path accounting (rare): /stats counter + one_shot retirement
    + a tag on the active sampled span so chaos trace trees show which
    fault each recovery absorbed. Must never mask the injected fault."""
    if site.one_shot:
        deactivate(site.name)
    try:
        from ..observability.context import _current
        from ..utils.stats import Stats, tagged

        Stats.get().incr(tagged("failpoint.trips", site=site.name))
        span = _current.get()
        if span is not None and span.sampled:
            span.annotate(failpoint=site.name)
    except Exception:
        pass


load_env()

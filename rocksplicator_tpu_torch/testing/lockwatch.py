"""lockwatch: runtime lock-order watchdog — the dynamic corroboration of
(The port's copy of ``rocksplicator_tpu/testing/lockwatch.py``.)
``tools/rstpu_check.py`` pass 1.

Armed via ``RSTPU_LOCKWATCH=1`` (raise on violation) or
``RSTPU_LOCKWATCH=warn`` (count on /stats + log once per edge), checked
at package import so chaos-harness child processes arm themselves from
the inherited environment. When armed, :func:`install` replaces
``threading.Lock``/``threading.RLock`` with tracking wrappers; every
lock constructed AFTERWARDS records

- a per-thread held-set (cleared on release, recursion-counted for
  RLocks), and
- a process-global acquired-while-holding edge set, keyed by the lock's
  CONSTRUCTION SITE (file:line) — the same instance-agnostic identity
  the static pass uses, which is also how live locks map back to the
  static ranks in ``testing/lock_order.py``.

An acquisition violates when (a) its static rank is below a held lock's
rank — the canonical order learned from the static graph — or (b) it
closes a cycle in the dynamically-observed edge graph (covers locks the
static pass cannot see: locals, per-key ObjectLock internals, stdlib).
``Condition.wait``'s release/re-acquire goes through ``_release_save`` /
``_acquire_restore`` and is exempt from order checks, as in every
lock-order sanitizer: the re-acquire after a wait legitimately inverts
the textual order.

Zero-cost when unarmed BY CONSTRUCTION: nothing is patched, every lock
in the process is the stock ``_thread`` primitive, and the only cost
ever paid is this module's import.
"""

from __future__ import annotations

import _thread
import os
import sys
import threading
from typing import Dict, List, Optional, Set, Tuple

__all__ = [
    "LockOrderViolation", "install", "uninstall", "maybe_install",
    "installed", "reset_for_test", "edges",
]

# The stock primitives come from ``_thread``, not from ``threading``: a
# process that also imports the JAX package may have armed that package's
# watchdog first, and its wrapper classes then stand in ``threading``. Taken
# from there they would become this watchdog's inner locks, and every lock
# would be wrapped twice. (Armed the other way round, the wrappers below
# hand that watchdog stock locks: see _built_by_another_watchdog.)
_ORIG_LOCK = _thread.allocate_lock
_ORIG_RLOCK = _thread.RLock
# what install() replaced, put back by uninstall()
_replaced: Optional[Tuple[object, object]] = None

# repo root for construction-site keys relative to it (matches the
# static pass's repo-relative paths in lock_order.RANKS)
_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_REPO_ROOT = os.path.dirname(_PKG_DIR)


class LockOrderViolation(AssertionError):
    """Out-of-canonical-order or cycle-closing lock acquisition."""


_installed = False
_mode = "raise"                # "raise" | "warn"
_ranks: Dict[str, Tuple[str, int]] = {}   # site -> (name, rank)
# static PARTIAL order: (before_site, after_site) pairs from the
# transitive closure of the static graph — acquiring `before` while
# holding `after` is a violation; unrelated pairs are unconstrained
_static_order: Set[Tuple[str, str]] = set()
# dynamic edge graph over construction sites; guarded by a RAW lock so
# tracking can never recurse into itself
_graph_lock = _thread.allocate_lock()
_edges: Dict[str, Set[str]] = {}
_warned: Set[Tuple[str, str]] = set()
_tls = threading.local()


def _load_static() -> Tuple[Dict[str, Tuple[str, int]],
                            Set[Tuple[str, str]]]:
    try:
        from .lock_order import ORDER, RANKS
        return dict(RANKS), set(ORDER)
    except Exception:  # generated file absent: dynamic checks only
        return {}, set()


def _held() -> List["_Entry"]:
    held = getattr(_tls, "held", None)
    if held is None:
        held = _tls.held = []
    return held


class _Entry:
    __slots__ = ("lock", "count")

    def __init__(self, lock) -> None:
        self.lock = lock
        self.count = 1


def _site_of_caller() -> str:
    # first frame outside this module = the `threading.Lock()` call site
    f = sys._getframe(1)
    here = __file__
    while f is not None and f.f_code.co_filename == here:
        f = f.f_back
    if f is None:  # pragma: no cover
        return "ext/unknown:0"
    fn = f.f_code.co_filename
    try:
        rel = os.path.relpath(fn, _REPO_ROOT)
    except ValueError:  # different drive (windows); keep absolute
        rel = fn
    if rel.startswith(".."):  # outside the repo (stdlib etc.)
        rel = "ext/" + os.path.basename(fn)
    return f"{rel}:{f.f_lineno}"


def _name_of(site: str) -> str:
    info = _ranks.get(site)
    return info[0] if info else site


def _reaches(src: str, dst: str) -> bool:
    """dst reachable from src in the dynamic edge graph (caller holds
    _graph_lock)."""
    stack, seen = [src], {src}
    while stack:
        n = stack.pop()
        if n == dst:
            return True
        for m in _edges.get(n, ()):
            if m not in seen:
                seen.add(m)
                stack.append(m)
    return False


def _violation(kind: str, new_site: str, held_site: str) -> None:
    msg = (f"lock-order violation ({kind}): acquiring "
           f"{_name_of(new_site)} while holding {_name_of(held_site)} "
           f"(canonical order is the reverse; see "
           f"testing/lock_order.py and tools/rstpu_check.py)")
    if _mode == "warn":
        key = (held_site, new_site)
        with _graph_lock:
            fresh = key not in _warned
            if fresh:
                _warned.add(key)
        if fresh:
            try:
                from ..utils.stats import Stats, tagged

                Stats.get().incr(tagged("lockwatch.violations", kind=kind))
            except Exception:
                pass
            print(f"lockwatch: {msg}", file=sys.stderr)
        return
    raise LockOrderViolation(msg)


def _note_acquire(wlock, *, checked: bool = True) -> None:
    held = _held()
    for e in held:
        if e.lock is wlock:
            e.count += 1          # reentrant RLock: no new ordering fact
            return
    if checked:
        new_site = wlock._site
        for e in held:
            held_site = e.lock._site
            if held_site == new_site:
                continue          # same class+site pair: instances
            if (new_site, held_site) in _static_order:
                # static graph says new comes BEFORE held
                _violation("static-order", new_site, held_site)
            with _graph_lock:
                closes = _reaches(new_site, held_site)
                if not closes:
                    _edges.setdefault(held_site, set()).add(new_site)
            if closes:
                _violation("dynamic-cycle", new_site, held_site)
    held.append(_Entry(wlock))


def _note_release(wlock) -> None:
    held = _held()
    for i in range(len(held) - 1, -1, -1):
        if held[i].lock is wlock:
            held[i].count -= 1
            if held[i].count == 0:
                del held[i]
            return
    # release of a lock acquired before install/by another thread: ignore


class _WatchedLockBase:
    _site: str

    def __init__(self, inner) -> None:
        self._inner = inner
        self._site = _site_of_caller()

    def acquire(self, blocking: bool = True, timeout: float = -1):
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            try:
                _note_acquire(self)
            except LockOrderViolation:
                # don't leak the just-acquired inner lock under the
                # raising `with` statement (its __exit__ never runs)
                self._inner.release()
                raise
        return ok

    acquire_lock = acquire  # legacy alias some stdlib code uses

    def release(self) -> None:
        self._inner.release()
        _note_release(self)

    release_lock = release

    def __enter__(self):
        return self.acquire()

    def __exit__(self, exc_type, exc, tb):
        self.release()
        return False

    def locked(self) -> bool:
        return self._inner.locked()

    # -- Condition protocol ------------------------------------------------
    # Condition binds these at construction; wait()'s release/re-acquire
    # must keep the held-set truthful but is EXEMPT from order checks.

    def _release_save(self):
        inner_save = getattr(self._inner, "_release_save", None)
        state = inner_save() if inner_save else self._inner.release()
        held = _held()
        entry = None
        for i in range(len(held) - 1, -1, -1):
            if held[i].lock is self:
                entry = held[i]
                del held[i]
                break
        return (state, entry)

    def _acquire_restore(self, saved):
        state, entry = saved
        inner_restore = getattr(self._inner, "_acquire_restore", None)
        if inner_restore:
            inner_restore(state)
        else:
            self._inner.acquire()
        if entry is not None:
            _held().append(entry)
        else:
            _note_acquire(self, checked=False)

    def _is_owned(self) -> bool:
        inner_owned = getattr(self._inner, "_is_owned", None)
        if inner_owned:
            return inner_owned()
        return any(e.lock is self for e in _held())

    def _at_fork_reinit(self) -> None:  # pragma: no cover
        reinit = getattr(self._inner, "_at_fork_reinit", None)
        if reinit:
            reinit()
        _tls.held = []

    def __repr__(self) -> str:
        return f"<lockwatch {self._inner!r} @ {self._site}>"


def _built_by_another_watchdog() -> bool:
    """True when the lock is being built by another copy of this module:
    the JAX package's watchdog, armed after this one, takes ``threading``'s
    primitives (ours by then) as the inner locks of its own wrappers."""
    fn = sys._getframe(2).f_code.co_filename
    return fn != __file__ and fn.endswith(
        os.path.join("testing", "lockwatch.py"))


class _WatchedLock(_WatchedLockBase):
    def __new__(cls):
        if _built_by_another_watchdog():
            return _ORIG_LOCK()  # that watchdog's wrapper tracks it
        return super().__new__(cls)

    def __init__(self) -> None:
        super().__init__(_ORIG_LOCK())


class _WatchedRLock(_WatchedLockBase):
    def __new__(cls):
        if _built_by_another_watchdog():
            return _ORIG_RLOCK()
        return super().__new__(cls)

    def __init__(self) -> None:
        super().__init__(_ORIG_RLOCK())

    def _recursion_count(self) -> int:
        # multiprocessing's resource tracker asks its RLock this at exit
        # (it is built when torch is imported, after the arming)
        return self._inner._recursion_count()


def install(mode: str = "raise") -> None:
    """Patch ``threading.Lock``/``RLock`` so every lock constructed from
    now on is order-tracked. Locks that already exist stay stock (they
    keep working; they just aren't watched)."""
    global _installed, _mode, _ranks, _static_order, _replaced
    if _installed:
        _mode = mode
        return
    _ranks, _static_order = _load_static()
    _mode = mode
    _replaced = (threading.Lock, threading.RLock)
    threading.Lock = _WatchedLock
    threading.RLock = _WatchedRLock
    _installed = True


def uninstall() -> None:
    """Restore what :func:`install` replaced: the stock primitives, or
    another package's watchdog armed before this one (already-wrapped
    locks keep their inner lock and keep functioning)."""
    global _installed, _replaced
    if _replaced is not None:
        threading.Lock, threading.RLock = _replaced
        _replaced = None
    _installed = False


def installed() -> bool:
    return _installed


def maybe_install() -> bool:
    """Arm from the environment (``RSTPU_LOCKWATCH=1`` or ``=warn``);
    called at package import so child processes arm themselves."""
    val = os.environ.get("RSTPU_LOCKWATCH", "")
    if val == "1":
        install("raise")
    elif val == "warn":
        install("warn")
    else:
        return False
    return True


def edges() -> Dict[str, Set[str]]:
    with _graph_lock:
        return {k: set(v) for k, v in _edges.items()}


def reset_for_test() -> None:
    with _graph_lock:
        _edges.clear()
        _warned.clear()
    _tls.held = []

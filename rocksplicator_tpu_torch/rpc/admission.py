"""Per-tenant admission control at the server edge.
(The port's copy of ``rocksplicator_tpu/rpc/admission.py``.)

Reference: the production cluster fronts many product surfaces on the
same shard fleet; one misbehaving caller retrying at 10x its share sets
every caller's p99.9 unless admission is tenant-aware. The reference
delegates this to service-mesh quotas; here it lives at the one place
every request already passes — ``RpcServer._dispatch`` — keyed by the
``tenant`` frame-header tag (rpc/deadline.TENANT_KEY).

Machinery: the storage engine's ``IoBudget`` token-bucket shape (refill =
elapsed x rate, clamped to capacity) generalized to two meters per
tenant — ops/s and bytes/s — under a **weighted-fair default tier**:
every tenant gets an EQUAL bucket of the configured per-tenant rate,
so a noisy tenant exhausts only its own bucket and gets a typed
``RETRY_LATER`` (+ jittered retry-after hint) while well-behaved
tenants keep admitting. The server meters only tenant-TAGGED requests
— internal plane traffic (replication pulls, coordinator RPCs) carries
no tag and must never be shed by a product tenant's bucket; direct
``admit(None)`` callers share the ``default`` bucket.

Config (env, read once per singleton — ``reset_for_test`` re-reads):

- ``RSTPU_TENANT_OPS``    per-tenant ops/second (0/unset = unlimited)
- ``RSTPU_TENANT_BYTES``  per-tenant bytes/second (0/unset = unlimited)

Determinism: refill math runs off an injectable ``clock`` (tests drive
a fake clock for exact token accounting) and the retry-after jitter
draws from ``seeded_rng("RSTPU_RETRY_SEED")`` — same seed, same hint
schedule, which is what keeps chaos overload runs reproducible.
"""

from __future__ import annotations

import re
import threading
import time
from typing import Callable, Dict, Optional, Tuple

from ..utils.retry_policy import seeded_rng

__all__ = ["TokenBucket", "TenantAdmission", "sanitize_tenant"]

_TENANT_RE = re.compile(r"[^A-Za-z0-9_.-]")


def sanitize_tenant(tenant: Optional[str]) -> str:
    """Clamp an untrusted wire tag into a metrics-safe tag value (the
    tenant name becomes a Prometheus label on /metrics — a hostile tag
    must not be able to break the exposition grammar or explode label
    cardinality via length)."""
    if not tenant:
        return "default"
    return _TENANT_RE.sub("_", str(tenant))[:32] or "default"


class TokenBucket:
    """The IoBudget refill shape with a "when could this admit" answer:
    ``try_take`` returns 0.0 on success, else the seconds until ``n``
    tokens will have refilled — the raw material for the RETRY_LATER
    retry-after hint. ``debit`` charges costs only known after the
    work ran (response bytes), allowing the balance to go negative so
    an oversized response is paid off by future refill before the
    tenant admits again."""

    def __init__(self, rate: float, capacity: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic):
        self._lock = threading.Lock()
        self._rate = float(rate)
        # default burst = one second of rate (same choice as IoBudget)
        self._capacity = float(capacity) if capacity is not None \
            else max(self._rate, 1.0)
        self._tokens = self._capacity
        self._clock = clock
        self._refilled = clock()

    def _refill_locked(self) -> None:
        now = self._clock()
        elapsed = now - self._refilled
        if elapsed > 0:
            self._tokens = min(self._capacity,
                               self._tokens + elapsed * self._rate)
        self._refilled = now

    def try_take(self, n: float = 1.0) -> float:
        """0.0 = admitted (tokens taken); >0 = seconds until ``n``
        tokens exist (nothing taken)."""
        with self._lock:
            self._refill_locked()
            if self._tokens >= n:
                self._tokens -= n
                return 0.0
            if self._rate <= 0.0:
                return 1.0
            return (n - self._tokens) / self._rate

    def debit(self, n: float) -> None:
        """Post-hoc charge; may drive the balance negative."""
        with self._lock:
            self._refill_locked()
            self._tokens -= n

    @property
    def tokens(self) -> float:
        with self._lock:
            self._refill_locked()
            return self._tokens


class TenantAdmission:
    """Per-tenant (ops, bytes) buckets behind the server admission
    edge. Unconfigured (both rates 0) it admits everything at zero
    cost — the killswitch-off and default-deployment path."""

    _instance: Optional["TenantAdmission"] = None
    _instance_lock = threading.Lock()

    def __init__(self, ops_per_sec: float = 0.0,
                 bytes_per_sec: float = 0.0,
                 clock: Callable[[], float] = time.monotonic,
                 rng=None):
        self._ops_rate = max(0.0, float(ops_per_sec))
        self._bytes_rate = max(0.0, float(bytes_per_sec))
        self._clock = clock
        self._rng = rng if rng is not None else seeded_rng()
        self._lock = threading.Lock()
        self._buckets: Dict[str, Tuple[Optional[TokenBucket],
                                       Optional[TokenBucket]]] = {}
        # tenant -> (ops_rate, bytes_rate) runtime overrides (the
        # set_tenant_quota admin RPC): take effect on the NEXT admit —
        # no restart, no env round trip
        self._overrides: Dict[str, Tuple[float, float]] = {}

    # -- singleton wiring --------------------------------------------------

    @classmethod
    def get(cls) -> "TenantAdmission":
        inst = cls._instance
        if inst is None:
            with cls._instance_lock:
                inst = cls._instance
                if inst is None:
                    inst = cls.from_env()
                    cls._instance = inst
        return inst

    @classmethod
    def from_env(cls) -> "TenantAdmission":
        import os

        def _rate(name: str) -> float:
            try:
                return float(os.environ.get(name, "") or 0.0)
            except ValueError:
                return 0.0

        return cls(ops_per_sec=_rate("RSTPU_TENANT_OPS"),
                   bytes_per_sec=_rate("RSTPU_TENANT_BYTES"))

    @classmethod
    def reset_for_test(cls) -> None:
        """Drop the singleton so the next get() re-reads the env (tests
        and per-arm bench children flip quotas via env)."""
        with cls._instance_lock:
            cls._instance = None

    # -- admission ---------------------------------------------------------

    @property
    def configured(self) -> bool:
        if self._ops_rate > 0.0 or self._bytes_rate > 0.0:
            return True
        with self._lock:
            return any(o > 0.0 or b > 0.0
                       for o, b in self._overrides.values())

    def set_quota(self, tenant: Optional[str], ops_per_sec: float,
                  bytes_per_sec: float) -> None:
        """Runtime quota override for one tenant (the set_tenant_quota
        admin RPC). The tenant's buckets are rebuilt at the new rates on
        its next admission — a RAISE takes effect without restart and
        without waiting out a starved bucket's refill horizon. Zero/zero
        clears the override back to the env-configured default tier."""
        name = sanitize_tenant(tenant)
        ops = max(0.0, float(ops_per_sec))
        byt = max(0.0, float(bytes_per_sec))
        with self._lock:
            if ops <= 0.0 and byt <= 0.0:
                self._overrides.pop(name, None)
            else:
                self._overrides[name] = (ops, byt)
            # drop the live buckets so _buckets_for rebuilds at the new
            # rates (keeping them would pin the old refill rate — and a
            # raised tenant would stay starved behind its old horizon)
            self._buckets.pop(name, None)

    def quota_for(self, tenant: Optional[str]) -> Tuple[float, float]:
        """(ops_rate, bytes_rate) currently in force for a tenant."""
        name = sanitize_tenant(tenant)
        with self._lock:
            return self._overrides.get(
                name, (self._ops_rate, self._bytes_rate))

    def _buckets_for(self, tenant: str) -> Tuple[Optional[TokenBucket],
                                                 Optional[TokenBucket]]:
        with self._lock:
            pair = self._buckets.get(tenant)
            if pair is None:
                # equal per-tenant buckets = the weighted-fair default
                # tier (every tenant weight 1); created lazily on first
                # sight so the tenant universe never needs declaring.
                # A runtime override (set_quota) replaces this tenant's
                # default rates.
                ops_rate, bytes_rate = self._overrides.get(
                    tenant, (self._ops_rate, self._bytes_rate))
                ops = TokenBucket(ops_rate, clock=self._clock) \
                    if ops_rate > 0 else None
                byt = TokenBucket(bytes_rate, clock=self._clock) \
                    if bytes_rate > 0 else None
                pair = (ops, byt)
                self._buckets[tenant] = pair
            return pair

    def admit(self, tenant: Optional[str],
              cost_bytes: int = 0) -> Tuple[bool, float]:
        """(admitted, retry_after_ms). Charges one op + the REQUEST
        bytes up front; response bytes are debited post-hoc via
        :meth:`debit_bytes`. The hint is the bucket's exact refill
        horizon plus up to +25% jitter so a shed cohort doesn't
        re-arrive in lockstep."""
        if not self.configured:
            return True, 0.0
        name = sanitize_tenant(tenant)
        ops, byt = self._buckets_for(name)
        wait_s = 0.0
        if ops is not None:
            wait_s = max(wait_s, ops.try_take(1.0))
        if wait_s == 0.0 and byt is not None and cost_bytes > 0:
            w = byt.try_take(float(cost_bytes))
            if w > 0.0 and ops is not None:
                # bytes bucket refused after the op token was taken:
                # refund the op so a shed costs the tenant nothing
                ops.debit(-1.0)
            wait_s = max(wait_s, w)
        if wait_s == 0.0:
            return True, 0.0
        jitter = 1.0 + 0.25 * self._rng.random()
        return False, wait_s * 1e3 * jitter

    def debit_bytes(self, tenant: Optional[str], nbytes: int) -> None:
        """Post-hoc response-bytes charge (size unknown at admission)."""
        if not self.configured or nbytes <= 0:
            return
        _ops, byt = self._buckets_for(sanitize_tenant(tenant))
        if byt is not None:
            byt.debit(float(nbytes))

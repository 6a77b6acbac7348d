"""Object store abstraction — the S3Util equivalent.
(The port's copy of ``rocksplicator_tpu/utils/objectstore.py``.)

Reference: common/s3util.{h,cpp} — AWS SDK wrapper with get/put/list(V2)/
delete/copy, ``getObjects(prefix, local_dir)`` batch download
(s3util.cpp:385-416), a direct-IO download path (s3util.h:82-103), rate
limiter hookup, and a ``BuildS3Util`` factory keyed by bucket + rate limit.

Design: a small ``ObjectStore`` interface with two backends:
``LocalObjectStore`` (a directory tree standing in for a bucket — used by
all tests and local deployments) and ``S3ObjectStore``, a real S3 backend
over the stdlib SigV4 wire client in ``utils/s3.py`` (works against AWS or
any S3-compatible endpoint; the in-process ``utils/s3_stub.py`` server
fills the reference's missing S3 mock). Parallel batched
transfer mirrors the reference's 8-thread upload/download executors
(admin_handler.cpp:399-407).
"""

from __future__ import annotations

import os
import shutil
import threading
from concurrent.futures import ThreadPoolExecutor, as_completed
from typing import Dict, List, Optional, Tuple

from ..testing import failpoints as fp
from .rate_limiter import ConcurrentRateLimiter
from .retry_policy import RetryBudget, RetryPolicy, retry_call


class ObjectStoreError(Exception):
    pass


# batch-transfer retry: transient per-object failures inside
# get_objects/put_objects are retried under the unified policy (the S3
# and WebHDFS clients also retry transport errors internally; this layer
# catches what leaks through — and local-store EIO-class faults, which
# previously failed the whole batch on the first hiccup)
_BATCH_RETRY = RetryPolicy(max_attempts=3, base_delay=0.05, max_delay=1.0)
_BATCH_BUDGET = RetryBudget(capacity=32.0, refill_per_sec=4.0)


def _transient_store_error(exc: BaseException) -> bool:
    """Retryable? Permanent object-store answers (missing key, bad
    bucket path) must surface immediately; transport-shaped failures
    (OSError incl. injected FailpointError, 5xx-status errors) retry."""
    status = getattr(exc, "status", None)
    if status is not None:
        return status == 0 or status >= 500
    if isinstance(exc, ObjectStoreError):
        return False
    return isinstance(exc, (OSError, ConnectionError))


class ObjectStore:
    """Abstract object store. Keys are '/'-separated paths within a bucket.
    Subclasses share the rate-limiter plumbing via ``_init_limiter`` /
    ``_charge`` (reference: S3Util rate limiter hookup)."""

    _limiter: Optional[ConcurrentRateLimiter] = None

    def _init_limiter(
        self, rate_limit_bytes_per_sec: Optional[float]
    ) -> None:
        self._limiter = (
            ConcurrentRateLimiter(rate_limit_bytes_per_sec)
            if rate_limit_bytes_per_sec
            else None
        )

    def _charge(self, nbytes: int) -> None:
        if self._limiter is not None and nbytes > 0:
            self._limiter.apply_cost(nbytes)

    def get_object(self, key: str, local_path: str,
                   direct_io: bool = False) -> None:
        raise NotImplementedError

    def get_object_bytes(self, key: str) -> bytes:
        raise NotImplementedError

    def put_object(self, local_path: str, key: str) -> None:
        raise NotImplementedError

    def put_object_bytes(self, key: str, data: bytes) -> None:
        raise NotImplementedError

    def list_objects(self, prefix: str) -> List[str]:
        raise NotImplementedError

    def delete_object(self, key: str) -> None:
        raise NotImplementedError

    def copy_object(self, src_key: str, dst_key: str) -> None:
        raise NotImplementedError

    # -- batch ops (reference: s3util.cpp:385-416 + admin_handler 8-thread
    #    parallel batched checkpoint transfer) ----------------------------

    def get_objects(
        self, prefix: str, local_dir: str, parallelism: int = 8,
        direct_io: bool = False,
    ) -> List[str]:
        """Download every object under ``prefix`` into ``local_dir``.
        ``direct_io`` bypasses the page cache (O_DIRECT sink — reference
        s3util direct-IO download path). Returns local file paths.

        All-or-nothing: a failed fetch raises an ObjectStoreError naming
        the failing KEY (pool.map used to surface it as an opaque error
        mid-iteration) after the remaining fetches drain, and every file
        this call already produced — including the failing fetch's
        partial sink — is removed, so callers never see a half-downloaded
        batch directory."""
        keys = self.list_objects(prefix)
        os.makedirs(local_dir, exist_ok=True)
        results: List[str] = []
        lock = threading.Lock()

        def fetch(key: str) -> None:
            name = key[len(prefix):].lstrip("/") or os.path.basename(key)
            local_path = os.path.join(local_dir, name)
            os.makedirs(os.path.dirname(local_path) or ".", exist_ok=True)
            try:
                retry_call(
                    lambda: self.get_object(
                        key, local_path, direct_io=direct_io),
                    policy=_BATCH_RETRY, classify=_transient_store_error,
                    op="objectstore.get", budget=_BATCH_BUDGET,
                )
            except Exception as e:
                try:
                    os.remove(local_path)  # partial sink
                except OSError:
                    pass
                raise ObjectStoreError(
                    f"get_objects: fetch of {key!r} failed: {e}") from e
            with lock:
                results.append(local_path)

        with ThreadPoolExecutor(max_workers=parallelism) as pool:
            error: Optional[ObjectStoreError] = None
            for fut in as_completed([pool.submit(fetch, k) for k in keys]):
                exc = fut.exception()
                if exc is not None and error is None:
                    error = exc  # first failure wins; let the rest drain
        if error is not None:
            for path in results:
                try:
                    os.remove(path)
                except OSError:
                    pass
            raise error
        return sorted(results)

    def put_objects(
        self, local_paths: List[str], prefix: str, parallelism: int = 8
    ) -> List[str]:
        """Upload files under ``prefix``; returns the object keys. Keys are
        ``prefix/<basename>``; duplicate basenames would silently overwrite
        each other, so they are rejected up front."""
        basenames = [os.path.basename(p) for p in local_paths]
        if len(set(basenames)) != len(basenames):
            dupes = sorted({b for b in basenames if basenames.count(b) > 1})
            raise ObjectStoreError(f"duplicate basenames in batch: {dupes}")
        keys: List[str] = []
        lock = threading.Lock()

        def push(local_path: str) -> None:
            key = prefix.rstrip("/") + "/" + os.path.basename(local_path)
            retry_call(
                lambda: self.put_object(local_path, key),
                policy=_BATCH_RETRY, classify=_transient_store_error,
                op="objectstore.put", budget=_BATCH_BUDGET,
            )
            with lock:
                keys.append(key)

        with ThreadPoolExecutor(max_workers=parallelism) as pool:
            list(pool.map(push, local_paths))
        return sorted(keys)


class LocalObjectStore(ObjectStore):
    """Directory-backed object store: bucket == a root directory."""

    def __init__(
        self,
        root: str,
        rate_limit_bytes_per_sec: Optional[float] = None,
    ):
        self._root = os.path.abspath(root)
        os.makedirs(self._root, exist_ok=True)
        self._init_limiter(rate_limit_bytes_per_sec)

    def _path(self, key: str) -> str:
        key = key.lstrip("/")
        path = os.path.abspath(os.path.join(self._root, key))
        if not path.startswith(self._root + os.sep) and path != self._root:
            raise ObjectStoreError(f"key escapes bucket root: {key!r}")
        return path

    def get_object(self, key: str, local_path: str,
                   direct_io: bool = False) -> None:
        fp.hit("objectstore.get")
        src = self._path(key)
        if not os.path.isfile(src):
            raise ObjectStoreError(f"no such object: {key}")
        self._charge(os.path.getsize(src))
        os.makedirs(os.path.dirname(os.path.abspath(local_path)), exist_ok=True)
        if direct_io:
            from .directio import DirectIOFile

            with open(src, "rb") as f, DirectIOFile(local_path) as out:
                for chunk in iter(lambda: f.read(1 << 20), b""):
                    out.write(chunk)
        else:
            # Zero-copy fast path when bucket and sink share a filesystem:
            # hardlink instead of copying the bytes (the dominant download
            # cost of a local-store SST bulk-ingest). Consumers that would
            # MUTATE the file must break the link themselves — the engine's
            # ingest does (its global-seqno footer rewrite would otherwise
            # write through to the bucket object). EXDEV/perm failures fall
            # back to the copy.
            try:
                if os.path.lexists(local_path):
                    os.remove(local_path)
                os.link(src, local_path)
            except OSError:
                shutil.copyfile(src, local_path)

    def get_object_bytes(self, key: str) -> bytes:
        fp.hit("objectstore.get")
        src = self._path(key)
        if not os.path.isfile(src):
            raise ObjectStoreError(f"no such object: {key}")
        with open(src, "rb") as f:
            data = f.read()
        self._charge(len(data))
        return data

    def put_object(self, local_path: str, key: str) -> None:
        fp.hit("objectstore.put")
        if not os.path.isfile(local_path):
            raise ObjectStoreError(f"no such local file: {local_path}")
        dst = self._path(key)
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        self._charge(os.path.getsize(local_path))
        tmp = self._tmp_name(dst)
        shutil.copyfile(local_path, tmp)
        os.replace(tmp, dst)

    def put_object_bytes(self, key: str, data: bytes) -> None:
        fp.hit("objectstore.put")
        dst = self._path(key)
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        self._charge(len(data))
        tmp = self._tmp_name(dst)
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, dst)

    @staticmethod
    def _tmp_name(dst: str) -> str:
        # Unique per writer so concurrent puts to one key can't interleave
        # in a shared temp file; last os.replace() wins atomically.
        return f"{dst}.{os.getpid()}.{threading.get_ident()}.tmp"

    def list_objects(self, prefix: str) -> List[str]:
        prefix = prefix.lstrip("/")
        out: List[str] = []
        for dirpath, _dirnames, filenames in os.walk(self._root):
            for name in filenames:
                if name.endswith(".tmp"):  # in-flight writer temp files
                    continue
                full = os.path.join(dirpath, name)
                key = os.path.relpath(full, self._root).replace(os.sep, "/")
                if key.startswith(prefix):
                    out.append(key)
        return sorted(out)

    def delete_object(self, key: str) -> None:
        path = self._path(key)
        try:
            os.remove(path)
        except FileNotFoundError:
            raise ObjectStoreError(f"no such object: {key}") from None

    def copy_object(self, src_key: str, dst_key: str) -> None:
        src, dst = self._path(src_key), self._path(dst_key)
        if not os.path.isfile(src):
            raise ObjectStoreError(f"no such object: {src_key}")
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        shutil.copyfile(src, dst)


class S3ObjectStore(ObjectStore):
    """Real S3 backend over the stdlib SigV4 client (utils/s3.py) — works
    against AWS or any S3-compatible endpoint (minio, the s3_stub test
    server). Mirrors the reference S3Util surface (common/s3util.cpp:
    get/put/listV2/delete/copy + batch transfer + rate limiting). Cloud
    integration tests stay gated behind RSTPU_S3_INTEGRATION like the
    reference's --enable_integration_test."""

    def __init__(
        self,
        bucket: str,
        rate_limit_bytes_per_sec: Optional[float] = None,
        endpoint: Optional[str] = None,
    ):
        from .s3 import S3Client, S3Config, S3Error

        self._S3Error = S3Error
        cfg = S3Config()
        if endpoint:
            cfg.endpoint = endpoint
        try:
            self._client = S3Client(bucket, cfg)
        except S3Error as e:
            raise ObjectStoreError(str(e)) from e
        self._init_limiter(rate_limit_bytes_per_sec)

    def _wrap(self, fn, *args):
        try:
            return fn(*args)
        except self._S3Error as e:
            err = ObjectStoreError(str(e))
            # preserve the HTTP status so the batch-retry classifier
            # treats a 5xx/transport S3 failure like its HDFS twin
            err.status = e.status
            raise err from e

    def get_object(self, key: str, local_path: str,
                   direct_io: bool = False) -> None:
        os.makedirs(
            os.path.dirname(os.path.abspath(local_path)), exist_ok=True)
        n = self._wrap(
            self._client.get_object_to_file, key.lstrip("/"), local_path,
            direct_io)
        self._charge(n)

    def get_object_bytes(self, key: str) -> bytes:
        data = self._wrap(self._client.get_object, key.lstrip("/"))
        self._charge(len(data))
        return data

    def put_object(self, local_path: str, key: str) -> None:
        if not os.path.isfile(local_path):
            raise ObjectStoreError(f"no such local file: {local_path}")
        self._charge(os.path.getsize(local_path))
        self._wrap(
            self._client.put_object_from_file, key.lstrip("/"), local_path)

    def put_object_bytes(self, key: str, data: bytes) -> None:
        self._charge(len(data))
        self._wrap(self._client.put_object, key.lstrip("/"), data)

    def list_objects(self, prefix: str) -> List[str]:
        return self._wrap(self._client.list_objects, prefix.lstrip("/"))

    def delete_object(self, key: str) -> None:
        key = key.lstrip("/")
        # S3 DELETE is idempotent (204 for absent keys); preserve the
        # ObjectStore contract that deleting a missing object raises.
        # (Best-effort: the HEAD+DELETE pair is not atomic — concurrent
        # deleters may both succeed, which is acceptable for backup GC.)
        if not self._wrap(self._client.head_object, key):
            raise ObjectStoreError(f"no such object: {key}")
        self._wrap(self._client.delete_object, key)

    def copy_object(self, src_key: str, dst_key: str) -> None:
        self._wrap(self._client.copy_object, src_key.lstrip("/"),
                   dst_key.lstrip("/"))


# -- factory (reference: S3Util::BuildS3Util keyed by bucket+ratelimit) ----

_store_cache: Dict[Tuple[str, Optional[float]], ObjectStore] = {}
_store_cache_lock = threading.Lock()


def build_object_store(
    uri: str, rate_limit_bytes_per_sec: Optional[float] = None
) -> ObjectStore:
    """``local:///path`` or bare ``/path`` → LocalObjectStore; ``s3://bucket``
    → S3ObjectStore; ``hdfs://namenode:port/base`` → HdfsObjectStore
    (WebHDFS). Cached by (uri, ratelimit) like BuildS3Util."""
    key = (uri, rate_limit_bytes_per_sec)
    with _store_cache_lock:
        store = _store_cache.get(key)
        if store is None:
            if uri.startswith("s3://"):
                store = S3ObjectStore(uri[5:], rate_limit_bytes_per_sec)
            elif uri.startswith("hdfs://"):
                from .hdfs import HdfsObjectStore

                store = HdfsObjectStore(uri, rate_limit_bytes_per_sec)
            elif uri.startswith("local://"):
                store = LocalObjectStore(uri[8:], rate_limit_bytes_per_sec)
            else:
                store = LocalObjectStore(uri, rate_limit_bytes_per_sec)
            _store_cache[key] = store
        return store

"""HDFS object store over the WebHDFS REST protocol (stdlib-only).
(The port's copy of ``rocksplicator_tpu/utils/hdfs.py``.)

Reference: the admin plane's backupDB/restoreDB run over ``NewHdfsEnv``
(rocksdb_admin/admin_handler.cpp:696-863) — RocksDB file IO against an
HDFS deployment. Here HDFS is one more backend behind the ObjectStore
URI seam (``hdfs://namenode:port/base``), speaking WebHDFS:

  CREATE  PUT    /webhdfs/v1/<p>?op=CREATE&overwrite=true  -> 307 -> PUT data
  OPEN    GET    /webhdfs/v1/<p>?op=OPEN                   -> 307 -> GET data
  LIST    GET    /webhdfs/v1/<p>?op=LISTSTATUS             -> FileStatuses
  DELETE  DELETE /webhdfs/v1/<p>?op=DELETE&recursive=false
  MKDIRS  PUT    /webhdfs/v1/<p>?op=MKDIRS

The two-step redirect (namenode chooses a datanode) is followed
manually — stdlib redirect handling drops PUT bodies. No kerberos/auth
(``user.name`` query param only), matching the reference's simple-auth
HdfsEnv usage. Integration against a live cluster is env-gated the same
way as S3 (RSTPU_HDFS_INTEGRATION=hdfs://...); CI drives the protocol
against a stub WebHDFS server (tests/test_hdfs.py).
"""

from __future__ import annotations

import http.client
import json
import os
import random
import urllib.parse
from typing import List, Optional, Tuple

from ..testing import failpoints as fp
from .objectstore import ObjectStore, ObjectStoreError
from .retry_policy import RetryBudget, RetryPolicy, retry_call

_MAX_REDIRECTS = 4
_CHUNK = 1 << 20

# transient-failure retry under the unified policy (previously WebHDFS
# had NO retry: one namenode hiccup failed the whole backup/restore)
_HDFS_RETRY = RetryPolicy(max_attempts=4, base_delay=0.1, max_delay=5.0)
_HDFS_RETRY_BUDGET = RetryBudget(capacity=20.0, refill_per_sec=2.0)


def _transient_hdfs_error(exc: BaseException) -> bool:
    if isinstance(exc, HdfsError):
        # 0 = transport-level; 5xx = server-side transient. 4xx (missing
        # path, bad op) and 3xx anomalies are permanent.
        return exc.status == 0 or exc.status >= 500
    return isinstance(exc, (OSError, http.client.HTTPException))


class HdfsError(ObjectStoreError):
    """WebHDFS failure; ``status`` carries the HTTP code (0 = transport)."""

    def __init__(self, msg: str, status: int = 0):
        super().__init__(msg)
        self.status = status


def _parse_uri(uri: str) -> Tuple[str, int, str]:
    """hdfs://host:port/base -> (host, port, /base)."""
    parsed = urllib.parse.urlsplit(uri)
    if parsed.scheme != "hdfs" or not parsed.hostname:
        raise ValueError(f"not an hdfs:// URI: {uri}")
    return (parsed.hostname, parsed.port or 9870,
            parsed.path.rstrip("/"))


class HdfsObjectStore(ObjectStore):
    def __init__(self, uri: str,
                 rate_limit_bytes_per_sec: Optional[float] = None,
                 user: Optional[str] = None, timeout: float = 60.0):
        self._host, self._port, self._base = _parse_uri(
            uri if uri.startswith("hdfs://") else f"hdfs://{uri}")
        self._user = user or os.environ.get("RSTPU_HDFS_USER", "rstpu")
        self._timeout = timeout
        self._init_limiter(rate_limit_bytes_per_sec)

    # -- REST plumbing -----------------------------------------------------

    def _path(self, key: str) -> str:
        return f"{self._base}/{key.lstrip('/')}" if key else self._base

    def _url(self, path: str, op: str, **params) -> str:
        q = {"op": op, "user.name": self._user, **params}
        return (f"/webhdfs/v1{urllib.parse.quote(path)}"
                f"?{urllib.parse.urlencode(q)}")

    def _send(self, host: str, port: int, method: str, url: str, body,
              sink=None):
        """One HTTP exchange. Returns (status, location, data). With a
        ``sink`` file object, a 2xx response body is streamed into it in
        _CHUNK pieces and ``data`` is b""."""
        fp.hit("hdfs.request")  # OSError-shaped: absorbed by the retry
        conn = http.client.HTTPConnection(host, port, timeout=self._timeout)
        try:
            headers = {}
            if body is not None and hasattr(body, "read"):
                body.seek(0)  # redirect retries must resend from the start
                # explicit length: http.client would otherwise fall back
                # to chunked transfer, which plain HTTP/1.0 datanode
                # stubs (and some gateways) do not accept
                headers["Content-Length"] = str(
                    os.fstat(body.fileno()).st_size)
            conn.request(method, url, body=body, headers=headers)
            resp = conn.getresponse()
            if resp.status in (301, 302, 307):
                loc = resp.getheader("Location")
                resp.read()
                return resp.status, loc, b""
            if sink is not None and resp.status < 300:
                while True:
                    chunk = resp.read(_CHUNK)
                    if not chunk:
                        return resp.status, None, b""
                    sink.write(chunk)
                    self._charge(len(chunk))
            return resp.status, None, resp.read()
        finally:
            conn.close()

    def _request(self, method: str, path: str, op: str, body=None,
                 sink=None, **params):
        """One WebHDFS op with transient-failure retries (exp backoff +
        full jitter + shared budget — utils/retry_policy.py). Retries
        are safe: CREATE is overwrite-idempotent (file bodies are
        rewound in ``_send``), OPEN re-streams, and a partial ``sink``
        from a failed attempt is truncated before the next one."""

        if op == "DELETE":
            # NOT retried: a retry after a transport failure that
            # followed a server-side successful delete reads
            # {"boolean": false} and fabricates a not-found for an op
            # that succeeded — surface the transport ambiguity instead
            return self._request_once(
                method, path, op, body=body, sink=sink, **params)

        def attempt():
            if sink is not None:
                sink.seek(0)
                sink.truncate()
            return self._request_once(
                method, path, op, body=body, sink=sink, **params)

        _seed = os.environ.get("RSTPU_RETRY_SEED")
        return retry_call(
            attempt, policy=_HDFS_RETRY, classify=_transient_hdfs_error,
            op="hdfs.request", budget=_HDFS_RETRY_BUDGET,
            rng=random.Random(int(_seed)) if _seed else None,
        )

    def _request_once(self, method: str, path: str, op: str, body=None,
                      sink=None, **params):
        """Issue one WebHDFS op, following namenode->datanode redirects
        manually. Per spec the data body is only sent to the redirect
        target; a server that handles CREATE directly (HttpFS /
        noredirect namenodes) is detected by a 2xx on the body-less
        first hop, and the op is re-issued WITH the body so the write
        is never silently dropped."""
        host, port = self._host, self._port
        url = self._url(path, op, **params)
        body_sent = body is None
        for _ in range(_MAX_REDIRECTS):
            status, loc, data = self._send(
                host, port, method, url, body if body_sent else None,
                sink=sink)
            if loc is not None and status in (301, 302, 307):
                parsed = urllib.parse.urlsplit(loc)
                host = parsed.hostname or host
                port = parsed.port or port
                url = (parsed.path +
                       (f"?{parsed.query}" if parsed.query else ""))
                if not body_sent:
                    body_sent = True
                    status, _loc, data = self._send(
                        host, port, method, url, body, sink=sink)
                    if status >= 300:
                        raise HdfsError(
                            f"{op} {path}: {status} {data[:200]!r}",
                            status=status)
                    return status, data
                continue
            if status >= 300:
                raise HdfsError(f"{op} {path}: {status} {data[:200]!r}",
                                status=status)
            if not body_sent:
                # no redirect and the body never went out: this server
                # takes the data directly — re-issue with it
                status, _loc, data = self._send(
                    host, port, method, url, body, sink=sink)
                if status >= 300:
                    raise HdfsError(
                        f"{op} {path}: {status} {data[:200]!r}",
                        status=status)
            return status, data
        # distinct non-zero, non-5xx status: a redirect loop is a
        # PERMANENT misconfiguration — status 0 would classify it
        # transient and re-walk the whole loop under backoff
        raise HdfsError(f"{op} {path}: too many redirects", status=310)

    # -- ObjectStore API ---------------------------------------------------

    def put_object_bytes(self, key: str, data: bytes) -> None:
        self._charge(len(data))
        self._request("PUT", self._path(key), "CREATE", body=data,
                      overwrite="true")

    def put_object(self, local_path: str, key: str) -> None:
        # file object body: http.client streams it with a fstat'd
        # Content-Length — no whole-object buffering
        self._charge(os.path.getsize(local_path))
        with open(local_path, "rb") as f:
            self._request("PUT", self._path(key), "CREATE", body=f,
                          overwrite="true")

    def get_object_bytes(self, key: str) -> bytes:
        _status, data = self._request("GET", self._path(key), "OPEN")
        self._charge(len(data))
        return data

    def get_object(self, key: str, local_path: str,
                   direct_io: bool = False) -> None:
        parent = os.path.dirname(local_path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        tmp = f"{local_path}.tmp.{os.getpid()}"
        try:
            with open(tmp, "wb") as f:
                self._request("GET", self._path(key), "OPEN", sink=f)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        os.replace(tmp, local_path)

    def list_objects(self, prefix: str) -> List[str]:
        """Every file whose KEY starts with ``prefix`` — the STRING-prefix
        contract Local/S3 implement (a prefix may be a partial filename:
        archive.py enumerates 'dbmeta-<seq>' chains with prefix
        '.../dbmeta'). The walk is rooted at the prefix's parent
        DIRECTORY and filtered by string prefix, so partial-name
        prefixes match exactly like the other backends."""
        prefix = prefix.lstrip("/")
        root = prefix.rstrip("/").rsplit("/", 1)[0] if "/" in prefix else ""
        out: List[str] = []
        pending = [root]
        while pending:
            cur = pending.pop()
            try:
                _s, data = self._request(
                    "GET", self._path(cur), "LISTSTATUS")
            except HdfsError as e:
                if e.status == 404:
                    continue
                raise
            statuses = json.loads(data)["FileStatuses"]["FileStatus"]
            for st in statuses:
                # LISTSTATUS of a FILE returns one entry with empty suffix
                name = st["pathSuffix"]
                child = (f"{cur}/{name}" if cur and name
                         else (name or cur))
                if st["type"] == "DIRECTORY":
                    # descend only where the subtree can still match
                    if child.startswith(prefix) or prefix.startswith(
                            child + "/"):
                        pending.append(child)
                elif child.startswith(prefix):
                    out.append(child)
        return sorted(out)

    def delete_object(self, key: str) -> None:
        _s, data = self._request("DELETE", self._path(key), "DELETE",
                                 recursive="false")
        # WebHDFS answers 200 {"boolean": false} for a missing path; the
        # ObjectStore contract (Local/S3 parity) is that this raises
        try:
            deleted = bool(json.loads(data)["boolean"])
        except (ValueError, KeyError, TypeError):
            deleted = True  # non-JSON success body: trust the 2xx
        if not deleted:
            raise HdfsError(f"DELETE {self._path(key)}: no such object",
                            status=404)

    def copy_object(self, src_key: str, dst_key: str) -> None:
        self.put_object_bytes(dst_key, self.get_object_bytes(src_key))

"""Real S3 backend: AWS Signature V4 + REST, stdlib only.
(The port's copy of ``rocksplicator_tpu/utils/s3.py``.)

Reference: common/s3util.{h,cpp} wraps the AWS C++ SDK (get/put/listV2/
delete/copy + batch download s3util.cpp:385-416). No AWS SDK is baked into
this image, so this module implements the actual S3 wire protocol —
SigV4 request signing (hmac/hashlib), the REST verbs over http.client,
and ListObjectsV2 XML — making ``S3ObjectStore`` a working production
backend against AWS or any S3-compatible endpoint (minio, the in-process
``s3_stub`` test server), not a boto3 shim.

Credentials come from the standard env (AWS_ACCESS_KEY_ID /
AWS_SECRET_ACCESS_KEY / AWS_SESSION_TOKEN, region from AWS_REGION or
AWS_DEFAULT_REGION) or explicit constructor args. A custom endpoint
(``http://host:port``) switches to path-style addressing, matching minio
convention.
"""

from __future__ import annotations

import datetime
import hashlib
import hmac
import http.client
import os
import random
import socket
import urllib.parse
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

from ..testing import failpoints as fp
from .retry_policy import RetryBudget, RetryPolicy, backoff_step

_ALGORITHM = "AWS4-HMAC-SHA256"

# One retry budget per process, shared by every S3Client: a hard-down
# endpoint degrades to fail-fast instead of every caller independently
# multiplying load (utils/retry_policy.py).
_S3_RETRY_BUDGET = RetryBudget(capacity=20.0, refill_per_sec=2.0)
_UNRESERVED = frozenset(
    "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789-._~"
)


class S3Error(Exception):
    def __init__(self, message: str, status: int = 0, code: str = ""):
        super().__init__(message)
        self.status = status
        self.code = code


def _tmp_name(dst: str) -> str:
    """Unique per writer so concurrent downloads of one target can't
    interleave; the final os.replace() wins atomically."""
    import threading

    return f"{dst}.{os.getpid()}.{threading.get_ident()}.tmp"


def _uri_encode(s: str, encode_slash: bool = True) -> str:
    """AWS canonical URI encoding (NOT urllib.quote: AWS requires
    uppercase percent escapes and '~' unreserved)."""
    out = []
    for ch in s.encode("utf-8"):
        c = chr(ch)
        if c in _UNRESERVED or (c == "/" and not encode_slash):
            out.append(c)
        else:
            out.append("%%%02X" % ch)
    return "".join(out)


def _hmac(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode("utf-8"), hashlib.sha256).digest()


def signing_key(secret_key: str, date: str, region: str, service: str) -> bytes:
    """SigV4 key derivation chain (date is YYYYMMDD)."""
    k = _hmac(("AWS4" + secret_key).encode("utf-8"), date)
    k = _hmac(k, region)
    k = _hmac(k, service)
    return _hmac(k, "aws4_request")


def canonical_request(
    method: str,
    canonical_uri: str,
    query: Iterable[Tuple[str, str]],
    headers: Dict[str, str],
    signed_headers: List[str],
    payload_sha256: str,
) -> str:
    cq = "&".join(
        f"{_uri_encode(k)}={_uri_encode(v)}"
        for k, v in sorted(query)
    )
    ch = "".join(
        f"{h}:{' '.join(headers[h].split())}\n" for h in signed_headers
    )
    return "\n".join([
        method, canonical_uri, cq, ch, ";".join(signed_headers),
        payload_sha256,
    ])


def string_to_sign(amz_date: str, scope: str, creq: str) -> str:
    return "\n".join([
        _ALGORITHM, amz_date, scope,
        hashlib.sha256(creq.encode("utf-8")).hexdigest(),
    ])


def sign_request(
    method: str,
    canonical_uri: str,
    query: Iterable[Tuple[str, str]],
    headers: Dict[str, str],
    payload_sha256: str,
    access_key: str,
    secret_key: str,
    region: str,
    amz_date: str,
    service: str = "s3",
) -> str:
    """Returns the Authorization header value. ``headers`` must already
    contain every header to be signed (host, x-amz-date,
    x-amz-content-sha256, ...); all lowercase-keyed headers are signed."""
    signed = sorted(h.lower() for h in headers)
    lower = {h.lower(): v for h, v in headers.items()}
    creq = canonical_request(
        method, canonical_uri, query, lower, signed, payload_sha256)
    date = amz_date[:8]
    scope = f"{date}/{region}/{service}/aws4_request"
    sts = string_to_sign(amz_date, scope, creq)
    sig = hmac.new(
        signing_key(secret_key, date, region, service),
        sts.encode("utf-8"), hashlib.sha256,
    ).hexdigest()
    return (
        f"{_ALGORITHM} Credential={access_key}/{scope}, "
        f"SignedHeaders={';'.join(signed)}, Signature={sig}"
    )


@dataclass
class S3Config:
    region: str = field(
        default_factory=lambda: os.environ.get(
            "AWS_REGION", os.environ.get("AWS_DEFAULT_REGION", "us-east-1"))
    )
    access_key: str = field(
        default_factory=lambda: os.environ.get("AWS_ACCESS_KEY_ID", ""))
    secret_key: str = field(
        default_factory=lambda: os.environ.get("AWS_SECRET_ACCESS_KEY", ""))
    session_token: Optional[str] = field(
        default_factory=lambda: os.environ.get("AWS_SESSION_TOKEN"))
    # http(s)://host[:port] — None = AWS virtual-hosted style
    endpoint: Optional[str] = field(
        default_factory=lambda: os.environ.get("RSTPU_S3_ENDPOINT"))
    connect_timeout: float = 10.0
    read_timeout: float = 120.0
    max_retries: int = 3


class S3Client:
    """Low-level S3 REST client for one bucket.

    Verbs mirror s3util.h: getObject(+ToFile), putObject, listObjects(V2
    w/ continuation), deleteObject, copyObject. Transient failures (5xx,
    connection resets) retry with exponential backoff like the SDK's
    default retry strategy.
    """

    def __init__(self, bucket: str, config: Optional[S3Config] = None):
        self.bucket = bucket
        self.cfg = config or S3Config()
        # exp backoff + full jitter (was an inline 2**n*0.1 sleep);
        # RSTPU_RETRY_SEED pins the jitter for reproducible chaos runs
        self._retry = RetryPolicy(
            max_attempts=self.cfg.max_retries + 1,
            base_delay=0.1, max_delay=5.0)
        _seed = os.environ.get("RSTPU_RETRY_SEED")
        self._retry_rng = random.Random(int(_seed) if _seed else None)
        if not self.cfg.access_key or not self.cfg.secret_key:
            raise S3Error(
                "missing AWS credentials (AWS_ACCESS_KEY_ID / "
                "AWS_SECRET_ACCESS_KEY)"
            )
        if self.cfg.endpoint:
            u = urllib.parse.urlparse(self.cfg.endpoint)
            self._secure = u.scheme == "https"
            self._host = u.hostname or "127.0.0.1"
            self._port = u.port or (443 if self._secure else 80)
            self._path_style = True
            host_hdr = (
                self._host if self._port in (80, 443)
                else f"{self._host}:{self._port}"
            )
            self._host_header = host_hdr
        else:
            self._secure = True
            self._host = f"{bucket}.s3.{self.cfg.region}.amazonaws.com"
            self._port = 443
            self._path_style = False
            self._host_header = self._host

    # -- plumbing ----------------------------------------------------------

    def _canonical_uri(self, key: str) -> str:
        path = f"/{self.bucket}/{key}" if self._path_style else f"/{key}"
        return _uri_encode(path, encode_slash=False)

    def _request(
        self,
        method: str,
        key: str = "",
        query: Optional[List[Tuple[str, str]]] = None,
        body: bytes = b"",
        extra_headers: Optional[Dict[str, str]] = None,
        body_path: Optional[str] = None,
        sink_path: Optional[str] = None,
        sink_direct: bool = False,
    ) -> Tuple[int, Dict[str, str], bytes]:
        """One signed request with retries. ``body_path`` streams a file
        up (payload hashed incrementally first — SigV4 signs the hash, so
        one extra read pass replaces holding the file in RAM);
        ``sink_path`` streams a 200 response to a file in chunks and
        returns b"" as data (error bodies still return in full)."""
        query = query or []
        uri = self._canonical_uri(key)
        if body_path is not None:
            h = hashlib.sha256()
            body_len = 0
            with open(body_path, "rb") as f:
                for chunk in iter(lambda: f.read(1 << 20), b""):
                    h.update(chunk)
                    body_len += len(chunk)
            payload_hash = h.hexdigest()
        else:
            payload_hash = hashlib.sha256(body).hexdigest()
            body_len = len(body)
        attempt = 0
        while True:
            now = datetime.datetime.now(datetime.timezone.utc)
            amz_date = now.strftime("%Y%m%dT%H%M%SZ")
            headers = {
                "host": self._host_header,
                "x-amz-date": amz_date,
                "x-amz-content-sha256": payload_hash,
            }
            if self.cfg.session_token:
                headers["x-amz-security-token"] = self.cfg.session_token
            if extra_headers:
                headers.update(
                    {k.lower(): v for k, v in extra_headers.items()})
            auth = sign_request(
                method, uri, query, headers, payload_hash,
                self.cfg.access_key, self.cfg.secret_key, self.cfg.region,
                amz_date,
            )
            send_headers = dict(headers)
            send_headers["Authorization"] = auth
            if body_len or method in ("PUT", "POST"):
                send_headers["content-length"] = str(body_len)
            # the wire query string must be byte-identical to the signed
            # canonical query string (same ordering and escaping)
            qs = "&".join(
                f"{_uri_encode(k)}={_uri_encode(v)}"
                for k, v in sorted(query)
            )
            target = uri + ("?" + qs if qs else "")
            try:
                fp.hit("s3.request")  # OSError-shaped: retried below
                conn_cls = (
                    http.client.HTTPSConnection if self._secure
                    else http.client.HTTPConnection
                )
                conn = conn_cls(
                    self._host, self._port, timeout=self.cfg.read_timeout)
                try:
                    send_body = body or None
                    if body_path is not None:
                        send_body = open(body_path, "rb")
                    try:
                        conn.request(method, target, body=send_body,
                                     headers=send_headers)
                    finally:
                        if body_path is not None:
                            send_body.close()
                    resp = conn.getresponse()
                    status = resp.status
                    rheaders = {k.lower(): v for k, v in resp.getheaders()}
                    if sink_path is not None and status == 200:
                        tmp = _tmp_name(sink_path)
                        if sink_direct:
                            # page-cache-bypassing sink (reference
                            # DirectIOWritableFile, s3util.h:82-103)
                            from .directio import DirectIOFile

                            sink_cm = DirectIOFile(tmp)
                        else:
                            sink_cm = open(tmp, "wb")
                        with sink_cm as out:
                            for chunk in iter(
                                    lambda: resp.read(1 << 20), b""):
                                out.write(chunk)
                        os.replace(tmp, sink_path)
                        data = b""
                    else:
                        data = resp.read()
                finally:
                    conn.close()
            except (OSError, socket.timeout, http.client.HTTPException) as e:
                if not self._retry_sleep(attempt):
                    raise S3Error(f"S3 request failed: {e!r}") from e
                attempt += 1
                continue
            if status >= 500 and self._retry_sleep(attempt):
                attempt += 1
                continue
            return status, rheaders, data

    def _retry_sleep(self, attempt: int) -> bool:
        """One backoff step under the unified policy; False when the
        attempt or the process-wide retry budget is exhausted."""
        return backoff_step(
            self._retry, attempt, op="s3.request",
            budget=_S3_RETRY_BUDGET, rng=self._retry_rng)

    @staticmethod
    def _error(status: int, data: bytes, what: str) -> S3Error:
        code, msg = "", ""
        try:
            root = ET.fromstring(data.decode("utf-8"))
            code = (root.findtext("Code") or "").strip()
            msg = (root.findtext("Message") or "").strip()
        except Exception:
            pass
        return S3Error(
            f"{what}: HTTP {status} {code} {msg}".strip(), status, code)

    # -- verbs (s3util.h API surface) --------------------------------------

    def get_object(self, key: str) -> bytes:
        status, _h, data = self._request("GET", key)
        if status != 200:
            raise self._error(status, data, f"getObject {key}")
        return data

    def get_object_to_file(self, key: str, local_path: str,
                           direct_io: bool = False) -> int:
        """Streams the object to ``local_path`` (1 MiB chunks, atomic
        replace; ``direct_io`` bypasses the page cache via O_DIRECT —
        s3util.h:82-103). Returns the byte count."""
        status, headers, data = self._request(
            "GET", key, sink_path=local_path, sink_direct=direct_io)
        if status != 200:
            raise self._error(status, data, f"getObject {key}")
        try:
            return os.path.getsize(local_path)
        except OSError:
            return int(headers.get("content-length", "0") or "0")

    def put_object(self, key: str, data: bytes) -> None:
        status, _h, body = self._request("PUT", key, body=data)
        if status not in (200, 201):
            raise self._error(status, body, f"putObject {key}")

    def put_object_from_file(self, key: str, local_path: str) -> int:
        """Streams a file up without buffering it in RAM (one hashing
        pass for the signed payload sha256, then a streamed send).
        Returns the byte count."""
        status, _h, body = self._request("PUT", key, body_path=local_path)
        if status not in (200, 201):
            raise self._error(status, body, f"putObject {key}")
        return os.path.getsize(local_path)

    def delete_object(self, key: str) -> None:
        status, _h, body = self._request("DELETE", key)
        if status not in (200, 204):
            raise self._error(status, body, f"deleteObject {key}")

    def head_object(self, key: str) -> bool:
        """True/False for 200/404; any other status raises (a 403 is a
        permission problem, not object absence)."""
        status, _h, data = self._request("HEAD", key)
        if status == 200:
            return True
        if status == 404:
            return False
        raise self._error(status, data, f"headObject {key}")

    def copy_object(self, src_key: str, dst_key: str) -> None:
        src = _uri_encode(f"/{self.bucket}/{src_key}", encode_slash=False)
        status, _h, body = self._request(
            "PUT", dst_key, extra_headers={"x-amz-copy-source": src})
        if status != 200:
            raise self._error(status, body, f"copyObject {src_key}")
        # S3 reports some copy failures inside a 200 body
        if b"<Error>" in body:
            raise self._error(200, body, f"copyObject {src_key}")

    def list_objects(self, prefix: str) -> List[str]:
        """Full ListObjectsV2 with continuation (s3util listAllObjects)."""
        keys: List[str] = []
        token: Optional[str] = None
        while True:
            query: List[Tuple[str, str]] = [
                ("list-type", "2"), ("prefix", prefix),
            ]
            if token:
                query.append(("continuation-token", token))
            status, _h, data = self._request("GET", "", query=query)
            if status != 200:
                raise self._error(status, data, f"listObjects {prefix}")
            root = ET.fromstring(data.decode("utf-8"))
            ns = ""
            if root.tag.startswith("{"):
                ns = root.tag[: root.tag.index("}") + 1]
            for contents in root.iter(f"{ns}Contents"):
                k = contents.findtext(f"{ns}Key")
                if k is not None:
                    keys.append(k)
            truncated = (root.findtext(f"{ns}IsTruncated") or "").lower()
            token = root.findtext(f"{ns}NextContinuationToken")
            if truncated != "true" or not token:
                return keys

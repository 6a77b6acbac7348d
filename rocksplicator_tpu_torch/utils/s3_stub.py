"""In-process S3-compatible server for tests and local development.
(The port's copy of ``rocksplicator_tpu/utils/s3_stub.py``.)

Fills the reference's acknowledged S3-mock gap (for S3 there
is no mock, only the gated integration tests). Implements the subset
the framework uses — PUT/GET/HEAD/DELETE object, PUT with
x-amz-copy-source (copy), ListObjectsV2 with prefix + continuation — and
VERIFIES each request's SigV4 signature against the configured
credentials by recomputing it from the raw request, so the client's
signer is exercised end-to-end, not just its happy path.

Usage:
    srv = S3StubServer(access_key="test", secret_key="secret")
    srv.start()   # -> endpoint http://127.0.0.1:<port>
    ...
    srv.stop()
"""

from __future__ import annotations

import hashlib
import hmac
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple

from .s3 import signing_key, string_to_sign

_MAX_KEYS_DEFAULT = 1000


class S3StubServer:
    def __init__(
        self,
        access_key: str = "test-access",
        secret_key: str = "test-secret",
        region: str = "us-east-1",
        max_keys: int = _MAX_KEYS_DEFAULT,
        verify_signatures: bool = True,
    ):
        self.access_key = access_key
        self.secret_key = secret_key
        self.region = region
        self.max_keys = max_keys
        self.verify_signatures = verify_signatures
        # bucket -> key -> bytes
        self.data: Dict[str, Dict[str, bytes]] = {}
        self.lock = threading.Lock()
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> str:
        stub = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *args) -> None:
                pass

            def _fail(self, status: int, code: str, msg: str) -> None:
                body = (
                    f"<?xml version=\"1.0\"?><Error><Code>{code}</Code>"
                    f"<Message>{msg}</Message></Error>"
                ).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/xml")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _ok(self, body: bytes = b"",
                    content_type: str = "application/xml",
                    status: int = 200) -> None:
                self.send_response(status)
                if body or status != 204:
                    self.send_header("Content-Type", content_type)
                    self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                if body:
                    self.wfile.write(body)

            def _read_body(self) -> bytes:
                n = int(self.headers.get("Content-Length", "0") or "0")
                return self.rfile.read(n) if n else b""

            def _parse(self) -> Tuple[str, str, List[Tuple[str, str]]]:
                """(bucket, key, query) from a path-style request path."""
                raw_path, _, raw_query = self.path.partition("?")
                parts = urllib.parse.unquote(raw_path).lstrip("/").split(
                    "/", 1)
                bucket = parts[0]
                key = parts[1] if len(parts) > 1 else ""
                query = urllib.parse.parse_qsl(
                    raw_query, keep_blank_values=True)
                return bucket, key, query

            def _verify(self, body: bytes) -> Optional[str]:
                """Recompute the SigV4 signature from the raw request;
                returns an error string or None."""
                if not stub.verify_signatures:
                    return None
                auth = self.headers.get("Authorization", "")
                if not auth.startswith("AWS4-HMAC-SHA256 "):
                    return "missing/invalid Authorization"
                try:
                    fields = dict(
                        kv.strip().split("=", 1)
                        for kv in auth[len("AWS4-HMAC-SHA256 "):].split(",")
                    )
                    cred = fields["Credential"].split("/")
                    akey, date, region = cred[0], cred[1], cred[2]
                    signed_headers = fields["SignedHeaders"].split(";")
                    got_sig = fields["Signature"]
                except Exception:
                    return "malformed Authorization"
                if akey != stub.access_key:
                    return "unknown access key"
                amz_date = self.headers.get("x-amz-date", "")
                payload_hash = self.headers.get("x-amz-content-sha256", "")
                if hashlib.sha256(body).hexdigest() != payload_hash:
                    return "payload hash mismatch"
                raw_path, _, raw_query = self.path.partition("?")
                # canonical query: already-encoded pairs, sorted
                pairs = []
                if raw_query:
                    for item in raw_query.split("&"):
                        k, _, v = item.partition("=")
                        pairs.append((k, v))
                cq = "&".join(f"{k}={v}" for k, v in sorted(pairs))
                ch = "".join(
                    f"{h}:{' '.join((self.headers.get(h) or '').split())}\n"
                    for h in signed_headers
                )
                creq = "\n".join([
                    self.command, raw_path, cq, ch,
                    ";".join(signed_headers), payload_hash,
                ])
                scope = f"{date}/{region}/s3/aws4_request"
                sts = string_to_sign(amz_date, scope, creq)
                want = hmac.new(
                    signing_key(stub.secret_key, date, region, "s3"),
                    sts.encode(), hashlib.sha256,
                ).hexdigest()
                if not hmac.compare_digest(want, got_sig):
                    return "signature mismatch"
                return None

            # -- verbs ----------------------------------------------------

            def do_PUT(self) -> None:  # noqa: N802
                body = self._read_body()
                err = self._verify(body)
                if err:
                    return self._fail(403, "SignatureDoesNotMatch", err)
                bucket, key, _q = self._parse()
                src = self.headers.get("x-amz-copy-source")
                with stub.lock:
                    bkt = stub.data.setdefault(bucket, {})
                    if src:
                        sparts = urllib.parse.unquote(
                            src.lstrip("/")).split("/", 1)
                        sbucket = sparts[0]
                        skey = sparts[1] if len(sparts) > 1 else ""
                        sdata = stub.data.get(sbucket, {}).get(skey)
                        if sdata is None:
                            return self._fail(
                                404, "NoSuchKey", f"copy source {src}")
                        bkt[key] = sdata
                        return self._ok(
                            b"<?xml version=\"1.0\"?><CopyObjectResult>"
                            b"<ETag>\"stub\"</ETag></CopyObjectResult>")
                    bkt[key] = body
                self._ok()

            def do_GET(self) -> None:  # noqa: N802
                err = self._verify(b"")
                if err:
                    return self._fail(403, "SignatureDoesNotMatch", err)
                bucket, key, query = self._parse()
                qd = dict(query)
                if not key and qd.get("list-type") == "2":
                    return self._list(bucket, qd)
                with stub.lock:
                    data = stub.data.get(bucket, {}).get(key)
                if data is None:
                    return self._fail(404, "NoSuchKey", key)
                self._ok(data, content_type="application/octet-stream")

            def do_HEAD(self) -> None:  # noqa: N802
                bucket, key, _q = self._parse()
                with stub.lock:
                    exists = key in stub.data.get(bucket, {})
                self.send_response(200 if exists else 404)
                self.send_header("Content-Length", "0")
                self.end_headers()

            def do_DELETE(self) -> None:  # noqa: N802
                err = self._verify(b"")
                if err:
                    return self._fail(403, "SignatureDoesNotMatch", err)
                bucket, key, _q = self._parse()
                with stub.lock:
                    stub.data.get(bucket, {}).pop(key, None)
                self._ok(status=204)

            def _list(self, bucket: str, qd: Dict[str, str]) -> None:
                prefix = qd.get("prefix", "")
                token = qd.get("continuation-token", "")
                with stub.lock:
                    keys = sorted(
                        k for k in stub.data.get(bucket, {})
                        if k.startswith(prefix)
                    )
                if token:
                    keys = [k for k in keys if k > token]
                page = keys[: stub.max_keys]
                truncated = len(keys) > len(page)
                parts = [
                    "<?xml version=\"1.0\"?>",
                    "<ListBucketResult>",
                    f"<IsTruncated>{'true' if truncated else 'false'}"
                    "</IsTruncated>",
                ]
                for k in page:
                    parts.append(f"<Contents><Key>{k}</Key></Contents>")
                if truncated and page:
                    parts.append(
                        f"<NextContinuationToken>{page[-1]}"
                        "</NextContinuationToken>")
                parts.append("</ListBucketResult>")
                self._ok("".join(parts).encode())

        self._httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="s3-stub", daemon=True)
        self._thread.start()
        return self.endpoint

    @property
    def port(self) -> int:
        assert self._httpd is not None
        return self._httpd.server_address[1]

    @property
    def endpoint(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

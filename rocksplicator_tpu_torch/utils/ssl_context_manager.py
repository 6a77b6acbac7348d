"""Refreshable TLS contexts + per-connection auth for the RPC plane.
(The port's copy of ``rocksplicator_tpu/utils/ssl_context_manager.py``.)

Reference: common/ssl_context_manager.{h,cpp} — a periodically-refreshed
SSLContext picked up by the thrift client pool/server
(thrift_client_pool.h:254-290 configures SSL on channels). Here:

- ``SslContextManager`` owns ONE ``ssl.SSLContext`` and reloads the
  cert chain into it when the cert/key/CA files change on disk (checked
  at most every ``refresh_interval`` seconds). Reloading into the same
  context object means in-flight asyncio servers pick the new certs up
  for every subsequent handshake without rebinding.
- Mutual TLS IS the per-connection auth: with ``ca_path`` set, the
  server requires and verifies a client certificate signed by that CA
  (``verify_mode=CERT_REQUIRED``), and clients verify the server chain.
- **Role binding**: CA membership alone would let any cluster cert
  impersonate any peer (a stolen CLIENT cert presented as a server).
  Minted certs carry an ExtendedKeyUsage of serverAuth or clientAuth,
  and ``check_peer_role(ssl_object)`` verifies the peer's EKU matches
  the side it is playing — the RPC server and client both call it
  right after the handshake and drop mismatched peers.
- Refresh-thread ownership is REFCOUNTED: every ``ensure_auto_refresh``
  must be paired with a ``release_auto_refresh`` (servers and client
  pools share managers; the thread stops when the last user releases).
"""

from __future__ import annotations

import logging
import os
import ssl
import threading
import time
from typing import Optional, Tuple

log = logging.getLogger(__name__)

DEFAULT_REFRESH_INTERVAL = 300.0


class SslContextManager:
    """One refreshable context, server- or client-side."""

    def __init__(
        self,
        cert_path: str,
        key_path: str,
        ca_path: Optional[str] = None,
        server_side: bool = True,
        refresh_interval: float = DEFAULT_REFRESH_INTERVAL,
        check_hostname: bool = False,
    ):
        self._cert_path = cert_path
        self._key_path = key_path
        self._ca_path = ca_path
        self._server_side = server_side
        self._refresh_interval = refresh_interval
        self._lock = threading.Lock()
        self._last_check = 0.0
        self._mtimes: Tuple = ()
        if server_side:
            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        else:
            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
            # RPC peers are addressed by IP from shard maps; identity is
            # proven by the CA-signed cert, not the hostname
            ctx.check_hostname = check_hostname
            if ca_path is None:
                # encrypt-without-verify mode (PROTOCOL_TLS_CLIENT
                # defaults to CERT_REQUIRED, which would fail every
                # handshake with no CA loaded)
                ctx.verify_mode = ssl.CERT_NONE
        self._ctx = ctx
        self._refresh_thread: Optional[threading.Thread] = None
        self._refresh_cond = threading.Condition(self._lock)
        self._refresh_users = 0
        self._load(initial=True)

    # -- internals ---------------------------------------------------------

    def _file_mtimes(self) -> Tuple:
        out = []
        for p in (self._cert_path, self._key_path, self._ca_path):
            if p is None:
                out.append(None)
                continue
            try:
                out.append(os.path.getmtime(p))
            except OSError:
                out.append(-1)
        return tuple(out)

    def _load(self, initial: bool = False) -> None:
        mtimes = self._file_mtimes()
        if not initial and mtimes == self._mtimes:
            return
        ca_changed = (
            not initial and self._ca_path is not None
            and mtimes[2] != self._mtimes[2]
        )
        self._ctx.load_cert_chain(self._cert_path, self._key_path)
        if self._ca_path:
            self._ctx.load_verify_locations(self._ca_path)
            if self._server_side:
                # mutual TLS: the client must present a CA-signed cert
                self._ctx.verify_mode = ssl.CERT_REQUIRED
        self._mtimes = mtimes
        if ca_changed:
            # load_verify_locations ACCUMULATES trust anchors on a live
            # context; rotating a CA to DISTRUST the old one requires a
            # process restart (asyncio pins the context object).
            log.warning(
                "ssl CA file %s changed: new CA added, but previously "
                "trusted CAs remain trusted until process restart",
                self._ca_path,
            )
        if not initial:
            log.info("ssl context refreshed from %s", self._cert_path)

    # -- API ---------------------------------------------------------------

    def get(self) -> ssl.SSLContext:
        """The context, refreshed from disk if files changed and the
        refresh interval elapsed. Always the SAME object — safe to hand
        to a long-lived asyncio server once."""
        if self._refresh_thread is not None and self._refresh_thread.is_alive():
            # the background thread owns refresh: never do disk IO on the
            # caller (clients call get() inside the asyncio event loop —
            # a blocking cert reload there stalls every in-flight RPC).
            # A DEAD thread (timed-out close, crashed loop) must not
            # disable refresh silently — fall through to inline mode.
            return self._ctx
        now = time.monotonic()
        with self._lock:
            if now - self._last_check >= self._refresh_interval:
                self._last_check = now
                try:
                    self._load()
                except (OSError, ssl.SSLError):
                    log.exception("ssl context refresh failed; keeping old")
        return self._ctx

    def force_refresh(self) -> None:
        with self._lock:
            self._last_check = time.monotonic()
            self._load()

    def ensure_auto_refresh(self) -> None:
        """Register a user of the background refresh thread and start it
        if needed. Servers need it because they call get() once at bind
        time; clients need it so get() on the event loop NEVER does disk
        IO. Pair every call with release_auto_refresh() — managers are
        shared across servers and pools, so ownership is refcounted.
        All lifecycle transitions happen under one lock: a release
        racing a fresh claim can never strand the new claimant without
        a live thread (the loop re-checks the user count every wake)."""
        if self._refresh_interval <= 0:
            return
        with self._lock:
            self._refresh_users += 1
            if (self._refresh_thread is not None
                    and self._refresh_thread.is_alive()):
                return
            self._refresh_thread = threading.Thread(
                target=self._refresh_loop, name="ssl-refresh", daemon=True)
            self._refresh_thread.start()

    def _refresh_loop(self) -> None:
        me = threading.current_thread()
        with self._lock:
            while True:
                if self._refresh_users <= 0 or self._refresh_thread is not me:
                    if self._refresh_thread is me:
                        self._refresh_thread = None
                    return
                # Condition releases the lock while waiting; release /
                # close notify to end the wait early
                self._refresh_cond.wait(self._refresh_interval)
                if self._refresh_users <= 0 or self._refresh_thread is not me:
                    if self._refresh_thread is me:
                        self._refresh_thread = None
                    return
                self._last_check = time.monotonic()
                try:
                    self._load()
                except (OSError, ssl.SSLError):
                    log.exception("ssl auto-refresh failed; keeping old")

    def release_auto_refresh(self) -> None:
        """Drop one refresh-thread user; the thread exits at zero."""
        with self._lock:
            if self._refresh_users > 0:
                self._refresh_users -= 1
            if self._refresh_users > 0:
                return
            self._refresh_cond.notify_all()
            thread = self._refresh_thread
        if thread is not None and thread is not threading.current_thread():
            # prompt, bounded reap; a re-claim racing this join keeps the
            # thread alive (it re-checks users) and the join just times out
            thread.join(timeout=2.0)

    def close(self) -> None:
        """Stop the refresh thread unconditionally (final teardown)."""
        with self._lock:
            self._refresh_users = 0
            self._refresh_cond.notify_all()
            thread = self._refresh_thread
        if thread is not None and thread is not threading.current_thread():
            thread.join(timeout=2.0)
            if thread.is_alive():
                log.warning("ssl-refresh thread did not stop in time")


def _new_key():
    from cryptography.hazmat.primitives.asymmetric import rsa

    return rsa.generate_private_key(public_exponent=65537, key_size=2048)


def _write_key(key, path: str) -> None:
    from cryptography.hazmat.primitives import serialization

    with open(path, "wb") as f:
        f.write(key.private_bytes(
            serialization.Encoding.PEM,
            serialization.PrivateFormat.TraditionalOpenSSL,
            serialization.NoEncryption(),
        ))


def _write_cert(cert, path: str) -> None:
    from cryptography.hazmat.primitives import serialization

    with open(path, "wb") as f:
        f.write(cert.public_bytes(serialization.Encoding.PEM))


def _issue_cert(ca_key, issuer_name, cn: str,
                san_ip: Optional[str] = "127.0.0.1",
                role: Optional[str] = None):
    """One leaf cert under ``issuer_name``, signed by ``ca_key`` —
    the single minting recipe shared by make_test_ca and reissue_cert.
    ``role`` ∈ {"server", "client"} stamps the matching ExtendedKeyUsage
    so a stolen client cert cannot impersonate a server (check_peer_role
    enforces it after the handshake)."""
    import datetime

    from cryptography import x509
    from cryptography.hazmat.primitives import hashes
    from cryptography.x509.oid import ExtendedKeyUsageOID, NameOID

    now = datetime.datetime.now(datetime.timezone.utc)
    key = _new_key()
    builder = (
        x509.CertificateBuilder()
        .subject_name(x509.Name(
            [x509.NameAttribute(NameOID.COMMON_NAME, cn)]))
        .issuer_name(issuer_name)
        .public_key(key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now - datetime.timedelta(minutes=5))
        .not_valid_after(now + datetime.timedelta(days=1))
    )
    if san_ip:
        import ipaddress

        builder = builder.add_extension(
            x509.SubjectAlternativeName(
                [x509.IPAddress(ipaddress.ip_address(san_ip))]),
            critical=False,
        )
    if role is not None:
        oid = (ExtendedKeyUsageOID.SERVER_AUTH if role == "server"
               else ExtendedKeyUsageOID.CLIENT_AUTH)
        builder = builder.add_extension(
            x509.ExtendedKeyUsage([oid]), critical=False)
    return key, builder.sign(ca_key, hashes.SHA256())


# dotted-string OIDs as returned by ssl.SSLObject.getpeercert()
_EKU_SERVER_AUTH = "1.3.6.1.5.5.7.3.1"
_EKU_CLIENT_AUTH = "1.3.6.1.5.5.7.3.2"


class PeerRoleError(Exception):
    """Peer presented a CA-valid cert minted for the WRONG role."""


def check_peer_role(ssl_object, expect_role: str) -> None:
    """Post-handshake role binding: the peer's cert must carry the EKU
    for the side it is playing (``expect_role`` ∈ {"server", "client"}).
    Certs WITHOUT any EKU pass (externally-provisioned certs predating
    role stamping); certs WITH an EKU must include the right one.

    OpenSSL's default X509 purpose check already rejects wrong-EKU peers
    during the handshake in common configurations; this is the explicit
    application-layer backstop so role binding doesn't silently depend
    on a library default. ``ssl.SSLObject.getpeercert()``'s dict form
    does NOT expose EKUs, so the DER cert is parsed with the
    ``cryptography`` package (the same one that mints the certs).

    No-op when there is no peer cert OR the connection did not verify
    the peer (encrypt-only mode: server with no client-cert
    requirement, or client with verification off — an UNVERIFIED cert's
    EKU proves nothing, and binary_form getpeercert returns it even
    when verification is off)."""
    if ssl_object is None:
        return
    if ssl_object.context.verify_mode == ssl.CERT_NONE:
        return
    der = ssl_object.getpeercert(binary_form=True)
    if not der:
        return
    from cryptography import x509
    from cryptography.x509.oid import ExtensionOID

    cert = x509.load_der_x509_certificate(der)
    try:
        eku = cert.extensions.get_extension_for_oid(
            ExtensionOID.EXTENDED_KEY_USAGE).value
    except x509.ExtensionNotFound:
        return
    want = (_EKU_SERVER_AUTH if expect_role == "server"
            else _EKU_CLIENT_AUTH)
    have = {oid.dotted_string for oid in eku}
    if want not in have:
        raise PeerRoleError(
            f"peer cert EKU {sorted(have)} does not permit role "
            f"{expect_role!r}"
        )


def make_test_ca(dir_path: str, common_name: str = "rstpu-test-ca"):
    """Generate a CA + signed server/client certs for tests (the
    reference's tests ship fixture certs; we mint them fresh with the
    ``cryptography`` package). Returns a dict of file paths."""
    import datetime

    from cryptography import x509
    from cryptography.hazmat.primitives import hashes
    from cryptography.x509.oid import NameOID

    os.makedirs(dir_path, exist_ok=True)
    now = datetime.datetime.now(datetime.timezone.utc)
    ca_key = _new_key()
    ca_name = x509.Name(
        [x509.NameAttribute(NameOID.COMMON_NAME, common_name)])
    ca_cert = (
        x509.CertificateBuilder()
        .subject_name(ca_name).issuer_name(ca_name)
        .public_key(ca_key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now - datetime.timedelta(minutes=5))
        .not_valid_after(now + datetime.timedelta(days=1))
        .add_extension(x509.BasicConstraints(ca=True, path_length=0),
                       critical=True)
        .sign(ca_key, hashes.SHA256())
    )
    paths = {
        "ca_cert": os.path.join(dir_path, "ca.pem"),
        "ca_key": os.path.join(dir_path, "ca.key"),
    }
    _write_cert(ca_cert, paths["ca_cert"])
    _write_key(ca_key, paths["ca_key"])
    for role in ("server", "client"):
        key, cert = _issue_cert(ca_key, ca_name, f"rstpu-test-{role}",
                                role=role)
        paths[f"{role}_cert"] = os.path.join(dir_path, f"{role}.pem")
        paths[f"{role}_key"] = os.path.join(dir_path, f"{role}.key")
        _write_cert(cert, paths[f"{role}_cert"])
        _write_key(key, paths[f"{role}_key"])
    return paths


def reissue_cert(certs: dict, role: str, out_cert: str, out_key: str,
                 san_ip: str = "127.0.0.1") -> None:
    """Mint a NEW cert for ``role`` under an existing test CA (rotation
    scenarios: genuinely different bytes, same trust chain)."""
    from cryptography import x509
    from cryptography.hazmat.primitives import serialization

    with open(certs["ca_key"], "rb") as f:
        ca_key = serialization.load_pem_private_key(f.read(), password=None)
    with open(certs["ca_cert"], "rb") as f:
        ca_cert = x509.load_pem_x509_certificate(f.read())
    key, cert = _issue_cert(
        ca_key, ca_cert.subject, f"rstpu-test-{role}-rotated", san_ip,
        role=role if role in ("server", "client") else None)
    _write_cert(cert, out_cert)
    _write_key(key, out_key)

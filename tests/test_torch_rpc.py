"""The port's RPC core against the JAX package's: the same seeded inputs
give byte-identical frames, serde headers and payloads, the same deadline
and tenant stamps and the same admission verdicts; a port client talks to
a reference server and a reference client to a port server, over both
transports that ``RSTPU_TRANSPORT`` selects across processes (tcp, uds),
with the same replies, ``RpcApplicationError`` codes and timeouts.
Tolerance 0.
"""

import asyncio
import importlib
import json
import random
import socket
import threading

import pytest

import rocksplicator_tpu_torch.utils.misc as port_misc
import rocksplicator_tpu.utils.misc as ref_misc

PACKAGES = ("rocksplicator_tpu", "rocksplicator_tpu_torch")


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


@pytest.fixture(autouse=True)
def _fresh_port_singletons():
    from torch_parity import reset_observability

    import rocksplicator_tpu_torch
    from rocksplicator_tpu_torch.rpc.admission import TenantAdmission

    reset_observability(rocksplicator_tpu_torch, sample_rate=0.0)
    TenantAdmission.reset_for_test()
    yield
    TenantAdmission.reset_for_test()


def seeded_messages(seed: int, n: int = 24):
    """Nested messages with binary blobs of seeded sizes, from a few bytes
    to past the compression threshold, some of them compressible."""
    rng = random.Random(seed)
    out = []
    for i in range(n):
        size = rng.choice([0, 7, 300, 5000, 20000, 70000])
        if rng.random() < 0.5:
            blob = bytes(rng.getrandbits(8) for _ in range(min(size, 512)))
            blob = (blob * (size // max(1, len(blob)) + 1))[:size]
        else:
            blob = rng.randbytes(size)
        out.append({
            "id": i, "method": rng.choice(["replicate", "echo", "get"]),
            "args": {"db_name": f"seg{rng.randrange(10**5):05d}",
                     "updates": [{"seq_no": rng.randrange(1 << 40),
                                  "raw_data": blob},
                                 {"seq_no": i, "raw_data": b"x" * i}],
                     "n": rng.random(), "flag": bool(i % 2), "none": None,
                     "text": "ünï☃" * (i % 3)}})
    return out


# ---------------------------------------------------------------------------
# wire bytes
# ---------------------------------------------------------------------------


def test_serde_bytes_equal_reference():
    for msg in seeded_messages(11):
        want = mod("rocksplicator_tpu", "rpc.serde").encode_message(msg)
        got = mod("rocksplicator_tpu_torch", "rpc.serde").encode_message(msg)
        assert got[0] == want[0]
        assert [bytes(c) for c in got[1]] == [bytes(c) for c in want[1]]
    for bad in ({"$bin": [0, 1]}, {"a": [{"$bin": 3}]}):
        for pkg in PACKAGES:
            with pytest.raises(ValueError):
                mod(pkg, "rpc.serde").encode_message(bad)


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_frame_bytes_equal_reference(native, monkeypatch):
    """Header struct, flags, the rlz- (native codec) or zlib-compressed
    payload region: every frame part is byte-equal, and each package's
    FrameBuffer decodes the other's frames."""
    ref_rlz = mod("rocksplicator_tpu", "storage.rlz")
    port_rlz = mod("rocksplicator_tpu_torch", "storage.rlz")
    assert ref_rlz.native_available() and port_rlz.native_available()
    if not native:
        for m in (ref_rlz, port_rlz):
            monkeypatch.setattr(m, "native_available", lambda: False)
    flags_seen = set()
    for msg in seeded_messages(12):
        frames = {}
        for pkg in PACKAGES:
            header, chunks = mod(pkg, "rpc.serde").encode_message(msg)
            parts, n = mod(pkg, "rpc.framing").encode_wire_parts(
                header, chunks)
            frames[pkg] = b"".join(bytes(p) for p in parts)
            assert len(frames[pkg]) == n
        assert frames["rocksplicator_tpu_torch"] == frames["rocksplicator_tpu"]
        wire = frames["rocksplicator_tpu"]
        flags_seen.add(int.from_bytes(wire[2:4], "little"))
        for reader, writer in (PACKAGES, PACKAGES[::-1]):
            fb = mod(reader, "rpc.framing").FrameBuffer(1024)
            view = fb.recv_view(len(frames[writer]))
            view[:len(frames[writer])] = frames[writer]
            view.release()
            fb.advance(len(frames[writer]))
            [(h, p)] = fb.pop_frames()
            back = mod(reader, "rpc.serde").decode_message(h, p)
            assert back["id"] == msg["id"]
            assert bytes(back["args"]["updates"][0]["raw_data"]) \
                == msg["args"]["updates"][0]["raw_data"]
    # plain frames and the codec's compressed ones both occurred
    assert flags_seen == ({0, 2} if native else {0, 1}), flags_seen


def test_deadline_and_admission_equal_reference():
    """The wire keys, the killswitch, and a seeded sequence of admission
    verdicts (ops and bytes buckets on a scripted clock, retry-after hints
    jittered by ``seeded_rng``) are the reference's."""
    ref_dl = mod("rocksplicator_tpu", "rpc.deadline")
    port_dl = mod("rocksplicator_tpu_torch", "rpc.deadline")
    for name in ("DEADLINE_KEY", "TENANT_KEY", "DEADLINE_EXCEEDED",
                 "RETRY_LATER"):
        assert getattr(port_dl, name) == getattr(ref_dl, name)
    assert mod("rocksplicator_tpu_torch", "observability.context").TRACE_KEY \
        == mod("rocksplicator_tpu", "observability.context").TRACE_KEY
    for pkg_dl in (ref_dl, port_dl):
        with pkg_dl.request_scope(pkg_dl.Deadline.after_ms(-1.0), "t1"):
            assert pkg_dl.current_deadline().expired
            assert pkg_dl.current_tenant() == "t1"
        assert pkg_dl.current_deadline() is None

    def verdicts(pkg):
        adm = mod(pkg, "rpc.admission")
        retry = mod(pkg, "utils.retry_policy")
        now = [0.0]
        a = adm.TenantAdmission(
            ops_per_sec=50.0, bytes_per_sec=4000.0, clock=lambda: now[0],
            rng=retry.seeded_rng("RSTPU_TEST_UNSET_SEED_VAR"))
        a.set_quota("vip", 500.0, 0.0)
        rng = random.Random(5)
        out = []
        for _ in range(400):
            now[0] += rng.choice([0.0, 0.001, 0.01, 0.05])
            tenant = rng.choice(["a", "b", "vip", None, "bad tag/é" * 5])
            ok, after = a.admit(tenant, cost_bytes=rng.choice([0, 10, 900]))
            if ok and rng.random() < 0.3:
                a.debit_bytes(tenant, rng.randrange(2000))
            out.append((ok, after, adm.sanitize_tenant(tenant)))
        return out

    # seeded_rng of an unset variable is seeded from os.urandom: pin both
    import os

    os.environ["RSTPU_TEST_UNSET_SEED_VAR"] = "41"
    try:
        want, got = verdicts(PACKAGES[0]), verdicts(PACKAGES[1])
    finally:
        del os.environ["RSTPU_TEST_UNSET_SEED_VAR"]
    assert got == want
    assert any(not ok for ok, _a, _t in got) and any(ok for ok, _a, _t in got)


class _Recorder:
    """A TCP listener that records the first frame a client sends and
    never answers (the client's call then times out)."""

    def __init__(self):
        self.sock = socket.socket()
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(4)
        self.port = self.sock.getsockname()[1]
        self.frames = []
        self._conns = []
        threading.Thread(target=self._serve, daemon=True).start()

    def _serve(self):
        while True:
            try:
                conn, _ = self.sock.accept()
            except OSError:
                return
            self._conns.append(conn)
            buf = b""
            while len(buf) < 12 or len(buf) < 12 + int.from_bytes(
                    buf[4:8], "little") + int.from_bytes(buf[8:12], "little"):
                chunk = conn.recv(65536)
                if not chunk:
                    break
                buf += chunk
            self.frames.append(buf)

    def close(self):
        self.sock.close()
        for c in self._conns:
            c.close()


def test_client_stamps_equal_reference():
    """The frame a client sends for a call with an explicit deadline and
    tenant is byte-equal (no trace context: sampling is off), and the
    call raises the client package's RpcTimeout."""
    frames = {}
    for pkg in PACKAGES:
        rec = _Recorder()
        rpc = mod(pkg, "rpc")

        async def go():
            pool = rpc.RpcClientPool()
            try:
                with pytest.raises(rpc.RpcTimeout):
                    await pool.call("127.0.0.1", rec.port, "echo",
                                    {"text": "hi", "blob": b"\x00\x01"},
                                    timeout=0.3, deadline_ms=1234.56789,
                                    tenant="tenant-a")
            finally:
                await pool.close()

        try:
            rpc.IoLoop.default().run_sync(go())
        finally:
            rec.close()
        assert len(rec.frames) == 1
        frames[pkg] = rec.frames[0]
    assert frames[PACKAGES[1]] == frames[PACKAGES[0]]
    header = json.loads(frames[PACKAGES[0]][12:12 + int.from_bytes(
        frames[PACKAGES[0]][4:8], "little")])
    assert header["deadline"] == 1234.568 and header["tenant"] == "tenant-a"


# ---------------------------------------------------------------------------
# mixed client / server pairs
# ---------------------------------------------------------------------------


def _handlers(pkg):
    errors = mod(pkg, "rpc.errors")

    class EchoHandler:
        async def handle_echo(self, text="", blob=b""):
            return {"text": text, "blob": bytes(blob) + b"!", "pkg": pkg}

        async def handle_fail(self, code="BOOM"):
            raise errors.RpcApplicationError(code, "requested failure",
                                             {"k": 1})

        async def handle_slow(self, delay=1.0):
            await asyncio.sleep(delay)
            return {"done": True}

        async def handle_crash(self):
            raise RuntimeError("unexpected")

    return EchoHandler()


def _outcome(coro_fn, rpc):
    """(kind, detail) of one client call, comparable across packages."""
    async def go():
        try:
            r = await coro_fn()
        except rpc.RpcApplicationError as e:
            return ("app_error", e.code, e.data)
        except rpc.RpcTimeout:
            return ("timeout",)
        r = dict(r)
        r.pop("pkg", None)
        return ("ok", {k: bytes(v) if isinstance(v, memoryview) else v
                       for k, v in r.items()})
    return go


@pytest.mark.parametrize("transport", ["tcp", "uds"])
@pytest.mark.parametrize("client_pkg,server_pkg", [
    (PACKAGES[0], PACKAGES[0]), (PACKAGES[1], PACKAGES[1]),
    (PACKAGES[1], PACKAGES[0]), (PACKAGES[0], PACKAGES[1])],
    ids=["ref-ref", "port-port", "port-client", "port-server"])
def test_mixed_client_server(client_pkg, server_pkg, transport, monkeypatch,
                             tmp_path):
    monkeypatch.setenv("RSTPU_TRANSPORT", transport)
    monkeypatch.setenv("RSTPU_UDS_DIR", str(tmp_path / "uds"))
    srpc, crpc = mod(server_pkg, "rpc"), mod(client_pkg, "rpc")
    server = srpc.RpcServer(port=0)
    server.add_handler(_handlers(server_pkg))
    server.start()
    calls = [
        ("echo", {"text": "hi", "blob": bytes(range(256)) * 40}, {}),
        ("fail", {"code": "SOURCE_NOT_FOUND"}, {}),
        ("crash", {}, {}),
        ("nope", {}, {}),
        ("slow", {"delay": 5.0}, {"timeout": 0.2}),
        ("echo", {"text": "late"}, {"deadline_ms": -1.0}),
        ("echo", {"text": "in time"}, {"deadline_ms": 60_000.0,
                                       "tenant": "t"}),
    ]

    async def run_all():
        pool = crpc.RpcClientPool()
        out = []
        try:
            for method, args, kw in calls:
                out.append(await _outcome(
                    lambda: pool.call("127.0.0.1", server.port, method,
                                      args, **kw), crpc)())
            client = pool.peek("127.0.0.1", server.port)
            out.append(("scheme", client.transport_scheme))
            # many calls multiplex on one connection
            rs = await asyncio.gather(*(
                pool.call("127.0.0.1", server.port, "echo", {"text": str(i)})
                for i in range(20)))
            out.append(("pkgs", sorted({r["pkg"] for r in rs})))
        finally:
            await pool.close()
        return out

    try:
        got = crpc.IoLoop.default().run_sync(run_all())
    finally:
        server.stop()
    blob = bytes(range(256)) * 40 + b"!"
    assert got == [
        ("ok", {"text": "hi", "blob": blob}),
        ("app_error", "SOURCE_NOT_FOUND", {"k": 1}),
        ("app_error", "INTERNAL", got[2][2]),
        ("app_error", "NO_SUCH_METHOD", got[3][2]),
        ("timeout",),
        ("app_error", "DEADLINE_EXCEEDED", got[5][2]),
        ("ok", {"text": "in time", "blob": b"!"}),
        ("scheme", transport),
        ("pkgs", [server_pkg]),
    ]


def test_transport_policy_equal_reference(monkeypatch, tmp_path):
    for value in ("", "tcp", "uds", "loopback", "bogus"):
        monkeypatch.setenv("RSTPU_TRANSPORT", value)
        monkeypatch.setenv("RSTPU_UDS_DIR", str(tmp_path))
        res = []
        for pkg in PACKAGES:
            tr = mod(pkg, "rpc.transport")
            try:
                res.append((tr.transport_policy(), tr.uds_path_for_port(7),
                            tr.uds_default_dir()))
            except mod(pkg, "rpc.errors").RpcTransportConfigError as e:
                res.append(("config_error", str(e)))
        assert res[0] == res[1], value
    for url in ("tcp://h:1", "uds:///tmp/x.sock", "uds://rel.sock",
                "loopback://k", "h:9", "tcp://nohost"):
        got = []
        for pkg in PACKAGES:
            tr = mod(pkg, "rpc.transport")
            try:
                ep = tr.parse_endpoint(url)
                got.append((ep.scheme, ep.host, ep.port, ep.path, str(ep)))
            except mod(pkg, "rpc.errors").RpcTransportConfigError as e:
                got.append(("config_error", str(e)))
        assert got[0] == got[1], url


def test_local_ip_equal_reference(monkeypatch):
    assert port_misc.local_ip() == ref_misc.local_ip()
    monkeypatch.setenv("RSTPU_LOCAL_IP", "10.1.2.3")
    assert port_misc.local_ip() == ref_misc.local_ip() == "10.1.2.3"


def test_rpc_spans_equal_reference():
    """With every root kept, one pooled call traces the reference's span
    tree in each package's own collector: ``rpc.pool.acquire`` with its
    ``rpc.pool.connect``, ``rpc.rtt`` and the server's ``rpc.server``."""
    from torch_parity import reset_observability, span_shape

    import rocksplicator_tpu
    import rocksplicator_tpu_torch

    shapes = []
    for pkg, top in zip(PACKAGES, (rocksplicator_tpu,
                                   rocksplicator_tpu_torch)):
        reset_observability(top)
        rpc = mod(pkg, "rpc")
        server = rpc.RpcServer(port=0)
        server.add_handler(_handlers(pkg))
        server.start()

        async def go():
            pool = rpc.RpcClientPool()
            try:
                await pool.call("127.0.0.1", server.port, "echo",
                                {"text": "x"})
                with pytest.raises(rpc.RpcApplicationError):
                    await pool.call("127.0.0.1", server.port, "fail")
            finally:
                await pool.close()

        try:
            rpc.IoLoop.default().run_sync(go())
        finally:
            server.stop()
        shapes.append(span_shape(mod(pkg, "observability.collector"),
                                 prefixes=("rpc.",),
                                 timed=("queue_wait_ms", "peer", "port",
                                        "remote")))
    assert shapes[1] == shapes[0]
    names = {k[0] for k in shapes[0]}
    assert {"rpc.rtt", "rpc.server", "rpc.pool.acquire"} <= names, names

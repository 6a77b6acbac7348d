"""The port's object store, S3 client and retry policy against the JAX
package's: the local store's round trip, batch transfers, listing and
factory cache, with objects one package put read back by the other; the
SigV4 client against both packages' in-process S3 stubs crosswise (the
canonical request, ``string_to_sign``, ``signing_key`` and the
Authorization header byte-equal, list pagination, keys with special
characters, a bad signature rejected); and the retry schedule, backoff
steps and ``retry_call`` under a seed. Tolerance 0.
"""

import importlib
import os
import random

import pytest

PACKAGES = ("rocksplicator_tpu", "rocksplicator_tpu_torch")
CROSS = [(a, b) for a in PACKAGES for b in PACKAGES]
CROSS_IDS = ["ref-ref", "ref-port", "port-ref", "port-port"]


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


@pytest.fixture(autouse=True)
def _fresh_port_singletons():
    from torch_parity import reset_observability

    import rocksplicator_tpu_torch

    reset_observability(rocksplicator_tpu_torch, sample_rate=0.0)
    mod(PACKAGES[0], "testing.failpoints").reset_for_test()
    yield
    for pkg in PACKAGES:
        store = mod(pkg, "utils.objectstore")
        with store._store_cache_lock:
            store._store_cache.clear()


def blobs(seed: int, n: int = 12):
    rng = random.Random(seed)
    return {f"dir{i % 3}/obj-{i:03d}.sst": rng.randbytes(rng.randrange(1, 5000))
            for i in range(n)}


# ---------------------------------------------------------------------------
# the local store
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("writer,reader", CROSS, ids=CROSS_IDS)
def test_local_store_round_trip_crosswise(writer, reader, tmp_path):
    """Objects one package's local store put — single and batch puts, from
    bytes and from files — list, read, copy and delete the same through
    the other package's store on the same root."""
    root = str(tmp_path / "bucket")
    wstore = mod(writer, "utils.objectstore").LocalObjectStore(root)
    rstore = mod(reader, "utils.objectstore").LocalObjectStore(root)
    data = blobs(3)
    src = tmp_path / "src"
    src.mkdir()
    for i, (key, blob) in enumerate(sorted(data.items())):
        if i % 2:
            wstore.put_object_bytes(key, blob)
        else:
            path = src / key.replace("/", "_")
            path.write_bytes(blob)
            wstore.put_object(str(path), key)
    batch = []
    for i in range(4):
        path = src / f"batch-{i}.sst"
        path.write_bytes(bytes([i]) * (100 + i))
        batch.append(str(path))
    keys = wstore.put_objects(batch, "batch/", parallelism=2)
    assert keys == [f"batch/batch-{i}.sst" for i in range(4)]
    assert rstore.list_objects("dir1/") == sorted(
        k for k in data if k.startswith("dir1/"))
    assert rstore.list_objects("") == sorted(list(data) + keys)
    for key, blob in data.items():
        assert rstore.get_object_bytes(key) == blob
    out = tmp_path / "out"
    for direct in (False, True):
        got = out / f"one-{direct}"
        rstore.get_object("dir0/obj-000.sst", str(got), direct_io=direct)
        assert got.read_bytes() == data["dir0/obj-000.sst"]
    fetched = rstore.get_objects("batch/", str(out / "batch"), parallelism=2)
    assert [os.path.basename(p) for p in fetched] == [
        f"batch-{i}.sst" for i in range(4)]
    assert all(open(p, "rb").read() == bytes([i]) * (100 + i)
               for i, p in enumerate(fetched))
    rstore.copy_object("dir2/obj-002.sst", "copies/c.sst")
    assert wstore.get_object_bytes("copies/c.sst") == data["dir2/obj-002.sst"]
    rstore.delete_object("copies/c.sst")
    errors = (mod(reader, "utils.objectstore").ObjectStoreError,)
    with pytest.raises(errors):
        rstore.delete_object("copies/c.sst")
    with pytest.raises(errors):
        rstore.get_object_bytes("../escape")
    with pytest.raises(errors):
        rstore.put_objects([batch[0], batch[0]], "dup/")


@pytest.mark.parametrize("pkg", PACKAGES)
def test_store_factory_and_failpoints(pkg, tmp_path):
    """``build_object_store`` caches by (uri, rate limit) and resolves the
    local schemes as the reference does; ``objectstore.get`` / ``put``
    trip in the package's own failpoint table, and a batch fetch that
    fails removes what it produced and names the key."""
    store_mod = mod(pkg, "utils.objectstore")
    fp = mod(pkg, "testing.failpoints")
    a = store_mod.build_object_store(f"local://{tmp_path}/s")
    assert store_mod.build_object_store(f"local://{tmp_path}/s") is a
    assert store_mod.build_object_store(f"local://{tmp_path}/s", 1e9) is not a
    assert isinstance(store_mod.build_object_store(str(tmp_path / "bare")),
                      store_mod.LocalObjectStore)
    a.put_object_bytes("p/x", b"1")
    a.put_object_bytes("p/y", b"2")
    fp.activate("objectstore.get", "fail_first:50")
    try:
        with pytest.raises(store_mod.ObjectStoreError) as ei:
            a.get_objects("p/", str(tmp_path / "dl"), parallelism=1)
        assert "p/" in str(ei.value)
        assert os.listdir(tmp_path / "dl") == []
    finally:
        fp.deactivate("objectstore.get")
    fp.activate("objectstore.put", "fail_nth:1")
    try:
        with pytest.raises(fp.FailpointError):
            a.put_object_bytes("p/z", b"3")
        a.put_object_bytes("p/z", b"3")
    finally:
        fp.deactivate("objectstore.put")
    assert fp.trip_counts()["objectstore.put"] == 1
    assert fp.trip_counts()["objectstore.get"] >= 2


# ---------------------------------------------------------------------------
# S3: signatures, and each client against each stub
# ---------------------------------------------------------------------------


def test_sigv4_bytes_equal_reference():
    rng = random.Random(17)
    for _ in range(40):
        secret = rng.randbytes(12).hex()
        date = f"2026{rng.randrange(1, 13):02d}{rng.randrange(1, 29):02d}"
        amz_date = date + f"T{rng.randrange(24):02d}0000Z"
        key = rng.choice(["a b", "ü/ñ+x=1", "k%20", "plain/key.sst", ""])
        query = [("prefix", rng.choice(["", "x y/", "a+b"])),
                 ("list-type", "2")]
        headers = {"host": "127.0.0.1:9000", "x-amz-date": amz_date,
                   "x-amz-content-sha256": rng.randbytes(32).hex(),
                   "X-Amz-Copy-Source": "/b/" + key}
        out = []
        for pkg in PACKAGES:
            s3 = mod(pkg, "utils.s3")
            uri = s3._uri_encode(f"/bucket/{key}", encode_slash=False)
            lower = {h.lower(): v for h, v in headers.items()}
            creq = s3.canonical_request("PUT", uri, query, lower,
                                        sorted(lower), lower[
                                            "x-amz-content-sha256"])
            scope = f"{date}/us-east-1/s3/aws4_request"
            out.append((uri, creq, s3.string_to_sign(amz_date, scope, creq),
                        s3.signing_key(secret, date, "us-east-1", "s3"),
                        s3.sign_request("PUT", uri, query, headers,
                                        lower["x-amz-content-sha256"],
                                        "AKID", secret, "us-east-1",
                                        amz_date)))
        assert out[0] == out[1]


@pytest.fixture()
def stub_factory(monkeypatch):
    monkeypatch.setenv("AWS_ACCESS_KEY_ID", "test-access")
    monkeypatch.setenv("AWS_SECRET_ACCESS_KEY", "test-secret")
    monkeypatch.setenv("RSTPU_RETRY_SEED", "9")
    started = []

    def make(pkg, **kw):
        srv = mod(pkg, "utils.s3_stub").S3StubServer(
            access_key="test-access", secret_key="test-secret", **kw)
        srv.start()
        started.append(srv)
        return srv

    yield make
    for srv in started:
        srv.stop()


SPECIAL_KEYS = ["plain.sst", "with space/x.sst", "plus+eq=/y", "ünï/☃.sst",
                "pct%20lit", "a/b/c/d.tsst", "tilde~_-.x"]


@pytest.mark.parametrize("client_pkg,stub_pkg", CROSS, ids=CROSS_IDS)
def test_s3_client_against_stub_crosswise(client_pkg, stub_pkg, tmp_path,
                                          stub_factory):
    srv = stub_factory(stub_pkg, max_keys=3)
    s3 = mod(client_pkg, "utils.s3")
    client = s3.S3Client("bkt", s3.S3Config(endpoint=srv.endpoint,
                                            region="us-east-1"))
    data = {k: random.Random(k).randbytes(300 + len(k)) for k in SPECIAL_KEYS}
    for key, blob in data.items():
        client.put_object(key, blob)
    # the stub verified every signature and holds the exact bytes
    assert srv.data["bkt"] == data
    # pagination: 3 keys a page
    assert client.list_objects("") == sorted(data)
    assert client.list_objects("a/") == ["a/b/c/d.tsst"]
    for key, blob in data.items():
        assert client.get_object(key) == blob
    path = tmp_path / "f.bin"
    path.write_bytes(b"z" * 70_000)
    assert client.put_object_from_file("big/f.bin", str(path)) == 70_000
    assert client.get_object_to_file("big/f.bin", str(tmp_path / "g")) \
        == 70_000
    assert (tmp_path / "g").read_bytes() == b"z" * 70_000
    client.copy_object("plain.sst", "copy/plain.sst")
    assert srv.data["bkt"]["copy/plain.sst"] == data["plain.sst"]
    assert client.head_object("copy/plain.sst")
    client.delete_object("copy/plain.sst")
    assert not client.head_object("copy/plain.sst")
    with pytest.raises(s3.S3Error) as ei:
        client.get_object("missing")
    assert ei.value.status == 404
    bad = s3.S3Client("bkt", s3.S3Config(endpoint=srv.endpoint,
                                         access_key="test-access",
                                         secret_key="wrong-secret"))
    with pytest.raises(s3.S3Error) as ei:
        bad.put_object("nope", b"x")
    assert ei.value.status == 403 and ei.value.code == "SignatureDoesNotMatch"
    assert "nope" not in srv.data["bkt"]


@pytest.mark.parametrize("writer,reader", CROSS, ids=CROSS_IDS)
def test_s3_object_store_crosswise(writer, reader, tmp_path, stub_factory,
                                   monkeypatch):
    """Objects one package's ``s3://`` store put into one stub are read,
    listed and deleted by the other's store, retrying through a fault
    armed at ``s3.request`` in the reader's own failpoint table."""
    srv = stub_factory(PACKAGES[1])
    monkeypatch.setenv("RSTPU_S3_ENDPOINT", srv.endpoint)
    wstore = mod(writer, "utils.objectstore").build_object_store("s3://b2")
    rstore = mod(reader, "utils.objectstore").build_object_store("s3://b2")
    data = blobs(5, n=6)
    for key, blob in data.items():
        wstore.put_object_bytes(key, blob)
    fp = mod(reader, "testing.failpoints")
    fp.activate("s3.request", "fail_first:2")
    try:
        assert rstore.list_objects("dir") == sorted(data)
    finally:
        fp.deactivate("s3.request")
    assert fp.trip_counts()["s3.request"] == 2
    fetched = rstore.get_objects("dir1/", str(tmp_path / "dl"))
    assert [open(p, "rb").read() for p in fetched] == [
        data[k] for k in sorted(data) if k.startswith("dir1/")]
    for key in data:
        rstore.delete_object(key)
    assert wstore.list_objects("") == []
    with pytest.raises(mod(reader, "utils.objectstore").ObjectStoreError):
        rstore.delete_object("dir0/obj-000.sst")


# ---------------------------------------------------------------------------
# the retry policy
# ---------------------------------------------------------------------------


def test_retry_policy_equal_reference():
    def run(pkg):
        rp = mod(pkg, "utils.retry_policy")
        out = []
        for policy in (rp.RetryPolicy(), rp.RetryPolicy(
                max_attempts=9, base_delay=0.05, max_delay=1.0, floor=0.01),
                rp.RetryPolicy(jitter=False, max_attempts=6),
                rp.RetryPolicy(base_delay=0.0)):
            out.append(policy.schedule(seed=123))
            out.append([policy.cap(a) for a in (0, 1, 5, 60, 5000)])
        sleeps = []
        rng = random.Random(7)
        policy = rp.RetryPolicy(max_attempts=5)
        steps = [rp.backoff_step(policy, a, op="t", rng=rng,
                                 sleep=sleeps.append, hint=h)
                 for a, h in ((0, None), (1, 0.5), (2, None), (3, 2.0),
                              (4, None))]
        out.append((steps, sleeps))
        calls = []

        def flaky():
            calls.append(1)
            if len(calls) < 3:
                raise ConnectionError("transient")
            return "done"

        got = rp.retry_call(flaky, policy=policy, op="t",
                            classify=lambda e: isinstance(e, ConnectionError),
                            rng=random.Random(3), sleep=sleeps.append)
        out.append((got, len(calls), sleeps[-2:]))
        with pytest.raises(ValueError):
            rp.retry_call(lambda: (_ for _ in ()).throw(ValueError("p")),
                          policy=policy, classify=lambda e: False)
        budget = rp.RetryBudget(capacity=2, refill_per_sec=0.0)
        out.append([budget.try_spend() for _ in range(4)])
        out.append(mod(pkg, "utils.stats").Stats.get().get_counter(
            "retry.attempts op=t"))
        return out

    mod(PACKAGES[0], "utils.stats").Stats.reset_for_test()
    assert run(PACKAGES[1]) == run(PACKAGES[0])

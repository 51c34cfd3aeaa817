"""Slice H6a's object stores in the port against the JAX package:
``pw.io.s3``, ``minio`` and ``s3_csv`` over the SigV4 client
(``io/_s3http.py``), and the ``S3Backend``, ``GcsBackend`` and
``AzureBackend`` persistence backends with their clients.

The fakes are the JAX package's own, imported unedited:
``MockS3Handler`` (``tests/test_connectors.py:272``),
``MockAzuriteHandler`` (``:1454``, which recomputes every SharedKey
signature) and ``MockGcsHandler`` (``:1700``); SigV4 is held byte for byte
to the independent signer of ``tests/test_wire_conformance.py:296``, and
to ``tests/torch_fake_services.py``'s verifying endpoint.  Each test runs in
both packages; whole runs compare the two packages' streams.
"""

from __future__ import annotations

import base64
import datetime as _dt
import hashlib
import importlib
import os

import pytest

from tests import torch_cluster_programs as progs
from tests.test_connectors import (  # noqa: F401  (fixtures)
    MockAzuriteHandler,
    MockGcsHandler,
    MockS3Handler,
    mock_azurite,
    mock_gcs,
    mock_s3,
)
from tests.test_wire_conformance import (
    AWS_KEY,
    AWS_REGION,
    AWS_SECRET,
    ScriptedServer,
    _http_capture_handler,
    _independent_sigv4,
)
from tests.torch_fake_services import S3Server

PACKAGES = progs.PACKAGES
each_package = pytest.mark.parametrize("pkg", PACKAGES)


def _settings(pkg, srv):
    http = importlib.import_module(f"{pkg}.io._s3http")
    return http.AwsS3Settings(bucket_name="bkt", access_key="AK", secret_access_key="SK",
                              endpoint=f"http://127.0.0.1:{srv.server_address[1]}", with_path_style=True)


def _final(pw, table) -> list:
    try:
        rows = pw.debug._capture_table(table).final_rows()
    finally:
        pw.G.clear()
    return sorted(rows.values(), key=repr)


# ---------------------------------------------------------------------------
# the SigV4 client and the readers (tests/test_connectors.py:362-660, 2038)
# ---------------------------------------------------------------------------


@each_package
def test_s3_client_list_get_and_sigv4_header(pkg, mock_s3):
    MockS3Handler.objects = {"data/a.txt": b"hello", "data/b.txt": b"world", "other": b"x"}
    client = _settings(pkg, mock_s3).client()
    assert [o["key"] for o in client.list_objects("data/")] == ["data/a.txt", "data/b.txt"]
    assert client.get_object("data/a.txt") == b"hello"
    assert any(a and a.startswith("AWS4-HMAC-SHA256") for a in MockS3Handler.auth_headers)


@each_package
@pytest.mark.parametrize("method,path,query,body", [
    ("GET", "/bucket1/", [("list-type", "2"), ("prefix", "a/b")], b""),
    ("PUT", "/bucket1/key one.txt", [], b"hello wire"),
])
def test_s3_sigv4_signature_byte_exact(pkg, monkeypatch, method, path, query, body):
    s3http = importlib.import_module(f"{pkg}.io._s3http")
    fixed = _dt.datetime(2013, 5, 24, tzinfo=_dt.timezone.utc)

    class _FixedDT(_dt.datetime):
        @classmethod
        def now(cls, tz=None):
            return fixed

    monkeypatch.setattr(s3http.datetime, "datetime", _FixedDT)
    srv = ScriptedServer(_http_capture_handler)
    client = s3http.S3Client("bucket1", access_key=AWS_KEY, secret_access_key=AWS_SECRET, region=AWS_REGION,
                             endpoint=f"http://127.0.0.1:{srv.port}")
    client._request(path, dict(query), method=method, body=body)
    srv.finish()
    got = srv.state["headers"]
    assert got["authorization"] == _independent_sigv4(method, f"127.0.0.1:{srv.port}", path, query,
                                                      "20130524T000000Z", body)
    assert got["x-amz-content-sha256"] == hashlib.sha256(body).hexdigest() and srv.state["body"] == body


@each_package
def test_s3_signatures_verified_by_the_endpoint(pkg):
    s3http = importlib.import_module(f"{pkg}.io._s3http")
    srv = S3Server()
    try:
        ok = s3http.S3Client("b", access_key="AK", secret_access_key="SK", endpoint=srv.endpoint)
        ok.put_object("dir/a b.bin", b"\x00\x01")
        assert ok.get_object("dir/a b.bin") == b"\x00\x01" and [o["key"] for o in ok.list_objects("dir/")] == ["dir/a b.bin"]
        ok.delete_object("dir/a b.bin")
        bad = s3http.S3Client("b", access_key="AK", secret_access_key="wrong", endpoint=srv.endpoint)
        with pytest.raises(s3http.S3Error) as info:
            bad.get_object("x")
        assert info.value.status == 403 and srv.stats()["rejected"] == 1
    finally:
        srv.close()


@each_package
def test_s3_virtual_host_addressing(pkg):
    s3http = importlib.import_module(f"{pkg}.io._s3http")
    client = s3http.S3Client("my-bucket", region="eu-west-1", with_path_style=False)
    assert client.host == "my-bucket.s3.eu-west-1.amazonaws.com" and client._base_path() == ""
    path_client = s3http.S3Client("my-bucket", region="eu-west-1", with_path_style=True)
    assert path_client.host == "s3.eu-west-1.amazonaws.com" and path_client._base_path() == "/my-bucket"


@pytest.mark.parametrize("case", ("csv", "csv_settings", "jsonlines", "minio", "s3_csv", "metadata"))
def test_s3_reads_match_jax(mock_s3, case):
    objects = {
        "csv": {"in/part1.csv": b"a,b\n1,x\n2,y\n", "in/part2.csv": b"a,b\n3,z\n"},
        "csv_settings": {"in/f.csv": b"a;b\n1;x\n"},
        "jsonlines": {"in/one.jsonl": b'{"a": 1, "b": "p"}\n{"a": 2, "b": "q"}\n'},
        "minio": {"in/f.txt": b"line1\nline2\n"},
        "s3_csv": {"in/a.csv": b"a,b\n3,apple\n7,plum\n"},
        "metadata": {"in/m.txt": b"only\n"},
    }[case]
    got = []
    for pkg in PACKAGES:
        MockS3Handler.objects = dict(objects)
        pw = importlib.import_module(pkg)
        schema = pw.schema_from_types(a=int, b=str)
        settings = _settings(pkg, mock_s3)
        if case == "minio":
            t = pw.io.minio.read("in/", minio_settings=pw.io.minio.MinIOSettings(
                endpoint=settings.endpoint, bucket_name="bkt", access_key="AK", secret_access_key="SK"),
                format="plaintext", mode="static")
        elif case == "s3_csv":
            t = pw.io.s3_csv.read("s3://bkt/in/", aws_s3_settings=settings, schema=schema, mode="static")
        elif case == "metadata":
            t = pw.io.s3.read("s3://bkt/in/", aws_s3_settings=settings, format="plaintext", mode="static",
                              with_metadata=True)
            t = t.select(pw.this.data, path=pw.apply_with_type(lambda m: m.value["path"], str, pw.this._metadata))
        else:
            kw = {"csv_settings": type("S", (), {"as_dict": lambda self: {"delimiter": ";"}})()} if case == "csv_settings" else {}
            t = pw.io.s3.read("s3://bkt/in/", aws_s3_settings=settings, format="json" if case == "jsonlines" else "csv",
                              schema=schema, mode="static", **kw)
        got.append(_final(pw, t))
    assert got[0] == got[1] and got[1], got
    if case in ("csv", "s3_csv"):
        assert got[1] == ([(1, "x"), (2, "y"), (3, "z")] if case == "csv" else [(3, "apple"), (7, "plum")])


@each_package
def test_s3_modified_object_rereads(pkg, mock_s3):
    s3 = importlib.import_module(f"{pkg}.io.s3")
    MockS3Handler.objects = {"w/x.txt": b"v1"}
    client = _settings(pkg, mock_s3).client()

    def read(seek=None):
        reader = s3._S3Reader(client, "w/", "plaintext_by_object", None, "static", None)
        if seek:
            reader.seek(seek)
        got = []
        reader.run(lambda item: got.append(item) if isinstance(item, dict) else None)
        return [r["data"] for r in got]

    assert read() == ["v1"]
    assert read({"watermark": "2025-01-01T00:00:00Z", "at_mark": []}) == ["v1"]
    assert read({"watermark": "2026-01-01T00:00:00Z", "at_mark": ["w/x.txt"]}) == []


@each_package
def test_s3_reader_repartition(pkg):
    s3 = importlib.import_module(f"{pkg}.io.s3")
    types = importlib.import_module(f"{pkg}.engine.types")
    reader = object.__new__(s3._S3Reader)
    reader._stripe = None
    reader.partition(1, 2)
    assert {k for k in "abcdefgh" if reader._mine(k)} == {k for k in "abcdefgh" if types.hash_values([k]) % 2 == 1}


# ---------------------------------------------------------------------------
# the persistence backends (tests/test_connectors.py:1076, 1587-1640, 1764-1845)
# ---------------------------------------------------------------------------

BACKENDS = ("s3", "gcs", "azure")


def _backend_cfg(pw, kind: str, fake, prefix: str):
    if kind == "s3":
        http = importlib.import_module(f"{pw.__name__}.io._s3http")
        settings = http.AwsS3Settings(access_key="AK", secret_access_key="SK",
                                      endpoint=f"http://127.0.0.1:{fake.server_address[1]}", with_path_style=True)
        return pw.persistence.Backend.s3(f"s3://bkt/{prefix}", settings)
    if kind == "gcs":
        return pw.persistence.Backend.gcs(f"gs://bkt/{prefix}", endpoint=fake, token_provider=lambda: "tok-123")
    return pw.persistence.Backend.azure(f"az://cont/{prefix}", account={
        "account_name": "acct", "account_key": base64.b64encode(b"secret").decode(), "endpoint": fake})


@pytest.fixture()
def store(mock_s3, mock_gcs, mock_azurite):
    return {"s3": mock_s3, "gcs": mock_gcs, "azure": mock_azurite}


@each_package
@pytest.mark.parametrize("kind", BACKENDS)
def test_backend_blob_semantics(pkg, kind, store):
    pw = importlib.import_module(pkg)
    pz = importlib.import_module(f"{pkg}.engine.persistence")
    backend = pz.backend_from_config(_backend_cfg(pw, kind, store[kind], "pstate"))
    assert type(backend).__name__ == {"s3": "S3Backend", "gcs": "GcsBackend", "azure": "AzureBackend"}[kind]
    assert backend.prefix == "pstate"
    backend.put("a/b", b"one")
    assert backend.get("a/b") == b"one" and backend.get("missing") is None
    assert backend.list_keys("a/") == ["a/b"]
    backend.delete("a/b")
    assert backend.get("a/b") is None
    if kind == "gcs":
        assert MockGcsHandler.bearer_tokens and set(MockGcsHandler.bearer_tokens) == {"Bearer tok-123"}
    if kind == "azure":
        assert MockAzuriteHandler.auth_headers and all(h.startswith("SharedKey acct:") for h in MockAzuriteHandler.auth_headers)


def _counts_run(pw, tmp_path, cfg) -> dict:
    """The word-count program of the JAX backend tests over ``in/``,
    persisted through ``cfg``; the net ``{word: n}`` of its stream."""
    t = pw.io.csv.read(str(tmp_path / "in"), schema=pw.schema_from_types(word=str), mode="static", name="words")
    counts = t.groupby(t.word).reduce(t.word, n=pw.reducers.count())
    net: dict = {}
    pw.io.subscribe(counts, on_change=lambda key, row, time, is_addition: net.__setitem__(
        (row["word"], row["n"]), net.get((row["word"], row["n"]), 0) + (1 if is_addition else -1)))
    try:
        pw.run(monitoring_level=pw.MonitoringLevel.NONE, persistence_config=pw.persistence.Config(cfg))
    finally:
        pw.G.clear()
    return {w: n for (w, n), m in net.items() if m}


@pytest.mark.parametrize("kind", BACKENDS)
def test_backend_crash_resume_matches_jax(kind, store, tmp_path):
    """Run, add a file, resume from the object store: the old rows come from
    the snapshot, only the new one is read, in both packages."""
    results = []
    for pkg in PACKAGES:
        pw = importlib.import_module(pkg)
        pz = importlib.import_module(f"{pkg}.engine.persistence")
        d = tmp_path / pkg
        os.makedirs(d / "in")
        (d / "in" / "a.csv").write_text("word\nfoo\nbar\nfoo\n")
        cfg = _backend_cfg(pw, kind, store[kind], f"run-{pkg}")
        first = _counts_run(pw, d, cfg)
        keys = pz.backend_from_config(cfg).list_keys("")
        assert any(k.startswith("metadata.json") for k in keys) and any(k.startswith("snapshots/") for k in keys)
        (d / "in" / "b.csv").write_text("word\nfoo\n")
        results.append((first, _counts_run(pw, d, cfg)))
    assert results[0] == results[1]
    assert results[1] == ({"foo": 2, "bar": 1}, {"foo": 3, "bar": 1})


@each_package
def test_azure_bad_key_rejected(pkg, mock_azurite):
    az = importlib.import_module(f"{pkg}.io._azureblob")
    client = az.AzureBlobClient("acct", "cont", account_key=base64.b64encode(b"wrong-key").decode(), endpoint=mock_azurite)
    with pytest.raises(az.AzureBlobError) as info:
        client.put_blob("x", b"data")
    assert info.value.status == 403


@each_package
def test_gcs_auth_failure_is_not_read_as_missing(pkg, mock_gcs):
    pz = importlib.import_module(f"{pkg}.engine.persistence")
    gcs = importlib.import_module(f"{pkg}.io._gcshttp")

    def broken():
        raise gcs.GcsAuthError("metadata token fetch: HTTP 404", 404)

    backend = pz.GcsBackend(gcs.GcsClient("bkt", endpoint=mock_gcs, token_provider=broken), prefix="p")
    with pytest.raises(gcs.GcsAuthError):
        backend.get("metadata.json")
    with pytest.raises(gcs.GcsAuthError):
        backend.delete("metadata.json")

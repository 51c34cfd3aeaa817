"""Slice H6a's NATS and Google connectors in the port against the JAX
package: ``pw.io.nats`` (the text protocol over a socket), ``_gauth``
(service-account JWT, RS256 in pure Python), ``pw.io.pubsub``,
``pw.io.gdrive`` and ``pw.io.bigquery``.

The fakes are the JAX package's own, imported unedited: ``MockNats``
(``tests/test_connectors.py:761``) and ``MockGoogle``
(``tests/test_gcp_connectors.py:136``), which verifies each JWT's RS256
signature before it issues a token.  Each test runs in both packages, and
where a run's output can be compared, the two packages' are.
"""

from __future__ import annotations

import base64
import importlib
import json
import time

import pytest

from tests import torch_cluster_programs as progs
from tests.test_connectors import MockNats
from tests.test_gcp_connectors import _D, _E, _N, _PEM, MockGoogle, mock_google  # noqa: F401  (fixture)

PACKAGES = progs.PACKAGES
each_package = pytest.mark.parametrize("pkg", PACKAGES)


def _run(pw, raises=None) -> None:
    try:
        if raises is None:
            pw.run(monitoring_level=pw.MonitoringLevel.NONE)
        else:
            with pytest.raises(raises[0], match=raises[1]):
                pw.run(monitoring_level=pw.MonitoringLevel.NONE)
    finally:
        pw.G.clear()


def test_nats_write_matches_jax():
    published = []
    for pkg in PACKAGES:
        pw = importlib.import_module(pkg)
        srv = MockNats()
        try:
            pw.io.nats.write(pw.debug.table_from_markdown("a | b\n1 | x\n2 | y"), f"nats://127.0.0.1:{srv.port}",
                             topic="out.stream")
            _run(pw)
            deadline = time.monotonic() + 5
            while len(srv.published) < 2 and time.monotonic() < deadline:
                time.sleep(0.02)
            published.append(sorted(((h.split(" ")[1], json.loads(p)) for h, p in srv.published), key=repr))
        finally:
            srv.close()
    assert published[0] == published[1]
    assert [(t, o["a"], o["b"], o["diff"]) for t, o in published[1]] == [("out.stream", 1, "x", 1), ("out.stream", 2, "y", 1)]


@each_package
def test_nats_read(pkg):
    pw = importlib.import_module(pkg)
    srv = MockNats(feed=[json.dumps({"v": i}).encode() for i in (10, 20, 30)], close_after_feed=True)
    try:
        t = pw.io.nats.read(f"nats://127.0.0.1:{srv.port}", topic="topic", schema=pw.schema_from_types(v=int))
        got = []
        pw.io.subscribe(t, on_change=lambda key, row, time, is_addition: got.append(row["v"]))
        _run(pw)
        assert sorted(got) == [10, 20, 30]
    finally:
        srv.close()


@each_package
def test_nats_headers_rejected_loudly(pkg):
    pw = importlib.import_module(pkg)
    try:
        with pytest.raises(NotImplementedError, match="HPUB"):
            pw.io.nats.write(pw.debug.table_from_markdown("x\n1"), "nats://h", topic="t",
                             headers=[pw.this.x], _sink_factory=object)
    finally:
        pw.G.clear()


@each_package
def test_rsa_key_and_rs256(pkg):
    gauth = importlib.import_module(f"{pkg}.io._gauth")
    assert gauth.parse_rsa_private_key(_PEM) == (_N, _E, _D)
    sig = gauth.rs256_sign(b"hello jwt", _N, _D)
    assert gauth.rs256_verify(b"hello jwt", sig, _N, _E) and not gauth.rs256_verify(b"tampered", sig, _N, _E)
    other = importlib.import_module(f"{PACKAGES[pkg == PACKAGES[0]]}.io._gauth")
    assert other.rs256_sign(b"hello jwt", _N, _D) == sig


@each_package
def test_token_exchange_and_caching(pkg, mock_google):
    gauth = importlib.import_module(f"{pkg}.io._gauth")
    _base, creds_file = mock_google
    creds = gauth.ServiceAccountCredentials.from_file(creds_file, ["scope-a"])
    assert creds.token() == creds.token() == "tok-123"
    assert MockGoogle.tokens_issued == 1


@each_package
def test_bigquery_write(pkg, mock_google):
    pw = importlib.import_module(pkg)
    base, creds_file = mock_google
    pw.io.bigquery.write(pw.debug.table_from_markdown("a | b\n1 | x\n2 | y"), "ds1", "tbl1", creds_file, _api_base=base)
    _run(pw)
    sent = [r["json"] for req in MockGoogle.inserts for r in req["rows"]]
    assert sorted((r["a"], r["b"], r["diff"]) for r in sent) == [(1, "x", 1), (2, "y", 1)]


@each_package
def test_pubsub_write(pkg, mock_google):
    pw = importlib.import_module(pkg)
    base, creds_file = mock_google
    pw.io.pubsub.write(pw.debug.table_from_markdown("v\n7"), "proj1", "topic1", creds_file, _api_base=base)
    _run(pw)
    (msg,) = [m for req in MockGoogle.published for m in req["messages"]]
    assert json.loads(base64.b64decode(msg["data"])) == {"v": 7} and msg["attributes"]["pathway_diff"] == "1"


@each_package
def test_pubsub_read(pkg, mock_google, monkeypatch):
    pw = importlib.import_module(pkg)
    base, creds_file = mock_google
    pubsub = importlib.import_module(f"{pkg}.io.pubsub")
    got = []
    retry = pubsub.api_request_retry

    def pull(*args, **kw):
        """The pull that meets the mock's closing 500 waits until the rows
        arrived (10 s at most), then makes one attempt, not the 7.5 s of
        backoff that gives the engine its time in the JAX package's test."""
        deadline = time.monotonic() + 10
        while not MockGoogle.pull_feed and len(got) < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        return retry(*args, **{**kw, "attempts": 1})

    monkeypatch.setattr(pubsub, "api_request_retry", pull)
    MockGoogle.pull_feed = [[{"ackId": f"a{v}", "message": {"data": base64.b64encode(json.dumps({"v": v}).encode()).decode()}}
                             for v in (10, 20)]]
    t = pw.io.pubsub.read("proj1", "sub1", creds_file, schema=pw.schema_from_types(v=int), _api_base=base)
    pw.io.subscribe(t, on_change=lambda key, row, time, is_addition: got.append(row["v"]))
    # the mock ends its feed with a 500: the rows arrive, then the dead
    # subscription fails the run (reader budget 0, as in the JAX package)
    engine = importlib.import_module(f"{pkg}.engine.dataflow")
    _run(pw, raises=(engine.EngineError, "pubsub pull failed"))
    assert sorted(got) == [10, 20]


def test_gdrive_read_matches_jax(mock_google):
    base, creds_file = mock_google
    got = []
    for pkg in PACKAGES:
        pw = importlib.import_module(pkg)
        MockGoogle.drive_files = {
            "f1": {"name": "a.txt", "modifiedTime": "2026-01-01T00:00:00Z", "content": b"alpha"},
            "f2": {"name": "b.txt", "modifiedTime": "2026-01-02T00:00:00Z", "content": b"beta"},
        }
        t = pw.io.gdrive.read("folder1", service_user_credentials_file=creds_file, mode="static", with_metadata=True,
                              _api_base=base)
        try:
            rows = pw.debug._capture_table(t).final_rows().values()
        finally:
            pw.G.clear()
        got.append(sorted((data, meta.value["name"]) for data, meta in rows))
    assert got[0] == got[1] == [(b"alpha", "a.txt"), (b"beta", "b.txt")]


@each_package
def test_gdrive_name_and_size_filters(pkg):
    gdrive = importlib.import_module(f"{pkg}.io.gdrive")
    r = gdrive._GDriveReader(None, "root", "static", 1.0, "x", False, file_name_pattern="*.pdf", object_size_limit=100)
    assert r._accepts({"name": "doc.pdf", "size": "50"})
    assert not r._accepts({"name": "doc.txt", "size": "50"}) and not r._accepts({"name": "big.pdf", "size": "500"})

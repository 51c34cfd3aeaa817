"""Slice H6a's message streams in the port against the JAX package:
``pw.io.kafka``, ``redpanda`` and ``debezium``.

The broker is ``tests/torch_fake_services.py``'s in-process one, put behind
each package's ``kafka._get_client`` (the seam of
``tests/test_connector_options.py:95-118``).  The JAX package's own Kafka
tests (``test_kafka_offsets.py``, ``test_connector_options.py:95-270``,
``test_reader_tolerance.py:162``, ``test_rescale_repartition.py:634``,
``test_connectors.py``'s debezium and redpanda cases) run here over both
packages; whole runs over the broker compare the two packages' streams.
``chip_smoke.py``'s ``[kafka]`` program runs at a small size in both, over
the tiny encoder of ``test_torch_dataflow_embed.py``: unbroken, stopped at
``max_epochs`` and resumed from ``Backend.s3``.  A two-worker mesh stripes
a four-partition topic.
"""

from __future__ import annotations

import importlib
import json

import numpy as np
import pytest

import chip_smoke
from tests import torch_cluster_programs as progs
from tests import torch_dataflow_programs as P
from tests.test_torch_dataflow_embed import COS_MIN, SCORE_TOL, model  # noqa: F401  (its encoder fixture)
from tests.torch_fake_services import KafkaBroker, S3Server, until_drained

PACKAGES = progs.PACKAGES
each_package = pytest.mark.parametrize("pkg", PACKAGES)
SETTINGS = {"bootstrap.servers": "127.0.0.1:9092", "group.id": "g", "auto.offset.reset": "earliest"}


def _pkg(pkg: str):
    return importlib.import_module(pkg), importlib.import_module(f"{pkg}.io.kafka"), importlib.import_module(f"{pkg}.io._utils")


@pytest.fixture()
def broker(monkeypatch):
    """A finite broker behind both packages' seams, their readers ending
    once it is drained."""
    b = KafkaBroker(finite=True)
    for pkg in PACKAGES:
        _pw, kafka_mod, _u = _pkg(pkg)
        monkeypatch.setattr(kafka_mod, "_get_client", b.get_client)
        monkeypatch.setattr(kafka_mod._KafkaReader, "run", until_drained(kafka_mod._KafkaReader.run))
    yield b
    b.park_consumers()


def _stream(pw, table) -> list:
    """``[(key, row, diff)]`` of one run, sorted: times left out, since a
    connector's rows may land in either of two epochs."""
    out = []
    pw.io.subscribe(table, on_change=lambda key, row, time, is_addition: out.append(
        (str(key), json.dumps({k: P.canon(v) for k, v in row.items()}, sort_keys=True, default=str),
         1 if is_addition else -1)))
    try:
        pw.run(monitoring_level=pw.MonitoringLevel.NONE)
    finally:
        pw.G.clear()
    return sorted(out)


# ---------------------------------------------------------------------------
# the offset protocol (tests/test_kafka_offsets.py)
# ---------------------------------------------------------------------------


def _reader(pkg):
    pw, kafka_mod, _u = _pkg(pkg)
    return kafka_mod._KafkaReader({"bootstrap.servers": "x", "group.id": "g"}, "t", "raw",
                                  pw.schema_from_types(data=bytes))


@each_package
def test_capture_and_ack_selects_marker_snapshot(pkg):
    r = _reader(pkg)
    for off in ("off@10", "off@20", "off@30"):
        r._capture([off])
    r.request_offset_commit(2)
    assert r._offset_commit_requested.is_set()
    assert r._take_acked() == ["off@20"]
    assert r._captured == {3: ["off@30"]}
    r.request_offset_commit(3)
    assert r._take_acked() == ["off@30"] and r._captured == {}


@each_package
def test_ack_before_capture_and_empty_positions_are_noops(pkg):
    r = _reader(pkg)
    r.request_offset_commit(5)
    assert r._take_acked() is None
    r._capture([])
    r.request_offset_commit(6)
    assert r._take_acked() is None


@each_package
@pytest.mark.parametrize("case", ("epoch_gated", "unconditional", "empty_marker"))
def test_poller_acks_only_processed_markers(pkg, case):
    pw, _k, u = _pkg(pkg)
    df = importlib.import_module(f"{pkg}.engine.dataflow")

    class Acks(u.Reader):
        external_resume = True

        def __init__(self):
            self.acks = []

        def request_offset_commit(self, up_to=None):
            self.acks.append(up_to)

    poller = u._QueuePoller(df.InputNode(df.Scope()), pw.schema_from_types(v=int), autocommit_duration_ms=1500)
    poller.reader = Acks()
    items = [u.COMMIT] if case == "empty_marker" else [{"v": 1}, u.COMMIT, {"v": 2}, u.COMMIT]
    for item in items:
        poller.q.put(item)
    poller.poll()
    if case == "epoch_gated":
        poller.ack_processed(up_to_time=2)
        assert poller.reader.acks == [1]  # marker 2's rows are staged for epoch 4, not processed
        poller.ack_processed(up_to_time=4)
        poller.ack_processed(up_to_time=10)
        assert poller.reader.acks == [1, 2]
    elif case == "unconditional":
        poller.ack_processed(None)
        assert poller.reader.acks == [2]
    else:
        poller.ack_processed(up_to_time=0)
        assert poller.reader.acks == [1]


# ---------------------------------------------------------------------------
# the reader's parsing, keys and budgets (test_connector_options.py,
# test_reader_tolerance.py:162, test_rescale_repartition.py:634)
# ---------------------------------------------------------------------------


@each_package
def test_read_json_paths_and_metadata(pkg):
    pw, kafka_mod, _u = _pkg(pkg)
    r = kafka_mod._KafkaReader({}, "t", "json", pw.schema_from_types(city=str, temp=int),
                               json_field_paths={"temp": "/payload/temperature"}, with_metadata=True)
    out = []
    r._emit_payload(b'{"city": "oslo", "payload": {"temperature": 7}}', ["city", "temp", "_metadata"], out.append,
                    key=b"k1", meta={"topic": "t", "partition": 0, "offset": 5, "timestamp": 1})
    (row,) = out
    assert row["city"] == "oslo" and row["temp"] == 7
    assert type(row["_metadata"]).__module__ == f"{pkg}.engine.types" and row["_metadata"].value["offset"] == 5


@each_package
def test_message_key_identity(pkg):
    pw, kafka_mod, _u = _pkg(pkg)
    types = importlib.import_module(f"{pkg}.engine.types")
    r = kafka_mod._KafkaReader({}, "t", "raw", pw.schema_from_types(data=bytes), autogenerate_key=False)
    out = []
    r._emit_payload(b"v1", ["data"], out.append, key=b"order-1")
    r._emit_payload(b"v2", ["data"], out.append, key=b"order-1")
    assert out[0]["_pw_key"] == out[1]["_pw_key"] == types.hash_values([b"order-1"])


@each_package
def test_read_wires_upsert_for_message_keys(pkg, monkeypatch):
    _pw, kafka_mod, u = _pkg(pkg)
    captured = []
    orig = u.make_input_table
    monkeypatch.setattr(kafka_mod._utils, "make_input_table",
                        lambda schema, factory, **kw: captured.append(kw["upsert"]) or orig(schema, factory, **kw))
    kafka_mod.read({}, "t", format="raw")
    kafka_mod.read({}, "t", format="raw", autogenerate_key=True)
    kafka_mod.read({}, "t", format="plaintext")
    assert captured == [True, False, True]


@each_package
def test_budget_repartition_and_redpanda(pkg):
    _pw, kafka_mod, u = _pkg(pkg)
    nats = importlib.import_module(f"{pkg}.io.nats")
    redpanda = importlib.import_module(f"{pkg}.io.redpanda")
    assert kafka_mod._KafkaReader.max_allowed_consecutive_errors == 32
    assert nats._NatsReader.max_allowed_consecutive_errors == 32 and u.Reader.max_allowed_consecutive_errors == 0
    reader = kafka_mod._KafkaReader({}, "topic", "json", None)
    parts = list(range(8))
    assert reader._my_partitions(parts) == parts
    assert reader.partition(0, 4)._my_partitions(parts) == [0, 4]
    assert reader.partition(1, 2)._my_partitions(parts) == [1, 3, 5, 7]
    assert redpanda.read is kafka_mod.read and redpanda.write is kafka_mod.write


@each_package
def test_kafka_python_settings_mapping(pkg):
    _pw, kafka_mod, _u = _pkg(pkg)
    r = kafka_mod._KafkaReader({"bootstrap.servers": "b:9", "auto.offset.reset": "earliest",
                                "security.protocol": "sasl_ssl", "sasl.mechanism": "SCRAM-SHA-256",
                                "sasl.username": "u", "sasl.password": "p"}, "t", "raw", None)
    assert r._kafka_python_kwargs("grp") == {
        "bootstrap_servers": "b:9", "group_id": "grp", "enable_auto_commit": False, "auto_offset_reset": "earliest",
        "security_protocol": "SASL_SSL", "sasl_mechanism": "SCRAM-SHA-256", "sasl_plain_username": "u",
        "sasl_plain_password": "p"}


def test_missing_client_raises_the_same_error():
    errors = []
    for pkg in PACKAGES:
        with pytest.raises(ImportError) as info:
            _pkg(pkg)[1]._get_client()
        errors.append(str(info.value))
    assert errors[0] == errors[1] and "kafka-python" in errors[0]


# ---------------------------------------------------------------------------
# whole runs over the broker, the two packages' streams compared
# ---------------------------------------------------------------------------


def _value(row: str, col: str):
    """A column's plain value in a ``_stream`` row."""
    return json.loads(row)[col][1]


def _both(build) -> list:
    streams = [_stream(importlib.import_module(pkg), build(importlib.import_module(pkg))) for pkg in PACKAGES]
    assert streams[0] == streams[1]
    return streams[1]


def test_read_json_over_partitions_with_metadata(broker):
    broker.create_topic("events", 4)
    for i in range(40):
        broker.produce("events", json.dumps({"k": i % 5, "v": i, "nest": {"x": i * 2}}).encode(), key=str(i).encode(),
                       timestamp_ms=1_700_000_000_000 + i)
    got = _both(lambda pw: pw.io.kafka.read(
        SETTINGS, "events", format="json", schema=pw.schema_from_types(k=int, v=int, x=int),
        json_field_paths={"x": "/nest/x"}, with_metadata=True, autocommit_duration_ms=20))
    assert len(got) == 40 and all(d == 1 for _k, _r, d in got)
    assert sorted(_value(r, "v") for _k, r, _d in got) == list(range(40))
    assert all(_value(r, "x") == 2 * _value(r, "v") for _k, r, _d in got)


def test_plaintext_message_keys_replace(broker):
    broker.create_topic("kv", 2)
    for key, value in (("a", "1"), ("b", "2"), ("a", "3"), ("c", "4"), ("b", "5")):
        broker.produce("kv", value.encode(), key=key.encode(), partition=0)
    got = _both(lambda pw: pw.io.kafka.read(SETTINGS, "kv", format="plaintext", autocommit_duration_ms=20))
    net = {}
    for key, row, diff in got:
        net[(key, row)] = net.get((key, row), 0) + diff
    live = {(k, _value(r, "data")) for (k, r), n in net.items() if n}
    assert sorted(v for _k, v in live) == ["3", "4", "5"] and len({k for k, _v in live}) == 3


def test_start_from_timestamp(broker):
    broker.create_topic("ts", 2)
    for i in range(12):
        broker.produce("ts", json.dumps({"v": i}).encode(), partition=i % 2, timestamp_ms=1000 + 10 * i)
    got = _both(lambda pw: pw.io.kafka.read(SETTINGS, "ts", format="json", schema=pw.schema_from_types(v=int),
                                            start_from_timestamp_ms=1055, autocommit_duration_ms=20))
    assert sorted(_value(r, "v") for _k, r, _d in got) == [6, 7, 8, 9, 10, 11]


@pytest.mark.parametrize("case", ("key_value_headers", "dsv"))
def test_write_framing(broker, case):
    sent = {}
    for pkg in PACKAGES:
        pw = importlib.import_module(pkg)
        t = pw.debug.table_from_markdown("k | payload\nA | hello" if case != "dsv" else "a | b\n1 | x")
        kw = (dict(format="raw", key=pw.this.k, value=pw.this.payload, headers=[pw.this.k]) if case != "dsv"
              else dict(format="dsv", delimiter="|"))
        pw.io.kafka.write(t, SETTINGS, f"out-{pkg}", **kw)
        pw.run(monitoring_level=pw.MonitoringLevel.NONE)
        pw.G.clear()
        sent[pkg] = [(m.value, m.key, m.headers) for m in broker.messages(f"out-{pkg}")]
    assert sent["pathway_tpu"] == sent["pathway_tpu_torch"]
    if case == "dsv":
        (value, key, _h), = sent["pathway_tpu_torch"]
        assert value.startswith(b"1|x|") and key is None
    else:
        assert sent["pathway_tpu_torch"] == [(b"hello", b"A", [("k", b"A")])]


@pytest.mark.parametrize("case", ("create_read", "update", "delete_tombstone", "garbage"))
def test_debezium_parse_matches_jax(case):
    def env(op, before=None, after=None, with_schema=True):
        payload = {"op": op, "before": before, "after": after}
        return json.dumps({"schema": {}, "payload": payload} if with_schema else payload).encode()

    msgs = {"create_read": [env("c", after={"id": 1, "v": "a"}), env("r", after={"id": 2, "v": "b"}, with_schema=False)],
            "update": [env("u", before={"id": 1, "v": "old"}, after={"id": 1, "v": "new"})],
            "delete_tombstone": [env("d", before={"id": 1, "v": "x"}), None, b"", b"null"],
            "garbage": [b"not json"]}[case]
    parsed = [[importlib.import_module(f"{pkg}.io.debezium").parse_debezium_message(m, ["id", "v"]) for m in msgs]
              for pkg in PACKAGES]
    assert parsed[0] == parsed[1]
    assert sum(len(p) for p in parsed[1]) == {"create_read": 2, "update": 2, "delete_tombstone": 1, "garbage": 0}[case]


def test_debezium_read_over_the_broker(broker, monkeypatch):
    """A CDC topic of creates, snapshot reads, updates, deletes, a re-insert,
    tombstones and garbage over four primary keys through
    ``pw.io.debezium.read``: the port's net table is the JAX package's
    ``parse_debezium_message`` over the same messages, folded.  The JAX
    package's reader override lacks the loop's ``key``/``meta`` keywords and
    fails the run (ROADMAP Queue 3), here at its first error rather than
    after the 32 retries of its budget."""
    jdbz = importlib.import_module("pathway_tpu.io.debezium")
    monkeypatch.setattr(jdbz._DebeziumKafkaReader, "max_allowed_consecutive_errors", 0)

    def env(op, before=None, after=None, with_schema=True):
        payload = {"op": op, "before": before, "after": after}
        return json.dumps({"schema": {}, "payload": payload} if with_schema else payload).encode()

    def img(i, v):
        return {"id": i, "v": v}

    msgs = [env("c", after=img(1, "a")), env("c", after=img(2, "b")), env("r", after=img(3, "c"), with_schema=False),
            env("u", before=img(1, "a"), after=img(1, "z")), env("d", before=img(2, "b")), None, b"",
            env("c", after=img(4, "d")), b"not json", env("u", before=img(3, "c"), after=img(3, "q"), with_schema=False),
            env("u", before=img(4, "d"), after=img(4, "e")), env("d", before=img(4, "e")), b"null",
            env("c", after=img(2, "b2")), env("u", before=img(2, "b2"), after=img(2, "b3"))]
    broker.create_topic("cdc", 1)
    for m in msgs:
        broker.produce("cdc", m)
    want: dict = {}
    for m in msgs:
        for row, diff in jdbz.parse_debezium_message(m, ["id", "v"]):
            canon = json.dumps({c: P.canon(row[c]) for c in ("id", "v")}, sort_keys=True, default=str)
            want[canon] = want.get(canon, 0) + diff
    assert set(want.values()) <= {0, 1}

    def build(pw):
        class S(pw.Schema):
            id: int = pw.column_definition(primary_key=True)
            v: str

        return pw.io.debezium.read(SETTINGS, "cdc", schema=S, autocommit_duration_ms=20)

    pj = importlib.import_module("pathway_tpu")
    with pytest.raises(Exception, match="unexpected keyword argument 'key'"):
        _stream(pj, build(pj))
    pt = importlib.import_module("pathway_tpu_torch")
    net: dict = {}
    for key, row, diff in _stream(pt, build(pt)):
        net[(key, row)] = net.get((key, row), 0) + diff
    rows = sorted(r for (_k, r), n in net.items() if n)
    assert all(n in (0, 1) for n in net.values()) and len({k for (k, _r), n in net.items() if n}) == len(rows)
    assert rows == sorted(r for r, n in want.items() if n)
    assert [_value(r, "v") for r in rows] == ["z", "b3", "q"]
    with pytest.raises(ValueError, match="primary-key"):
        pt.io.debezium.read(SETTINGS, "cdc", schema=pt.schema_from_types(id=int))


# ---------------------------------------------------------------------------
# [kafka]'s program: Kafka -> embedder -> KNNIndex, stopped and resumed on S3
# ---------------------------------------------------------------------------

SIZES = chip_smoke.KafkaSizes(docs=32, partitions=4, batch=8, ahead=2, queries=4, query_batch=2, k=4,
                              commit_ms=40, snapshot_ms=100, wait_s=60.0)


@pytest.fixture(scope="module")
def kafka_runs(model):  # noqa: F811
    """Both packages' unbroken, stopped and resumed runs, on one S3 server."""
    from pathway_tpu_torch.device import get_default_executor

    _, _, jenc, tenc = model
    corpus = chip_smoke.kafka_corpus(SIZES, 31)
    s3 = S3Server()
    out = {}
    try:
        for pkg, enc in (("pathway_tpu", jenc), ("pathway_tpu_torch", tenc)):
            pw = importlib.import_module(pkg)
            batching = importlib.import_module(f"{pkg}.utils.batching")
            ex = {"executor": get_default_executor("cpu")} if pkg.endswith("torch") else {}
            embed = chip_smoke.embedding_udf(pw, batching.AsyncMicroBatcher(enc.encode, max_batch_size=16, **ex).submit)
            kw = dict(index_kw=P.port_kw(pw))
            unbroken, resumed = KafkaBroker(), KafkaBroker()
            for b in (unbroken, resumed):
                chip_smoke.kafka_topics(b, SIZES)
            dim = tenc.dimensions
            runs = {"unbroken": chip_smoke.kafka_run(pw, unbroken, corpus, embed, dim, SIZES, chip_smoke.kafka_persistence(
                pw, s3, f"{pkg}/unbroken", SIZES.snapshot_ms), **kw)}
            stop_sizes, stop = chip_smoke.kafka_stop(SIZES)
            root = chip_smoke.kafka_persistence(pw, s3, f"{pkg}/resumed", SIZES.snapshot_ms)
            runs["stopped"] = chip_smoke.kafka_run(pw, resumed, corpus, embed, dim, stop_sizes, root, max_epochs=stop,
                                                   queries=False, **kw)
            committed = resumed.committed_offsets(chip_smoke.KAFKA_GROUP, "docs")
            runs["resumed"] = chip_smoke.kafka_run(pw, resumed, corpus, embed, dim, SIZES, root,
                                                   first_batch=runs["stopped"]["traffic"].next_batch, **kw)
            direct = (np.asarray(enc.encode(corpus["docs"]), np.float32), np.asarray(enc.encode(corpus["queries"]), np.float32))
            out[pkg] = {"runs": runs, "brokers": (unbroken, resumed), "committed": committed, "direct": direct}
        out["s3"] = s3.stats()
    finally:
        s3.close()
    return out


def _same_answers(a: dict, b: dict) -> None:
    """Equal ids but at near-ties, scores within ``SCORE_TOL``."""
    rows = sorted(a)
    assert sorted(b) == rows
    ids, dists = (np.array([x[q][0] for q in rows]) for x in (a, b)), (np.array([x[q][1] for q in rows]) for x in (a, b))
    (ia, ib), (da, db) = ids, dists
    _parted, gap = chip_smoke.topk_parted(ib, db, ia, da)
    assert gap <= SCORE_TOL and np.abs(da - db).max() <= SCORE_TOL, (gap, np.abs(da - db).max())


@each_package
def test_kafka_program_gates(kafka_runs, pkg):
    got = kafka_runs[pkg]
    runs, (unbroken, resumed) = got["runs"], got["brokers"]
    assert [runs[n]["ended"] for n in ("unbroken", "stopped", "resumed")] == ["answered", "max_epochs", "answered"]
    assert [runs[n]["unparked"] for n in runs] == [0, 0, 0]
    offsets = chip_smoke.kafka_offsets_check(resumed, got["committed"], set(runs["stopped"]["traffic"].indexed_at))
    assert offsets["passed_unprocessed"] == 0 and 0 < offsets["processed"] <= 3 * SIZES.docs // 4, offsets
    state = chip_smoke.kafka_state_check(chip_smoke.kafka_net(runs["unbroken"]["traffic"]),
                                         chip_smoke.kafka_net(runs["resumed"]["traffic"]), SIZES.docs)
    assert state["docs_once"] and state["keys_equal"] and state["min_cos_vs_unbroken"] > COS_MIN, state
    for run in ("unbroken", "resumed"):
        v = chip_smoke.kafka_vectors_check(chip_smoke.kafka_net(runs[run]["traffic"]), got["direct"][0], "cpu")
        assert v["rows"] == SIZES.docs and v["min_cos_own"] > COS_MIN and v["nearer_other"] == 0, v
    a, b = chip_smoke.kafka_answer_topic(unbroken), chip_smoke.kafka_answer_topic(resumed)
    assert sorted(a) == sorted(b) == list(range(SIZES.queries))
    for answers in (a, b):
        c = chip_smoke.kafka_answers_check(got["direct"], answers, SIZES.k, "cpu")
        assert not chip_smoke.kafka_answers_fail(c, SIZES.queries, SCORE_TOL), c
    _same_answers(a, b)
    assert kafka_runs["s3"]["rejected"] == 0 and kafka_runs["s3"]["requests"]["PUT"]


def test_kafka_program_port_matches_jax(kafka_runs):
    for run in ("unbroken", "resumed"):
        jax_net, port_net = (chip_smoke.kafka_net(kafka_runs[pkg]["runs"][run]["traffic"]) for pkg in PACKAGES)
        assert set(jax_net) == set(port_net)
        for key, (doc, vec, m) in port_net.items():
            jdoc, jvec, jm = jax_net[key]
            assert (doc, m) == (jdoc, jm)
            assert float(np.dot(vec, jvec) / (np.linalg.norm(vec) * np.linalg.norm(jvec))) > COS_MIN
        _same_answers(*(chip_smoke.kafka_answer_topic(kafka_runs[pkg]["brokers"][run == "resumed"])
                        for pkg in PACKAGES))


# ---------------------------------------------------------------------------
# two workers stripe a four-partition topic
# ---------------------------------------------------------------------------


def kafka_striped(pw, tmpdir):
    """Worker-striped read of 4 partitions (``partition % 2 == worker``),
    counted per key into jsonlines shards; the broker is this process's."""
    b = KafkaBroker(finite=True)
    b.create_topic("words", 4)
    for i, word in enumerate(progs.WORDS * 2):
        b.produce("words", json.dumps({"word": word, "n": i}).encode(), key=str(i).encode())
    kafka_mod = importlib.import_module(f"{pw.__name__}.io.kafka")
    kafka_mod._get_client = b.get_client
    kafka_mod._KafkaReader.run = until_drained(kafka_mod._KafkaReader.run)
    t = pw.io.kafka.read(SETTINGS, "words", format="json", schema=pw.schema_from_types(word=str, n=int),
                         autocommit_duration_ms=20)
    counts = t.groupby(t.word).reduce(k=t.word, n=pw.reducers.count())
    pw.io.jsonlines.write(counts, f"{tmpdir}/counts.jsonl")
    pw.run(monitoring_level=pw.MonitoringLevel.NONE)


def test_two_workers_stripe_four_partitions(tmp_path):
    progs.PROGRAMS["kafka_striped"] = kafka_striped
    nets = []
    for pkg in PACKAGES:
        (tmp_path / pkg).mkdir()
        progs.run_cluster(pkg, "kafka_striped", tmp_path / pkg, n=2)
        nets.append(progs.canonical_bytes(tmp_path / pkg))
    assert nets[0] == nets[1]
    from collections import Counter

    assert progs.counts_of(nets[1]) == dict(Counter(progs.WORDS * 2))

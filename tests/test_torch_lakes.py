"""Slice H6b's tables and sources in the port against the JAX package:
``pw.io.deltalake`` and ``iceberg`` (with ``io/_avro.py``), ``sqlite``,
``pyfilesystem``, ``airbyte`` (and the CLI's ``airbyte create-source``) and
the SharePoint xpack's entitlement gate.

A Delta or Iceberg table written by either package reads in both to the
same stream: the readers' items in order (rows with their stored keys,
retractions, offsets, commits) and the engine's net state, keys and
values (``tests/torch_dataflow_programs.py``'s ``canon``, floats by their
bits); the engine's epochs follow each reader thread's pace, so every
engine run is compared by its net state.  The
foreign layouts of ``tests/test_connectors.py`` (remove actions, parquet
checkpoints, vacuumed files, incremental snapshots) read alike, and Avro
containers are byte-equal.  Two faults of the reference are pinned in both
packages (ROADMAP "Noted"): a list column cannot be read back once its
table holds a retraction, and ``start_from_timestamp_ms`` fails on a table
with versions.  The sources' readers are driven item by item, so their
streams compare exactly; the one column masked is pyfilesystem's
``modified_at``, the fsspec memory filesystem's clock at each write.
"""

from __future__ import annotations

import importlib
import json
import os
import sqlite3
import sys

import fsspec
import numpy as np
import pytest

import pathway_tpu as pj
import pathway_tpu_torch as pt
from tests import torch_dataflow_programs as P
from tests.test_connectors import FAKE_AIRBYTE_SOURCE, MODERN_STATE_SOURCE
from tests.test_telemetry import make_license_file

PACKAGES = (pj, pt)


@pytest.fixture(autouse=True)
def clean_graphs():
    for pw in PACKAGES:
        pw.G.clear()
    yield
    for pw in PACKAGES:
        pw.G.clear()


def changes(pw):
    return pw.debug.table_from_markdown("""
          | k | v | f    | _time | _diff
        A | 1 | a | 0.25 | 2     | 1
        B | 2 | b | 1.5  | 2     | 1
        A | 1 | a | 0.25 | 4     | -1
        C | 1 | z | -3.0 | 4     | 1
        B | 2 | b | 1.5  | 6     | -1
        """)


def write_lake(pw, kind: str, uri: str, table=None) -> None:
    table = changes(pw) if table is None else table
    if kind == "delta":
        pw.io.deltalake.write(table, uri)
    else:
        pw.io.iceberg.write(table, uri=uri)
    pw.run(monitoring_level=pw.MonitoringLevel.NONE)
    pw.G.clear()


def read_lake(pw, kind: str, uri: str, **types):
    schema = pw.schema_from_types(**(types or {"k": int, "v": str, "f": float}))
    if kind == "delta":
        return pw.io.deltalake.read(uri, schema=schema, mode="static")
    return pw.io.iceberg.read(uri=uri, schema=schema, mode="static")


def canon_item(pw, item, drop=()):
    """A reader's item as a plain value: ``"COMMIT"``, an offset, or a row
    as sorted ``canon`` pairs less the columns ``drop``, a retraction
    marked ``"-"``."""
    utils = importlib.import_module(f"{pw.__name__}.io._utils")
    if item is utils.COMMIT:
        return "COMMIT"
    if isinstance(item, utils.Offset):
        return ("offset", json.dumps(item.value, sort_keys=True))
    row = {k: v for k, v in item.items() if k is not utils.DELETE and k not in drop}
    return ("-" if item.get(utils.DELETE) else "+", P.canon(tuple(sorted(row.items(), key=str))))


def read_items(kind: str, uri: str, **types) -> list:
    """Each package's lake reader run statically on ``uri``: its items in
    order (the stream the engine takes; the engine's epochs follow the
    reader thread's pace, so runs are compared by their net state)."""
    got = []
    for pw in PACKAGES:
        schema = pw.schema_from_types(**(types or {"k": int, "v": str, "f": float}))
        mod = importlib.import_module(f"{pw.__name__}.io.{'deltalake' if kind == 'delta' else 'iceberg'}")
        reader = (mod._DeltaReader if kind == "delta" else mod._IcebergReader)(uri, schema, "static")
        items = []
        reader.run(lambda item: items.append(canon_item(pw, item)))
        got.append(items)
    return got


def net_of(pw, table) -> dict:
    """``{(key, row): count}`` of the net state of ``table``'s run."""
    net: dict = {}
    for _t, key, diff, row in P.capture(pw, {"t": table})["t"]:
        net[(key, row)] = net.get((key, row), 0) + diff
    return {k: n for k, n in net.items() if n}


def net_rows(kind: str, uri: str, **types) -> list:
    """Each package's engine read of the lake, as its net state."""
    return [net_of(pw, read_lake(pw, kind, uri, **types)) for pw in PACKAGES]


def values(row) -> list:
    """A ``canon`` row's plain values (``("tuple", ((type, value), ...))``)."""
    return [v for _type, v in row[1]]


@pytest.mark.parametrize("kind", ["delta", "iceberg"])
@pytest.mark.parametrize("writer", ["pathway_tpu", "pathway_tpu_torch"])
def test_a_lake_written_by_either_package_reads_alike(tmp_path, kind, writer):
    uri = str(tmp_path / kind)
    write_lake(importlib.import_module(writer), kind, uri)
    items = read_items(kind, uri)
    assert items[1] == items[0]
    assert [i[0] for i in items[0] if i[0] in "+-"] == ["+", "+", "-", "+", "-"]  # the stored change stream
    net = net_rows(kind, uri)
    assert net[1] == net[0] and [values(row) for _key, row in net[0]] == [[1, "z", (-3.0).hex()]]
    raw = read_items(kind, uri, k=int, v=str, time=int, diff=int)  # the diff column read as data
    assert raw[1] == raw[0] and [i[0] for i in raw[0] if i[0] in "+-"] == ["+"] * 5


@pytest.mark.parametrize("kind", ["delta", "iceberg"])
def test_the_two_packages_append_to_one_lake(tmp_path, kind):
    uri = str(tmp_path / kind)
    for i, pw in enumerate(PACKAGES):
        write_lake(pw, kind, uri, pw.debug.table_from_markdown(f"k | v | f\n{i} | w{i} | 0.5"))
    items, net = read_items(kind, uri), net_rows(kind, uri)
    assert items[1] == items[0] and net[1] == net[0]
    assert sorted(values(row)[0] for _key, row in net[0]) == [0, 1]
    if kind == "iceberg":
        snaps = [f for f in os.listdir(os.path.join(uri, "metadata")) if f.startswith("snap-")]
        assert len(snaps) == 2


def _delta_versions(uri: str) -> list[str]:
    return sorted(os.listdir(os.path.join(uri, "_delta_log")))


def _add_paths(uri: str) -> list[str]:
    paths = []
    for f in _delta_versions(uri):
        with open(os.path.join(uri, "_delta_log", f)) as fh:
            paths += [json.loads(line)["add"]["path"] for line in fh if '"add"' in line]
    return paths


def _commit(uri: str, *actions) -> None:
    with open(os.path.join(uri, "_delta_log", f"{len(_delta_versions(uri)):020d}.json"), "w") as fh:
        fh.write("".join(json.dumps(a) + "\n" for a in actions))


def foreign_remove(uri):
    _commit(uri, {"remove": {"path": _add_paths(uri)[0], "dataChange": True}})


def foreign_vacuum(uri):
    part = _add_paths(uri)[0]
    _commit(uri, {"remove": {"path": part, "dataChange": True}})
    os.remove(os.path.join(uri, part))


def foreign_checkpoint(uri):
    import pyarrow as pa
    import pyarrow.parquet as pq

    log = os.path.join(uri, "_delta_log")
    os.makedirs(log)
    pq.write_table(pa.table({"k": [1, 2], "v": ["a", "b"], "f": [0.5, 1.0]}), os.path.join(uri, "old.parquet"))
    pq.write_table(pa.table({"add": [{"path": "old.parquet", "size": 1, "dataChange": True}, None],
                             "metaData": [None, {"id": "t1"}]}),
                   os.path.join(log, f"{5:020d}.checkpoint.parquet"))
    with open(os.path.join(log, "_last_checkpoint"), "w") as f:
        f.write(json.dumps({"version": 5, "size": 2}))
    pq.write_table(pa.table({"k": [3], "v": ["c"], "f": [2.0]}), os.path.join(uri, "new.parquet"))
    with open(os.path.join(log, f"{6:020d}.json"), "w") as f:
        f.write(json.dumps({"add": {"path": "new.parquet", "dataChange": True}}) + "\n")


@pytest.mark.parametrize("layout,rows", [(foreign_remove, 0), (foreign_vacuum, 0), (foreign_checkpoint, 3)],
                         ids=["remove", "vacuumed", "checkpoint"])
def test_foreign_delta_layouts_read_alike(tmp_path, layout, rows):
    uri = str(tmp_path / "dl")
    if layout is not foreign_checkpoint:
        write_lake(pj, "delta", uri, pj.debug.table_from_markdown("k | v | f\n1 | a | 0.5\n2 | b | 1.0"))
    layout(uri)
    items, net = read_items("delta", uri), net_rows("delta", uri)
    assert items[1] == items[0] and net[1] == net[0]
    assert sum(net[0].values()) == rows


@pytest.mark.parametrize("kind", ["delta", "iceberg"])
def test_reserved_columns_are_refused_alike(tmp_path, kind):
    for pw in PACKAGES:
        with pytest.raises(ValueError, match="collide"):
            write_lake(pw, kind, str(tmp_path / pw.__name__), pw.debug.table_from_markdown("diff | v\n1 | a"))


def test_avro_containers_are_byte_equal(tmp_path):
    schema = {"type": "record", "name": "rec", "fields": [
        {"name": "s", "type": "string"}, {"name": "n", "type": "long"},
        {"name": "maybe", "type": ["null", "long"], "default": None},
        {"name": "tags", "type": {"type": "array", "items": "string"}},
        {"name": "props", "type": {"type": "map", "values": "long"}}, {"name": "flag", "type": "boolean"},
        {"name": "f", "type": "double"}, {"name": "b", "type": "bytes"},
        {"name": "sub", "type": {"type": "record", "name": "sub", "fields": [{"name": "x", "type": "int"}]}}]}
    records = [{"s": "héllo", "n": -12345678901, "maybe": None, "tags": ["a", "b"], "props": {"k": 7}, "flag": True,
                "f": 2.5, "b": b"\x00\x01", "sub": {"x": 1}},
               {"s": "", "n": 0, "maybe": 9, "tags": [], "props": {}, "flag": False, "f": -0.125, "b": b"",
                "sub": {"x": -2}}]
    blobs, back = [], []
    for pw in PACKAGES:
        avro = importlib.import_module(f"{pw.__name__}.io._avro")
        path = str(tmp_path / f"{pw.__name__}.avro")
        avro.write_container(path, schema, records)
        blobs.append(open(path, "rb").read())
        back.append(avro.read_container(path))
    assert blobs[1] == blobs[0] and back[1] == back[0] == records
    assert importlib.import_module("pathway_tpu_torch.io._avro")._SYNC in blobs[0]


def test_noted_a_list_column_cannot_be_read_back_after_a_retraction(tmp_path):
    """Noted in the reference: the lake readers hand a parquet list to the
    engine as a Python list, which its consolidation cannot hash."""
    for pw in PACKAGES:
        uri = str(tmp_path / pw.__name__)
        t = pw.debug.table_from_markdown("k | _time | _diff\n1 | 2 | 1\n1 | 4 | -1")

        @pw.udf
        def vec(k: int) -> np.ndarray:
            return np.arange(3, dtype=np.float32) + k

        write_lake(pw, "delta", uri, t.select(pw.this.k, vec=vec(pw.this.k)))
        pw.io.subscribe(read_lake(pw, "delta", uri, k=int, vec=np.ndarray),
                        on_change=lambda key, row, time, is_addition: None)
        with pytest.raises(TypeError, match="unhashable type: 'list'"):
            pw.run(monitoring_level=pw.MonitoringLevel.NONE)


def test_noted_start_from_timestamp_fails_on_a_table_with_versions(tmp_path):
    """Noted in the reference: ``_seek_to_timestamp`` opens ``_log_path``,
    which the module does not define."""
    write_lake(pj, "delta", str(tmp_path / "dl"))
    for pw in PACKAGES:
        t = pw.io.deltalake.read(str(tmp_path / "dl"), schema=pw.schema_from_types(k=int, v=str, f=float),
                                 mode="static", start_from_timestamp_ms=0)
        with pytest.raises(Exception, match="name '_log_path' is not defined"):
            P.capture(pw, {"t": t})
        pw.G.clear()


# ---------------------------------------------------------------------------
# sqlite, pyfilesystem, airbyte
# ---------------------------------------------------------------------------


class _Stop(Exception):
    pass


def drive(pw, reader, steps, drop=()) -> list:
    """Run ``reader`` to the end of ``steps``: after each ``COMMIT`` it
    emits, the next step (a function) changes its source; its rows and
    commits by ``canon_item`` (offsets left out)."""
    items, todo = [], list(steps)

    def emit(item):
        item = canon_item(pw, item, drop)
        if item[0] == "offset":  # a file reader's offsets carry the fs clock
            return
        items.append(item)
        if item == "COMMIT":
            if not todo:
                raise _Stop
            todo.pop(0)()

    with pytest.raises(_Stop):
        reader.run(emit)
    return items


def test_sqlite_streaming_reads_inserts_updates_and_deletes_alike(tmp_path):
    got = []
    for pw in PACKAGES:
        db = str(tmp_path / f"{pw.__name__}.db")
        conn = sqlite3.connect(db)
        conn.execute("CREATE TABLE t (id INTEGER PRIMARY KEY, name TEXT, score REAL)")
        conn.executemany("INSERT INTO t VALUES (?, ?, ?)", [(1, "a", 0.5), (2, "b", 1.5)])
        conn.commit()
        steps = [lambda: (conn.execute("INSERT INTO t VALUES (3, 'c', 2.5)"), conn.commit()),
                 lambda: (conn.execute("UPDATE t SET name = 'bb' WHERE id = 2"), conn.commit()),
                 lambda: (conn.execute("DELETE FROM t WHERE id = 1"), conn.commit())]
        sqlite_mod = importlib.import_module(f"{pw.__name__}.io.sqlite")
        schema = pw.schema_from_types(name=str, score=float)
        got.append(drive(pw, sqlite_mod._SqliteReader(db, "t", schema, streaming=True, poll_interval=0.01), steps))
        conn.close()
    assert got[1] == got[0]
    assert [i[0] for i in got[0] if i != "COMMIT"] == ["+", "+", "+", "-", "+", "-"]


def test_sqlite_static_read_alike(tmp_path):
    db = str(tmp_path / "s.db")
    with sqlite3.connect(db) as conn:
        conn.execute("CREATE TABLE t (name TEXT, n INTEGER)")
        conn.executemany("INSERT INTO t VALUES (?, ?)", [("x", 1), ("y", 2), ("x", 3)])
    conn.close()
    got = [net_of(pw, pw.io.sqlite.read(db, "t", pw.schema_from_types(name=str, n=int), mode="static"))
           for pw in PACKAGES]
    assert got[1] == got[0] and len(got[0]) == 3


def test_pyfilesystem_reads_and_replaces_a_modified_file_alike():
    mem = fsspec.filesystem("memory")
    got = []
    try:
        for pw in PACKAGES:
            mem.pipe_file("/vfs-h6b/a.txt", b"old")
            mem.pipe_file("/vfs-h6b/sub/b.txt", b"other")
            files = pw.io.pyfilesystem.read(mem, "/vfs-h6b", format="plaintext", mode="static")
            static = net_of(pw, files.select(pw.this.data, pw.this.path))  # modified_at is the fs clock
            vfs = importlib.import_module(f"{pw.__name__}.io.pyfilesystem")
            reader = vfs._VfsReader(mem, "/vfs-h6b", "plaintext", "streaming", 0.01)
            steps = [lambda: mem.pipe_file("/vfs-h6b/a.txt", b"new"), lambda: mem.rm("/vfs-h6b/a.txt")]
            got.append((static, drive(pw, reader, steps, drop={"modified_at"}),
                        drive(pw, vfs._VfsReader(mem, "/vfs-h6b", "plaintext", "streaming", 0.01), [],
                              drop={"modified_at"})))
            mem.rm("/vfs-h6b", recursive=True)
    finally:
        if mem.exists("/vfs-h6b"):
            mem.rm("/vfs-h6b", recursive=True)
    assert got[1] == got[0] and len(got[0][0]) == 2
    # the rewrite replaces a.txt's row under its key, the delete retracts it
    assert [i[0] for i in got[0][1] if i != "COMMIT"] == ["+", "+", "+", "-"]
    assert [i[0] for i in got[0][2] if i != "COMMIT"] == ["+"]


def _airbyte_reader(pw, src, streams=("users",)):
    airbyte = importlib.import_module(f"{pw.__name__}.io.airbyte")
    return airbyte._AirbyteReader(exec_command=f"{sys.executable} {src}", docker_image=None, config={},
                                  streams=list(streams), mode="static", refresh_interval=0.1, env_vars=None)


def _records(reader, state=None) -> list:
    if state is not None:
        reader.seek({"state": state})
    got = []
    reader.run(lambda item: got.append(item["data"].value) if isinstance(item, dict) else None)
    return got


@pytest.mark.parametrize("source", [FAKE_AIRBYTE_SOURCE, MODERN_STATE_SOURCE], ids=["legacy_state", "modern_state"])
def test_airbyte_exec_source_and_its_resume_alike(tmp_path, source):
    src = tmp_path / "source.py"
    src.write_text(source)
    got = []
    for pw in PACKAGES:
        first = _airbyte_reader(pw, src)
        records = _records(first)
        got.append((records, _records(_airbyte_reader(pw, src), state=first._state), first._state))
    assert got[1] == got[0] and got[0][0] and got[0][1] and got[0][1] != got[0][0]


def test_airbyte_read_and_multi_stream_state_alike(tmp_path):
    src = tmp_path / "source.py"
    src.write_text(FAKE_AIRBYTE_SOURCE)
    runs = [net_of(pw, pw.io.airbyte.read({"source": {"exec_command": f"{sys.executable} {src}", "config": {"seed": 1}}},
                                          streams=["users"], mode="static")) for pw in PACKAGES]
    assert runs[1] == runs[0] and len(runs[0]) == 2
    payloads = []
    for pw in PACKAGES:
        reader = _airbyte_reader(pw, "unused", streams=("users", "orders"))
        for name, cursor in (("users", 5), ("orders", 9), ("users", 7)):
            reader._record_state({"type": "STREAM", "stream": {"stream_descriptor": {"name": name},
                                                               "stream_state": {"cursor": cursor}}})
        payloads.append(reader._state_file_payload(reader._state))
    assert payloads[1] == payloads[0] and len(payloads[0]) == 2


def test_cli_airbyte_create_source_writes_jaxs_scaffold(tmp_path, monkeypatch):
    from pathway_tpu.io.airbyte import write_connection_scaffold
    from pathway_tpu_torch import cli

    for name in ("port", "jax"):
        (tmp_path / name).mkdir()
    monkeypatch.chdir(tmp_path / "port")
    assert cli.main(["airbyte", "create-source", "conn", "--image", "airbyte/source-x:1.0"]) == 0
    monkeypatch.chdir(tmp_path / "jax")
    write_connection_scaffold("conn", "airbyte/source-x:1.0")
    assert (tmp_path / "port" / "conn.yaml").read_text() == (tmp_path / "jax" / "conn.yaml").read_text()


SHAREPOINT = dict(tenant="t", client_id="c", cert_path="cert.pem", thumbprint="TP", root_path="/Shared Documents")


@pytest.mark.parametrize("licensed", [False, True], ids=["no_entitlement", "no_office365"])
def test_sharepoint_gates_alike(monkeypatch, licensed):
    errors = []
    for pw in PACKAGES:
        sharepoint = importlib.import_module(f"{pw.__name__}.xpacks.connectors.sharepoint")
        if licensed:
            config = importlib.import_module(f"{pw.__name__}.internals.config").get_config()
            monkeypatch.setattr(config, "license_key", make_license_file(["XPACK-SHAREPOINT"]))
        monkeypatch.setitem(sys.modules, "office365", None)
        with pytest.raises(Exception) as err:
            sharepoint.read("https://company.sharepoint.com/sites/S", **SHAREPOINT)
        errors.append((type(err.value).__name__, str(err.value)))
    assert errors[1] == errors[0]
    assert errors[0][0] == ("ImportError" if licensed else "InsufficientLicenseError")

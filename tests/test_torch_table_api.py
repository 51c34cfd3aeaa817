"""The rest of the port's Table API against the JAX package's.

Each program of the JAX package's tests over ``pw.sql``
(``tests/test_sql.py``), ``export_table``/``import_table`` and
``Table.live()`` (``tests/test_export_import.py``), ``pw.transformer``
(``tests/test_transformers_viz_hmm.py``), ``pw.load_yaml``
(``tests/test_cli_yaml.py``) and ``pw.table_transformer``
(``tests/test_coverage_fill.py``) runs here as a function of the package,
once through ``pathway_tpu`` and once through ``pathway_tpu_torch``; the
outputs (change streams with keys and float bits, exported row logs,
snapshots, errors) must be equal.  The streaming programs gate their
reader on what the importer has seen, not on sleeps, so their epochs
overlap in every run.
"""

from __future__ import annotations

import importlib
import io
import threading
import time
import warnings

import pytest

import pathway_tpu as pj
import pathway_tpu_torch as pt
from tests import torch_dataflow_programs as P

PACKAGES = (pj, pt)
WAIT_S = 10.0


def T(pw, md: str):
    return pw.debug.table_from_markdown(md)


def capture(pw, table) -> list:
    return P.capture(pw, {"t": table})["t"]


def outcome(program, pw):
    """``program(pw)``'s output, or the error it raised by class and text."""
    pw.G.clear()
    try:
        return program(pw)
    except Exception as exc:  # noqa: BLE001 — compared across the packages
        return ("raised", type(exc).__name__, str(exc))
    finally:
        pw.G.clear()


def assert_same(program, raises: str | None = None) -> None:
    """Both packages give one output: rows, or the error ``raises`` names."""
    want, got = (outcome(program, pw) for pw in PACKAGES)
    assert got == want
    raised = isinstance(want, tuple) and want[:1] == ("raised",)
    assert (want[1] if raised else None) == raises, want
    assert raised or want


# ---------------------------------------------------------------------------
# pw.sql: (tables, query) of each program of tests/test_sql.py
# ---------------------------------------------------------------------------

TAB = "a | b | grp\n1 | 10 | x\n2 | 20 | x\n3 | 30 | y\n4 | 40 | y"
ORDERS = "oid | cust | amount\n1 | a | 10\n2 | b | 20\n3 | zz | 30"
CUSTOMERS = "cname | city\na | rome\nb | oslo"
SETS = {"l": "v\n1\n2\n2\n3", "r": "v\n2\n3\n4"}

SQL = {
    "projection": ({"tab": TAB}, "SELECT a, b FROM tab"),
    "expression_alias": ({"tab": TAB}, "SELECT a + b AS s FROM tab"),
    "where": ({"tab": TAB}, "SELECT a FROM tab WHERE b > 20"),
    "where_and": ({"tab": TAB}, "SELECT a FROM tab WHERE a > 1 AND b < 40"),
    "where_or": ({"tab": TAB}, "SELECT a FROM tab WHERE a = 1 OR a = 4"),
    "group_by": ({"tab": TAB}, "SELECT grp, COUNT(*) AS c, SUM(b) AS s FROM tab GROUP BY grp"),
    "group_by_having": ({"tab": TAB}, "SELECT grp, SUM(a) AS s FROM tab GROUP BY grp HAVING SUM(a) > 3"),
    "union_all": ({"t1": "a\n1", "t2": "a\n2"}, "SELECT a FROM t1 UNION ALL SELECT a FROM t2"),
    "avg_min_max": ({"tab": TAB}, "SELECT grp, AVG(b) AS m, MIN(a) AS lo, MAX(a) AS hi FROM tab GROUP BY grp"),
    "select_star": ({"t": "a | b\n1 | 2"}, "SELECT * FROM t"),
    "inner_join": ({"orders": ORDERS, "customers": CUSTOMERS},
                   "SELECT o.oid, c.city FROM orders o JOIN customers c ON o.cust = c.cname"),
    "left_join": ({"a": "k | v\n1 | x\n2 | y", "b": "k2 | w\n1 | z"},
                  "SELECT a.v, b.w FROM a LEFT JOIN b ON a.k = b.k2"),
    "join_residual": ({"a": "k | v\n1 | 5\n1 | 50", "b": "k2 | lim\n1 | 10"},
                      "SELECT a.v FROM a JOIN b ON a.k = b.k2 AND a.v < b.lim"),
    "cross_join": ({"a": "x\n1\n2", "b": "y\n10"}, "SELECT a.x, b.y FROM a, b"),
    "three_way_join": ({"a": "ka | va\n1 | p", "b": "kb | vb\n1 | q", "c": "kc | vc\n1 | r"},
                       "SELECT a.va, b.vb, c.vc FROM a JOIN b ON a.ka = b.kb JOIN c ON b.kb = c.kc"),
    "subquery_in_from": ({"tab": TAB}, "SELECT grp, s FROM (SELECT grp, SUM(a) AS s FROM tab GROUP BY grp) sub "
                                       "WHERE s > 3"),
    "distinct": ({"t": "v\n1\n1\n2"}, "SELECT DISTINCT v FROM t"),
    "union_dedups": ({"t1": "a\n1\n2", "t2": "a\n2\n3"}, "SELECT a FROM t1 UNION SELECT a FROM t2"),
    "between": ({"tab": TAB}, "SELECT a FROM tab WHERE a BETWEEN 2 AND 3"),
    "in_list": ({"tab": TAB}, "SELECT a FROM tab WHERE grp IN ('y')"),
    "is_null": ({"t": "a | b\n1 | x\n2 |"}, "SELECT a FROM t WHERE b IS NULL"),
    "is_not_null": ({"t": "a | b\n1 | x\n2 |"}, "SELECT a FROM t WHERE b IS NOT NULL"),
    "count_and_sum": ({"t": "a | b\n1 | 2\n3 |"}, "SELECT COUNT(*) AS n, SUM(a) AS s FROM t"),
    "string_literal_quotes": ({"t": "name | v\nann's | 1\nbob | 2"}, "SELECT v FROM t WHERE name = 'ann''s'"),
    "unknown_column": ({"t": "a\n1"}, "SELECT nope FROM t"),
    "mangle_no_alias_collision": ({"t1": "k | b_c\n1 | 100", "t2": "k | c\n1 | 999"},
                                  "SELECT a.b_c AS x, a_b.c AS y FROM t1 AS a JOIN t2 AS a_b ON a.k = a_b.k"),
    "duplicate_output_name": ({"t": "a | b\n1 | 2"}, "SELECT SUM(a), SUM(b) FROM t"),
    "with_cte": ({"tab": TAB}, "WITH big AS (SELECT a, grp FROM tab WHERE a > 1) "
                               "SELECT grp, COUNT(*) AS c FROM big GROUP BY grp"),
    "chained_ctes": ({"tab": TAB}, "WITH big AS (SELECT a, grp FROM tab WHERE a > 1), "
                                   "     counts AS (SELECT grp, COUNT(*) AS c FROM big GROUP BY grp) "
                                   "SELECT grp FROM counts WHERE c = 2"),
    "cte_shadows_table": ({"tab": TAB}, "WITH tab AS (SELECT a FROM tab WHERE a = 1) SELECT a FROM tab"),
    "with_recursive": ({"tab": TAB}, "WITH RECURSIVE r AS (SELECT a FROM tab) SELECT a FROM r"),
    "intersect": (SETS, "SELECT v FROM l INTERSECT SELECT v FROM r"),
    "except": ({"l": SETS["l"], "r": "v\n2\n4"}, "SELECT v FROM l EXCEPT SELECT v FROM r"),
    "intersect_binds_tighter": ({"a": "v\n1", "b": "v\n2", "c": "v\n2\n3"},
                                "SELECT v FROM a UNION SELECT v FROM b INTERSECT SELECT v FROM c"),
    "set_op_arity": ({"tab": TAB}, "SELECT a, b FROM tab INTERSECT SELECT a FROM tab"),
    "scalar_subquery_where": ({"tab": TAB}, "SELECT a FROM tab WHERE b > (SELECT AVG(b) FROM tab)"),
    "scalar_subquery_arithmetic": ({"tab": TAB}, "SELECT a FROM tab WHERE b >= (SELECT MAX(b) FROM tab) - 10"),
    "scalar_subquery_having": ({"tab": TAB}, "SELECT grp, SUM(b) AS s FROM tab GROUP BY grp "
                                             "HAVING SUM(b) > (SELECT MAX(b) FROM tab)"),
    "scalar_subquery_not_aggregate": ({"tab": TAB}, "SELECT a FROM tab WHERE b > (SELECT b FROM tab)"),
    "in_subquery": ({"tab": TAB}, "SELECT a FROM tab WHERE a IN (SELECT a FROM tab)"),
    "having_alias": ({"tab": TAB}, "SELECT grp, SUM(a) AS s FROM tab GROUP BY grp HAVING s > 3"),
    "having_alias_vs_column": ({"tab": TAB}, "SELECT grp, MAX(b) AS m FROM tab GROUP BY grp HAVING m >= 40"),
    "having_derived_name": ({"tab": TAB}, "SELECT grp, COUNT(*) FROM tab GROUP BY grp HAVING count >= 2"),
    "cte_set_ops_subquery": ({"tab": TAB}, "WITH hi AS (SELECT a FROM tab WHERE b > (SELECT AVG(b) FROM tab)), "
                                           "     lo AS (SELECT a FROM tab WHERE a <= 2) "
                                           "SELECT a FROM hi UNION SELECT a FROM lo EXCEPT SELECT a FROM tab "
                                           "WHERE a = 4"),
    "case_searched": ({"t": "a\n1\n5\n9"}, "SELECT a, CASE WHEN a > 4 THEN 'big' ELSE 'small' END AS size FROM t"),
    "case_simple_no_else": ({"t": "a | b\n1 | x\n5 | y\n9 | z"},
                            "SELECT a, CASE b WHEN 'x' THEN 10 WHEN 'y' THEN 20 END AS code FROM t"),
    "case_priority": ({"t": "a\n1\n5\n9"},
                      "SELECT CASE WHEN a > 6 THEN 'hi' WHEN a > 2 THEN 'mid' ELSE 'lo' END AS lvl FROM t"),
    "case_aggregate": ({"t": "a | b\n1 | x\n5 | y\n9 | x"},
                       "SELECT b, CASE WHEN SUM(a) > 5 THEN 'hot' ELSE 'cold' END AS tag FROM t GROUP BY b"),
    "if_function": ({"t": "a\n1\n9"}, "SELECT IF(a > 4, 'big', 'small') AS s FROM t"),
    "nullif_function": ({"t": "a\n1\n5"}, "SELECT NULLIF(a, 1) AS n FROM t"),
    "case_else_without_when": ({"t": "a\n1"}, "SELECT CASE ELSE 1 END AS x FROM t"),
    "case_without_when": ({"t": "a\n1"}, "SELECT CASE a END AS x FROM t"),
    # the log monitor's query of chip_smoke.py's [table_api]
    "having_count_join": ({"lines": "label | score\nx | 0.5\nx | 0.25\ny | 0.75\nx | 1.0\ny | 0.5",
                           "templates": "label | severity\nx | 3\ny | 1\nz | 2"},
                          "SELECT l.label, COUNT(*) AS n, AVG(l.score) AS mean, t.severity FROM lines l "
                          "JOIN templates t ON l.label = t.label GROUP BY l.label, t.severity "
                          "HAVING COUNT(*) >= 3"),
}


SQL_ERRORS = {"case_else_without_when", "case_without_when", "duplicate_output_name", "in_subquery",
              "scalar_subquery_not_aggregate", "set_op_arity", "unknown_column", "with_recursive"}


@pytest.mark.parametrize("name", sorted(SQL))
def test_sql_matches_jax(name):
    tables, query = SQL[name]

    def program(pw):
        return capture(pw, pw.sql(query, **{k: T(pw, md) for k, md in tables.items()}))

    assert_same(program, "SqlError" if name in SQL_ERRORS else None)


def test_sql_except_null_rows_compare_equal():
    def program(pw):
        l2 = pw.sql("SELECT v, NULL AS n FROM l", l=T(pw, "v\n1\n2"))
        r2 = pw.sql("SELECT v, NULL AS n FROM r", r=T(pw, "v\n2"))
        return capture(pw, pw.sql("SELECT v, n FROM l2 EXCEPT SELECT v, n FROM r2", l2=l2, r2=r2))

    assert_same(program)


# ---------------------------------------------------------------------------
# export_table / import_table / Table.live (tests/test_export_import.py)
# ---------------------------------------------------------------------------


def _utils(pw):
    return importlib.import_module(pw.__name__ + ".io._utils")


def _log(exported) -> list:
    return [(int(k), P.canon(r), t, d) for k, r, t, d in exported.data_from_offset(0)[0]]


def _subscribe(pw, table, on_row=None) -> list:
    out = []

    def on_change(key, row, time, is_addition):
        out.append((P.canon(key), P.canon(tuple(sorted(row.items()))), time, is_addition))
        if on_row is not None:
            on_row()

    pw.io.subscribe(table, on_change=on_change)
    return out


def _gated_table(pw, schema, first: list, second: list, release: threading.Event):
    """A streaming table of two commits; the second waits for ``release``."""
    U = _utils(pw)

    class Gated(U.Reader):
        def run(self, emit):
            for rows, gate in ((first, None), (second, release)):
                if gate is not None:
                    gate.wait(WAIT_S)
                for row in rows:
                    emit(row)
                emit(U.COMMIT)

    return U.make_input_table(schema, Gated, autocommit_duration_ms=50)


def _until(exported, ready) -> None:
    """Wait on the handle's condition until ``ready()`` holds."""
    deadline = time.monotonic() + WAIT_S
    while not ready():
        assert time.monotonic() < deadline, "the exporting run stalled"
        exported.wait(len(exported.data_from_offset(0)[0]), exported.frontier(), 0.5)


def _run_exporter(pw, **kwargs):
    errs: list = []

    def target():
        try:
            pw.run(**kwargs)
        except Exception as exc:  # noqa: BLE001 — the programs report it
            errs.append(type(exc).__name__)

    thread = threading.Thread(target=target, name="exporter")
    thread.start()
    return thread, errs


def export_sequential(pw):
    t = T(pw, "word  | n\napple | 2\nplum  | 3\napple | 5")
    summed = t.groupby(pw.this.word).reduce(word=pw.this.word, total=pw.reducers.sum(pw.this.n))
    exported = pw.export_table(summed)
    pw.run()
    state = (exported.done, exported.failed, exported.frontier())
    pw.G.clear()
    imported = pw.import_table(exported)
    rows = _subscribe(pw, imported.select(pw.this.word, d=pw.this.total * 2))
    pw.run()
    return {"state": state, "log": _log(exported), "columns": sorted(imported.column_names()),
            "imported": sorted(rows)}


def export_updates(pw):
    t = T(pw, "word | n | _time | _diff\na | 1 | 2 | 1\na | 1 | 4 | -1\na | 7 | 4 | 1\nb | 2 | 6 | 1")
    exported = pw.export_table(t)
    pw.run()
    pw.G.clear()
    changes = _subscribe(pw, pw.import_table(exported))
    pw.run()
    return {"log": _log(exported), "imported": sorted(changes)}


def export_concurrent(pw):
    """The importer reads the first commit while the exporter still runs:
    the reader's second commit waits until the importer has seen a row."""
    release = threading.Event()
    t = _gated_table(pw, pw.schema_from_types(word=str, n=int), [{"word": "x", "n": 1}],
                     [{"word": "y", "n": 2}], release)
    exported = pw.export_table(t)
    thread, errs = _run_exporter(pw)
    _until(exported, lambda: exported.data_from_offset(0)[0])
    pw.G.clear()
    rows = _subscribe(pw, pw.import_table(exported), on_row=release.set)
    pw.run()
    thread.join(WAIT_S)
    return {"errs": errs, "rows": sorted((k, r, add) for k, r, _t, add in rows),
            "import_times": len({t for _k, _r, t, _a in rows})}


def export_failure(pw):
    """The exporting run dies on its second commit: the importer raises."""
    release = threading.Event()
    t = _gated_table(pw, pw.schema_from_types(n=int), [{"n": 1}], [{"n": 2}], release)
    exported = pw.export_table(t.select(v=pw.udf(lambda n: 1 // (2 - n))(pw.this.n)))
    thread, errs = _run_exporter(pw, terminate_on_error=True)
    _until(exported, lambda: exported.data_from_offset(0)[0])
    pw.G.clear()
    _subscribe(pw, pw.import_table(exported), on_row=release.set)
    ei = importlib.import_module(pw.__name__ + ".internals.export_import")
    with pytest.raises(ei.ImportedTableFailed) as failed:
        pw.run()
    thread.join(WAIT_S)
    return {"errs": errs, "importer": str(failed.value), "failed": exported.failed}


def table_live(pw):
    """A live table's snapshot mid-stream, then its final one, then the
    live table composed into a later run."""
    release = threading.Event()
    t = _gated_table(pw, pw.schema_from_types(word=str, n=int), [{"word": "x", "n": 1}],
                     [{"word": "y", "n": 2}], release)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        live = t.live()
    _until(live._exported, lambda: live.snapshot().data)
    mid = live.snapshot()
    release.set()
    final = live.wait_for(WAIT_S).snapshot()
    rows = _subscribe(pw, live.select(pw.this.word, d=pw.this.n * 2))
    pw.run()
    return {"warnings": [str(w.message) for w in caught], "failed": live.failed(),
            "mid": (mid.done, P.canon(mid.data)),
            "final": (final.done, P.canon(final.data), str(final).splitlines()[0], str(live) == str(final)),
            "composed": sorted((k, r, add) for k, r, _t, add in rows)}


def import_only_closed_epochs(pw):
    """Rows of an epoch the exporter has not closed are withheld."""
    ei = importlib.import_module(pw.__name__ + ".internals.export_import")
    df = importlib.import_module(pw.__name__ + ".engine.dataflow")
    exported = ei.ExportedTable(pw.schema_from_types(n=int))
    node = df.InputNode(df.Scope())
    poller = ei._ImportPoller(node, exported)
    seen = []
    exported._push(1, (10,), 2, 1)
    exported._push(2, (20,), 2, 1)
    seen.append((poller.poll(), node.pending_times()))
    exported._advance(2)
    exported._push(3, (30,), 4, 1)
    seen.append((poller.poll(), node.pending_times()))
    exported._advance(4)
    exported._finish()
    seen.append((poller.poll(), node.pending_times(), node.finished))
    return seen


EXPORT = {f.__name__: f for f in (export_sequential, export_updates, export_concurrent, export_failure,
                                  table_live, import_only_closed_epochs)}


@pytest.mark.parametrize("name", sorted(EXPORT))
def test_export_import_matches_jax(name):
    assert_same(EXPORT[name])


# ---------------------------------------------------------------------------
# pw.transformer (tests/test_transformers_viz_hmm.py), pw.table_transformer
# ---------------------------------------------------------------------------


def transformer_simple(pw):
    class OutputSchema(pw.Schema):
        ret: int

    @pw.transformer
    class foo_transformer:
        class table(pw.ClassArg, output=OutputSchema):
            arg = pw.input_attribute()

            @pw.output_attribute
            def ret(self) -> int:
                return self.arg + 1

    return capture(pw, foo_transformer(T(pw, "  | arg\n1 | 1\n2 | 2\n3 | 3")).table)


def transformer_pointers(pw):
    """A linked list's lengths through next-pointers."""
    types = importlib.import_module(pw.__name__ + ".engine.types")

    @pw.transformer
    class linked_list_transformer:
        class linked_list(pw.ClassArg):
            next = pw.input_attribute()

            @pw.output_attribute
            def len(self) -> int:
                if self.next is None:
                    return 1
                return 1 + self.transformer.linked_list[self.next].len

    t = T(pw, "  | n\n1 | 2\n2 | 3\n3 |")
    nodes = t.select(next=pw.apply(lambda n: None if n is None else pw.Pointer(types.hash_values([str(n)])),
                                   pw.this.n))
    return capture(pw, linked_list_transformer(nodes).linked_list)


def transformer_methods(pw):
    @pw.transformer
    class m:
        class table(pw.ClassArg):
            arg = pw.input_attribute()
            const = 10

            @pw.attribute
            def half(self) -> int:
                return self.arg // 2

            @pw.method
            def fun(self, a) -> int:
                return a * self.arg + self.const + self.half

    return capture(pw, m(T(pw, "  | arg\n1 | 4\n2 | 6")).table.select(r=pw.this.fun(100)))


def transformer_cycle(pw):
    @pw.transformer
    class cyc:
        class table(pw.ClassArg):
            arg = pw.input_attribute()

            @pw.output_attribute
            def a(self) -> int:
                return self.b

            @pw.output_attribute
            def b(self) -> int:
                return self.a

    return capture(pw, cyc(T(pw, "  | arg\n1 | 1")).table)


def transformer_no_churn(pw):
    """Unchanged rows are not retracted when another row arrives."""

    @pw.transformer
    class m:
        class table(pw.ClassArg):
            arg = pw.input_attribute()

            @pw.output_attribute
            def out(self) -> int:
                return self.arg

            @pw.method
            def f(self) -> int:
                return self.arg

    t = T(pw, "arg | _time\n1   | 2\n2   | 2\n3   | 4")
    return capture(pw, m(t).table.select(pw.this.out))


def table_transformer_schemas(pw):
    class In(pw.Schema):
        x: int

    @pw.table_transformer
    def double(t: pw.Table[In]) -> pw.Table:
        return t.select(y=pw.this.x * 2)

    return capture(pw, double(T(pw, "x\n1\n2")))


TRANSFORMERS = {f.__name__: f for f in (transformer_simple, transformer_pointers, transformer_methods,
                                        transformer_cycle, transformer_no_churn, table_transformer_schemas)}


@pytest.mark.parametrize("name", sorted(TRANSFORMERS))
def test_transformer_matches_jax(name):
    assert_same(TRANSFORMERS[name], "_CycleError" if name == "transformer_cycle" else None)


# ---------------------------------------------------------------------------
# pw.load_yaml (tests/test_cli_yaml.py); ``PKG`` is each package's name
# ---------------------------------------------------------------------------

YAML = {
    "tagged_objects": "table: !pw.debug.table_from_markdown\n  table_def: |\n    a | b\n    1 | 2\n",
    "variables_and_sharing": "$k: 7\nfirst:\n  k: $k\nsecond:\n  k: $k\n"
                             "shared: !PKG.internals.yaml_loader:Var\n  name: x\n"
                             "also_shared: $y\n$y: !PKG.internals.yaml_loader:Var\n  name: x\n",
    "env_fallback": "v: $MY_YAML_SETTING",
    "undefined_lowercase": "v: $not_defined_lowercase",
    "unused_variable": "$dead: 1\nlive: 2",
    "lexical_scoping": "$a: $b\ninner:\n  $b: 1\n  v: $a\n",
    "var_keys_in_tagged_mapping": "d: !dict\n  $p: 7\n  k: $p\n",
    "env_value_constructed_once": "a: $SHARED_OBJ\nb: $SHARED_OBJ",
    "env_circular": "v: $LOOPY",
    "circular": "$a: $a\nv: $a",
    "empty_tag_calls_or_returns": "d: !dict\ns: !PKG.internals.yaml_loader:_VAR_TAG",
}
YAML_ERRORS = {"circular": "ValueError", "env_circular": "ValueError", "lexical_scoping": "KeyError",
               "undefined_lowercase": "KeyError"}


def _plain(value, pw):
    """A loaded value in a form both packages give alike."""
    if isinstance(value, dict):
        return {k: _plain(v, pw) for k, v in value.items()}
    if isinstance(value, pw.Table):
        return ("Table", list(value.column_names()))
    if type(value).__name__ == "Var":
        return ("Var", value.name)
    return value


@pytest.mark.parametrize("name", sorted(YAML))
def test_load_yaml_matches_jax(name, monkeypatch):
    monkeypatch.setenv("MY_YAML_SETTING", "42")
    monkeypatch.setenv("LOOPY", "$LOOPY")

    def program(pw):
        monkeypatch.setenv("SHARED_OBJ", f"!{pw.__name__}.internals.yaml_loader:Var {{name: x}}")
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = pw.load_yaml(io.StringIO(YAML[name].replace("PKG", pw.__name__)))
        shared = out.get("a") is out.get("b") if "a" in out else None
        return _plain(out, pw), shared, [str(w.message) for w in caught]

    assert_same(program, YAML_ERRORS.get(name))


def test_import_object_forms():
    for pw in PACKAGES:
        yl = importlib.import_module(pw.__name__ + ".internals.yaml_loader")
        assert yl.import_object("pw.io.csv") is pw.io.csv
        assert yl.import_object(f"{pw.__name__}.internals.yaml_loader:load_yaml") is pw.load_yaml
        assert yl.import_object("len") is len

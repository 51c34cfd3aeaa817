"""The static-input part of the connectors' shared plumbing.

A copy of ``make_static_input_table`` and its persistence bookkeeping from
``pathway_tpu/io/_utils.py``: what ``Table.empty`` and ``pw.debug`` need.
The reader-thread → queue → poller machinery of the streaming connectors
arrives with slice H2.  Without a persistence storage (slice H4)
``register_static_persistence`` returns at once.
"""

from __future__ import annotations

from typing import Any, Iterable, Mapping

from pathway_tpu_torch.engine import dataflow as df
from pathway_tpu_torch.engine.types import KEY_MASK, hash_values, sequential_keys
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import schema as schema_mod
from pathway_tpu_torch.internals.table import Lowerer, Table, Universe


def schema_digest(schema: type[schema_mod.Schema]) -> str:
    """The persistence compatibility digest: resumed runs refuse a source
    whose digest changed (one definition — the format is a contract)."""
    return "|".join(
        f"{n}:{schema.__columns__[n].dtype}" for n in schema.__columns__
    )


def register_static_persistence(lowerer, node, schema=None) -> None:
    """Operator-persistence bookkeeping for build-time (static) sources.

    Restored operator state already contains the effects of static rows
    from the previous run, so re-emitting them would double-apply state
    (joins against a static side over-count after resume).  The static
    source registers a trivial offset: {"done": true} commits once the
    engine processed the rows' epoch, and a resume that finds it skips
    emission entirely.
    """
    storage = getattr(lowerer, "persistence_storage", None)
    if storage is None or not getattr(storage, "operator_persistence", False):
        return
    counter = getattr(lowerer, "_source_counter", 0)
    lowerer._source_counter = counter + 1
    base_sid = sid = f"static_{counter}"
    worker = getattr(lowerer.scope, "worker", None)
    if worker is not None and worker.worker_count > 1:
        sid = f"{sid}-w{worker.worker_id}"
    state = storage.register_source(
        sid,
        schema_digest=None if schema is None else schema_digest(schema),
        base=base_sid,
    )
    if state.offset is not None:
        node.clear_staged()
        return
    last_t = max(node._staged.keys(), default=0)
    state.pending_offsets.append(({"done": True}, last_t))


def make_static_input_table(
    schema: type[schema_mod.Schema],
    rows: Iterable[Mapping[str, Any]],
) -> Table:
    """Static source: all rows at time 0 (connector static mode)."""
    names = list(schema.__columns__.keys())
    dtypes = [schema.__columns__[n].dtype for n in names]
    pk = schema.primary_key_columns()
    keyed: list = []
    auto_rows: list[int] = []  # positions needing a sequential auto key
    explicit_keys = False
    for row in rows:
        values = [dt.coerce(row.get(n), d) for n, d in zip(names, dtypes)]
        if "_pw_key" in row:
            k = row["_pw_key"]
            key = (k & KEY_MASK) if isinstance(k, int) else hash_values([k])
            explicit_keys = True
        elif pk:
            key = hash_values([values[names.index(c)] for c in pk])
            explicit_keys = True
        else:
            # key filled below: the bulk native derivation is ~10x the
            # per-row call at 1M rows
            auto_rows.append(len(keyed))
            key = None
        keyed.append((key, tuple(values), 1))
    if auto_rows:
        keys = sequential_keys(0, len(auto_rows))
        for pos, key in zip(auto_rows, keys):
            old = keyed[pos]
            keyed[pos] = (key, old[1], old[2])
    # all-auto keys are unique by construction: the whole batch is a
    # provably-clean epoch and the emit path's consolidate scan collapses
    # to a tag check.  pk/_pw_key rows may collide, so they stay unproven.
    if not explicit_keys:
        keyed = df.CleanDeltas(keyed)

    def build(lowerer: Lowerer) -> df.Node:
        deltas_for_worker = keyed
        worker = getattr(lowerer.scope, "worker", None)
        if worker is not None and worker.worker_count > 1:
            # every worker computed identical keys from identical build-time
            # data; each keeps only its own shard (SPMD data ownership) —
            # a key-subset of a clean batch stays clean
            subset = [
                e for e in keyed if worker.owner_of(e[0]) == worker.worker_id
            ]
            deltas_for_worker = (
                df.CleanDeltas(subset)
                if isinstance(keyed, df.CleanDeltas)
                else subset
            )
        node = df.StaticNode(lowerer.scope, prestaged=deltas_for_worker)
        register_static_persistence(lowerer, node, schema=schema)
        return node

    return Table(schema, build, universe=Universe())

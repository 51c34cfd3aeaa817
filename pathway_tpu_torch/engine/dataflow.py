"""The incremental dataflow engine.

Parity target: ``src/engine/dataflow.rs`` (6,173 LoC) +
``src/engine/graph.rs`` (the ~45-method ``Graph`` trait).  Re-designed rather
than translated:

* The reference schedules fine-grained differential operators cooperatively
  (``worker.step_or_park``).  Here the unit of work is an **epoch batch**: all
  deltas that share a commit timestamp flow through the operator DAG in one
  topologically-ordered pass.  That matches how a TPU program wants to see
  work — large consolidated batches that can be padded to fixed shapes and
  jitted — instead of row-at-a-time callbacks.
* Collections are multisets of ``(key, row, diff)`` with 128-bit keys
  (``engine/types.py``); every operator is delta-correct: retractions
  (diff = -1) flow through joins, groupbys, and indexes exactly as in
  differential dataflow.
* Stateful operators own explicit dict-based arrangements; there is no
  shared-arrangement machinery, which differential needs because operators
  run concurrently — here the per-epoch barrier makes sharing trivial.

The node set mirrors the Graph trait surface (graph.rs:643-986): input,
expression/select, filter, flatten, reindex, update_cells/update_rows,
concat, intersect/difference/restrict, ix, join (all modes), groupby/reduce,
deduplicate, buffer/freeze/forget (temporal behaviors from time_column.rs),
sort (prev/next), external index as-of-now, output/subscribe, iterate,
gradual_broadcast, error log.
"""

from __future__ import annotations

import itertools
from collections import Counter, defaultdict
from time import monotonic as _monotonic
from typing import Any, Callable, Iterable, Sequence

from pathway_tpu_torch.engine.types import (
    ERROR,
    Error,
    Pointer,
    Time,
    as_hashable,
    hash_values,
)

Row = tuple
Delta = tuple  # (key:int, row:Row, diff:int)


def _serving_note_row_error(key: int, message: str) -> None:
    """Poisoned-cell hook: if this row key is an in-flight REST request,
    complete its waiting HTTP future as a typed 500 and quarantine the
    record (engine/serving.py) — a cheap no-op when nothing is serving."""
    from pathway_tpu_torch.engine import serving as _serving

    _serving.note_row_error(key, message)


class CleanDeltas(list):
    """Delta list known to be all-insert (+1) with pairwise-distinct keys.

    Such a list cannot cancel or merge, so ``consolidate`` is the identity
    on it.  Producers whose transformation preserves the property (1:1 maps,
    filters, key-fresh flattens) re-tag their output, letting the ingest-
    heavy epochs skip the O(n) clean-scan at every node boundary — that scan
    was the hottest host-path line at 1M rows/epoch.
    """


_native_consolidate = None
_native_checked = False


_native_module = None


def _get_native_module():
    global _native_module, _native_checked, _native_consolidate
    if not _native_checked:
        _native_checked = True
        try:
            from pathway_tpu_torch import native as _nat

            _native_module = _nat.get()
            _native_consolidate = getattr(
                _native_module, "consolidate_dirty", None
            )
        except Exception:
            _native_module = None
            _native_consolidate = None
    return _native_module


def _get_native_consolidate():
    _get_native_module()
    return _native_consolidate


def consolidate(deltas: Iterable[Delta]) -> list[Delta]:
    if isinstance(deltas, CleanDeltas):
        return deltas
    if not isinstance(deltas, list):
        deltas = list(deltas)
    # fast path: all-distinct-key inserts cannot cancel or merge — CPython's
    # int-set scan beats a C++ hash table here (measured 1.6x), while the
    # native accumulation below wins 2x on retraction-heavy batches
    keys: set[int] = set()
    clean = True
    for key, _, diff in deltas:
        if diff != 1 or key in keys:
            clean = False
            break
        keys.add(key)
    if clean:
        return CleanDeltas(deltas)
    nc = _get_native_consolidate()
    if nc is not None:
        out = nc(deltas)  # precondition: batch proven dirty above
        if out is not None:  # None = diffs beyond int64, use Python path
            return out
    acc: Counter = Counter()
    for key, row, diff in deltas:
        acc[(key, row)] += diff
    # retractions before insertions: stateful consumers replace a row by
    # applying (-old, +new) for the same key — the insert landing first
    # would be popped by the retract and the row silently lost
    out = [(k, r, d) for (k, r), d in acc.items() if d != 0]
    out.sort(key=lambda d: d[2] > 0)
    return out


class EngineError(RuntimeError):
    pass


def _vec_threshold() -> int:
    # single source of truth for the columnar batch threshold
    from pathway_tpu_torch.internals import vector_compiler as vc

    return vc.VEC_THRESHOLD


def _vec_temporal_arrays(node, deltas, op):
    """The temporal operators' shared columnar pre-pass: materialize the
    epoch batch's time/threshold columns once and apply the affine offsets
    (``engine/dataflow.py`` Buffer/Freeze/Forget all lower to ``column +
    const`` time math — see ``Table._temporal_op``).  Returns ``(t, thr)``
    arrays or None on a counted bail; dtype-kind mixes between the columns
    or against the running watermark bail because numpy's promotion would
    compare inexactly where the row path's Python scalars are exact."""
    from pathway_tpu_torch.internals import vector_compiler as vc

    t_idx, t_off, thr_idx, thr_off = node.vec_temporal
    cols = vc.materialize_delta_columns(deltas, {t_idx, thr_idx})
    if cols is None:
        vc.note_bail(op, "dirty-column")
        return None
    try:
        t = vc.affine_values(cols, t_idx, t_off)
        thr = vc.affine_values(cols, thr_idx, thr_off)
    except vc.VecBail:
        vc.note_bail(op, "value-guard")
        return None
    if t.dtype.kind != thr.dtype.kind:
        vc.note_bail(op, "dtype-mix")
        return None
    if t.dtype.kind == "f":
        import numpy as np

        # NaN diverges from the row oracle: t.max() would poison the
        # watermark where the sequential `t > wm` scan skips NaN, and a
        # NaN threshold wedges the forget expiry heap's ordering
        if np.isnan(t).any() or np.isnan(thr).any():
            vc.note_bail(op, "nan-time")
            return None
    wm = node._watermark
    if wm is not None and (
        (t.dtype.kind == "i" and type(wm) is not int)
        or (t.dtype.kind == "f" and type(wm) is not float)
    ):
        vc.note_bail(op, "watermark-dtype")
        return None
    return t, thr


class Node:
    """A dataflow operator. Subclasses implement ``step``."""

    name: str = "node"
    # Execution-path attribution (engine/profiler.py snapshots render each
    # operator as columnar / row / mixed): operators with a columnar fast
    # path bump vec_batches when a batch ran it and row_batches when a
    # batch fell to the row-wise evaluator.  Class-level zeros keep nodes
    # without fast paths attribute-cheap; the first bump shadows them.
    vec_batches: int = 0
    row_batches: int = 0
    # Append-only dataflow analysis (parity: column properties threaded
    # through lowering, python/pathway/internals/column_properties.py,
    # consumed by the engine's append_only_or_deterministic switches,
    # src/engine/dataflow.rs:1741): classes whose output stream is
    # append-only whenever every input stream is set
    # ``preserves_append_only``; ``infer_append_only`` fills the per-node
    # flags after lowering, and stateful operators pick cheaper
    # no-retraction accumulator variants off their input's flag.
    preserves_append_only = False

    def __init__(self, scope: "Scope", inputs: Sequence["Node"] = ()):
        self.append_only = False
        self.scope = scope
        self.inputs = list(inputs)
        self.downstream: list[tuple[Node, int]] = []
        self.pending: dict[int, list[Delta]] = defaultdict(list)
        self.keep_state = False
        self.state: dict[int, Row] = {}
        # key -> plain row (the common single-row multiplicity-1 case) or
        # Counter(row -> multiplicity); `state` holds the positive row
        self._state_rows: dict[int, Row | Counter] = {}
        self.id = scope._register(self)
        for port, inp in enumerate(self.inputs):
            inp.downstream.append((self, port))
        # monitoring counters (ProberStats analog, graph.rs:512)
        self.rows_in = 0
        self.rows_out = 0
        self.step_seconds = 0.0  # cumulative time in step(), probe-read
        # multi-worker exchange declaration (engine/comm.py WorkerContext):
        # port -> routing-key fn (None = route by row key), or gather-to-0
        # for globally-ordered operators.  The exchange point is exactly
        # where the reference reshards before stateful operators
        # (dataflow.rs:1414, shard.rs:15-20).
        self.exchange_routes: dict[int, Callable[[int, Row], int] | None] | None = None
        self.exchange_gather0 = False

    # -- wiring --
    def send(self, deltas: list[Delta], time: Time) -> None:
        if not deltas:
            return
        self.rows_out += len(deltas)
        for node, port in self.downstream:
            cur = node.pending.get(port)
            if not cur:
                # preserve the clean marker while the port holds one chunk;
                # concatenated chunks may collide keys, so they downgrade
                cls = CleanDeltas if isinstance(deltas, CleanDeltas) else list
                node.pending[port] = cls(deltas)
            elif isinstance(cur, CleanDeltas):
                plain = list(cur)
                plain.extend(deltas)
                node.pending[port] = plain
            else:
                cur.extend(deltas)

    def take_pending(self, port: int = 0) -> list[Delta]:
        deltas = self.pending.pop(port, [])
        self.rows_in += len(deltas)
        return deltas

    def _update_state(self, deltas: list[Delta]) -> None:
        """Maintain the per-key row multiset and the live-row view.

        Representation: ``_state_rows[key]`` is a plain row tuple while the
        key holds exactly one row at multiplicity 1 (the overwhelmingly
        common case — measured as the churn-benchmark hot spot when every
        key carried a Counter), and promotes to a ``Counter`` only for
        multi-row / non-unit multiplicities.
        """
        state_rows = self._state_rows
        state = self.state
        for key, row, diff in deltas:
            cur = state_rows.get(key)
            if cur is None:
                if diff == 1:
                    state_rows[key] = row
                    state[key] = row
                    continue
                cur = state_rows[key] = Counter()
            elif not isinstance(cur, Counter):
                if diff == -1 and cur == row:
                    del state_rows[key]
                    state.pop(key, None)
                    continue
                cur = state_rows[key] = Counter({cur: 1})
            cur[row] += diff
            if cur[row] == 0:
                del cur[row]
            if not cur:
                del state_rows[key]
                state.pop(key, None)
            else:
                for r, c in cur.items():
                    if c > 0:
                        state[key] = r
                        break
                else:
                    state.pop(key, None)

    def state_multiset(self) -> Counter:
        """(key, row) -> positive multiplicity of the maintained state."""
        out: Counter = Counter()
        for key, rows in self._state_rows.items():
            if not isinstance(rows, Counter):
                out[(key, rows)] = 1
                continue
            for r, c in rows.items():
                if c > 0:
                    out[(key, r)] = c
        return out

    def step(self, time: Time) -> None:
        """Process this epoch's pending input; emit output deltas."""
        deltas = self.take_pending()
        if self.keep_state:
            self._update_state(deltas)
        self.send(deltas, time)

    def flush(self, time: Time) -> None:
        """Epoch-boundary hook (after every node stepped)."""

    def on_finish(self) -> None:
        """All inputs exhausted; release any remaining buffered work."""

    def final_check(self) -> None:
        """After the finish-quiesce: report errors that only count if they
        survived to end-of-stream (e.g. strict ix dangling pointers)."""

    # -- operator snapshots (persistence/operator_snapshot.rs analog) --
    # subclasses list their arrangement attributes; dumps hold plain
    # picklable data (callables are re-bound by the rebuilt graph)
    _persist_attrs: tuple = ()

    def persist_dump(self):
        data: dict = {}
        if self.keep_state and self._state_rows:
            data["__state_rows"] = self._state_rows
        for a in self._persist_attrs:
            data[a] = getattr(self, a)
        if not data and not self.keep_state:
            return None
        return data

    def persist_load(self, data) -> None:
        for a, v in data.items():
            if a == "__state_rows":
                # snapshots may hold either form: plain row (multiplicity
                # 1) or a Counter/dict of multiplicities
                self._state_rows = {
                    k: Counter(c) if isinstance(c, dict) else c
                    for k, c in v.items()
                }
                self.state = {}
                for k, rows in self._state_rows.items():
                    if not isinstance(rows, Counter):
                        self.state[k] = rows
                        continue
                    for r, c in rows.items():
                        if c > 0:
                            self.state[k] = r
                            break
            else:
                setattr(self, a, v)

    def has_pending(self) -> bool:
        return any(self.pending.values())

    def require_state(self) -> "Node":
        self.keep_state = True
        return self

    def _infer_append_only(self) -> bool:
        return (
            self.preserves_append_only
            and bool(self.inputs)
            and all(i.append_only for i in self.inputs)
        )

    def __repr__(self):
        return f"<{self.__class__.__name__}#{self.id}>"


def infer_append_only(scope: "Scope") -> None:
    """Fill ``Node.append_only`` over a built graph.

    Creation order is topological (inputs exist before their consumers), so
    one forward pass suffices.  Runs after lowering, before any state is
    restored or stepped."""
    for node in scope.nodes:
        node.append_only = node._infer_append_only()


class InputNode(Node):
    """An input session: rows pushed by connectors / static data.

    Mirrors the InputSession+poller pattern (connectors/mod.rs:292, adaptors.rs).
    """

    name = "input"

    def __init__(self, scope: "Scope"):
        super().__init__(scope)
        self._staged: dict[Time, list[Delta]] = defaultdict(list)
        self._staged_wallclock: dict[Time, float] = {}
        # hot-bucket cache: streams insert runs of rows at one time, so
        # the common insert() is a single list append (no dict lookups,
        # no wallclock check).  Invalidate wherever staged lists are
        # popped or re-filed (merge_staged_through / emit_time).
        self._hot_time: Time | None = None
        self._hot_list: list[Delta] | None = None
        self.finished = False
        # ingest low-watermark of the epoch this node last emitted: the
        # earliest staged-row wall-clock folded into that epoch (set by
        # emit_time, read by the freshness tracker's per-operator
        # min-ingest-frontier pass — engine/freshness.py)
        self.epoch_ingest_wallclock: float | None = None
        # upsert sessions key rows and treat same-key insert as replace
        self.upsert = False
        # set by the io layer when the source schema declares append_only
        # (column_definition / schema properties); enforced at insert
        self.declared_append_only = False

    def _infer_append_only(self) -> bool:
        # upsert sessions synthesize retractions for overwritten keys, so a
        # declared-append-only upsert source still is not append-only
        return self.declared_append_only and not self.upsert

    def insert(self, key: int, row: Row, time: Time, diff: int = 1) -> None:
        if diff < 0 and self.append_only:
            raise EngineError(
                "retraction arrived at an append-only input: the schema "
                "declares append_only=True but the source produced a "
                "deletion"
            )
        if time == self._hot_time:
            self._hot_list.append((key, row, diff))
            return
        lst = self._staged[time]
        lst.append((key, row, diff))
        self._hot_time, self._hot_list = time, lst
        if time not in self._staged_wallclock:
            self._staged_wallclock[time] = _monotonic()

    def _invalidate_hot(self) -> None:
        """Drop the hot-bucket insert cache.  EVERY mutation of
        ``_staged`` outside ``insert()`` must call this (directly or via
        take_staged/put_staged/clear_staged) — a stale hot list keeps
        receiving appends into an orphaned object, silently losing rows."""
        self._hot_time = self._hot_list = None

    def take_staged(self, time: Time, default=None):
        """Pop a staged bucket (invalidates the hot-bucket cache)."""
        self._invalidate_hot()
        return self._staged.pop(time, default)

    def put_staged(self, time: Time, deltas: list) -> None:
        """Re-file a bucket (see ``take_staged``)."""
        self._invalidate_hot()
        self._staged[time] = deltas

    def clear_staged(self) -> None:
        """Discard every staged bucket (persistence resume skips static
        re-emission); keeps the hot cache consistent with the dicts."""
        self._invalidate_hot()
        self._staged.clear()
        self._staged_wallclock.clear()

    def pending_times(self) -> list[Time]:
        return sorted(self._staged.keys())

    def merge_staged_through(self, time: Time) -> None:
        """Fold rows staged at earlier times into epoch ``time`` (the runner
        picks one commit timestamp across all inputs), keeping the earliest
        ingest wallclock so latency probes measure from first arrival."""
        self._invalidate_hot()
        below = [st for st in self._staged if st <= time]
        if len(below) == 1:
            # single staged bucket: move the list object itself so a
            # CleanDeltas tag (stage_static's cleanliness proof) survives
            # and emit_time's consolidate becomes O(1)
            st = below[0]
            if st != time:
                self._staged[time] = self._staged.pop(st)
                w = self._staged_wallclock.pop(st, None)
                if w is not None:
                    self._staged_wallclock[time] = w
            return
        merged: list[Delta] = []
        wall: float | None = None
        for staged in sorted(below):
            merged.extend(self._staged.pop(staged))
            w = self._staged_wallclock.pop(staged, None)
            if w is not None:
                wall = w if wall is None else min(wall, w)
        if merged:
            self._staged[time] = merged
        if wall is not None:
            self._staged_wallclock[time] = wall

    def emit_time(self, time: Time) -> None:
        wall = self._staged_wallclock.pop(time, None)
        self.epoch_ingest_wallclock = wall
        if wall is not None:
            ew = self.scope.epoch_wallclock
            ew[time] = min(ew.get(time, wall), wall)
        deltas = self.take_staged(time, [])
        if self.upsert:
            # multiple updates of one key within an epoch must chain
            # (each retracts the PREVIOUS value, not the epoch-start one):
            # `seen` overlays committed state with this epoch's staged rows
            nat = _get_native_module()
            chain = getattr(nat, "upsert_chain", None) if nat else None
            if chain is not None and isinstance(self.state, dict):
                out = chain(deltas, self.state)
            else:
                out = []
                seen: dict[int, Row | None] = {}
                state_get = self.state.get
                _MISS = object()
                for key, row, diff in deltas:
                    prev = seen.get(key, _MISS)
                    if prev is _MISS:
                        prev = state_get(key)
                    if prev is not None:
                        out.append((key, prev, -1))
                    if diff > 0:
                        out.append((key, row, 1))
                        seen[key] = row
                    else:
                        seen[key] = None
            deltas = consolidate(out)
            self._update_state(deltas)
        else:
            deltas = consolidate(deltas)
            if self.keep_state:
                self._update_state(deltas)
        # input rows bypass take_pending, so count them here — monitoring
        # and the operator-snapshot dirty check both key off rows_in
        self.rows_in += len(deltas)
        self.send(deltas, time)

    def close(self) -> None:
        self.finished = True


class StaticNode(InputNode):
    """A table whose rows are known at build time (debug tables)."""

    name = "static"

    def __init__(
        self,
        scope: "Scope",
        rows: Iterable[tuple[int, Row, Time, int]] | None = None,
        *,
        prestaged: "list[Delta] | None" = None,
        prestaged_time: Time = 0,
    ):
        super().__init__(scope)
        now = _monotonic()
        if prestaged is not None:
            # the build function already produced epoch-shaped deltas (and tagged
            # CleanDeltas when provably clean) — stage the object as-is,
            # zero extra passes
            self._staged[prestaged_time] = prestaged
            self._staged_wallclock.setdefault(prestaged_time, now)
            self.finished = True
            self.declared_append_only = isinstance(
                prestaged, CleanDeltas
            ) or all(d >= 0 for (_, _, d) in prestaged)
            return
        # bulk-stage by time: per-row insert() was a measurable share of the
        # static-ingest epoch at 1M rows.  The native partitioner also
        # proves per-bucket cleanliness (unique keys, all diffs +1) so the
        # emit path's consolidate scan collapses to an O(1) tag check.
        stage = None
        nat = _get_native_module()
        if nat is not None:
            stage = getattr(nat, "stage_static", None)
        if stage is not None:
            rows_list = rows if isinstance(rows, list) else list(rows)
            staged = stage(rows_list, CleanDeltas)
            for time, deltas, clean in staged:
                self._staged[time] = deltas  # already CleanDeltas iff clean
                self._staged_wallclock.setdefault(time, now)
        else:
            by_time: dict[Time, list[Delta]] = defaultdict(list)
            for key, row, time, diff in rows:
                by_time[time].append((key, row, diff))
            for time, deltas in by_time.items():
                self._staged[time].extend(deltas)
                self._staged_wallclock.setdefault(time, now)
        self.finished = True
        # build-time rows are fully known: a static table with no deletion
        # diffs is factually append-only, no declaration needed
        self.declared_append_only = all(
            isinstance(ds, CleanDeltas) or all(d >= 0 for (_, _, d) in ds)
            for ds in self._staged.values()
        )


class ExprNode(Node):
    """Row-wise map: select/with_columns — evaluates compiled expressions.

    ``vec_select`` (set by the Lowerer when every output expression compiles
    to column ops) switches large batches to a numpy columnar evaluation —
    the §7.3 "columnar batches instead of row tuples" path.  The vector
    path bails back to the row interpreter on anything it cannot honor
    exactly (mixed/None columns, zero divisors, …).
    """

    name = "select"
    preserves_append_only = True

    def __init__(self, scope, inp: Node, fn: Callable[[int, Row], Row], deps: Sequence[Node] = ()):
        super().__init__(scope, [inp])
        self.fn = fn
        # (needed_col_indices, [fn per out col], [out dtype per out col])
        self.vec_select = None
        # join-select projection spec ((src, idx), ...) — set by the
        # Lowerer when every output is a plain left/right column or id
        # pick over JoinNode payload rows; one native C pass replaces the
        # per-row accessor closures (pure copies — no new Errors possible)
        self.vec_join_project = None
        for d in deps:
            d.require_state()

    def _try_columnar(self, deltas: list[Delta]) -> list[Delta] | None:
        from pathway_tpu_torch.internals import vector_compiler as vc

        if not vc.ENABLED:
            return None
        needed, out_fns, out_dtypes = self.vec_select
        cols = vc.materialize_delta_columns(deltas, needed)
        if cols is None:
            vc.note_bail("select", "dirty-column")
            return None
        n = len(deltas)
        try:
            out_cols = []
            for f, d in zip(out_fns, out_dtypes):
                if isinstance(f, int):  # passthrough: copy from input row
                    out_cols.append(("P", f))
                    continue
                arr = f(cols, n)
                if isinstance(arr, list):  # Python-object column (tuples)
                    if len(arr) != n:
                        vc.note_bail("select", "length-mismatch")
                        return None
                    out_cols.append(("U", arr))
                    continue
                if not vc.result_kind_ok(arr, d):
                    vc.note_bail("select", "result-dtype")
                    return None
                out_cols.append(arr)
        except vc.VecBail:
            vc.note_bail("select", "value-guard")
            return None
        return vc.rebuild_delta_rows(deltas, out_cols, n)

    def step(self, time):
        deltas = self.take_pending()
        clean_in = isinstance(deltas, CleanDeltas)
        out = None
        if self.vec_join_project is not None and deltas:
            from pathway_tpu_torch.internals import vector_compiler as vc

            nat = _get_native_module()
            if vc.ENABLED and nat is not None and hasattr(nat, "project_join_rows"):
                res = nat.project_join_rows(deltas, self.vec_join_project)
                if res is not None:  # None = malformed shape, row path
                    out, err_keys = res
                    for ek in err_keys or ():
                        # row-path parity: copied Error cells are logged
                        self.scope.error_log.append(
                            (
                                self,
                                ek,
                                "expression evaluated to Error (division by "
                                "zero, bad cast, or type error)",
                            )
                        )
                        _serving_note_row_error(
                            ek, "expression evaluated to Error"
                        )
        if out is None and self.vec_select is not None and len(deltas) >= _vec_threshold():
            out = self._try_columnar(deltas)
        if deltas and (
            self.vec_select is not None or self.vec_join_project is not None
        ):
            if out is None:
                self.row_batches += 1
            else:
                self.vec_batches += 1
        if out is None:
            out = []
            for key, row, diff in deltas:
                new_row = self.fn(key, row)
                if (
                    diff > 0
                    and any(isinstance(v, Error) for v in new_row)
                    and not any(isinstance(v, Error) for v in row)
                ):
                    # a NEW Error value (division by zero, bad cast, …):
                    # poison the cell and log it — the error-log tables
                    # (pw.global_error_log) read scope.error_log.  Logged
                    # directly (not report_row_error): cell poisoning is
                    # recoverable via fill_error/remove_errors, so it must
                    # not abort the run even with terminate_on_error=True
                    self.scope.error_log.append(
                        (
                            self,
                            key,
                            "expression evaluated to Error (division by "
                            "zero, bad cast, or type error)",
                        )
                    )
                    _serving_note_row_error(
                        key, "expression evaluated to Error"
                    )
                out.append((key, new_row, diff))
        # a 1:1 map preserves keys and diffs, hence cleanliness
        out = CleanDeltas(out) if clean_in else consolidate(out)
        if self.keep_state:
            self._update_state(out)
        self.send(out, time)


class FilterNode(Node):
    # the Table layer's filter() lowers to its own _PredFilter with the
    # columnar fast path; this plain node serves engine-internal filters
    name = "filter"
    preserves_append_only = True

    def __init__(self, scope, inp: Node, pred: Callable[[int, Row], bool]):
        super().__init__(scope, [inp])
        self.pred = pred

    def step(self, time):
        deltas = self.take_pending()
        out = CleanDeltas() if isinstance(deltas, CleanDeltas) else []
        for key, row, diff in deltas:
            res = self.pred(key, row)
            if isinstance(res, Error):
                self.scope.report_row_error(self, key, "filter predicate returned Error")
                continue
            if res:
                out.append((key, row, diff))  # subset of clean stays clean
        if self.keep_state:
            self._update_state(out)
        self.send(out, time)


class FlattenNode(Node):
    """flatten a column of sequences into multiple rows (dataflow.rs flatten_table)."""

    name = "flatten"
    preserves_append_only = True

    def __init__(
        self,
        scope,
        inp: Node,
        fn: Callable[[int, Row], Iterable[tuple[int, Row]]],
        *,
        key_fresh: bool = False,
    ):
        super().__init__(scope, [inp])
        self.fn = fn
        # set by callers whose fn derives pairwise-distinct new keys from
        # the origin key (e.g. hash(origin, position)); only then can clean
        # input imply clean output
        self.key_fresh = key_fresh
        # (col_idx, with_origin) when fn is the standard Table.flatten
        # shape — the whole per-item loop (incl. the hash-derived fresh
        # keys) then runs in _native.cpp
        self.vec_flatten: tuple[int, bool] | None = None

    def step(self, time):
        deltas = self.take_pending()
        out = None
        if self.vec_flatten is not None and deltas:
            from pathway_tpu_torch.internals import vector_compiler as vc

            nat = _get_native_module()
            if vc.ENABLED and nat is not None and hasattr(nat, "flatten_deltas"):
                col_idx, with_origin = self.vec_flatten
                out = nat.flatten_deltas(deltas, col_idx, with_origin)
        if deltas and self.vec_flatten is not None:
            if out is None:
                self.row_batches += 1
            else:
                self.vec_batches += 1
        if out is None:
            out = []
            for key, row, diff in deltas:
                for new_key, new_row in self.fn(key, row):
                    out.append((new_key, new_row, diff))
        if self.key_fresh and isinstance(deltas, CleanDeltas):
            out = CleanDeltas(out)
        else:
            out = consolidate(out)
        if self.keep_state:
            self._update_state(out)
        self.send(out, time)


class ReindexNode(Node):
    """Change row keys (with_id_from / reindex); detects duplicate new keys."""

    name = "reindex"
    preserves_append_only = True

    def __init__(self, scope, inp: Node, key_fn: Callable[[int, Row], int]):
        super().__init__(scope, [inp])
        self.key_fn = key_fn
        self.require_state()
        # duplicate detection state lives with the owner of the NEW key
        self.exchange_routes = {0: lambda k, r: self.key_fn(k, r)}

    def step(self, time):
        out = []
        for key, row, diff in self.take_pending():
            out.append((self.key_fn(key, row), row, diff))
        out = consolidate(out)
        self._update_state(out)
        self.send(out, time)


class SaltRekeyNode(Node):
    """Deterministic injective rekey: new key = hash(Pointer(key), salt).

    Backs the vectorized sliding-window assignment (one branch per window
    offset, concatenated): distinct inputs at a fixed salt never collide,
    so no duplicate-detection state is needed and cleanliness carries.
    """

    name = "salt_rekey"
    preserves_append_only = True

    def __init__(self, scope, inp: Node, salt: int):
        super().__init__(scope, [inp])
        self.salt = salt
        self.exchange_routes = {
            0: lambda k, r: hash_values([Pointer(k), self.salt])
        }

    def step(self, time):
        deltas = self.take_pending()
        out = None
        nat = _get_native_module()
        if nat is not None and hasattr(nat, "rekey_deltas") and deltas:
            out = nat.rekey_deltas(deltas, self.salt)
        if deltas:
            if out is None:
                self.row_batches += 1
            else:
                self.vec_batches += 1
        if out is None:
            salt = self.salt
            out = [
                (hash_values([Pointer(k), salt]), row, d)
                for k, row, d in deltas
            ]
        # injective key map, diffs unchanged: clean input stays clean
        out = (
            CleanDeltas(out)
            if isinstance(deltas, CleanDeltas)
            else consolidate(out)
        )
        if self.keep_state:
            self._update_state(out)
        self.send(out, time)


class ConcatNode(Node):
    name = "concat"
    preserves_append_only = True

    def __init__(self, scope, inputs: Sequence[Node]):
        super().__init__(scope, inputs)

    def step(self, time):
        out = []
        for port in range(len(self.inputs)):
            out.extend(self.take_pending(port))
        out = consolidate(out)
        if self.keep_state:
            self._update_state(out)
        self.send(out, time)


class UpdateRowsNode(Node):
    """update_rows: rows of the right table override same-key rows of the left
    (dataflow.rs update_rows_table)."""

    name = "update_rows"
    _persist_attrs = ("_left", "_right")


    def __init__(self, scope, left: Node, right: Node):
        super().__init__(scope, [left, right])
        self._left: dict[int, Row] = {}
        self._right: dict[int, Row] = {}
        self.exchange_routes = {0: None, 1: None}  # co-shard both sides by key

    def step(self, time):
        out = []
        dl = consolidate(self.take_pending(0))
        dr = consolidate(self.take_pending(1))
        for key, row, diff in dl:
            overridden = key in self._right
            if diff > 0:
                self._left[key] = row
            else:
                self._left.pop(key, None)
            if not overridden:
                out.append((key, row, diff))
        for key, row, diff in dr:
            if diff > 0:
                prev_r = self._right.get(key)
                if prev_r is not None:
                    out.append((key, prev_r, -1))
                elif key in self._left:
                    out.append((key, self._left[key], -1))
                self._right[key] = row
                out.append((key, row, 1))
            else:
                self._right.pop(key, None)
                out.append((key, row, -1))
                if key in self._left:
                    out.append((key, self._left[key], 1))
        out = consolidate(out)
        if self.keep_state:
            self._update_state(out)
        self.send(out, time)


class UpdateCellsNode(Node):
    """update_cells: override a subset of columns for keys present in right."""

    name = "update_cells"
    _persist_attrs = ("_left", "_right")


    def __init__(self, scope, left: Node, right: Node, merge_fn: Callable[[Row, Row | None], Row]):
        super().__init__(scope, [left, right])
        self._left: dict[int, Row] = {}
        self._right: dict[int, Row] = {}
        self.merge_fn = merge_fn
        self.exchange_routes = {0: None, 1: None}  # co-shard both sides by key

    def _merged(self, key: int) -> Row | None:
        if key not in self._left:
            return None
        return self.merge_fn(self._left[key], self._right.get(key))

    def step(self, time):
        out = []
        touched: set[int] = set()
        before: dict[int, Row | None] = {}
        for port, store in ((0, self._left), (1, self._right)):
            for key, row, diff in consolidate(self.take_pending(port)):
                if key not in before:
                    before[key] = self._merged(key)
                touched.add(key)
                if diff > 0:
                    store[key] = row
                else:
                    store.pop(key, None)
        for key in touched:
            old = before[key]
            new = self._merged(key)
            if old == new:
                continue
            if old is not None:
                out.append((key, old, -1))
            if new is not None:
                out.append((key, new, 1))
        out = consolidate(out)
        if self.keep_state:
            self._update_state(out)
        self.send(out, time)


class IntersectNode(Node):
    """restrict left to keys present in all other inputs (intersect_tables)."""

    name = "intersect"
    _persist_attrs = ("_left", "_present")


    def __init__(self, scope, left: Node, others: Sequence[Node], difference: bool = False):
        super().__init__(scope, [left, *others])
        self._left: dict[int, Row] = {}
        self._present: list[Counter] = [Counter() for _ in others]
        self.difference = difference
        self.exchange_routes = {p: None for p in range(1 + len(others))}

    def _visible(self, key: int) -> bool:
        if self.difference:
            return not any(c[key] > 0 for c in self._present)
        return all(c[key] > 0 for c in self._present)

    def step(self, time):
        out = []
        before: dict[int, tuple[Row | None, bool]] = {}

        def snapshot(key):
            if key not in before:
                row = self._left.get(key)
                before[key] = (row, row is not None and self._visible(key))

        for key, row, diff in consolidate(self.take_pending(0)):
            snapshot(key)
            if diff > 0:
                self._left[key] = row
            else:
                self._left.pop(key, None)
        for i in range(len(self._present)):
            for key, row, diff in self.take_pending(i + 1):
                snapshot(key)
                self._present[i][key] += diff
        for key, (old_row, was_visible) in before.items():
            new_row = self._left.get(key)
            now_visible = new_row is not None and self._visible(key)
            if was_visible and old_row is not None:
                out.append((key, old_row, -1))
            if now_visible and new_row is not None:
                out.append((key, new_row, 1))
        out = consolidate(out)
        if self.keep_state:
            self._update_state(out)
        self.send(out, time)


class IxNode(Node):
    """ix/ix_ref: for each row of the keys table, look up a row of the data
    table by pointer (dataflow.rs ix_table). Emits joined rows; reacts to
    changes on both sides."""

    name = "ix"
    _persist_attrs = ("_keys", "_data", "_by_target", "_unresolved")


    def __init__(
        self,
        scope,
        keys_node: Node,
        data_node: Node,
        key_fn: Callable[[int, Row], Any],
        merge_fn: Callable[[Row, Row | None], Row],
        optional: bool = False,
        strict: bool = True,
    ):
        super().__init__(scope, [keys_node, data_node])
        self._keys: dict[int, tuple[Row, Any]] = {}
        self._data: dict[int, Row] = {}
        self._by_target: dict[Any, set[int]] = defaultdict(set)
        # key-rows whose target is currently absent: a dangling pointer is
        # only an error if it survives to end-of-stream — mid-epoch (and
        # mid-iteration-round) dangling is a normal transient, e.g. an
        # argmax pointer into a groupby output that re-emits next round
        self._unresolved: set[int] = set()
        self.key_fn = key_fn
        self.merge_fn = merge_fn
        self.optional = optional
        self.strict = strict
        # key-rows travel to the owner of the row they point at; data rows
        # stay with their own key's owner — lookups are then local
        self.exchange_routes = {0: self._route_target, 1: None}

    def _route_target(self, key: int, row: Row) -> int:
        target = self.key_fn(key, row)
        if isinstance(target, Pointer):
            return target.value
        if isinstance(target, int):
            return target
        return key  # optional/None targets resolve locally

    def _emit_for(self, key: int, out: list, sign: int):
        row, target = self._keys[key]
        if target is None and self.optional:
            out.append((key, self.merge_fn(row, None), sign))
            return
        data_row = self._data.get(target)
        if data_row is None:
            if sign > 0:
                self._unresolved.add(key)
            else:
                self._unresolved.discard(key)
            return
        if sign > 0:
            self._unresolved.discard(key)
        out.append((key, self.merge_fn(row, data_row), sign))

    def step(self, time):
        out = []
        dk = consolidate(self.take_pending(0))
        dd = consolidate(self.take_pending(1))
        changed_targets = set()
        for key, row, diff in dd:
            changed_targets.add(key)
        # retract outputs of key-rows pointing at changed data (old data value)
        for target in changed_targets:
            for key in list(self._by_target.get(target, ())):
                self._emit_for(key, out, -1)
        for key, row, diff in dd:
            if diff > 0:
                self._data[key] = row
            else:
                self._data.pop(key, None)
        for target in changed_targets:
            for key in list(self._by_target.get(target, ())):
                self._emit_for(key, out, 1)
        for key, row, diff in dk:
            if diff > 0:
                target = self.key_fn(key, row)
                tkey = target.value if isinstance(target, Pointer) else target
                self._keys[key] = (row, tkey)
                self._by_target[tkey].add(key)
                self._emit_for(key, out, 1)
            else:
                if key in self._keys:
                    self._emit_for(key, out, -1)
                    _, tkey = self._keys.pop(key)
                    self._by_target[tkey].discard(key)
        out = consolidate(out)
        if self.keep_state:
            self._update_state(out)
        self.send(out, time)

    def final_check(self):
        # runs after the finish-quiesce so rows released by other nodes'
        # on_finish (e.g. temporal buffers) have already resolved lookups
        if self.strict:
            for key in sorted(self._unresolved):
                _row, target = self._keys.get(key, (None, None))
                self.scope.report_row_error(
                    self, key, f"ix: missing key {target!r}"
                )


class JoinNode(Node):
    """Incremental equi-join, all modes (dataflow.rs join 2740).

    Output rows are ``(left_key, right_key, left_row, right_row)`` tuples
    (either row may be None in outer modes); the Table layer projects them.
    Delta-join rule per epoch: dL⋈R ∪ L'⋈dR where L' already includes dL.
    """

    name = "join"
    _persist_attrs = ("_left_idx", "_right_idx", "_left_matches", "_right_matches")


    def __init__(
        self,
        scope,
        left: Node,
        right: Node,
        left_key_fn: Callable[[int, Row], tuple],
        right_key_fn: Callable[[int, Row], tuple],
        out_key_fn: Callable[[int, int, tuple], int],
        left_outer: bool = False,
        right_outer: bool = False,
        exact_match: bool = False,
    ):
        super().__init__(scope, [left, right])
        self.left_key_fn = left_key_fn
        self.right_key_fn = right_key_fn
        self.out_key_fn = out_key_fn
        self.left_outer = left_outer
        self.right_outer = right_outer
        # both sides co-shard on the join key (dataflow.rs:2744 ShardPolicy)
        self.exchange_routes = {
            0: lambda k, r: self._route_jk(self.left_key_fn, k, r),
            1: lambda k, r: self._route_jk(self.right_key_fn, k, r),
        }
        # join-key → {row_key: (row, count)}
        self._left_idx: dict[tuple, dict[int, Row]] = defaultdict(dict)
        self._right_idx: dict[tuple, dict[int, Row]] = defaultdict(dict)
        # for outer modes: per row match count
        self._left_matches: Counter = Counter()
        self._right_matches: Counter = Counter()
        # native inner-join fast path: the Lowerer sets (l_idxs, r_idxs,
        # okey_mode) when the join keys are plain column picks and the mode
        # is inner; the whole delta-join step then runs in _native.cpp with
        # the SAME semantics (None/Error keys match nothing, 128-bit jk
        # hashing, identical output keys).  Chosen once per node — the two
        # index representations never mix within a run.
        self.native_spec: tuple | None = None
        self._native_idx = None
        self._nat = None
        # batched exchange routing (engine/comm.py): per-port
        # (key column indices, hash_none flag) when the join keys are
        # plain column picks — the per-row key-hash+route loop then runs
        # in one native pass with identical hash_values semantics
        self.exchange_route_cols: dict[int, tuple[tuple, bool]] | None = None

    def _infer_append_only(self) -> bool:
        # inner joins of append-only sides only ever add pairs; outer modes
        # retract their null-padding when a first match arrives
        return (
            not self.left_outer
            and not self.right_outer
            and all(i.append_only for i in self.inputs)
        )

    @staticmethod
    def _route_jk(key_fn, key: int, row: Row) -> int:
        jk = key_fn(key, row)
        if jk is None:
            return key  # unjoined (error) rows resolve locally
        return hash_values(jk)

    def _pair(self, lkey, rkey, lrow, rrow, jk, sign, out):
        okey = self.out_key_fn(lkey, rkey, jk)
        out.append((okey, (lkey, rkey, lrow, rrow), sign))

    def _null_left(self, rkey, rrow, jk, sign, out):
        okey = self.out_key_fn(None, rkey, jk)
        out.append((okey, (None, rkey, None, rrow), sign))

    def _null_right(self, lkey, lrow, jk, sign, out):
        okey = self.out_key_fn(lkey, None, jk)
        out.append((okey, (lkey, None, lrow, None), sign))

    def _native_cap(self):
        if self.native_spec is None:
            return None
        if self._native_idx is None:
            nat = _get_native_module()
            if nat is None or not hasattr(nat, "join_step"):
                from pathway_tpu_torch.internals import vector_compiler as vc

                vc.note_bail("join", "native-unavailable")
                self.native_spec = None
                return None
            self._nat = nat
            self._native_idx = nat.join_new()
            # a snapshot restored into the row-path dicts before the first
            # step (path availability changed across runs): migrate it
            if self._left_idx or self._right_idx:
                l_idxs, r_idxs, _ = self.native_spec
                for side, idx_map, key_idxs in (
                    (0, self._left_idx, l_idxs),
                    (1, self._right_idx, r_idxs),
                ):
                    items = [
                        (k, row)
                        for bucket in idx_map.values()
                        for k, row in bucket.items()
                    ]
                    nat.join_load(self._native_idx, side, items, key_idxs)
                self._left_idx.clear()
                self._right_idx.clear()
        return self._native_idx

    def persist_dump(self):
        if self._native_idx is not None:
            data = super().persist_dump() or {}
            data["__native_join"] = self._nat.join_dump(self._native_idx)
            return data
        return super().persist_dump()

    def persist_load(self, data) -> None:
        data = dict(data)  # callers may reuse the dump; never mutate it
        nj = data.pop("__native_join", None)
        super().persist_load(data)
        if nj is None:
            return
        cap = self._native_cap()
        if cap is not None:
            l_idxs, r_idxs, _ = self.native_spec
            self._nat.join_load(cap, 0, nj[0], l_idxs)
            self._nat.join_load(cap, 1, nj[1], r_idxs)
        else:
            # native unavailable in this run: rebuild the row-path dicts
            for items, idx_map, key_fn in (
                (nj[0], self._left_idx, self.left_key_fn),
                (nj[1], self._right_idx, self.right_key_fn),
            ):
                for key, row in items:
                    jk = key_fn(key, row)
                    if jk is not None:
                        idx_map[jk][key] = row

    def step(self, time):
        cap = self._native_cap()
        if cap is not None:
            dl = consolidate(self.take_pending(0))
            dr = consolidate(self.take_pending(1))
            if dl or dr:
                self.vec_batches += 1
            l_idxs, r_idxs, mode = self.native_spec
            raw, replaced = self._nat.join_step(
                cap, dl, dr, l_idxs, r_idxs, mode,
                int(self.left_outer), int(self.right_outer),
            )
            if (
                mode == 0
                and not replaced
                and not self.left_outer
                and not self.right_outer
                and isinstance(dl, CleanDeltas)
                and isinstance(dr, CleanDeltas)
            ):
                # clean inputs + fresh row keys: every emitted pair
                # (lkey, rkey) is distinct, so the hash-pair okeys are
                # distinct and all diffs are +1 — provably clean output
                out = CleanDeltas(raw)
            else:
                out = consolidate(raw)
            if self.keep_state:
                self._update_state(out)
            self.send(out, time)
            return

        out: list[Delta] = []
        dl = consolidate(self.take_pending(0))
        dr = consolidate(self.take_pending(1))
        if dl or dr:
            self.row_batches += 1

        # apply left deltas against current right index
        for lkey, lrow, diff in dl:
            jk = self.left_key_fn(lkey, lrow)
            if jk is None:
                # a null join key matches nothing (SQL semantics), but the
                # row still survives outer modes with a null-padded partner
                if self.left_outer:
                    self._null_right(lkey, lrow, None, diff, out)
                continue
            matches = self._right_idx.get(jk, {})
            n_matches = len(matches)
            for rkey, rrow in matches.items():
                self._pair(lkey, rkey, lrow, rrow, jk, diff, out)
                if self.right_outer:
                    old = self._right_matches[rkey]
                    self._right_matches[rkey] = old + diff
                    if old == 0 and diff > 0:
                        self._null_left(rkey, rrow, jk, -1, out)
                    elif old + diff == 0:
                        self._null_left(rkey, rrow, jk, 1, out)
            if self.left_outer:
                # a dict-put REPLACE keeps the count: matches tracks live
                # right rows, which a same-key re-insert does not change
                if diff < 0 or lkey not in self._left_idx.get(jk, {}):
                    self._left_matches[lkey] += diff * n_matches
                if n_matches == 0:
                    self._null_right(lkey, lrow, jk, diff, out)
            if diff > 0:
                self._left_idx[jk][lkey] = lrow
            else:
                self._left_idx[jk].pop(lkey, None)
                if not self._left_idx[jk]:
                    del self._left_idx[jk]
                self._left_matches.pop(lkey, None)

        # apply right deltas against updated left index
        for rkey, rrow, diff in dr:
            jk = self.right_key_fn(rkey, rrow)
            if jk is None:
                if self.right_outer:
                    self._null_left(rkey, rrow, None, diff, out)
                continue
            matches = self._left_idx.get(jk, {})
            n_matches = len(matches)
            for lkey, lrow in matches.items():
                self._pair(lkey, rkey, lrow, rrow, jk, diff, out)
                if self.left_outer:
                    old = self._left_matches[lkey]
                    self._left_matches[lkey] = old + diff
                    if old == 0 and diff > 0:
                        self._null_right(lkey, lrow, jk, -1, out)
                    elif old + diff == 0:
                        self._null_right(lkey, lrow, jk, 1, out)
            if self.right_outer:
                if diff < 0 or rkey not in self._right_idx.get(jk, {}):
                    self._right_matches[rkey] += diff * n_matches
                if n_matches == 0:
                    self._null_left(rkey, rrow, jk, diff, out)
            if diff > 0:
                self._right_idx[jk][rkey] = rrow
            else:
                self._right_idx[jk].pop(rkey, None)
                if not self._right_idx[jk]:
                    del self._right_idx[jk]
                self._right_matches.pop(rkey, None)

        out = consolidate(out)
        if self.keep_state:
            self._update_state(out)
        self.send(out, time)


class GroupByNode(Node):
    """Incremental groupby + reduce (dataflow.rs group_by_table 3404)."""

    name = "groupby"

    def __init__(
        self,
        scope,
        inp: Node,
        group_key_fn: Callable[[int, Row], tuple],
        out_key_fn: Callable[[tuple], int],
        reducer_specs: Sequence[tuple[Any, Callable[[int, Row], tuple]]],
        # each spec: (Reducer, args_fn row→tuple of reducer args)
        result_fn: Callable[[tuple, tuple], Row] | None = None,
    ):
        super().__init__(scope, [inp])
        # contributions travel to the owner of the group's output key
        self.exchange_routes = {
            0: lambda k, r: self.out_key_fn(self.group_key_fn(k, r))
        }
        self.group_key_fn = group_key_fn
        self.out_key_fn = out_key_fn
        # batched exchange routing (engine/comm.py): (group-key column
        # indices, hash_none=True) when the group keys are plain column
        # picks — set by the Lowerer alongside vec_group
        self.exchange_route_cols: dict[int, tuple[tuple, bool]] | None = None
        self.reducer_specs = list(reducer_specs)
        self.result_fn = result_fn or (lambda gk, vals: tuple(vals))
        self._groups: dict[tuple, list] = {}
        self._group_counts: Counter = Counter()  # rows per group (for
        # reducer-less reduces: distinct group keys must still emit rows)
        self._last_out: dict[tuple, Row] = {}
        # columnar fast path (set by the Lowerer): (group_col_idx,
        # [(kind, value_col_idx), ...]) with kind in {"count" (idx None),
        # "sum" (also avg), "mm" (min/max)} — batch updates become
        # np.unique grouping + add_bulk per group (count/sum) or
        # per-(group, value) add_pairs into the multiset states (mm)
        self.vec_group = None

    def _make_states(self) -> list:
        # append-only input: non-invertible reducers (min/max/argmin/…)
        # swap their value multisets for O(1) running accumulators — the
        # engine-variant choice the reference drives off column properties
        # (dataflow.rs append_only_or_deterministic)
        if self.inputs[0].append_only:
            return [r.make_append_state() for (r, _) in self.reducer_specs]
        return [r.make_state() for (r, _) in self.reducer_specs]

    def _ensure_group(self, gk):
        states = self._groups.get(gk)
        if states is None:
            states = self._make_states()
            self._groups[gk] = states
        return states

    def _step_columnar(self, deltas: list[Delta], touched: set) -> bool:
        import numpy as np

        from pathway_tpu_torch.internals import vector_compiler as vc

        if not vc.ENABLED:
            return False
        gidx, red_cols = self.vec_group
        multi = isinstance(gidx, tuple)  # multi-column group key
        gvals_list = None
        inv = None
        if multi:
            needed = {vidx for kind, vidx in red_cols if kind != "count"}
            cols = vc.materialize_delta_columns(deltas, needed) if needed else {}
            if needed and cols is None:
                vc.note_bail("groupby", "dirty-column")
                return False
            # group keys are Python tuples straight off the rows — the
            # native hash grouping keys on the same objects the row path's
            # dict does, so equality semantics (incl. NaN identity) match;
            # the per-row tuple build itself is one native pass too
            nat = _get_native_module()
            gather = getattr(nat, "gather_key_rows", None) if nat else None
            if gather is not None:
                keys = gather(deltas, tuple(gidx))
            else:
                keys = [tuple(row[i] for i in gidx) for (_k, row, _d) in deltas]
            gvals_list, inv = vc.group_indices(keys)
        else:
            needed = {gidx} | {vidx for kind, vidx in red_cols if kind != "count"}
            # shared materializer: uniform-Python-type + int64-range checks.
            # Raw form keeps str columns as Python lists so the group keys
            # can hash-group natively (np.unique on a 1M-row U-array pays a
            # full array build plus a sort — the wordcount hot spot).
            raw = vc.materialize_delta_columns_raw(deltas, needed)
            if raw is NotImplemented:
                cols = vc.materialize_delta_columns(deltas, needed)
                if cols is None:
                    vc.note_bail("groupby", "dirty-column")
                    return False
            elif raw is None:
                vc.note_bail("groupby", "dirty-column")
                return False
            else:
                cols = {}
                for i, (kind, payload) in raw.items():
                    if i == gidx and kind == "U":
                        gvals_list, inv = vc.group_indices(payload)
                        cols[i] = payload  # raw list; grouped, never math
                    else:
                        cols[i] = vc.wrap_native_col(kind, payload)
            garr = cols[gidx]
            if gvals_list is None:
                # NaN group keys: np.unique collapses all NaNs into one
                # group while the row path's dict keeps one group per NaN
                # object — bail
                if garr.dtype.kind == "f" and np.isnan(garr).any():
                    vc.note_bail("groupby", "nan-group-key")
                    return False
        val_arrs = [
            None if kind == "count" else cols[vidx] for kind, vidx in red_cols
        ]
        if any(isinstance(v, list) for v in val_arrs):
            # a str group column doubling as a reducer value column: rare —
            # wrap it for the mm path
            val_arrs = [
                np.asarray(v) if isinstance(v, list) else v for v in val_arrs
            ]
        for (kind, _), varr in zip(red_cols, val_arrs):
            # sums need numeric columns; min/max works on any materialized
            # dtype (incl. str) since it only groups and counts
            if kind == "sum" and varr.dtype.kind not in "bif":
                vc.note_bail("groupby", "sum-dtype")
                return False
            # NaN breaks the mm multiset grouping: np.unique collapses all
            # NaNs into one entry while the row path's Counter keeps one
            # entry per object — bail to the row path to keep parity
            if kind == "mm" and varr.dtype.kind == "f" and np.isnan(varr).any():
                vc.note_bail("groupby", "nan-minmax")
                return False
        diffs = vc.delta_diffs(deltas)
        max_diff = vc._abs_bound(diffs)
        for (kind, _), varr in zip(red_cols, val_arrs):
            # per-batch int sums must stay within i64 (state accumulates in
            # Python bignums, so only the numpy partial sums can wrap)
            if (
                kind == "sum"
                and varr.dtype.kind == "i"
                and vc._abs_bound(varr) * max_diff * max(1, len(deltas)) > vc._I64_MAX
            ):
                vc.note_bail("groupby", "sum-overflow")
                return False
        if gvals_list is None:
            uniq, inv = np.unique(garr, return_inverse=True)
            gvals_list = uniq.tolist()
        n_groups = len(gvals_list)
        if n_groups == 0:
            return True
        counts = np.zeros(n_groups, np.int64)
        np.add.at(counts, inv, diffs)
        contribs = []
        for (kind, _), varr in zip(red_cols, val_arrs):
            if kind == "count":
                contribs.append(None)
            elif kind == "mm":
                # per-(group, value) summed diffs for the multiset states
                vu, vinv = np.unique(varr, return_inverse=True)
                combo = inv.astype(np.int64) * len(vu) + vinv
                cu, cinv = np.unique(combo, return_inverse=True)
                pair_counts = np.zeros(len(cu), np.int64)
                np.add.at(pair_counts, cinv, diffs)
                pair_groups = (cu // len(vu)).tolist()
                pair_vals = vu[cu % len(vu)].tolist()
                by_group: dict[int, tuple[list, list]] = {}
                for g, v, c in zip(pair_groups, pair_vals, pair_counts.tolist()):
                    if c:
                        vs, cs = by_group.setdefault(g, ([], []))
                        vs.append(v)
                        cs.append(c)
                contribs.append(("mm", by_group))
            elif varr.dtype.kind == "f":
                contribs.append(np.bincount(inv, weights=varr * diffs, minlength=n_groups))
            else:
                acc = np.zeros(n_groups, np.int64)
                np.add.at(acc, inv, varr.astype(np.int64) * diffs)
                contribs.append(acc)
        gvals = gvals_list
        counts_l = counts.tolist()
        contribs_l = [
            c.tolist() if isinstance(c, np.ndarray) else c for c in contribs
        ]
        for ui, gval in enumerate(gvals):
            gk = gval if multi else (gval,)
            states = self._ensure_group(gk)
            for state, contrib in zip(states, contribs_l):
                if contrib is None:
                    state.add_bulk(counts_l[ui])
                elif isinstance(contrib, tuple):  # ("mm", by_group)
                    pairs = contrib[1].get(ui)
                    if pairs is not None:
                        state.add_pairs(pairs[0], pairs[1])
                else:
                    state.add_bulk(contrib[ui], counts_l[ui])
            self._group_counts[gk] += counts_l[ui]
            touched.add(gk)
        return True

    def step(self, time):
        out = []
        touched: set[tuple] = set()
        deltas = consolidate(self.take_pending())
        handled = False
        if self.vec_group is not None and len(deltas) >= _vec_threshold():
            handled = self._step_columnar(deltas, touched)
        if deltas and self.vec_group is not None:
            if handled:
                self.vec_batches += 1
            else:
                self.row_batches += 1
        if not handled:
            for key, row, diff in deltas:
                gk = self.group_key_fn(key, row)
                states = self._ensure_group(gk)
                for state, (_, args_fn) in zip(states, self.reducer_specs):
                    state.add(args_fn(key, row), diff, time, key)
                self._group_counts[gk] += diff
                touched.add(gk)
        for gk in touched:
            states = self._groups[gk]
            okey = self.out_key_fn(gk)
            old = self._last_out.pop(gk, None)
            if old is not None:
                out.append((okey, old, -1))
            if self._group_counts[gk] > 0:
                values = tuple(s.extract() for s in states)
                new_row = self.result_fn(gk, values)
                out.append((okey, new_row, 1))
                self._last_out[gk] = new_row
            else:
                del self._groups[gk]
                del self._group_counts[gk]
        out = consolidate(out)
        if self.keep_state:
            self._update_state(out)
        self.send(out, time)

    def persist_dump(self):
        data = super().persist_dump() or {}
        data["__groups"] = {
            gk: [st.dump() for st in states] for gk, states in self._groups.items()
        }
        data["__group_counts"] = self._group_counts
        data["__last_out"] = self._last_out
        return data

    def persist_load(self, data):
        groups = data.pop("__groups")
        self._group_counts = Counter(data.pop("__group_counts"))
        self._last_out = dict(data.pop("__last_out"))
        super().persist_load(data)
        self._groups = {}
        for gk, dumps in groups.items():
            states = self._make_states()
            for st, d in zip(states, dumps):
                st.load(d)
            self._groups[gk] = states


class DeduplicateNode(Node):
    """deduplicate with a Python acceptor (dataflow.rs deduplicate 3514)."""

    name = "deduplicate"
    _persist_attrs = ("_current",)


    def __init__(
        self,
        scope,
        inp: Node,
        instance_fn: Callable[[int, Row], Any],
        value_fn: Callable[[int, Row], Any],
        acceptor: Callable[[Any, Any], bool],
        out_key_fn: Callable[[Any], int],
    ):
        super().__init__(scope, [inp])
        self.instance_fn = instance_fn
        self.value_fn = value_fn
        self.acceptor = acceptor
        self.out_key_fn = out_key_fn
        self._current: dict[Any, tuple[Any, Row]] = {}
        # the per-instance "current winner" state lives with the owner of
        # the instance's output key
        self.exchange_routes = {
            0: lambda k, r: self.out_key_fn(self.instance_fn(k, r))
        }

    def step(self, time):
        out = []
        for key, row, diff in consolidate(self.take_pending()):
            if diff <= 0:
                continue  # dedup consumes insertions only (append-only semantics)
            inst = self.instance_fn(key, row)
            value = self.value_fn(key, row)
            prev = self._current.get(inst)
            if prev is None:
                accept = self.acceptor(value, None)
            else:
                accept = self.acceptor(value, prev[0])
            if isinstance(accept, Error):
                self.scope.report_row_error(self, key, "deduplicate acceptor returned Error")
                continue
            if accept:
                okey = self.out_key_fn(inst)
                if prev is not None:
                    out.append((okey, prev[1], -1))
                self._current[inst] = (value, row)
                out.append((okey, row, 1))
        out = consolidate(out)
        if self.keep_state:
            self._update_state(out)
        self.send(out, time)


class BufferNode(Node):
    """Temporal behavior buffer/delay (time_column.rs analog).

    Holds rows until ``threshold_fn(row) <= current watermark column max seen``;
    used by windowby behaviors. The watermark here is the maximum value of the
    time column observed so far (event-time semantics).
    """

    name = "buffer"
    _persist_attrs = ("_held", "_watermark")


    def __init__(self, scope, inp: Node, time_fn, threshold_fn):
        super().__init__(scope, [inp])
        self.time_fn = time_fn
        self.threshold_fn = threshold_fn
        self._held: list[Delta] = []
        self._watermark = None
        self.exchange_routes = {0: None}  # buffer state lives with key owner
        # columnar fast path (set by the Lowerer when time/threshold lower
        # to column + const): (t_idx, t_off, thr_idx, thr_off).  While
        # every ingest batch materializes columnar, _held_thr caches the
        # held rows' thresholds as one array and the release scan becomes
        # a single vector compare + native split; any bail reverts the
        # node to the row path (the oracle) until the buffer drains.
        self.vec_temporal: tuple | None = None
        self._held_thr = None  # np.ndarray | None (None = row mode)

    def _ingest_columnar(self, incoming) -> bool:
        import numpy as np

        from pathway_tpu_torch.internals import vector_compiler as vc

        if self.vec_temporal is None or not vc.ENABLED:
            return False
        if self._held and self._held_thr is None:
            return False  # uncached held rows: stay row-wise until drained
        if not incoming:
            return True
        arrays = _vec_temporal_arrays(self, incoming, "buffer")
        if arrays is None:
            return False
        t, thr = arrays
        held_thr = self._held_thr
        if (
            held_thr is not None
            and len(held_thr)
            and held_thr.dtype.kind != thr.dtype.kind
        ):
            vc.note_bail("buffer", "dtype-mix")
            return False
        tmax = t.max().item()
        if self._watermark is None or tmax > self._watermark:
            self._watermark = tmax
        self._held_thr = (
            thr
            if held_thr is None or not len(held_thr)
            else np.concatenate([held_thr, thr])
        )
        return True

    def step(self, time):
        from pathway_tpu_torch.internals import vector_compiler as vc

        incoming = self.take_pending()
        vec = self._ingest_columnar(incoming)
        if not vec:
            self._held_thr = None
            for key, row, diff in incoming:
                t = self.time_fn(key, row)
                if self._watermark is None or t > self._watermark:
                    self._watermark = t
        self._held.extend(incoming)
        wm = self._watermark
        if vec and self._held_thr is not None:
            if incoming or self._held:
                self.vec_batches += 1
            held_thr = self._held_thr
            release: list[Delta] = []
            if len(held_thr) and wm is not None:
                mask = held_thr <= wm
                if mask.any():
                    release, self._held = vc.split_deltas(self._held, mask)
                    self._held_thr = held_thr[~mask]
        else:
            if incoming or self._held:
                self.row_batches += 1
            release, keep = [], []
            for key, row, diff in self._held:
                thr = self.threshold_fn(key, row)
                if wm is not None and thr <= wm:
                    release.append((key, row, diff))
                else:
                    keep.append((key, row, diff))
            self._held = keep
        release = consolidate(release)
        if self.keep_state:
            self._update_state(release)
        self.send(release, time)

    def on_finish(self):
        release = consolidate(self._held)
        self._held = []
        self._held_thr = None  # empty buffer: columnar mode may resume
        if self.keep_state:
            self._update_state(release)
        self.send(release, self.scope.current_time)


class ForgetNode(Node):
    """Forget (free state for) rows older than the watermark minus a horizon;
    emits retractions downstream (time_column.rs forget)."""

    name = "forget"
    _persist_attrs = ("_alive", "_watermark")


    def __init__(self, scope, inp: Node, time_fn, threshold_fn, mark_forgetting_records: bool = False):
        super().__init__(scope, [inp])
        self.time_fn = time_fn
        self.threshold_fn = threshold_fn
        self._alive: dict[int, Row] = {}
        self._watermark = None
        self.exchange_routes = {0: None}  # alive-set lives with key owner
        # columnar fast path (see BufferNode): batches materialize their
        # time/threshold columns once, and expiry runs off a threshold
        # min-heap (O(expired log n) per epoch) instead of re-evaluating
        # threshold_fn over the whole alive set every epoch.  A bail
        # reverts the node to the legacy full-sweep (the oracle).
        self.vec_temporal: tuple | None = None
        self._expiry: list = []  # min-heap of (thr, seq, key, row)
        self._alive_thr: dict[int, Any] = {}
        self._heap_seq = 0
        self._sweep_legacy = False

    def persist_load(self, data) -> None:
        super().persist_load(data)
        # a restored alive-set has no heap entries; the legacy sweep is
        # the semantics reference and needs none
        self._sweep_legacy = True

    def _ingest_columnar(self, deltas, out) -> bool:
        import heapq

        from pathway_tpu_torch.internals import vector_compiler as vc

        if self.vec_temporal is None or not vc.ENABLED or self._sweep_legacy:
            return False
        if not deltas:
            return True
        arrays = _vec_temporal_arrays(self, deltas, "forget")
        if arrays is None:
            return False
        t, thr = arrays
        tmax = t.max().item()
        if self._watermark is None or tmax > self._watermark:
            self._watermark = tmax
        out.extend(deltas)
        alive = self._alive
        alive_thr = self._alive_thr
        expiry = self._expiry
        seq = self._heap_seq
        for (key, row, diff), thr_v in zip(deltas, thr.tolist()):
            if diff > 0:
                alive[key] = row
                alive_thr[key] = thr_v
                seq += 1
                heapq.heappush(expiry, (thr_v, seq, key, row))
            else:
                alive.pop(key, None)
                alive_thr.pop(key, None)
        self._heap_seq = seq
        return True

    def step(self, time):
        import heapq

        out = []
        deltas = consolidate(self.take_pending())
        vec = self._ingest_columnar(deltas, out)
        if not vec:
            if not self._sweep_legacy:
                # heap entries no longer cover the alive set; the legacy
                # sweep takes over until the alive set drains
                self._sweep_legacy = True
                self._expiry.clear()
                self._alive_thr.clear()
            for key, row, diff in deltas:
                t = self.time_fn(key, row)
                if self._watermark is None or t > self._watermark:
                    self._watermark = t
                out.append((key, row, diff))
                if diff > 0:
                    self._alive[key] = row
                else:
                    self._alive.pop(key, None)
        if deltas:
            if vec:
                self.vec_batches += 1
            else:
                self.row_batches += 1
        wm = self._watermark
        if wm is not None:
            if self._sweep_legacy:
                for key in list(self._alive):
                    row = self._alive[key]
                    if self.threshold_fn(key, row) <= wm:
                        out.append((key, row, -1))
                        del self._alive[key]
                if not self._alive:
                    self._sweep_legacy = False  # drained: fast path resumes
            else:
                expiry = self._expiry
                alive = self._alive
                alive_thr = self._alive_thr
                while expiry and expiry[0][0] <= wm:
                    thr_v, _seq, key, row = heapq.heappop(expiry)
                    if alive.get(key) != row or alive_thr.get(key) != thr_v:
                        continue  # superseded entry (rekeyed or retracted)
                    out.append((key, row, -1))
                    del alive[key]
                    del alive_thr[key]
        out = consolidate(out)
        if self.keep_state:
            self._update_state(out)
        self.send(out, time)


class FreezeNode(Node):
    """Ignore updates to rows older than threshold (exactly-once behaviors)."""

    name = "freeze"
    _persist_attrs = ("_watermark",)


    def __init__(self, scope, inp: Node, time_fn, threshold_fn):
        super().__init__(scope, [inp])
        self.time_fn = time_fn
        self.threshold_fn = threshold_fn
        self._watermark = None
        # columnar fast path (see BufferNode): the admit/advance scan has
        # a sequential data dependence (later rows see earlier KEPT rows'
        # watermark), so it runs as one native freeze_scan pass over the
        # materialized time/threshold columns rather than a numpy op
        self.vec_temporal: tuple | None = None

    def _step_columnar(self, deltas):
        from pathway_tpu_torch.internals import vector_compiler as vc

        # stateless per batch (unlike the buffer's held-threshold cache),
        # so the standard small-batch gate applies: below the threshold
        # the row loop beats materialize + array ops
        if (
            self.vec_temporal is None
            or not vc.ENABLED
            or len(deltas) < _vec_threshold()
        ):
            return None
        arrays = _vec_temporal_arrays(self, deltas, "freeze")
        if arrays is None:
            return None
        t, thr = arrays
        import numpy as np

        mask, new_wm = vc.freeze_scan(t, thr, self._watermark)
        self._watermark = new_wm
        n_cols = len(deltas[0][1])
        return vc.filter_deltas(
            deltas, np.frombuffer(bytes(mask), np.uint8), n_cols
        )

    def step(self, time):
        deltas = consolidate(self.take_pending())
        out = self._step_columnar(deltas)
        if deltas:
            if out is None:
                self.row_batches += 1
            else:
                self.vec_batches += 1
        if out is None:
            out = []
            for key, row, diff in deltas:
                t = self.time_fn(key, row)
                thr = self.threshold_fn(key, row)
                if self._watermark is not None and thr <= self._watermark:
                    continue  # frozen: late data dropped
                if self._watermark is None or t > self._watermark:
                    self._watermark = t
                out.append((key, row, diff))
        out = consolidate(out)
        if self.keep_state:
            self._update_state(out)
        self.send(out, time)


class SortNode(Node):
    """Maintains prev/next pointers for sorted tables (prev_next.rs analog).

    Output rows: (key, instance, prev_key|None, next_key|None).
    Uses a per-instance sorted list: the bidirectional-cursor trick in the
    reference's DD fork exists to walk neighbours cheaply; a host-side sorted
    structure gives the same O(log n) updates here.
    """

    name = "sort"
    _persist_attrs = ("_by_instance", "_rows")


    def __init__(self, scope, inp: Node, key_fn, instance_fn):
        super().__init__(scope, [inp])
        self.key_fn = key_fn
        self.instance_fn = instance_fn
        self._by_instance: dict[Any, list] = defaultdict(list)  # sorted [(sort_key, key)]
        self._rows: dict[int, tuple[Any, Any]] = {}
        # global per-instance ordering: all rows on one worker (the analog
        # of the reference's arranged total order walked by bidirectional
        # cursors; per-shard ordering would give wrong neighbours)
        self.exchange_gather0 = True

    def _neighbors(self, lst, i):
        prev_k = lst[i - 1][1] if i > 0 else None
        next_k = lst[i + 1][1] if i + 1 < len(lst) else None
        return prev_k, next_k

    def step(self, time):
        import bisect

        out = []
        touched_instances = set()
        old_lists: dict[Any, list] = {}
        for key, row, diff in consolidate(self.take_pending()):
            sk = self.key_fn(key, row)
            inst = self.instance_fn(key, row)
            lst = self._by_instance[inst]
            if inst not in old_lists:
                old_lists[inst] = list(lst)
            touched_instances.add(inst)
            if diff > 0:
                bisect.insort(lst, ((_SortWrap(sk)), key))
                self._rows[key] = (sk, inst)
            else:
                try:
                    lst.remove((_SortWrap(sk), key))
                except ValueError:
                    pass
                self._rows.pop(key, None)
        for inst in touched_instances:
            old = old_lists[inst]
            new = self._by_instance[inst]
            old_out = {
                k: self._neighbors(old, i) for i, (_, k) in enumerate(old)
            }
            new_out = {
                k: self._neighbors(new, i) for i, (_, k) in enumerate(new)
            }
            for k, nb in old_out.items():
                if new_out.get(k) != nb:
                    out.append((k, (_ptr(nb[0]), _ptr(nb[1])), -1))
            for k, nb in new_out.items():
                if old_out.get(k) != nb:
                    out.append((k, (_ptr(nb[0]), _ptr(nb[1])), 1))
            if not new:
                del self._by_instance[inst]
        out = consolidate(out)
        if self.keep_state:
            self._update_state(out)
        self.send(out, time)


class _SortWrap:
    """Total order over mixed sort keys."""

    __slots__ = ("v",)

    def __init__(self, v):
        self.v = v

    def _k(self):
        v = self.v
        if isinstance(v, bool):
            return (0, int(v))
        if isinstance(v, (int, float)):
            return (1, v)
        if isinstance(v, str):
            return (2, v)
        if isinstance(v, tuple):
            return (3, tuple(_SortWrap(x)._k() for x in v))
        if isinstance(v, Pointer):
            return (4, v.value)
        return (5, repr(v))

    def __lt__(self, other):
        return self._k() < other._k()

    def __eq__(self, other):
        return isinstance(other, _SortWrap) and self.v == other.v

    def __hash__(self):
        return hash(self._k())


def _ptr(k):
    return Pointer(k) if isinstance(k, int) else k


class GradualBroadcastNode(Node):
    """gradual_broadcast (gradual_broadcast.rs): broadcast a slowly-changing
    scalar (lower/value/upper thresholds) onto every row of the input; updates
    to rows only when the value leaves [lower, upper]."""

    name = "gradual_broadcast"
    _persist_attrs = ("_current_value", "_lower", "_upper", "_rows")


    def __init__(self, scope, inp: Node, threshold_node: Node, lvu_fn):
        super().__init__(scope, [inp, threshold_node])
        self.lvu_fn = lvu_fn
        self._current_value = None
        self._lower = None
        self._upper = None
        self._rows: dict[int, Row] = {}
        # one global slowly-changing scalar: single-owner state
        self.exchange_gather0 = True

    def step(self, time):
        out = []
        new_bounds = None
        for key, row, diff in consolidate(self.take_pending(1)):
            if diff > 0:
                new_bounds = self.lvu_fn(key, row)
        changed = False
        if new_bounds is not None:
            lower, value, upper = new_bounds
            if (
                self._current_value is None
                or value < (self._lower if self._lower is not None else value)
                or value > (self._upper if self._upper is not None else value)
            ):
                self._current_value = value
                self._lower, self._upper = lower, upper
                changed = True
        if changed:
            # retract+re-emit all rows with new broadcast value
            for key, row in list(self._rows.items()):
                out.append((key, row, -1))
                new_row = row[:-1] + (self._current_value,)
                self._rows[key] = new_row
                out.append((key, new_row, 1))
        for key, row, diff in consolidate(self.take_pending(0)):
            new_row = row + (self._current_value,)
            if diff > 0:
                self._rows[key] = new_row
                out.append((key, new_row, 1))
            else:
                stored = self._rows.pop(key, new_row)
                out.append((key, stored, -1))
        out = consolidate(out)
        if self.keep_state:
            self._update_state(out)
        self.send(out, time)


class ExternalIndexNode(Node):
    """as-of-now external index (dataflow/operators/external_index.rs).

    Port 0: index data stream (key, (vector/doc, filter_data)); port 1: query
    stream.  Answers each query against the *current* index contents and
    keeps the answer updated: on index change, affected queries are re-run
    and old answers retracted — the retraction bookkeeping the reference
    implements in external_index.rs:1-163.
    """

    name = "external_index"

    def __init__(self, scope, data_node: Node, query_node: Node, index, res_fn):
        super().__init__(scope, [data_node, query_node])
        self.index = index  # duck-typed: add(key,row), remove(key), search(qrow) -> result value
        self.res_fn = res_fn  # (query_key, query_row, result) -> out Row
        self._queries: dict[int, Row] = {}
        self._answers: dict[int, Row] = {}
        # raw indexed rows: operator snapshots rebuild the (arbitrary,
        # non-picklable) index structure by re-adding these on restore
        self._data_rows: dict[int, Row] = {}
        # the index structure is one logical object: host bookkeeping on
        # worker 0 (its device path still shards the corpus over the mesh —
        # ops/topk.py DeviceIndexCache(mesh))
        self.exchange_gather0 = True

    def _search_many(self, qrows: list) -> list:
        """One batched index scan for the epoch's query rows: a
        ``search_many``-capable index (``stdlib/indexing``) answers every
        row in one bucketed DeviceExecutor dispatch; others fall back to
        per-row search."""
        many = getattr(self.index, "search_many", None)
        if many is not None:
            return many(qrows)
        return [self.index.search(qrow) for qrow in qrows]

    def step(self, time):
        out = []
        dd = consolidate(self.take_pending(0))
        dq = consolidate(self.take_pending(1))
        index_changed = bool(dd)
        for key, row, diff in dd:
            if diff > 0:
                self.index.add(key, row)
                self._data_rows[key] = row
            else:
                self.index.remove(key)
                self._data_rows.pop(key, None)
        # new/removed queries — new ones answered in one epoch batch
        new_queries: list[tuple[int, Row]] = []
        for qkey, qrow, diff in dq:
            if diff > 0:
                self._queries[qkey] = qrow
                new_queries.append((qkey, qrow))
            else:
                self._queries.pop(qkey, None)
                old = self._answers.pop(qkey, None)
                if old is not None:
                    out.append((qkey, old, -1))
        if new_queries:
            results = self._search_many([qrow for _, qrow in new_queries])
            for (qkey, qrow), result in zip(new_queries, results):
                ans = self.res_fn(qkey, qrow, result)
                self._answers[qkey] = ans
                out.append((qkey, ans, 1))
        if index_changed and self._queries:
            fresh = {qkey for qkey, _ in new_queries}
            # new queries were just answered against the post-add index;
            # only pre-existing ones can have a changed answer
            rerun = [
                (qkey, qrow)
                for qkey, qrow in self._queries.items()
                if qkey not in fresh
            ]
            results = self._search_many([qrow for _, qrow in rerun])
            for (qkey, qrow), result in zip(rerun, results):
                ans = self.res_fn(qkey, qrow, result)
                old = self._answers.get(qkey)
                if old != ans:
                    if old is not None:
                        out.append((qkey, old, -1))
                    out.append((qkey, ans, 1))
                    self._answers[qkey] = ans
        out = consolidate(out)
        if self.keep_state:
            self._update_state(out)
        self.send(out, time)

    _persist_attrs = ("_queries", "_answers", "_data_rows")

    def persist_load(self, data):
        super().persist_load(data)
        for key, row in self._data_rows.items():
            self.index.add(key, row)


async def _run_udf_traced(fn, k, r):
    """Run one async-UDF coroutine under the row's request trace, if any.

    The serving handler binds row key → RequestTrace before committing the
    request row (``tracing.bind_key``); this is the epoch-thread hop of the
    trace — ``asyncio.gather`` wraps each coroutine in a Task with a copied
    context, so the scope set here is task-local and concurrent rows never
    bleed traces into each other.
    """
    from pathway_tpu_torch.engine import tracing

    trace = tracing.trace_for_key(k)
    if trace is None:
        return await fn(k, r)
    with tracing.trace_scope(trace):
        return await fn(k, r)


def _host_value(value: Any) -> Any:
    """A ``torch.Tensor`` UDF result as the host numpy array its column will
    hold (``internals/dtype.py``), so the cache pins no device memory and an
    operator snapshot of it loads on a machine without the card; the JAX
    package caches its arrays as they come."""
    import torch

    if isinstance(value, torch.Tensor):
        from pathway_tpu_torch.internals.dtype import tensor_to_numpy

        return tensor_to_numpy(value)
    return value


class AsyncValuesNode(Node):
    """Computes extra columns with async functions: all rows of an epoch are
    awaited concurrently under one event loop, with an epoch barrier —
    the semantics of async_apply_table (dataflow.rs:1899-1937,
    executors.py:161-164).  Emits ``row + (v1, v2, ...)``; results are cached
    per (key, input row) so retractions retract the original value even for
    non-deterministic functions.
    """

    name = "async_values"
    _persist_attrs = ("_cache",)


    def __init__(self, scope, inp: Node, coro_fns: Sequence[Callable[[int, Row], Any]]):
        super().__init__(scope, [inp])
        self.coro_fns = list(coro_fns)
        self._cache: dict[tuple[int, Row], tuple] = {}

    def step(self, time):
        import asyncio

        deltas = consolidate(self.take_pending())
        inserts = [(k, r, d) for (k, r, d) in deltas if d > 0]
        others = [(k, r, d) for (k, r, d) in deltas if d <= 0]
        to_run = [(k, r) for (k, r, _) in inserts if (k, r) not in self._cache]

        if to_run:

            async def run_all():
                coros = [
                    _run_udf_traced(fn, k, r)
                    for (k, r) in to_run
                    for fn in self.coro_fns
                ]
                return await asyncio.gather(*coros, return_exceptions=True)

            flat = asyncio.run(run_all())
            n = len(self.coro_fns)
            for i, (k, r) in enumerate(to_run):
                values = []
                for res in flat[i * n : (i + 1) * n]:
                    if isinstance(res, Exception):
                        self.scope.report_row_error(
                            self, k, f"async UDF failed: {res}"
                        )
                        values.append(ERROR)
                    else:
                        values.append(as_hashable(_host_value(res)))
                self._cache[(k, r)] = tuple(values)
        out = []
        for k, r, d in inserts:
            out.append((k, r + self._cache[(k, r)], d))
        for k, r, d in others:
            cached = self._cache.pop((k, r), None)
            if cached is not None:
                out.append((k, r + cached, d))
        out = consolidate(out)
        if self.keep_state:
            self._update_state(out)
        self.send(out, time)


class OutputNode(Node):
    """Terminal: delivers consolidated epoch deltas to a writer/callback
    (output_table dataflow.rs:3979 / subscribe_table :4080)."""

    name = "output"

    def __init__(
        self,
        scope,
        inp: Node,
        on_data: Callable[[int, Row, Time, int], None] | None = None,
        on_time_end: Callable[[Time], None] | None = None,
        on_end: Callable[[], None] | None = None,
        on_frontier: Callable[[Time], None] | None = None,
    ):
        super().__init__(scope, [inp])
        self.on_data = on_data
        self.on_time_end = on_time_end
        self.on_end = on_end
        self.on_frontier = on_frontier
        self._saw_data_this_epoch = False
        # sink label from the registration (runner.run sets it): the
        # per-output identity freshness metrics are keyed by
        self.sink_name: str | None = None
        scope.outputs.append(self)

    def step(self, time):
        deltas = consolidate(self.take_pending())
        if self.keep_state:
            self._update_state(deltas)
        if self.on_data is not None:
            for key, row, diff in deltas:
                self.on_data(key, row, time, diff)
        self._saw_data_this_epoch = bool(deltas)

    def flush(self, time):
        if self.on_time_end is not None:
            self.on_time_end(time)

    def on_finish(self):
        if self.on_end is not None:
            self.on_end()


class IterateNode(Node):
    """Fixed-point iteration (dataflow.rs iterate 4185).

    Holds a sub-scope built by ``body``; per epoch, feeds the epoch's deltas
    into the sub-scope's iteration inputs and loops until quiescence or
    ``limit`` iterations — semi-naive in the sense that each round processes
    only the previous round's deltas.
    """

    name = "iterate"

    def __init__(self, scope, inputs: Sequence[Node], build_body, limit: int | None = None):
        # body builds BEFORE the node registers: any outer node it lowers
        # (scope imports) must get a lower registration id than this node —
        # run_epoch steps nodes in registration order, so an import landing
        # after the IterateNode would deliver its deltas one epoch late
        subscope = Scope(parent=scope)
        iter_inputs = [InputNode(subscope) for _ in inputs]
        # build_body returns (result_nodes, back_pairs, import_pairs):
        #   result_nodes: sub-scope nodes whose accumulated state is the result
        #   back_pairs: list of (input_index, node) — node's output deltas are
        #   fed into iter_inputs[input_index] on the next round
        #   import_pairs: list of (outer_node, sub_input) — outer-scope tables
        #   referenced by the body stream in per outer epoch, NOT part of the
        #   feedback variable (the reference's import/export of collections
        #   between scopes, dataflow.rs:4315-4724)
        result_nodes, back_pairs, import_pairs = build_body(subscope, iter_inputs)

        n_iter = len(inputs)
        super().__init__(scope, list(inputs) + [onode for onode, _ in import_pairs])
        self.limit = limit
        # fixed-point rounds are driven locally: gather all input to one
        # worker; the nested subscope never performs exchanges
        self.exchange_gather0 = True
        self.subscope = subscope
        self.iter_inputs = iter_inputs
        self.result_nodes = result_nodes
        self.back_pairs = back_pairs
        self._import_subinputs: list[tuple[int, InputNode]] = [
            (n_iter + i, sub_in) for i, (_onode, sub_in) in enumerate(import_pairs)
        ]
        for rn in self.result_nodes:
            rn.require_state()
        for _, bn in self.back_pairs:
            bn.require_state()
        self._result_sent: list[dict[tuple[int, Row], int]] = [
            {} for _ in self.result_nodes
        ]
        # everything ever fed into each iteration input (outer + feedback);
        # the back edge REPLACES the variable: we feed state(f(X)) - X, the
        # differential Variable semantics (X_{n+1} := f(X_n), not ∪)
        self._input_acc: list[Counter] = [Counter() for _ in self.iter_inputs]

    def step(self, time):
        # feed epoch deltas in
        had_input = False
        for port, iin in enumerate(self.iter_inputs):
            deltas = self.take_pending(port)
            for key, row, diff in deltas:
                had_input = True
                iin.insert(key, row, 0, diff)
                self._input_acc[port][(key, row)] += diff
        # imported outer collections: plain per-epoch streams into the
        # subscope, not part of the feedback variable
        for port, sub_in in self._import_subinputs:
            for key, row, diff in self.take_pending(port):
                had_input = True
                sub_in.insert(key, row, 0, diff)
        if not had_input:
            # nothing changed this epoch — re-running the rounds would both
            # waste work and (with iteration_limit) advance the fixed point
            # past the requested round budget
            self._last_results = [[] for _ in self.result_nodes]
            return
        rounds = 0
        limit_hit = False
        while True:
            rounds += 1
            for iin in self.iter_inputs:
                iin.emit_time(0)
            for _, sub_in in self._import_subinputs:
                sub_in.emit_time(0)
            self.subscope.run_epoch(0)
            fed_any = False
            for input_idx, bn in self.back_pairs:
                new_state = bn.state_multiset()
                acc = self._input_acc[input_idx]
                delta: list[Delta] = []
                for entry, cnt in new_state.items():
                    d = cnt - acc.get(entry, 0)
                    if d:
                        delta.append((entry[0], entry[1], d))
                for entry, cnt in list(acc.items()):
                    if cnt and entry not in new_state:
                        delta.append((entry[0], entry[1], -cnt))
                if delta:
                    fed_any = True
                    for key, row, d in delta:
                        self.iter_inputs[input_idx].insert(key, row, 0, d)
                        acc[(key, row)] += d
                        if acc[(key, row)] == 0:
                            del acc[(key, row)]
            if not fed_any:
                break
            if self.limit is not None and rounds >= self.limit:
                limit_hit = True
                break
        if limit_hit:
            # the loop fed one round of feedback it will not run — discard it
            # so the variable stays at f^limit(X) instead of leaking into the
            # next epoch (or finish) and exceeding the round budget
            for idx, iin in enumerate(self.iter_inputs):
                acc = self._input_acc[idx]
                for key, row, d in iin.take_staged(0, []):
                    acc[(key, row)] -= d
                    if acc[(key, row)] == 0:
                        del acc[(key, row)]
        # diff accumulated results against last sent
        out_all = []
        for i, rn in enumerate(self.result_nodes):
            current = rn.state_multiset()
            last = self._result_sent[i]
            out = []
            for entry, cnt in current.items():
                delta = cnt - last.get(entry, 0)
                if delta:
                    out.append((entry[0], entry[1], delta))
            for entry, cnt in last.items():
                if entry not in current:
                    out.append((entry[0], entry[1], -cnt))
            self._result_sent[i] = current
            out_all.append(out)
        merged = consolidate(itertools.chain.from_iterable(out_all))
        # tag rows with source result index so Table layer can split
        # — instead we send per-result through port-mapped downstream:
        self.send(merged, time)
        self._last_results = out_all

    # Table layer attaches ResultExtractNodes reading _last_results

    def on_finish(self):
        # end-of-stream propagates into the body: release its buffered work
        # (temporal buffers etc.), re-run the fixed point, and emit any
        # result change so the outer quiesce loop delivers it
        for node in self.subscope.nodes:
            if not isinstance(node, OutputNode):
                node.on_finish()
        self.step(self.scope.current_time)

    def final_check(self):
        for node in self.subscope.nodes:
            node.final_check()

    def persist_dump(self):
        sub = {}
        for node in self.subscope.nodes:
            d = node.persist_dump()
            if d is not None:
                sub[node.id] = d
        return {
            "__sub": sub,
            "__acc": self._input_acc,
            "__result_sent": self._result_sent,
        }

    def persist_load(self, data):
        for nid, d in data["__sub"].items():
            self.subscope.nodes[nid].persist_load(d)
        self._input_acc = [Counter(c) for c in data["__acc"]]
        self._result_sent = [dict(r) for r in data["__result_sent"]]


class IterateResultNode(Node):
    """Extracts the i-th result stream of an IterateNode."""

    name = "iterate_result"

    def __init__(self, scope, iterate_node: IterateNode, index: int):
        super().__init__(scope, [iterate_node])
        self.index = index

    def step(self, time):
        # consume the merged stream (ignored) and use the split results
        self.take_pending()
        it: IterateNode = self.inputs[0]  # type: ignore[assignment]
        out = consolidate(getattr(it, "_last_results", [[]] * (self.index + 1))[self.index])
        if self.keep_state:
            self._update_state(out)
        self.send(out, time)


class Scope:
    """Holds the operator DAG; analog of the engine Scope/Graph
    (python_api.rs Scope pyclass + graph.rs Graph trait)."""

    def __init__(self, parent: "Scope | None" = None):
        self.nodes: list[Node] = []
        self.outputs: list[OutputNode] = []
        self.parent = parent
        self.current_time: Time = 0
        self.error_log: list[tuple[Any, int, str]] = []
        self.terminate_on_error = True
        # epoch -> wallclock of its earliest staged row (latency probes)
        self.epoch_wallclock: dict[Time, float] = {}
        # multi-worker context (engine/comm.py WorkerContext); None =
        # single-process.  Only ever set on the root scope — nested scopes
        # (iterate bodies) always run locally.
        self.worker = None
        # processed-epoch counter: the index fault plans' `crash` specs
        # target (engine/faults.py) — counts run_epoch calls, root scope only
        self.epochs_run = 0

    def _register(self, node: Node) -> int:
        self.nodes.append(node)
        return len(self.nodes) - 1

    def report_row_error(self, node: Node, key: int, message: str) -> None:
        self.error_log.append((node, key, message))
        # a row error on a serving request row completes the waiting HTTP
        # future as a typed 500 NOW (before any terminate_on_error raise
        # can wedge the client until its deadline) — no-op otherwise
        from pathway_tpu_torch.engine import serving as _serving

        _serving.note_row_error(key, message)
        if self.terminate_on_error:
            raise EngineError(f"{node!r} key {Pointer(key)!r}: {message}")

    def run_epoch(self, time: Time) -> None:
        """One topologically-ordered pass (nodes registered in topo order).

        With a worker context, each declared exchange point performs one
        all-to-all right before the owning node steps — every worker walks
        the identical DAG in the same order, so the collectives pair up
        (the BSP superstep form of timely's exchange channels).
        """
        self.current_time = time
        worker = self.worker
        if self.parent is None:
            # epoch-boundary crash injection (chaos tests / soak runs):
            # SIGKILLs the process here when the active fault plan says so —
            # the boundary is where the supervisor's recovery guarantee
            # (resume from the last committed checkpoint) must hold
            from pathway_tpu_torch.engine import faults as _faults

            if _faults.active_plan() is not None:
                _faults.maybe_crash(
                    worker=worker.worker_id if worker is not None else 0,
                    epoch=self.epochs_run,
                )
                # hang injection shares the boundary: a wedged loop is the
                # watchdog's problem, a SIGKILL is the supervisor's
                _faults.maybe_hang(
                    worker=worker.worker_id if worker is not None else 0,
                    epoch=self.epochs_run,
                )
            self.epochs_run += 1
        for node in self.nodes:
            try:
                if worker is not None:
                    worker.exchange_node(node, time)
                t0 = _monotonic()
                node.step(time)
                # cumulative per-operator step time feeds the live
                # dashboard / metrics (progress_reporter.rs analog)
                node.step_seconds += _monotonic() - t0
            except Exception as exc:
                self._note_user_frame(node, exc)
                raise
        for node in self.nodes:
            try:
                node.flush(time)
            except Exception as exc:
                self._note_user_frame(node, exc)
                raise
        if self.epoch_wallclock:
            # processed epochs are read by the prober right after this call;
            # older entries are dead — keep the map bounded on long runs
            self.epoch_wallclock = {
                k: v for k, v in self.epoch_wallclock.items() if k >= time
            }

    @staticmethod
    def _note_user_frame(node: "Node", exc: Exception) -> None:
        """Attach the table-creation site to a run-time operator error so
        the user sees THEIR file:line (reference trace.py user frames)."""
        frame = getattr(node, "user_frame", None)
        if frame is not None:
            from pathway_tpu_torch.internals.trace import add_trace_note

            add_trace_note(exc, frame)

    def finish(self) -> None:
        # release buffered work (temporal buffers etc.), propagate, then
        # signal end-of-stream to outputs — ordering matters so subscribers
        # see the released rows before on_end.  In multi-worker mode the
        # quiesce check is a global any() — a worker with nothing pending
        # must still join its peers' exchange rounds.
        for node in self.nodes:
            if not isinstance(node, OutputNode):
                node.on_finish()
        guard = 0
        while self._any_pending_global(guard):
            self.run_epoch(self.current_time + 2)
            guard += 1
            if guard > 1000:
                raise EngineError("finish() did not quiesce")
        for node in self.nodes:
            node.final_check()
        for out in self.outputs:
            out.on_finish()

    def _any_pending_global(self, round_: int) -> bool:
        local = any(node.has_pending() for node in self.nodes)
        if self.worker is None:
            return local
        mesh = self.worker.mesh
        flags = mesh.gather(("finish", round_), local)
        return mesh.bcast(("finish-go", round_), flags is not None and any(flags))

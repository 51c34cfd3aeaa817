"""Columnar (vectorized) expression compilation for large epoch batches.

SURVEY.md §7.3: the host hot path should move columnar batches, not Python
row tuples.  The engine stays delta-correct and row-oriented at its edges;
inside an epoch, ``ExprNode``/``FilterNode``/``GroupByNode`` switch to a
numpy fast path when (a) the expression compiles to vector ops and (b) the
batch's columns materialize as typed 1-D arrays (no ``None``/``Error``
values, no mixed types).  Anything else falls back to the per-row
interpreter — semantics are identical by construction, because the fast
path *bails* (``VecBail``) rather than approximating:

* division/modulo with any zero divisor bails (per-row path yields ERROR
  for exactly the offending rows);
* ``**`` on ints bails (Python bignum semantics ≠ int64);
* columns containing None/Error/mixed types materialize as object arrays
  and bail.

Int arithmetic runs in int64 — the reference engine's own integer type
(``Value::Int`` is ``i64``, value.rs:210) — with overflow surfaced by
numpy where detectable.
"""

from __future__ import annotations

from collections import Counter as _Counter
from typing import Any, Callable

import numpy as np

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import expression as expr_mod
from pathway_tpu_torch.internals.expression import (
    CastExpression,
    CoalesceExpression,
    ColumnBinaryOpExpression,
    ColumnConstExpression,
    ColumnExpression,
    ColumnReference,
    ColumnUnaryOpExpression,
    ConvertExpression,
    IfElseExpression,
    IsNoneExpression,
    IsNotNoneExpression,
    MakeTupleExpression,
    UnwrapExpression,
)
from pathway_tpu_torch.internals.thisclass import ThisPlaceholder

VEC_THRESHOLD = 64  # below this, per-row beats transpose + dispatch


def _env_enabled() -> bool:
    # declared kill switch (PATHWAY_COLUMNAR): ops can force the row-wise
    # reference path fleet-wide without a code change
    try:
        from pathway_tpu_torch.internals.config import env_bool

        return env_bool("PATHWAY_COLUMNAR")
    except Exception:  # noqa: BLE001 - config must never break compilation
        return True


# process-wide switch (benchmark baselines, debugging); the row path is the
# reference semantics, the vector path must be observationally identical
ENABLED = _env_enabled()


def set_enabled(flag: bool) -> None:
    global ENABLED
    ENABLED = bool(flag)

VecFn = Callable[[dict, int], np.ndarray]  # (columns by index, n) -> array


class VecBail(Exception):
    """Data-dependent condition the vector path cannot honor; caller falls
    back to the per-row interpreter for this batch."""


# ---------------------------------------------------------------------------
# bail accounting: every fall-back from a columnar fast path to the row-wise
# evaluator is counted per (operator, reason) — silent bails were invisible
# before, so a pipeline could quietly run 5x slower than its benchmark twin.
# Mirrored two ways: the metrics registry (`columnar.bail.count{op=,reason=}`,
# /status + `pathway_tpu top`) and a process-local Counter the profiler
# snapshot embeds (`pathway_tpu profile` renders the top reasons).
# ---------------------------------------------------------------------------

BAIL_COUNTS: _Counter = _Counter()

_bail_children: dict[tuple[str, str], Any] = {}


def note_bail(op: str, reason: str) -> None:
    """Record one columnar→row fall-back of operator kind ``op``."""
    BAIL_COUNTS[(op, reason)] += 1
    child = _bail_children.get((op, reason))
    if child is None:
        try:
            from pathway_tpu_torch.engine import metrics as _metrics

            child = _metrics.get_registry().counter(
                "columnar.bail.count",
                "columnar fast-path batches that fell back to the row-wise "
                "evaluator",
                op=op,
                reason=reason,
            )
        except Exception:  # noqa: BLE001 - accounting must never break a step
            return
        _bail_children[(op, reason)] = child
    child.inc()


def bail_snapshot(top: int = 8) -> list[dict[str, Any]]:
    """Top bail reasons for profiler snapshots / post-mortems."""
    return [
        {"op": op, "reason": reason, "count": count}
        for (op, reason), count in BAIL_COUNTS.most_common(top)
    ]


def _const_array(v, n: int) -> np.ndarray:
    return np.full(n, v)


def passthrough_index(e, binder) -> int | None:
    """Source-column index when ``e`` is a bare same-table column reference
    (the dominant ``with_columns`` shape).  The columnar path then copies
    the value straight from the input row — no materialization, no
    array↔scalar conversions — which also means dirty columns (None/Error/
    mixed) no longer force the whole node onto the row path.  Values in
    rows are already coerced to their column dtypes, so the copy matches
    the row path's ``dt.coerce`` identity bit-for-bit."""
    if isinstance(e, ColumnReference):
        tbl = e.table
        if (
            (isinstance(tbl, ThisPlaceholder) or tbl is binder.table)
            and e.name != "id"
            and e.name in binder.col_index
        ):
            return binder.col_index[e.name]
    return None


def affine_index(e, binder) -> tuple[int, int | float] | None:
    """``(col_idx, const_offset)`` when ``e`` is a same-table column plus/
    minus a numeric constant (the shape every temporal threshold lowers to:
    ``time``, ``time + delay``, ``end + cutoff``).  The temporal operators'
    columnar path then evaluates the whole epoch's times/thresholds as one
    array op.  None for anything else — the row path stays the oracle."""
    idx = passthrough_index(e, binder)
    if idx is not None:
        return idx, 0
    if isinstance(e, ColumnBinaryOpExpression) and e._op in ("+", "-"):
        left, right = e._left, e._right
        lidx = passthrough_index(left, binder)
        if (
            lidx is not None
            and isinstance(right, ColumnConstExpression)
            and type(right._val) in (int, float)
        ):
            off = right._val
            return lidx, (-off if e._op == "-" else off)
        ridx = passthrough_index(right, binder)
        if (
            e._op == "+"
            and ridx is not None
            and isinstance(left, ColumnConstExpression)
            and type(left._val) in (int, float)
        ):
            return ridx, left._val
    return None


def affine_values(
    cols: dict[int, np.ndarray], idx: int, offset: int | float
) -> np.ndarray:
    """Apply an :func:`affine_index` offset to a materialized column with
    row-path exactness: numeric columns only, int offsets guarded against
    int64 wrap (the row path adds Python bignums)."""
    arr = cols[idx]
    if arr.dtype.kind not in "if":
        raise VecBail
    if offset == 0 and isinstance(offset, int):
        return arr
    if arr.dtype.kind == "i" and isinstance(offset, int):
        if _abs_bound(arr) + abs(offset) > _I64_MAX:
            raise VecBail
    return arr + offset


def split_deltas(deltas: list, mask) -> tuple[list, list]:
    """Partition a delta list by a uint8/bool mask (kept, dropped), rows
    untouched — the batched form of the temporal buffers' release scan.
    Native single pass when available."""
    sd = _native_sym("split_deltas")
    if sd is not None:
        return sd(deltas, np.ascontiguousarray(mask, dtype=np.uint8))
    kept: list = []
    dropped: list = []
    for d, keep in zip(deltas, np.asarray(mask).tolist()):
        (kept if keep else dropped).append(d)
    return kept, dropped


def freeze_scan(
    t: np.ndarray, thr: np.ndarray, watermark
) -> tuple[bytearray, Any]:
    """FreezeNode's sequential admit/advance scan over one epoch batch:
    a row is kept unless ``thr <= watermark``; kept rows advance the
    watermark to ``max(watermark, t)`` *as the scan runs* (later rows see
    earlier rows' watermark).  Returns ``(keep mask, new watermark)``.

    Native single pass (GIL-released) when available; the Python loop over
    unboxed scalars is the fallback and matches the row path exactly."""
    fs = _native_sym("freeze_scan")
    if (
        fs is not None
        and t.dtype.kind == thr.dtype.kind
        and t.dtype.kind in "if"
        and t.dtype.itemsize == 8
        and thr.dtype.itemsize == 8
    ):
        kind = "q" if t.dtype.kind == "i" else "d"
        wm = watermark
        if wm is not None and kind == "q" and (
            not isinstance(wm, int) or not (-(2**63) <= wm < 2**63)
        ):
            fs = None  # mixed/bignum watermark: take the exact scalar loop
        elif wm is not None and kind == "d" and not isinstance(wm, float):
            fs = None
        if fs is not None:
            return fs(
                kind,
                np.ascontiguousarray(t),
                np.ascontiguousarray(thr),
                wm,
            )
    tl = t.tolist()
    thl = thr.tolist()
    wm = watermark
    mask = bytearray(len(tl))
    for i in range(len(tl)):
        if wm is not None and thl[i] <= wm:
            continue
        if wm is None or tl[i] > wm:
            wm = tl[i]
        mask[i] = 1
    return mask, wm


def try_compile_vec(e: ColumnExpression, binder) -> tuple[VecFn, set[int]] | None:
    """Compile to a columnar evaluator, or None if not vectorizable.

    ``binder`` is the row binder (needs ``table``, ``col_index``).  Returns
    (fn, needed_column_indices).
    """
    needed: set[int] = set()
    fn = _compile(e, binder, needed)
    if fn is None:
        return None
    return fn, needed


def _compile(e, binder, needed: set[int]) -> VecFn | None:
    if isinstance(e, ColumnConstExpression):
        v = e._val
        if isinstance(v, (bool, int, float, str)):
            return lambda cols, n: _const_array(v, n)
        return None

    if isinstance(e, ColumnReference):
        tbl = e.table
        if not (isinstance(tbl, ThisPlaceholder) or tbl is binder.table):
            return None  # foreign/fetched columns use the row path
        if e.name == "id" or e.name not in binder.col_index:
            return None
        idx = binder.col_index[e.name]
        needed.add(idx)
        return lambda cols, n: cols[idx]

    if isinstance(e, ColumnBinaryOpExpression):
        lf = _compile(e._left, binder, needed)
        rf = _compile(e._right, binder, needed)
        if lf is None or rf is None:
            return None
        op = e._op
        return _bin_vec(op, lf, rf)

    if isinstance(e, ColumnUnaryOpExpression):
        f = _compile(e._expr, binder, needed)
        if f is None:
            return None
        if e._op == "-":

            def neg(cols, n):
                v = f(cols, n)
                if v.dtype.kind not in "if":
                    raise VecBail
                return -v

            return neg
        if e._op == "~":

            def inv(cols, n):
                v = f(cols, n)
                if v.dtype.kind == "b":
                    return ~v
                if v.dtype.kind == "i":
                    return ~v
                raise VecBail

            return inv
        return None

    if isinstance(e, IfElseExpression):
        cf = _compile(e._if, binder, needed)
        tf = _compile(e._then, binder, needed)
        ff = _compile(e._else, binder, needed)
        if cf is None or tf is None or ff is None:
            return None

        def where(cols, n):
            c = cf(cols, n)
            if c.dtype.kind != "b":
                raise VecBail
            return np.where(c, tf(cols, n), ff(cols, n))

        return where

    if isinstance(e, IsNoneExpression):
        f = _compile(e._expr, binder, needed)
        if f is None:
            return None
        # typed columns cannot hold None
        return lambda cols, n: np.zeros(n, bool)

    if isinstance(e, IsNotNoneExpression):
        f = _compile(e._expr, binder, needed)
        if f is None:
            return None
        return lambda cols, n: np.ones(n, bool)

    if isinstance(e, CoalesceExpression):
        f = _compile(e._args[0], binder, needed)
        return f  # typed first arg is never None

    if isinstance(e, UnwrapExpression):
        return _compile(e._expr, binder, needed)

    if isinstance(e, MakeTupleExpression):
        fs = [_compile(a, binder, needed) for a in e._args]
        if any(f is None for f in fs):
            return None

        def mk(cols, n):
            lists = []
            for f in fs:
                v = f(cols, n)
                if isinstance(v, np.ndarray):
                    # a shared-NaN object groups rows on the row path but
                    # tolist() would mint distinct NaNs — bail to keep
                    # group-key equality semantics identical
                    if v.dtype.kind == "f" and np.isnan(v).any():
                        raise VecBail
                    lists.append(v.tolist())
                else:
                    lists.append(list(v))
            return list(zip(*lists)) if lists else [()] * n

        return mk

    if isinstance(e, CastExpression):  # Convert (from Json) stays row-wise
        f = _compile(e._expr, binder, needed)
        if f is None:
            return None
        target = e._return_type.strip_optional()
        if target is dt.INT:

            def to_int(cols, n):
                v = f(cols, n)
                if v.dtype.kind not in "bif":
                    raise VecBail
                return v.astype(np.int64)

            return to_int
        if target is dt.FLOAT:

            def to_float(cols, n):
                v = f(cols, n)
                if v.dtype.kind not in "bif":
                    raise VecBail
                return v.astype(np.float64)

            return to_float
        if target is dt.BOOL:

            def to_bool(cols, n):
                v = f(cols, n)
                if v.dtype.kind != "b":
                    raise VecBail
                return v

            return to_bool
        return None

    return None


_NUMERIC = "bif"

_I64_MAX = 2**63 - 1


def _abs_bound(arr: np.ndarray) -> int:
    """Largest |value| in an int array, computed safely in Python ints."""
    if arr.size == 0:
        return 0
    return max(abs(int(arr.max())), abs(int(arr.min())))


def _guard_int_overflow(op: str, lv: np.ndarray, rv: np.ndarray) -> None:
    """numpy int64 wraps silently; the row path uses Python bignums — any
    result that could exceed i64 must bail to the row interpreter."""
    if lv.dtype.kind != "i" and rv.dtype.kind != "i":
        return
    m1, m2 = _abs_bound(lv), _abs_bound(rv)
    if op in ("+", "-"):
        if m1 + m2 > _I64_MAX:
            raise VecBail
    elif op == "*":
        if m1 and m2 and m1 * m2 > _I64_MAX:
            raise VecBail


def _bin_vec(op: str, lf: VecFn, rf: VecFn) -> VecFn:
    def run(cols, n):
        lv = lf(cols, n)
        rv = rf(cols, n)
        lk, rk = lv.dtype.kind, rv.dtype.kind
        if op in ("==", "!="):
            if (lk == "U") != (rk == "U"):
                raise VecBail  # str vs non-str: row semantics return False/True
            res = lv == rv if op == "==" else lv != rv
            return res
        if op in ("<", "<=", ">", ">="):
            if lk == "U" and rk == "U":
                pass  # lexicographic, matches Python
            elif lk not in _NUMERIC or rk not in _NUMERIC:
                raise VecBail
            if op == "<":
                return lv < rv
            if op == "<=":
                return lv <= rv
            if op == ">":
                return lv > rv
            return lv >= rv
        if op in ("&", "|", "^"):
            if lk == "b" and rk == "b":
                return {"&": lv & rv, "|": lv | rv, "^": lv ^ rv}[op]
            if lk == "i" and rk == "i":
                return {"&": lv & rv, "|": lv | rv, "^": lv ^ rv}[op]
            raise VecBail
        if lk not in _NUMERIC or rk not in _NUMERIC:
            raise VecBail
        if op == "+":
            _guard_int_overflow(op, lv, rv)
            return lv + rv
        if op == "-":
            _guard_int_overflow(op, lv, rv)
            return lv - rv
        if op == "*":
            _guard_int_overflow(op, lv, rv)
            return lv * rv
        if op == "/":
            if np.any(rv == 0):
                raise VecBail  # per-row path poisons exactly those rows
            return lv / rv
        if op == "//":
            if np.any(rv == 0):
                raise VecBail
            return lv // rv
        if op == "%":
            if np.any(rv == 0):
                raise VecBail
            return lv % rv
        if op == "**":
            if lk in "bi" and rk in "bi":
                raise VecBail  # Python bignum semantics
            return lv**rv
        raise VecBail

    return run


_NAT_KIND_DTYPE = {"q": np.int64, "d": np.float64, "?": np.bool_}

_native_syms: dict[str, Any] | None = None


def _native_sym(name: str):
    """Memoized lookup of a native-core function (None when unavailable) —
    the hot paths below must not pay an import + getattr per epoch batch."""
    global _native_syms
    if _native_syms is None:
        syms: dict[str, Any] = {}
        try:
            from pathway_tpu_torch import native as _nat

            mod = _nat.get()
            for n in (
                "materialize_columns",
                "rebuild_delta_rows",
                "filter_deltas",
                "group_indices",
                "delta_diffs",
                "split_deltas",
                "freeze_scan",
                "route_deltas",
            ):
                syms[n] = getattr(mod, n, None)
        except Exception:
            syms = {}
        _native_syms = syms
    return _native_syms.get(name)


def _get_native_materialize():
    return _native_sym("materialize_columns")


def _wrap_native_cols(res: dict) -> dict[int, np.ndarray]:
    return {
        i: (
            np.asarray(payload)
            if kind == "U"
            else np.frombuffer(payload, dtype=_NAT_KIND_DTYPE[kind])
        )
        for i, (kind, payload) in res.items()
    }


def materialize_delta_columns(
    deltas: list, needed: set[int]
) -> dict[int, np.ndarray] | None:
    """materialize_columns straight from a delta list (no rows listcomp) —
    the native single-pass when available."""
    nm = _get_native_materialize()
    if nm is not None:
        res = nm(deltas, tuple(needed), True)
        return None if res is None else _wrap_native_cols(res)
    return materialize_columns([r for (_, r, _) in deltas], needed)


def materialize_delta_columns_raw(deltas: list, needed: set[int]):
    """Native raw form ``{idx: (kind, payload)}`` — str columns stay Python
    lists (no U-array build), which the hash-grouping path wants.  Returns
    ``NotImplemented`` when the native core is unavailable."""
    nm = _get_native_materialize()
    if nm is None:
        return NotImplemented
    return nm(deltas, tuple(needed), True)


def wrap_native_col(kind: str, payload) -> np.ndarray:
    if kind == "U":
        return np.asarray(payload)
    return np.frombuffer(payload, dtype=_NAT_KIND_DTYPE[kind])


def group_indices(values: list) -> tuple[list, np.ndarray]:
    """(uniques, inverse) by hash grouping — np.unique(return_inverse)
    without the sort or the U-array conversion.  Uniques are in first-seen
    order (callers must not rely on sortedness)."""
    gi = _native_sym("group_indices")
    if gi is not None:
        uniques, inv = gi(values)
        return uniques, np.frombuffer(inv, np.int64)
    index: dict = {}
    inv = np.empty(len(values), np.int64)
    uniques: list = []
    for i, v in enumerate(values):
        pos = index.get(v)
        if pos is None:
            pos = index[v] = len(uniques)
            uniques.append(v)
        inv[i] = pos
    return uniques, inv


def delta_diffs(deltas: list) -> np.ndarray:
    """int64 diffs column of a delta list (native single pass)."""
    dd = _native_sym("delta_diffs")
    if dd is not None:
        buf = dd(deltas)
        if buf is not None:
            return np.frombuffer(buf, np.int64)
    return np.asarray([d for (_, _, d) in deltas], np.int64)


_NAT_DTYPE_KIND = {"i": "q", "f": "d", "b": "?"}


def rebuild_delta_rows(deltas: list, out_cols: list, n: int) -> list:
    """Zip result columns back into (key, row_tuple, diff) deltas, reusing
    the input keys/diffs.  ``out_cols`` entries are ndarrays or
    ``("P", src_idx)`` passthrough markers (copied from the input row).
    Native single pass when available; the Python fallback is the
    semantics reference (tolist -> zip)."""
    rb = _native_sym("rebuild_delta_rows")
    if rb is not None:
        packed = []
        for arr in out_cols:
            if isinstance(arr, tuple):  # ("P", src_idx)
                packed.append(arr)
                continue
            kind = _NAT_DTYPE_KIND.get(arr.dtype.kind)
            if kind is not None and arr.dtype.itemsize in (1, 8):
                packed.append((kind, np.ascontiguousarray(arr)))
            else:  # U / object / narrow dtypes: go through Python scalars
                packed.append(("U", arr.tolist()))
        return rb(deltas, packed)
    def _as_list(arr):
        if isinstance(arr, tuple):
            if arr[0] == "U":  # pre-built Python values (tuple columns)
                return arr[1]
            return [row[arr[1]] for (_, row, _) in deltas]  # ("P", idx)
        return arr.tolist()

    out_lists = [_as_list(arr) for arr in out_cols]
    out_rows = list(zip(*out_lists)) if out_lists else [()] * n
    return [
        (key, new_row, diff)
        for (key, _, diff), new_row in zip(deltas, out_rows)
    ]


def filter_deltas(deltas: list, mask: np.ndarray, n_cols: int) -> list:
    """Keep deltas where ``mask`` is true, truncating rows to ``n_cols``.
    Native single pass when available."""
    fd = _native_sym("filter_deltas")
    if fd is not None:
        return fd(deltas, np.ascontiguousarray(mask, dtype=np.uint8), n_cols)
    return [
        (key, row[:n_cols], diff)
        for (key, row, diff), keep in zip(deltas, mask.tolist())
        if keep
    ]


def materialize_columns(rows: list, needed: set[int]) -> dict[int, np.ndarray] | None:
    """Extract the needed columns as typed 1-D arrays; None if any column is
    not cleanly typed (None/Error/mixed/nested values).

    Uniform *Python* types are required — np.asarray would silently promote
    int/float mixes to float64 (precision loss above 2**53) and bool/int
    mixes to int64, changing values the row path preserves exactly.

    The native core does the scan+extract in one C pass per column when
    available; the Python loop below is the fallback and the semantics
    reference.
    """
    nm = _get_native_materialize()
    if nm is not None:
        res = nm(rows, tuple(needed), False)
        return None if res is None else _wrap_native_cols(res)
    cols: dict[int, np.ndarray] = {}
    for i in needed:
        vals = [r[i] for r in rows]
        t0 = type(vals[0])
        if t0 not in (bool, int, float, str):
            return None
        # C-level uniformity scan (set+map) — the per-value genexpr was the
        # single hottest line of the columnar path at 1M+ rows
        if set(map(type, vals)) != {t0}:
            return None
        try:
            arr = np.asarray(vals)
        except (ValueError, OverflowError, TypeError):
            return None
        if arr.ndim != 1 or arr.dtype.kind not in "bifU":
            return None
        if arr.dtype.kind == "i" and arr.size and int(arr.min()) == -(2**63):
            return None  # INT64_MIN: negation / // -1 would wrap
        cols[i] = arr
    return cols


_KIND_OK = {
    dt.INT: "bi",
    dt.FLOAT: "f",
    dt.BOOL: "b",
    dt.STR: "U",
}


def result_kind_ok(arr: np.ndarray, out_dtype) -> bool:
    """The vector result must already be in the declared dtype's kind —
    otherwise the per-row path's dt.coerce would alter values and we bail."""
    base = out_dtype.strip_optional() if hasattr(out_dtype, "strip_optional") else out_dtype
    allowed = _KIND_OK.get(base)
    if allowed is None:
        return True  # ANY etc. — whatever the math produced is the value
    return arr.dtype.kind in allowed

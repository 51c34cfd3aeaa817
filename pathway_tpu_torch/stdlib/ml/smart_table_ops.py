"""Fuzzy-join helpers (parity: stdlib/ml/smart_table_ops.py).

Provides ``fuzzy_match_tables`` — approximate matching of rows between two
tables by token overlap scoring.
"""

from __future__ import annotations

import re
from collections import defaultdict

from pathway_tpu_torch.internals import expression as expr_mod
from pathway_tpu_torch.internals import reducers
from pathway_tpu_torch.internals.expression import ApplyExpression, ColumnReference
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.internals.thisclass import left as lp, right as rp, this

_WORD = re.compile(r"\w+")


def _tokens(s) -> tuple:
    return tuple(sorted({w.lower() for w in _WORD.findall(str(s or ""))}))


def fuzzy_match_tables(
    left: Table,
    right: Table,
    *,
    left_column: ColumnReference | None = None,
    right_column: ColumnReference | None = None,
) -> Table:
    """Match rows by shared tokens; returns (left, right, weight)."""
    lcol = left_column or ColumnReference(left, left.column_names()[0])
    rcol = right_column or ColumnReference(right, right.column_names()[0])
    l_tok = left.select(_pw_tok=ApplyExpression(_tokens, None, lcol))
    r_tok = right.select(_pw_tok=ApplyExpression(_tokens, None, rcol))
    l_flat = l_tok.flatten(ColumnReference(this, "_pw_tok"), origin_id="_pw_lid")
    r_flat = r_tok.flatten(ColumnReference(this, "_pw_tok"), origin_id="_pw_rid")
    pairs = l_flat.join(
        r_flat, ColumnReference(lp, "_pw_tok") == ColumnReference(rp, "_pw_tok")
    ).select(
        left_id=ColumnReference(lp, "_pw_lid"),
        right_id=ColumnReference(rp, "_pw_rid"),
    )
    weights = pairs.groupby(this.left_id, this.right_id).reduce(
        left=this.left_id, right=this.right_id, weight=reducers.count()
    )
    return weights


__all__ = ["fuzzy_match_tables"]

"""``pw.this`` / ``pw.left`` / ``pw.right`` placeholders.

Parity target: ``python/pathway/internals/thisclass.py`` (313
LoC) + ``desugaring.py``.  A placeholder stands for a not-yet-known table;
attribute access produces unbound ``ColumnReference``s which get substituted
with the real table at the point of use (select/filter/join/reduce).
"""

from __future__ import annotations

from pathway_tpu_torch.internals.expression import ColumnReference


class ThisPlaceholder:
    _kind: str

    def __init__(self, kind: str):
        object.__setattr__(self, "_kind", kind)

    def __repr__(self):
        return {"this": "pw.this", "left": "pw.left", "right": "pw.right"}.get(
            self._kind, f"pw.{self._kind}"
        )

    def __getattr__(self, name: str) -> ColumnReference:
        if name.startswith("__") and name.endswith("__"):
            raise AttributeError(name)
        return ColumnReference(self, name)

    def __getitem__(self, arg):
        if isinstance(arg, str):
            return ColumnReference(self, arg)
        if isinstance(arg, ColumnReference):
            return ColumnReference(self, arg.name)
        if isinstance(arg, (list, tuple)):
            return ThisSlice(self, keep=[_name_of(a) for a in arg])
        raise TypeError(f"cannot index pw.this with {type(arg)}")

    @property
    def id(self) -> ColumnReference:
        return ColumnReference(self, "id")

    def without(self, *columns) -> "ThisSlice":
        return ThisSlice(self, without=[_name_of(c) for c in columns])

    def ix(self, expression, *, optional: bool = False, context=None):
        # pw.this.ix(keys_expression) — row lookup by pointer column
        from pathway_tpu_torch.internals.table import IxAppliedPlaceholder

        return IxAppliedPlaceholder(self, expression, optional=optional)

    def ix_ref(self, *args, optional: bool = False, context=None, instance=None):
        from pathway_tpu_torch.internals.table import IxRefAppliedPlaceholder

        return IxRefAppliedPlaceholder(self, args, optional=optional, instance=instance)


def _name_of(c) -> str:
    if isinstance(c, str):
        return c
    if isinstance(c, ColumnReference):
        return c.name
    raise TypeError(f"expected column name or reference, got {type(c)}")


class ThisSlice:
    """``pw.this.without(x)`` / ``pw.this[["a","b"]]`` — expands in select(*args)."""

    def __init__(self, base, keep: list[str] | None = None, without: list[str] | None = None):
        self._base = base
        self._keep = keep
        self._without = without or []

    def _column_names(self, table) -> list[str]:
        names = self._keep if self._keep is not None else table.column_names()
        return [n for n in names if n not in self._without]

    def without(self, *columns) -> "ThisSlice":
        return ThisSlice(
            self._base, keep=self._keep, without=self._without + [_name_of(c) for c in columns]
        )

    def __getitem__(self, arg):
        if isinstance(arg, (list, tuple)):
            return ThisSlice(self._base, keep=[_name_of(a) for a in arg], without=self._without)
        return ColumnReference(self._base, _name_of(arg))

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return ColumnReference(self._base, name)


this = ThisPlaceholder("this")
left = ThisPlaceholder("left")
right = ThisPlaceholder("right")

"""Live table/plot visualization (parity: python/pathway/stdlib/viz/).

``Table.show()`` / ``Table.plot()`` / ``_repr_mimebundle_`` — jupyter
widgets that preview a bounded table immediately and auto-update a
streaming one after ``pw.run()``.

The reference builds panel+bokeh dashboards.  With ``panel``/``bokeh``
importable the same widget shapes are produced; without them ``show`` degrades to a pandas snapshot
(static) or a subscriber-fed snapshot object (streaming), and ``plot``
raises the gating ImportError the other optional integrations use.
"""

from __future__ import annotations

from typing import Any, Callable

from pathway_tpu_torch.internals.table import Table


def _optional_panel():
    try:
        import bokeh  # noqa: F401
        import panel

        return panel
    except ImportError:
        return None


class TableSnapshot:
    """Fallback widget: maintains a keyed snapshot fed by a subscriber."""

    def __init__(self, table: Table, include_id: bool, snapshot_only: bool):
        self.table = table
        self.include_id = include_id
        self.snapshot_only = snapshot_only
        self.rows: dict = {}
        self.changes: list = []

    def _update(self, key, row, time, diff):
        if diff > 0:
            self.rows[key] = row
        else:
            self.rows.pop(key, None)
        self.changes.append((key, row, time, diff))

    def to_pandas(self):
        import pandas as pd

        names = list(self.table.column_names())
        if self.snapshot_only:
            data = [
                ((key,) if self.include_id else ()) + tuple(row)
                for key, row in sorted(self.rows.items())
            ]
            cols = (["id"] if self.include_id else []) + names
        else:
            data = [
                ((key,) if self.include_id else ()) + tuple(row) + (time, diff)
                for key, row, time, diff in self.changes
            ]
            cols = (["id"] if self.include_id else []) + names + ["time", "diff"]
        return pd.DataFrame(data, columns=cols)

    def _repr_html_(self):
        return self.to_pandas()._repr_html_()


def show(
    self: Table,
    *,
    snapshot: bool = True,
    include_id: bool = True,
    short_pointers: bool = True,
    sorters: Any = None,
) -> Any:
    """Display the table in a notebook; streaming tables update on pw.run().

    Reference: ``stdlib/viz/table_viz.py:26`` (panel Tabulator column).
    """
    panel = _optional_panel()
    widget = TableSnapshot(self, include_id, snapshot_only=snapshot)
    self._subscribe_raw(widget._update, name="viz:show")
    if panel is None:
        return widget
    import pandas as pd

    tabulator = panel.widgets.Tabulator(
        pd.DataFrame(), disabled=True, show_index=False
    )

    def refresh(*_a):
        tabulator.value = widget.to_pandas()

    self._subscribe_raw(
        lambda key, row, time, diff: refresh(), name="viz:show:refresh"
    )
    return panel.Column(tabulator)


def plot(
    self: Table,
    plotting_function: Callable[..., Any],
    sorting_col: str | None = None,
) -> Any:
    """Bokeh plot over the table, streamed via a ColumnDataSource.

    Reference: ``stdlib/viz/plotting.py:35``.
    """
    panel = _optional_panel()
    if panel is None:
        raise ImportError(
            "Table.plot requires the optional 'panel' and 'bokeh' packages, "
            "which are not installed in this environment"
        )
    from bokeh.models import ColumnDataSource

    names = list(self.column_names())
    source = ColumnDataSource(data={n: [] for n in names})
    figure = plotting_function(source)
    widget = TableSnapshot(self, include_id=False, snapshot_only=True)

    def refresh(key, row, time, diff):
        widget._update(key, row, time, diff)
        df = widget.to_pandas()
        if sorting_col:
            df = df.sort_values(sorting_col)
        source.stream(df.to_dict("list"), rollover=len(df))

    self._subscribe_raw(refresh, name="viz:plot")
    return panel.Column(figure)


def _repr_mimebundle_(self: Table, include, exclude):
    return {"text/html": show(self)._repr_html_()}


Table.show = show  # type: ignore[attr-defined]
Table.plot = plot  # type: ignore[attr-defined]

__all__ = ["plot", "show", "_repr_mimebundle_", "TableSnapshot"]

"""Python custom sources (parity: python/pathway/io/python/__init__.py:46-227).

``ConnectorSubject``: subclass, implement ``run()``, call ``self.next(...)``
(or next_str/next_bytes/next_json), ``self.commit()``, ``self.close()``.
Bridged into the engine through the reader-thread/queue pattern — the role
``PythonReader`` (data_storage.rs:806) plays in the reference.
"""

from __future__ import annotations

import threading
from typing import Any

from pathway_tpu_torch.engine.types import Json
from pathway_tpu_torch.internals import schema as schema_mod
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.io import _utils
from pathway_tpu_torch.io._utils import COMMIT, DELETE, Reader


class ConnectorSubject:
    """Base class for Python-defined sources.

    Example:

    >>> import pathway_tpu_torch as pw
    >>> class Numbers(pw.io.python.ConnectorSubject):
    ...     def run(self):
    ...         for i in range(3):
    ...             self.next(n=i)
    ...         self.commit()
    >>> t = pw.io.python.read(Numbers(), schema=pw.schema_from_types(n=int))
    >>> pw.debug.compute_and_print(t.select(sq=pw.this.n * pw.this.n), include_id=False)
    sq
    0
    1
    4
    """

    def __init__(self, datasource_name: str | None = None):
        self._datasource_name = datasource_name

    def _emit(self, item: Any) -> None:
        # Resolved per reader-thread (bound by _SubjectReader.run). The
        # same subject object can be re-run on a fresh reader thread while
        # a superseded lifetime's run() is still mid-flight — a surviving
        # worker rejoining in-process after a warm-standby promotion does
        # exactly this — and a plain instance attribute would redirect the
        # old thread's leftover rows into the new pipeline (double
        # ingest).  Helper threads a subject spawns itself fall back to
        # the most recent binding.
        tl = self.__dict__.get("_emit_threads")
        fn = getattr(tl, "fn", None) if tl is not None else None
        if fn is None:
            fn = self.__dict__.get("_emit_latest")
        if fn is None:
            raise RuntimeError(
                "ConnectorSubject.next() called outside pw.io.python.read()"
            )
        fn(item)

    # --- user API ---
    def next(self, **kwargs) -> None:
        self._emit(dict(kwargs))

    def next_str(self, message: str) -> None:
        self._emit({"data": message})

    def next_bytes(self, message: bytes) -> None:
        self._emit({"data": message})

    def next_json(self, message: dict) -> None:
        self._emit(
            {
                k: (Json(v) if isinstance(v, (dict, list)) else v)
                for k, v in message.items()
            }
        )

    def commit(self) -> None:
        self._emit(COMMIT)

    def close(self) -> None:
        pass

    def _remove(self, key, row: dict) -> None:
        row = dict(row)
        row[DELETE] = True
        if key is not None:
            row["_pw_key"] = key
        self._emit(row)

    def run(self) -> None:
        raise NotImplementedError

    def on_stop(self) -> None:
        pass

    @property
    def _deletions_enabled(self) -> bool:
        return True


class _SubjectReader(Reader):
    def __init__(self, subject: ConnectorSubject):
        self.subject = subject

    def run(self, emit) -> None:
        # thread-scoped emit binding: see ConnectorSubject._emit
        tl = self.subject.__dict__.setdefault(
            "_emit_threads", threading.local()
        )
        tl.fn = emit
        self.subject.__dict__["_emit_latest"] = emit
        try:
            self.subject.run()
        finally:
            self.subject.on_stop()


def read(
    subject: ConnectorSubject,
    *,
    schema: type[schema_mod.Schema] | None = None,
    format: str = "row",
    autocommit_duration_ms: int | None = 1500,
    name: str | None = None,
    **kwargs: Any,
) -> Table:
    if schema is None:
        raise ValueError("python.read requires schema=")
    return _utils.make_input_table(
        schema,
        lambda: _SubjectReader(subject),
        autocommit_duration_ms=autocommit_duration_ms,
        name=name,
    )


class InteractiveCsvPlayer(ConnectorSubject):
    """Replay a CSV interactively: rows stream as the position advances.

    Parity: ``io/python/__init__.py:440``.  In a notebook with ``panel``
    installed this renders the reference's slider widget; headless
    environments drive it programmatically via :meth:`advance_to` /
    :meth:`play_all` instead (the widget stack is optional here, matching
    the zero-extra-deps stance of this build).
    """

    def __init__(self, csv_file: str = "") -> None:
        import queue as _queue

        super().__init__()
        self.q: "_queue.Queue[int]" = _queue.Queue()
        import pandas as pd

        self.df = pd.read_csv(csv_file)
        self._widget = None
        try:  # optional notebook widget, exactly the reference's UI
            import panel as pn
            from IPython.display import display

            slider = pn.widgets.IntSlider(
                name="Row position in csv",
                start=0,
                end=len(self.df),
                step=1,
                value=0,
            )

            def _on_change(event):
                if event.new > event.old:
                    self.q.put_nowait(event.new)

            slider.param.watch(_on_change, "value")
            self._widget = slider
            display(pn.Row(slider, f"{len(self.df)} rows in csv"))
        except Exception:
            pass  # headless: advance_to()/play_all() drive the stream

    def advance_to(self, position: int) -> None:
        """Stream rows up to (excluding) ``position``."""
        self.q.put_nowait(min(position, len(self.df)))

    def play_all(self) -> None:
        self.advance_to(len(self.df))

    def run(self) -> None:
        import time as _time

        last_streamed_idx = -1
        while True:
            new_pos = self.q.get()
            for i in range(last_streamed_idx + 1, new_pos):
                self.next(**self.df.iloc[i].to_dict())
            self.commit()
            last_streamed_idx = max(last_streamed_idx, new_pos - 1)
            if new_pos >= len(self.df):
                break
            _time.sleep(0.05)
        self.close()

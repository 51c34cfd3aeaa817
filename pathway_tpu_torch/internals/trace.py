"""User-frame error re-tracing.

Parity target: ``python/pathway/internals/trace.py:92-140``
— when a public API call or a run-time engine step fails, the exception
gains a note pointing at the USER'S file:line (the last stack frame
outside the framework), instead of leaving them to dig through framework
frames.

Two hooks:

* :func:`trace_user_frame` decorates public Table/expression entry points
  (build-time errors: bad column names, type mismatches);
* :meth:`Trace.from_traceback` is captured when a Table recipe is created
  and replayed by the runner when an operator lowered from that table
  fails mid-run (run-time errors fire far from the user's code).
"""

from __future__ import annotations

import functools
import traceback
from dataclasses import dataclass
from typing import Any, Callable, TypeVar

import os as _os

# everything under the installed package is framework code — excluding by
# package root (not an enumerated subpackage list) means a frame inside
# e.g. pathway_tpu/demo or pathway_tpu/ops can never masquerade as user
# code when a new subpackage is added
_PKG_ROOT = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))) + _os.sep


@dataclass(frozen=True)
class Frame:
    filename: str
    line_number: int | None
    line: str | None
    function: str

    def is_external(self) -> bool:
        if "/tests/test_" in self.filename:
            return True
        return not self.filename.startswith(_PKG_ROOT) and "@beartype" not in self.filename

    def is_marker(self) -> bool:
        return self.function == "_pathway_trace_marker"


@dataclass(frozen=True)
class Trace:
    frames: list[Frame]
    user_frame: Frame | None

    @staticmethod
    def from_traceback() -> "Trace":
        frames = [
            Frame(
                filename=e.filename,
                line_number=e.lineno,
                line=e.line,
                function=e.name,
            )
            for e in traceback.extract_stack()[:-1]
        ]
        user_frame: Frame | None = None
        for frame in frames:
            if frame.is_marker():
                break
            if frame.is_external():
                user_frame = frame
        return Trace(frames=frames, user_frame=user_frame)


def user_frame_from_stack() -> Frame | None:
    """The innermost user frame of the CURRENT stack.

    Called on every Table construction, so it must be cheap: a raw
    ``sys._getframe`` walk that stops at the first external frame and
    reads exactly one source line — not ``traceback.extract_stack``,
    which builds FrameSummaries (with source reads) for the whole stack.
    """
    import linecache
    import sys

    f = sys._getframe(1)
    while f is not None:
        filename = f.f_code.co_filename
        if Frame(filename, None, None, f.f_code.co_name).is_external():
            line = linecache.getline(filename, f.f_lineno).strip()
            return Frame(filename, f.f_lineno, line or None, f.f_code.co_name)
        f = f.f_back
    return None


def _format_frame(frame: Frame) -> str:
    return (
        "Occurred here:\n"
        f"    Line: {frame.line}\n"
        f"    File: {frame.filename}:{frame.line_number}"
    )


def add_trace_note(e: BaseException, frame: Frame) -> None:
    if getattr(e, "_pathway_trace_note", None) is not None:
        return  # first (innermost) note wins, like the reference
    note = _format_frame(frame)
    e._pathway_trace_note = note  # type: ignore[attr-defined]
    if hasattr(e, "add_note"):  # BaseException.add_note is 3.11+
        e.add_note(note)
    else:  # 3.10: emulate PEP 678 so tooling reading __notes__ still works
        notes = getattr(e, "__notes__", None)
        if notes is None:
            notes = []
            e.__notes__ = notes  # type: ignore[attr-defined]
        notes.append(note)


def _reraise_with_user_frame(e: Exception) -> None:
    tb = e.__traceback__
    if tb is not None:
        tb = tb.tb_next  # drop the marker wrapper frame
    e = e.with_traceback(tb)
    if getattr(e, "_pathway_trace_note", None) is not None:
        raise e
    user_frame = Trace.from_traceback().user_frame
    if user_frame is not None:
        add_trace_note(e, user_frame)
    raise e


F = TypeVar("F", bound=Callable[..., Any])


def trace_user_frame(func: F) -> F:
    """Decorate a public entry point: exceptions gain the user's
    file:line as an exception note (reference trace.py:123-131)."""

    @functools.wraps(func)
    def _pathway_trace_marker(*args, **kwargs):
        try:
            return func(*args, **kwargs)
        except Exception as e:
            _reraise_with_user_frame(e)

    return _pathway_trace_marker  # type: ignore[return-value]

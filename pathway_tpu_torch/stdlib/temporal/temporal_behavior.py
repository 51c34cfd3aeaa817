"""Temporal behaviors (parity: stdlib/temporal/temporal_behavior.py:29-83).

Behaviors are lowered onto the engine's buffer/forget/freeze operators
(``time_column.rs`` analogs in engine/dataflow.py).
"""

from __future__ import annotations

import dataclasses
from typing import Any


class Behavior:
    pass


@dataclasses.dataclass
class CommonBehavior(Behavior):
    """delay: hold results until watermark passes start+delay;
    cutoff: ignore data later than end+cutoff; keep_results: retain closed
    windows."""

    delay: Any = None
    cutoff: Any = None
    keep_results: bool = True


def common_behavior(delay=None, cutoff=None, keep_results: bool = True) -> CommonBehavior:
    return CommonBehavior(delay, cutoff, keep_results)


@dataclasses.dataclass
class ExactlyOnceBehavior(Behavior):
    shift: Any = None


def exactly_once_behavior(shift=None) -> ExactlyOnceBehavior:
    return ExactlyOnceBehavior(shift)

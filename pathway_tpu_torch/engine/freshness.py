"""Metric-label hygiene of the freshness layer.

The part of ``pathway_tpu/engine/freshness.py`` that the REST ingress
reads: :func:`safe_label`, which turns a route into a metric label value.
``FreshnessTracker`` and its rendering come with the observability slice
(H5).
"""

from __future__ import annotations

import re
from typing import Any

__all__ = ["safe_label"]

_LABEL_UNSAFE = re.compile(r"[{}=,\n]")


def safe_label(value: Any) -> str:
    """User-supplied names become metric label VALUES in the
    ``name{k=v,...}`` collector key format — strip the characters that
    would corrupt its parsing."""
    return _LABEL_UNSAFE.sub("_", str(value))

"""Run-level trace identity.

The part of ``pathway_tpu/engine/telemetry.py`` that the multi-worker
runner and ``spawn`` read: :func:`mint_traceparent`.  The OTLP exporter,
the run and epoch spans and the process metrics come with slice H5.
"""

from __future__ import annotations

import secrets


def mint_traceparent() -> str:
    """A fresh W3C ``traceparent`` header value (sampled flag set).

    One per run: ``cli spawn`` mints it into the cluster environment and
    worker 0 broadcasts it over the mesh to any worker that missed it
    (``internals/runner.py``), so every worker of the run carries one trace
    id."""
    return f"00-{secrets.token_hex(16)}-{secrets.token_hex(8)}-01"

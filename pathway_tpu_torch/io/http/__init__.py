"""HTTP connectors (parity: python/pathway/io/http/_server.py:329-624).

A copy of ``pathway_tpu/io/http``: ``PathwayWebserver`` + ``rest_connector``
turn HTTP requests into rows of a streaming table and answer each from
the result row for its request id, on a standard-library server; ``read``
and ``write`` stream a table from and to an HTTP endpoint over urllib.
"""

from pathway_tpu_torch.io.http._client import RetryPolicy, read, write
from pathway_tpu_torch.io.http._server import (
    EndpointDocumentation,
    EndpointExamples,
    PathwayWebserver,
    rest_connector,
)

__all__ = [
    "PathwayWebserver",
    "rest_connector",
    "EndpointDocumentation",
    "EndpointExamples",
    "RetryPolicy",
    "read",
    "write",
]

"""``pw.io`` — connectors (parity: python/pathway/io/__init__.py:3-31).

The port's namespace: ``fs``, ``csv``, ``jsonlines``, ``plaintext``,
``python``, ``http``, ``null`` and ``subscribe``, the message streams
(``kafka``, ``redpanda``, ``debezium``, ``nats``, ``pubsub``) and the
object stores (``s3``, ``minio``, ``s3_csv``, ``gdrive``, ``bigquery``)
work, copied from the JAX package.  Every other connector of
``pathway_tpu/io`` (the sinks and the data lakes) is a stand-in here that
raises ``NotImplementedError`` on use, naming slice H6b, which brings it.
"""

from __future__ import annotations

import types

from pathway_tpu_torch.io import (
    bigquery,
    csv,
    debezium,
    fs,
    gdrive,
    http,
    jsonlines,
    kafka,
    minio,
    nats,
    null,
    plaintext,
    pubsub,
    python,
    redpanda,
    s3,
    s3_csv,
)
from pathway_tpu_torch.io._subscribe import (
    OnChangeCallback,
    OnFinishCallback,
    OnTimeEndCallback,
    subscribe,
)
from pathway_tpu_torch.io._utils import register_output
from pathway_tpu_torch.io.csv import CsvParserSettings


class _LaterSlice(types.ModuleType):
    """A module of the JAX package that the port brings later: any
    attribute raises ``NotImplementedError`` naming the slice."""

    def __init__(self, qualname: str, later: str):
        super().__init__(qualname)
        self._later = later

    def __getattr__(self, attr: str):
        if attr.startswith("__"):
            raise AttributeError(attr)
        raise NotImplementedError(
            f"{self.__name__}.{attr} needs a module that the port brings in "
            f"{self._later}"
        )


airbyte = _LaterSlice("pw.io.airbyte", "slice H6b")
deltalake = _LaterSlice("pw.io.deltalake", "slice H6b")
elasticsearch = _LaterSlice("pw.io.elasticsearch", "slice H6b")
iceberg = _LaterSlice("pw.io.iceberg", "slice H6b")
logstash = _LaterSlice("pw.io.logstash", "slice H6b")
mongodb = _LaterSlice("pw.io.mongodb", "slice H6b")
postgres = _LaterSlice("pw.io.postgres", "slice H6b")
pyfilesystem = _LaterSlice("pw.io.pyfilesystem", "slice H6b")
slack = _LaterSlice("pw.io.slack", "slice H6b")
sqlite = _LaterSlice("pw.io.sqlite", "slice H6b")

__all__ = [
    "airbyte",
    "bigquery",
    "csv",
    "CsvParserSettings",
    "debezium",
    "deltalake",
    "elasticsearch",
    "fs",
    "gdrive",
    "http",
    "iceberg",
    "jsonlines",
    "kafka",
    "logstash",
    "minio",
    "mongodb",
    "nats",
    "null",
    "OnChangeCallback",
    "OnFinishCallback",
    "OnTimeEndCallback",
    "plaintext",
    "postgres",
    "pubsub",
    "pyfilesystem",
    "python",
    "redpanda",
    "s3",
    "s3_csv",
    "slack",
    "sqlite",
    "subscribe",
    "register_output",
]

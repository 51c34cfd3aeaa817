"""``pw.io`` — connectors (parity: python/pathway/io/__init__.py:3-31).

The port's namespace: ``fs``, ``csv``, ``jsonlines``, ``plaintext``,
``python``, ``http``, ``null`` and ``subscribe`` work, copied from the JAX
package.  Every other connector of ``pathway_tpu/io`` is a stand-in here
that raises ``NotImplementedError`` on use, naming slice H6, which brings
it.
"""

from __future__ import annotations

import types

from pathway_tpu_torch.io import csv, fs, http, jsonlines, null, plaintext, python
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


airbyte = _LaterSlice("pw.io.airbyte", "slice H6")
bigquery = _LaterSlice("pw.io.bigquery", "slice H6")
debezium = _LaterSlice("pw.io.debezium", "slice H6")
deltalake = _LaterSlice("pw.io.deltalake", "slice H6")
elasticsearch = _LaterSlice("pw.io.elasticsearch", "slice H6")
gdrive = _LaterSlice("pw.io.gdrive", "slice H6")
iceberg = _LaterSlice("pw.io.iceberg", "slice H6")
kafka = _LaterSlice("pw.io.kafka", "slice H6")
logstash = _LaterSlice("pw.io.logstash", "slice H6")
minio = _LaterSlice("pw.io.minio", "slice H6")
mongodb = _LaterSlice("pw.io.mongodb", "slice H6")
nats = _LaterSlice("pw.io.nats", "slice H6")
postgres = _LaterSlice("pw.io.postgres", "slice H6")
pubsub = _LaterSlice("pw.io.pubsub", "slice H6")
pyfilesystem = _LaterSlice("pw.io.pyfilesystem", "slice H6")
redpanda = _LaterSlice("pw.io.redpanda", "slice H6")
s3 = _LaterSlice("pw.io.s3", "slice H6")
s3_csv = _LaterSlice("pw.io.s3_csv", "slice H6")
slack = _LaterSlice("pw.io.slack", "slice H6")
sqlite = _LaterSlice("pw.io.sqlite", "slice H6")

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

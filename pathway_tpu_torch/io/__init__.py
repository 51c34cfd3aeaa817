"""``pw.io`` — connectors (parity: python/pathway/io/__init__.py:3-31).

The port's namespace, every module copied from the JAX package: ``fs``,
``csv``, ``jsonlines``, ``plaintext``, ``python``, ``http``, ``null`` and
``subscribe``; the message streams (``kafka``, ``redpanda``, ``debezium``,
``nats``, ``pubsub``); the object stores (``s3``, ``minio``, ``s3_csv``,
``gdrive``, ``bigquery``); the sinks (``postgres``, ``mongodb``,
``elasticsearch``, ``logstash``, ``slack``); and the tables and sources
(``sqlite``, ``deltalake``, ``iceberg``, ``airbyte``, ``pyfilesystem``).
"""

from __future__ import annotations

from pathway_tpu_torch.io import (
    airbyte,
    bigquery,
    csv,
    debezium,
    deltalake,
    elasticsearch,
    fs,
    gdrive,
    http,
    iceberg,
    jsonlines,
    kafka,
    logstash,
    minio,
    mongodb,
    nats,
    null,
    plaintext,
    postgres,
    pubsub,
    pyfilesystem,
    python,
    redpanda,
    s3,
    s3_csv,
    slack,
    sqlite,
)
from pathway_tpu_torch.io._subscribe import (
    OnChangeCallback,
    OnFinishCallback,
    OnTimeEndCallback,
    subscribe,
)
from pathway_tpu_torch.io._utils import register_output
from pathway_tpu_torch.io.csv import CsvParserSettings

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

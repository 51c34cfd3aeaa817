"""Redpanda connector (parity: python/pathway/io/redpanda).

Redpanda speaks the Kafka protocol, so this is ``pw.io.kafka`` under a
different name — exactly how the reference implements it
(python/pathway/io/redpanda re-exports the kafka connector).
"""

from pathway_tpu_torch.io.kafka import read, write

__all__ = ["read", "write"]

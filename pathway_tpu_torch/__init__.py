"""pathway_tpu_torch — the PyTorch/CUDA port of ``pathway_tpu``.

The streaming embed-and-retrieve path: text → sentence encoder (with a
hand-written CUDA encoder-attention kernel) → L2-normalised vectors → a
device-resident brute-force index → masked top-k.  Reranking: the
``CrossEncoder`` scores (query, document) pairs over the same trunk and
kernel; both encoders serve W8A8 on request.  Decoder generation:
``DecoderLM`` (dense KV cache; dense or Mixtral MoE layers, bf16 or
weight-only int8, plain or self-speculative greedy decoding) and the
continuous-batching ``GenerationScheduler`` over a paged KV cache; a
LoRA-adapted tree (``models/lora.py``'s ``lora_decoder_tree``) serves
through both unchanged.  Multimodal embedding: ``MultimodalEncoder`` (a
SigLIP ViT image tower and a projected text tower in one space, with
SigLIP's pairwise logits).  Every device call of the encoders and the
index goes through the device's shared ``DeviceExecutor``
(``device.get_default_executor``: bucketing, async ``submit``, the
typed failure rail, cost accounting), with ``utils.batching``'s
``AsyncMicroBatcher`` as the coalescing front end.  Entry points run on
the first CUDA device unless the caller passes ``device=`` (``"cpu"``
runs the kernels' plain PyTorch versions).  The port imports nothing of
JAX or of ``pathway_tpu``.

The Table API around them mirrors ``import pathway as pw`` as the JAX
package does: ``Table``, ``Schema``, ``this``/``left``/``right``,
expressions, ``reducers``, ``groupby``, the joins, ``iterate``, ``udf``
with its executors and caches, ``run`` and ``debug``, over the incremental
dataflow of ``engine/dataflow.py`` and its native C++ core (``native/``).
A UDF that calls an encoder (through ``AsyncMicroBatcher``) runs the
encoder's kernels inside the dataflow.  ``pw.io`` holds the connectors
(files, ``python``, ``subscribe``, the message streams, the object
stores, and the sinks and lakes: Postgres, SQLite, MongoDB,
Elasticsearch, Logstash, Slack, Delta, Iceberg, Airbyte, pyfilesystem),
``pw.indexing`` the Table-API indexes (``DataIndex`` over
``BruteForceKnn`` on the device, or the host's HNSW, BM25 and their
reciprocal-rank fusion), ``pw.ml``, ``pw.stateful``, ``pw.statistical``,
``pw.ordered`` and ``pw.utils`` the small modules of the standard library,
``pw.temporal`` the event-time windows, behaviors and time joins,
``pw.graphs`` the graph algorithms over ``iterate``, ``pw.viz`` the
notebook widgets, ``pw.demo`` the synthetic streams, and ``xpacks.llm``
the LLM xpack (``VectorStoreServer``, ``DocumentStore``,
rerankers and the question answerers).  ``pw.sql``
compiles SQL onto the joins, filters and groupbys, ``pw.transformer``
runs class-based row transformers over ``Pointer``s, ``pw.load_yaml``
builds an app from YAML, ``export_table``/``import_table`` hand a table
from one graph to another, ``Table.live()`` runs a table's cone on a
background thread, and ``python -m pathway_tpu_torch lint`` (``analysis/``)
checks the package's own threading, lock and registry invariants.
"""

from __future__ import annotations

__version__ = "0.1.0"

import enum as _enum
import datetime as _datetime

from pathway_tpu_torch.engine.types import (
    ERROR,
    Json,
    Pointer,
    PyObjectWrapper,
    wrap_py_object,
)
from pathway_tpu_torch.internals import dtype as _dt
from pathway_tpu_torch.internals import reducers
from pathway_tpu_torch.internals.config import (
    local_pathway_config,
    set_license_key,
    set_monitoring_config,
)
from pathway_tpu_torch.internals.expression import (
    ColumnExpression,
    ColumnReference,
    apply,
    apply_async,
    apply_with_type,
    assert_table_has_schema,
    cast,
    coalesce,
    declare_type,
    fill_error,
    if_else,
    make_tuple,
    require,
    unwrap,
)
from pathway_tpu_torch.internals.reducers import BaseCustomAccumulator
from pathway_tpu_torch.internals.schema import (
    ColumnDefinition,
    Schema,
    SchemaProperties,
    column_definition,
    schema_builder,
    schema_from_csv,
    schema_from_dict,
    schema_from_types,
)
from pathway_tpu_torch.internals.table import (
    GroupedJoinResult,
    GroupedTable,
    Joinable,
    JoinMode,
    JoinResult,
    OuterJoinResult,
    Table,
    TableLike,
    TableSlice,
    groupby,
    join,
    join_inner,
    join_left,
    join_outer,
    join_right,
)
from pathway_tpu_torch.internals.thisclass import left, right, this
from pathway_tpu_torch.internals.runner import run, run_all
from pathway_tpu_torch.internals.parse_graph import G
from pathway_tpu_torch.internals import udfs as _udfs_internal
from pathway_tpu_torch.internals.udfs import UDF, udf
from pathway_tpu_torch.internals.monitoring import MonitoringLevel


class PersistenceMode(_enum.Enum):
    # mirrors engine PersistenceMode (src/connectors/mod.rs:108-116)
    BATCH = 0
    SPEEDRUN_REPLAY = 1
    REALTIME_REPLAY = 2
    PERSISTING = 3
    SELECTIVE_PERSISTING = 4
    OPERATOR_PERSISTING = 5
    UDF_CACHING = 6


from pathway_tpu_torch.internals.iterate import iterate, iterate_universe
from pathway_tpu_torch.internals import universes
from pathway_tpu_torch.internals.errors import global_error_log, local_error_log

# datetime convenience types (pw.DateTimeNaive etc.); defined before the
# subpackages, whose time_utils reads pw.DateTimeUtc while this package loads
DateTimeNaive = _datetime.datetime
DateTimeUtc = _datetime.datetime
Duration = _datetime.timedelta

from pathway_tpu_torch import debug, demo, io, persistence, udfs
from pathway_tpu_torch.stdlib import (
    graphs,
    indexing,
    ml,
    ordered,
    stateful,
    statistical,
    temporal,
    utils,
    viz,
)
from pathway_tpu_torch.stdlib.temporal import (
    AsofJoinResult,
    IntervalJoinResult,
    WindowJoinResult,
    windowby,
)
from pathway_tpu_torch.stdlib.temporal import _window as window
from pathway_tpu_torch.stdlib.utils.async_transformer import AsyncTransformer
from pathway_tpu_torch.stdlib.utils.pandas_transformer import pandas_transformer
from pathway_tpu_torch.internals.interactive import LiveTable, enable_interactive_mode
# `asynchronous` was the pre-rename home of the async UDF helpers (now `udfs`)
from pathway_tpu_torch import udfs as asynchronous
from pathway_tpu_torch.internals.export_import import (
    ExportedTable,
    export_table,
    import_table,
)
from pathway_tpu_torch.internals.sql import sql
from pathway_tpu_torch.internals.yaml_loader import load_yaml
from pathway_tpu_torch.internals.row_transformer import (
    ClassArg,
    attribute,
    input_attribute,
    input_method,
    method,
    output_attribute,
    transformer,
)
from pathway_tpu_torch.internals.table_io import table_transformer


class Type:
    """Engine type enum facade (pw.Type.INT etc., api.py PathwayType)."""

    ANY = _dt.ANY
    STRING = _dt.STR
    INT = _dt.INT
    BOOL = _dt.BOOL
    FLOAT = _dt.FLOAT
    POINTER = _dt.POINTER
    DATE_TIME_NAIVE = _dt.DATE_TIME_NAIVE
    DATE_TIME_UTC = _dt.DATE_TIME_UTC
    DURATION = _dt.DURATION
    ARRAY = _dt.ANY_ARRAY
    JSON = _dt.JSON
    BYTES = _dt.BYTES
    PY_OBJECT_WRAPPER = _dt.PY_OBJECT_WRAPPER


# the stdlib-defined Table methods, attached as the JAX package attaches
# them, keeping table.py free of temporal imports
for _name in (
    "windowby", "asof_join", "asof_join_left", "asof_join_right", "asof_join_outer",
    "asof_now_join", "interval_join", "interval_join_left", "interval_join_right",
    "interval_join_outer", "window_join",
):
    setattr(Table, _name, getattr(temporal, _name))
Table.interpolate = lambda self, *args, **kwargs: statistical.interpolate(self, *args, **kwargs)


def unwrap_err(x):  # small helper used in some pathway examples
    return unwrap(x)


from pathway_tpu_torch.device import resolve_device
from pathway_tpu_torch.models.decoder import DecoderLM
from pathway_tpu_torch.models.encoder import CrossEncoder, SentenceEncoder
from pathway_tpu_torch.models.vision import MultimodalEncoder
from pathway_tpu_torch.serving.generation import GenerationScheduler
from pathway_tpu_torch.stdlib.indexing.nearest_neighbors import (
    BruteForceKnnIndex,
    DistanceMetric,
)

__all__ = [
    "__version__",
    "ERROR",
    "BaseCustomAccumulator",
    "ColumnDefinition",
    "ColumnExpression",
    "ColumnReference",
    "DateTimeNaive",
    "DateTimeUtc",
    "Duration",
    "G",
    "GroupedJoinResult",
    "GroupedTable",
    "JoinMode",
    "JoinResult",
    "Joinable",
    "Json",
    "MonitoringLevel",
    "OuterJoinResult",
    "PersistenceMode",
    "Pointer",
    "PyObjectWrapper",
    "Schema",
    "SchemaProperties",
    "Table",
    "TableLike",
    "TableSlice",
    "Type",
    "UDF",
    "AsyncTransformer",
    "ClassArg",
    "ExportedTable",
    "LiveTable",
    "asynchronous",
    "attribute",
    "enable_interactive_mode",
    "export_table",
    "import_table",
    "input_attribute",
    "input_method",
    "load_yaml",
    "method",
    "output_attribute",
    "sql",
    "table_transformer",
    "transformer",
    "AsofJoinResult",
    "IntervalJoinResult",
    "WindowJoinResult",
    "apply",
    "apply_async",
    "apply_with_type",
    "assert_table_has_schema",
    "cast",
    "coalesce",
    "column_definition",
    "debug",
    "declare_type",
    "demo",
    "fill_error",
    "global_error_log",
    "groupby",
    "if_else",
    "graphs",
    "indexing",
    "io",
    "iterate",
    "iterate_universe",
    "join",
    "join_inner",
    "join_left",
    "join_outer",
    "join_right",
    "left",
    "local_error_log",
    "local_pathway_config",
    "make_tuple",
    "ml",
    "ordered",
    "pandas_transformer",
    "persistence",
    "reducers",
    "require",
    "right",
    "run",
    "run_all",
    "schema_builder",
    "set_license_key",
    "set_monitoring_config",
    "schema_from_csv",
    "schema_from_dict",
    "schema_from_types",
    "stateful",
    "statistical",
    "temporal",
    "this",
    "udf",
    "udfs",
    "universes",
    "unwrap",
    "utils",
    "viz",
    "window",
    "windowby",
    "wrap_py_object",
    "BruteForceKnnIndex",
    "CrossEncoder",
    "DecoderLM",
    "DistanceMetric",
    "GenerationScheduler",
    "MultimodalEncoder",
    "SentenceEncoder",
    "resolve_device",
]

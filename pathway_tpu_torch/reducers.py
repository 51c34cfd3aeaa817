"""``import pathway_tpu_torch.reducers`` — module-path parity with the
reference's ``pathway/reducers.py`` (the same objects are also reachable
as ``pw.reducers``)."""

from pathway_tpu_torch.internals.reducers import *  # noqa: F401,F403
from pathway_tpu_torch.internals.reducers import (  # noqa: F401
    any,
    avg,
    count,
    earliest,
    latest,
    max,
    min,
    ndarray,
    sorted_tuple,
    stateful_many,
    stateful_single,
    sum,
    tuple,
    udf_reducer,
    unique,
)

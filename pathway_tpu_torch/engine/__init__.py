"""Host engine pieces of the PyTorch port: the dataflow, its value model and
codec, the serving edge's errors and deadlines, and device-side
instrumentation."""

from pathway_tpu_torch.engine import dataflow, types
from pathway_tpu_torch.engine.types import (
    ERROR,
    Error,
    Json,
    Pointer,
    PyObjectWrapper,
    wrap_py_object,
)

__all__ = [
    "dataflow",
    "types",
    "ERROR",
    "Error",
    "Json",
    "Pointer",
    "PyObjectWrapper",
    "wrap_py_object",
]

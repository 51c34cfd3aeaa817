"""Host engine pieces of the PyTorch port: the dataflow, its value model and
codec, the serving edge's errors and deadlines, and device-side
instrumentation."""

"""The benchmark of ``pathway_tpu_torch`` on one NVIDIA H100.

``run.py`` runs one cell of ``BENCHMARK.json`` once and prints its result
line; ``controls.py`` reads a cell's lower-precision control.  Everything a
cell needs is found by name: ``configs/<config>.json``,
``traffic/<traffic>.json`` (read by ``generators/<generator>.py``) and one
reader ``metrics/<metric>.py`` per metric.  ``reference/`` is the plain
PyTorch reference that decides ``correct``; it imports nothing of the
program.
"""

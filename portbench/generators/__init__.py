"""The general traffic generators.  A traffic file names one
(``"generator"``) and gives it its parameters; each module has
``run(cell) -> dict`` that builds the cell's system, warms it up, drives
the measured window and returns what the window saw and a check."""

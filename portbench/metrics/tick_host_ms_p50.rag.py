"""Median host milliseconds of the generation scheduler's ticks in the
window."""

import statistics


def read(obs):
    ticks = obs["probe"].of("tick", obs["window"])
    return 1e3 * statistics.median(dt for _t, dt in ticks) if ticks else None

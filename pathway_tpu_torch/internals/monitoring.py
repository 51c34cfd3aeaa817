"""``pw.MonitoringLevel``: what the console dashboard shows.

The enum of ``pathway_tpu/internals/monitoring.py`` (reference
``monitoring.py:228``).  The dashboard itself (``StatsMonitor``,
``monitor_stats``, the tty resolution of ``AUTO``) arrives with the
observability slice (H5); until then ``pw.run`` accepts ``NONE`` and
``AUTO`` and shows no dashboard, and refuses the others.
"""

from __future__ import annotations

import enum


class MonitoringLevel(enum.Enum):
    """What the console dashboard shows (reference ``monitoring.py:228``)."""

    AUTO = 0  # IN_OUT when stderr is a tty, NONE otherwise
    AUTO_ALL = 1  # ALL when stderr is a tty, NONE otherwise
    NONE = 2
    IN_OUT = 3  # inputs + outputs only
    ALL = 4  # every operator

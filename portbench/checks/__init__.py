"""The comparisons that decide ``correct``: what the timed path produced,
against ``portbench/reference``, each number against its limit from
``limits/<workload>.json``."""

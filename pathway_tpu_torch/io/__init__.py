"""Connectors of the port: the static input of ``pw.debug`` so far (slice H2 brings the rest)."""

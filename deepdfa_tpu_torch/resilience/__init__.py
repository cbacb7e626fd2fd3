"""Fault tolerance for the port's host pipelines: the run journal and
atomic small-file writes, capped-backoff retry, the extraction supervisor
(session restart, poison-item quarantine) and the named fault points the
port fires (``joern.die``, ``joern.hang``)."""

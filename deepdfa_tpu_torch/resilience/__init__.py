"""Fault tolerance for the port's trainer and host pipelines: the run
journal and atomic small-file writes, capped-backoff retry, the extraction
supervisor (session restart, poison-item quarantine), the named fault
points (``resilience.faults``), the divergence sentinel
(``resilience.sentinel``), preemption handling (``resilience.preemption``)
and the step watchdog (``resilience.watchdog``)."""

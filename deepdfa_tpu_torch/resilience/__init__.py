"""Crash-safe run records: the run journal and atomic small-file writes."""

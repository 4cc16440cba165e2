"""Utilities: the port's spans, counters and trace helpers."""

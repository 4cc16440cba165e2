"""Utilities: profiling counters and trace helpers."""

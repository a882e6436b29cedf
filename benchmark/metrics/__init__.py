"""Per-layer metric readers, one module a metric (``<metric>.py``), and the count arithmetic they share.

A reader's ``read(obs)`` takes what the entry's traced calls recorded and
returns the metric, or None where it finds nothing to read.
"""

"""Fault-tolerance bookkeeping of the port (``failures``)."""

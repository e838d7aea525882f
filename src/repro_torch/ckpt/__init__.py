"""Step-atomic checkpoints of the port (``checkpoint``)."""

"""Command-line entry points of the port's LM path."""

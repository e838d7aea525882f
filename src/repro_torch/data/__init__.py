"""The deterministic data pipeline of the port."""

"""Data parallelism of the port over the visible devices
(``sharding.py``)."""

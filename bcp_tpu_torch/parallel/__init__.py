"""Data parallelism over several ranks (``parallel.mesh``)."""

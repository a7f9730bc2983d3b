"""Data parallelism and spatial partitioning over several ranks
(``parallel.mesh``)."""

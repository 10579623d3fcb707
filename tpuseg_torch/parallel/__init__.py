"""Parallel execution over a ``core/mesh.py`` mesh: spatial (z-sharded)
partitioning, pipeline stages and tensor (output-channel) sharding."""

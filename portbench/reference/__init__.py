"""Plain references of the benchmark's configurations.

Each module solves single-source shortest paths by Bellman-Ford in
plain PyTorch on the instance the benchmark made (its COO, or for a
game map its occupancy grid), with no Δ, no buckets and no kernel.
``tree`` recovers the predecessor tree the configuration states and
checks paths. Nothing here imports JAX, the JAX package or the port.
"""

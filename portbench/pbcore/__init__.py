"""The port's benchmark harness: what every cell shares.

``spec`` finds a cell's configuration, traffic mix, generator, reference
and metric readers by the names in ``BENCHMARK.json``; ``traffic`` is the
one generator of queries that every mix's data file parameterises;
``trace`` reduces a profiler trace to busy time, idle gaps and records;
``runner`` drives one run of one cell. Nothing here imports JAX or the
JAX package.
"""

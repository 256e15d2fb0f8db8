"""PyTorch + CUDA port of the Δ-stepping SSSP engine (``repro``).

The layout mirrors ``src/repro/``: ``graphs/``, ``core/``,
``kernels/<name>/{<name>.py, ops.py, ref.py}``, ``api/``, ``launch/``.
The hand-written Hopper kernels live in ``csrc/`` and are built with
``nvcc`` at their first launch. The package imports ``torch`` and
``numpy``, never ``jax`` and nothing of ``repro``.
"""

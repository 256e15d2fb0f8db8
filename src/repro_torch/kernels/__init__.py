"""Hand-written Hopper kernels of the port, one folder each:
``<name>.py`` launches the CUDA kernel from ``csrc/``, ``ref.py`` is its
plain PyTorch twin, ``ops.py`` dispatches on the tensor's device."""

"""Gradient compression of the PyTorch port
(``repro_torch.distributed.compression``). ``plan_remesh``, ``remesh``
and ``make_mesh_from`` (the reference's ``distributed/elastic.py``)
come with the mesh slice of the port (ROADMAP Queue 1)."""
from repro_torch.distributed.compression import (
    compress_grads,
    dequantize_int8,
    quantize_int8,
    topk_sparsify,
)

__all__ = ["compress_grads", "quantize_int8", "dequantize_int8",
           "topk_sparsify"]

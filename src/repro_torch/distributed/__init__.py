"""Gradient compression and elastic re-meshing of the PyTorch port
(``repro_torch.distributed.compression``, ``.elastic``)."""
from repro_torch.distributed.compression import (
    compress_grads,
    dequantize_int8,
    quantize_int8,
    topk_sparsify,
)
from repro_torch.distributed.elastic import make_mesh_from, plan_remesh, remesh

__all__ = ["compress_grads", "quantize_int8", "dequantize_int8",
           "topk_sparsify", "plan_remesh", "remesh", "make_mesh_from"]

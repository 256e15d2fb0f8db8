"""Serving layer of the PyTorch port: the async SSSP serving tier
(``Server`` — continuous batching, multi-graph tenancy, admission
control; DESIGN.md §13), the LM-decode continuous batcher
(``BatchServer``, with ``generate``), and the deprecated synchronous
``SSSPServer`` shim kept for legacy call sites.

    from repro_torch.serve import Server
    from repro_torch.api import SingleSource, PointToPoint

    with Server({"road": g1, "social": g2}, tuning="auto") as srv:
        t1 = srv.submit(SingleSource(0), graph="road")
        t2 = srv.submit(PointToPoint(3, 99), graph="social", deadline=0.5)
        print(t1.result().dist, t2.result().distance)
    print(srv.stats())   # p50/p99 latency, occupancy, shed counts

In a process group of more than one rank (``sharded_*`` tenants under
``torchrun``), rank 0 takes the requests and forms every batch; the
other ranks run its batch plan (``repro_torch.serve.server``'s note).
"""
from repro_torch.serve.decode import (
    BatchServer,
    Request,
    SSSPQuery,
    SSSPServer,
    generate,
)
from repro_torch.serve.server import (
    RequestRejected,
    RequestTrace,
    Server,
    Ticket,
    UpdateApplied,
)

__all__ = [
    "BatchServer",
    "Request",
    "RequestRejected",
    "RequestTrace",
    "SSSPQuery",
    "SSSPServer",
    "Server",
    "Ticket",
    "UpdateApplied",
    "generate",
]

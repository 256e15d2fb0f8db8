from repro_torch.kernels.bucket_scan.bucket_scan import bucket_scan_cuda
from repro_torch.kernels.bucket_scan.ops import bucket_scan
from repro_torch.kernels.bucket_scan.ref import bucket_scan_ref

__all__ = ["bucket_scan", "bucket_scan_cuda", "bucket_scan_ref"]

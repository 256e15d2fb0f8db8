"""Dry-run analysis of the PyTorch port (counterpart of
``repro.analysis``): the record of one traced step, its collectives and
roofline terms on the H100, and the report tables."""
from repro_torch.analysis.roofline import (
    H100,
    RooflineReport,
    analyze,
    estimate_model_flops,
    load_reports,
    save_reports,
)
from repro_torch.analysis.trace import collective_stats, count_op

__all__ = ["collective_stats", "count_op", "analyze", "RooflineReport",
           "H100", "estimate_model_flops", "save_reports", "load_reports"]

"""Roofline accounting of one rank's traced step on the H100 (the port's
``repro.roofline``): ``op_cost`` counts, ``analysis`` bounds."""
from .analysis import (HBM_BW, NET_BW, NVLINK_BW, PEAK_FLOPS,
                       PEAK_FLOPS_BY_DTYPE, analyze_cell, analyze_cost,
                       analyze_file, model_flops, suggest)
from .op_cost import Cost, CostCounter, record_kernel

__all__ = ["analyze_cell", "analyze_cost", "analyze_file", "model_flops",
           "suggest", "PEAK_FLOPS", "PEAK_FLOPS_BY_DTYPE", "HBM_BW",
           "NET_BW", "NVLINK_BW", "Cost", "CostCounter", "record_kernel"]

"""Roofline of a step on the H100 (port of the reference's ``roofline/``):
``model_flops`` (6·N·D) for an MFU and the three-term bound of a counted
step (``roofline.analysis``)."""

from repro_torch.roofline.analysis import (
    collective_bytes,
    cost_analysis,
    roofline_terms,
    model_flops,
    param_count,
    RooflineReport,
)

__all__ = ["collective_bytes", "cost_analysis", "roofline_terms",
           "model_flops", "param_count", "RooflineReport"]

"""Roofline accounting (torch port of ``repro.roofline``): the WireReport
summary, which the observability layer's ledger check reads."""
from repro_torch.roofline.analysis import summarize_wire_reports

__all__ = ["summarize_wire_reports"]

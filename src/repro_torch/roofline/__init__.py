"""Roofline accounting (torch port of ``repro.roofline``): the three-term
roofline of a measured step (``analysis``: FLOPs from a flop counter,
collective bytes from a profiler trace, the WireReport summary), the
analytic cost model (``model``) and the markdown report (``report``)."""
from repro_torch.roofline.analysis import (HBM_BW, LINK_BW, MD_HEADER, MD_HEADER_WIRE,
                                           NET_BW, PEAK_FLOPS_BF16, Roofline,
                                           analyze_cell, collective_bytes, markdown_row,
                                           markdown_row_wire, model_flops_for,
                                           summarize_wire_reports, wire_report_seconds)
from repro_torch.roofline.model import AnalyticCost, analytic_cost, analyze_cell_v2

__all__ = ["HBM_BW", "LINK_BW", "MD_HEADER", "MD_HEADER_WIRE", "NET_BW",
           "PEAK_FLOPS_BF16", "AnalyticCost", "Roofline", "analytic_cost",
           "analyze_cell", "analyze_cell_v2", "collective_bytes", "markdown_row",
           "markdown_row_wire", "model_flops_for", "summarize_wire_reports",
           "wire_report_seconds"]

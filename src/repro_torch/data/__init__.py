"""Data pipeline (torch port of ``repro.data``)."""

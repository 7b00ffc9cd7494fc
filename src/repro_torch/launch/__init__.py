"""Drivers (torch port of ``repro.launch``)."""

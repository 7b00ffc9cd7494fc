"""Training step (torch port of ``repro.train``)."""

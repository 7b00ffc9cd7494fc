"""Serving: KV-cache transfer and the continuous-batching engine (torch port
of ``repro.serve``)."""

"""Optimizers and the ZeRO-1 step (torch port of ``repro.optim``)."""

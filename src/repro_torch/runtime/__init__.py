"""Fault injection for the weight-sync fleet (torch port of
``repro.runtime.faults``): a seeded :class:`~repro_torch.runtime.faults.FaultPlan`,
the :class:`~repro_torch.runtime.faults.FaultyWire` that applies it, and the
corruption model :func:`~repro_torch.runtime.faults.corrupt_payload`."""
from repro_torch.runtime.faults import (FAULT_KINDS, MESSAGE_FAULTS, FaultConfig,
                                        FaultEvent, FaultPlan, FaultyWire,
                                        corrupt_payload)

__all__ = ["FAULT_KINDS", "MESSAGE_FAULTS", "FaultConfig", "FaultEvent", "FaultPlan",
           "FaultyWire", "corrupt_payload"]

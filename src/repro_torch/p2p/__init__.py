"""Host-orchestrated P2P engine (torch port of ``repro.p2p``)."""

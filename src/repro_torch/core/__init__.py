"""Wire codec, policy and compressed collectives (torch port of ``repro.core``)."""

"""Weight sync (paper §5.3.1: RL weight synchronization), torch port of
``repro.sync``, host path: a trainer publishes versioned weights
(``train/step.make_publish_hook``), :class:`WeightSyncEngine` encodes each
replica's update as an XOR delta against the version it acked or as the full
compressed tensors, on a kind-"wsync" ``CommPlan`` compiled once, and a
replica reconstructs the published bits (:func:`apply_update`,
``serve/engine.ServeEngine.ingest_weights``).  Every update carries a CRC-32
of its payload (:func:`update_checksum`, :func:`verify_update`).  The in-mesh
wire, :func:`sync_weights`, sends the same buckets along a process group's
``perm``, and :func:`broadcast_weights` along a ``BroadcastSchedule``'s hop
levels (``sync/wire.py``).  :class:`SyncFleet` drives a trainer and N
replicas through publish/distribute/ack rounds under injected faults, with
star, tree and pipeline fan-out and checkpointed trainer failover
(``sync/fleet.py``)."""
from repro_torch.sync.engine import (SyncUpdate, WeightSyncEngine, apply_update,
                                     update_checksum, verify_update)
from repro_torch.sync.fleet import FleetConfig, Replica, RoutedUpdate, SyncFleet
from repro_torch.sync.store import VersionedStore
from repro_torch.sync.wire import broadcast_weights, sync_weights

__all__ = ["FleetConfig", "Replica", "RoutedUpdate", "SyncFleet", "SyncUpdate",
           "VersionedStore", "WeightSyncEngine", "apply_update", "broadcast_weights",
           "sync_weights", "update_checksum", "verify_update"]

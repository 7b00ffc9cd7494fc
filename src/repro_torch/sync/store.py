"""Version bookkeeping of the weight-sync wire (torch port of
``repro.sync.store``).

The XOR-delta wire is lossless only if both ends XOR against the same base
bits, so the protocol says who holds what:

  * the trainer ``publish``es monotonically numbered versions and keeps a
    bounded history (a replica can be sent a delta only against a version
    the trainer still holds);
  * each replica ``ack``s the version it has applied; the sender deltas
    against the acked version, or sends the full tensors when the ack is
    absent (late joiner), stale (version pruned) or fenced (older epoch);
  * ``advance_epoch()`` fences a trainer restart: version numbers may repeat
    with other bits, so every outstanding ack is dropped.
"""
from __future__ import annotations

import collections
from typing import Optional

import numpy as np
import torch

from repro_torch.tree_util import tree_flatten, tree_unflatten


def _own_copy(params):
    """Clone the tensor leaves on their device: the trainer updates its
    weights in place, so the store must own the versions it keeps."""
    leaves, treedef = tree_flatten(params)
    return tree_unflatten(treedef, [
        leaf.detach().clone() if isinstance(leaf, torch.Tensor) else leaf
        for leaf in leaves])


class VersionedStore:
    """Trainer-side version history and per-replica ack table.  Each
    published tree is kept as a copy of its own."""

    def __init__(self, *, history: int = 4) -> None:
        if history < 1:
            raise ValueError(f"history must be >= 1, got {history}")
        self.history = history
        self.epoch = 0
        self._versions: collections.OrderedDict = collections.OrderedDict()
        self._version = 0
        self._acks: dict = {}  # replica -> (epoch, version)

    # -- publishing ----------------------------------------------------------

    def publish(self, params) -> int:
        """Keep ``params`` as the next version; returns its number."""
        self._version += 1
        self._versions[self._version] = _own_copy(params)
        while len(self._versions) > self.history:
            self._versions.popitem(last=False)
        return self._version

    @property
    def version(self) -> int:
        """Latest published version (0 = nothing published yet)."""
        return self._version

    def latest(self) -> tuple:
        """(params, version) of the latest publish."""
        if not self._versions:
            raise ValueError("nothing published yet")
        return self._versions[self._version], self._version

    def get(self, version: int):
        """The kept params of ``version``, or None if pruned or unknown."""
        return self._versions.get(version)

    def retained(self) -> tuple:
        return tuple(self._versions)

    # -- acks and fencing ----------------------------------------------------

    def ack(self, replica, version: int, epoch: Optional[int] = None) -> bool:
        """Record that ``replica`` holds ``version``.  Rejected (False, the
        previous state kept) when fenced (another epoch) or when the version
        was never published."""
        epoch = self.epoch if epoch is None else epoch
        if epoch != self.epoch or not 1 <= version <= self._version:
            return False
        self._acks[replica] = (epoch, version)
        return True

    def acked_version(self, replica) -> Optional[int]:
        """The replica's epoch-current acked version, or None."""
        a = self._acks.get(replica)
        return a[1] if a is not None and a[0] == self.epoch else None

    def acked_replicas(self) -> tuple:
        """Replicas with an epoch-current ack."""
        return tuple(r for r, (e, _) in self._acks.items() if e == self.epoch)

    def base_for(self, replica) -> Optional[int]:
        """The version a delta to ``replica`` may assume as its base: its
        epoch-current ack, if that version is still kept.  None means a
        full send."""
        v = self.acked_version(replica)
        return v if v is not None and v in self._versions else None

    def advance_epoch(self) -> int:
        """Fence every outstanding ack: the next send to every replica is
        full."""
        self.epoch += 1
        self._acks.clear()
        return self.epoch

    # -- failover ------------------------------------------------------------

    def state_dict(self) -> dict:
        """The latest kept version and the (version, epoch) counters.  One
        version is enough: a restore must fence anyway, so every send after
        it is full."""
        params, version = self.latest()
        return {"params": params, "version": np.asarray(version, np.int64),
                "epoch": np.asarray(self.epoch, np.int64)}

    @classmethod
    def from_state_dict(cls, state: dict, *, history: int = 4) -> "VersionedStore":
        """Rebuild a store from :meth:`state_dict`.  The caller must call
        ``advance_epoch()`` next: restored version numbers can repeat with
        other bits, and only the fence keeps a stale ack from becoming a
        wrong delta base."""
        st = cls(history=history)
        st._version = int(state["version"])
        st.epoch = int(state["epoch"])
        st._versions[st._version] = _own_copy(state["params"])
        return st

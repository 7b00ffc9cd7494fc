"""Elastic weight-sync fleet: a trainer and N replicas under injected faults
(torch port of ``repro.sync.fleet``).

``WeightSyncEngine`` encodes updates; this module owns the protocol around
them, which the paper's RL result (§5.3.1) assumes works: every replica
ends up holding the latest published version bit for bit, while messages
drop, payloads corrupt, replicas come and go and the trainer restarts.

:class:`SyncFleet` drives publish/distribute/ack rounds over a
:class:`~repro_torch.runtime.faults.FaultyWire`:

  * **Straggler-tolerant acks**: a round never waits on a slow or
    unreachable replica; a missing answer is that replica's timeout, which
    schedules a retry after a bounded backoff, and the others go on.
  * **Integrity and negative acks**: replicas check every update's CRC
    envelope (``sync.engine.verify_update``) and its (epoch, version, base)
    fence before applying; a rejection is a nack that moves the next send
    one rung down the ladder delta -> full -> raw (``update_for(force=)``).
    Corruption is detected and recovered from, never applied.
  * **Bounded retries and quarantine**: per-replica failure counts drive an
    exponential backoff (``FleetConfig.backoff_*``); a replica past
    ``max_retries`` is quarantined (counted, left out of convergence).
  * **Elasticity**: ``kill``/``join`` mid-epoch; a dead replica's messages
    evaporate, a joiner has no ack and gets the full wire.
  * **Broadcast schedules**: ``FleetConfig.broadcast`` routes each round
    over a compiled :class:`~repro_torch.sched.plan.BroadcastSchedule`
    (star, k-ary tree or chain).  Receivers of one base share one encoded
    update (the engine's per-(base, force) memo), so interior replicas
    forward the received wire object as it is after their own CRC check,
    never decoding and re-encoding it; a dead interior node's subtree gets
    direct full sends from the trainer until it acks back into the tree.
  * **Trainer failover**: ``restart_trainer()`` rebuilds the
    ``VersionedStore`` from its latest ``CheckpointManager`` snapshot
    (taken every ``ckpt_every_publishes`` publishes, so a crash can rewind
    versions) and fences the epoch: ``advance_epoch()`` forces full sends
    until every replica acks under the new epoch.

Given a seeded :class:`~repro_torch.runtime.faults.FaultPlan` everything is
deterministic: the trace (``SyncFleet.trace``), ``stats`` and
``integrity_ledger()`` replay exactly, and equal the reference fleet's on
the same publishes.  Replicas hold their weights as tensors on the fleet's
``device``.  The fleet records the reference's ``obs`` metrics, spans and
instants (``fleet_*``, ``sync_integrity_failures_total``, the
``fleet:round`` and ``fleet:restart`` spans, the ``fleet:forward``
instant) beside the ``stats`` they mirror.
"""
from __future__ import annotations

import dataclasses
import tempfile
from typing import Optional

from repro_torch import kernels, obs
from repro_torch.runtime.faults import FaultPlan, FaultyWire
from repro_torch.sched.plan import BROADCAST_KINDS, BROADCAST_STAR
from repro_torch.sync.engine import (MODE_FULL, MODE_RAW, SyncUpdate, WeightSyncEngine,
                                     apply_update, verify_update)
from repro_torch.sync.store import VersionedStore
from repro_torch.tree_util import bits_equal, tree_leaves

TRAINER = "trainer"  # the wire address acks and nacks travel to


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """Protocol knobs.  The retry budget is per replica per streak of
    failures: ``failures`` resets on every accepted ack.

    ``broadcast``/``fanout`` select the fan-out of each round
    (``sched.compile_broadcast_schedule``): "star" is the trainer sending
    every copy; "tree" and "pipeline" route each group of receivers of one
    base through a compiled :class:`~repro_torch.sched.plan.BroadcastSchedule`
    whose interior replicas forward the encoded update."""

    max_retries: int = 8  # consecutive failures before quarantine
    backoff_base: int = 1  # rounds skipped after the first failure
    backoff_factor: float = 2.0
    backoff_cap: int = 4  # backoff never exceeds this many rounds
    history: int = 4  # VersionedStore retention
    ckpt_dir: Optional[str] = None  # a temporary directory when unset
    ckpt_every_publishes: int = 1  # store snapshot cadence
    broadcast: str = BROADCAST_STAR  # fan-out topology kind
    fanout: int = 2  # interior fan-out (tree kind)


@dataclasses.dataclass(frozen=True)
class RoutedUpdate:
    """A scheduled delivery: the shared encoded :class:`SyncUpdate` and the
    receiver's subtree.  ``route`` holds ``(child_name, child_subroute)``
    pairs to which the receiver forwards the same ``update`` object after
    its own CRC check; ``hop`` counts wire hops from the trainer (root
    children: 1).  Corruption (``runtime/faults.corrupt_payload``) targets
    the inner update, so every hop's CRC check covers the forwarded bits."""

    update: SyncUpdate
    route: tuple  # ((child_name, subroute), ...)
    hop: int = 1


class Replica:
    """A simulated inference replica: verifies, fences, applies, acks.

    The apply path is ``serve.ServeEngine.ingest_weights``': the checksum
    first (corruption never reaches ``apply_update``), then the delta's
    base and epoch fence; it answers with protocol messages rather than
    exceptions, because in a fleet the sender owns recovery.  Its weights
    are tensors on ``device``."""

    def __init__(self, name: str, device="cuda"):
        self.name = name
        self.device = kernels.resolve_device(device)
        self.params = None
        self.version: Optional[int] = None
        self.epoch: Optional[int] = None
        self.alive = True
        self.applied = 0
        self.rejects = {"checksum": 0, "base_fence": 0}
        self.stale_seen = 0

    def receive(self, update) -> dict:
        """Process one delivered update; returns an ack or a nack."""
        if not verify_update(update):
            self.rejects["checksum"] += 1
            obs.metric("sync_integrity_failures_total").inc(reason="checksum")
            return {"type": "nack", "replica": self.name, "reason": "checksum",
                    "version": update.version}
        if (self.version is not None and update.epoch == self.epoch
                and update.version <= self.version):
            # a duplicate or stale delivery: ack again what is held (the ack
            # itself may have been lost)
            self.stale_seen += 1
            return {"type": "ack", "replica": self.name, "version": self.version,
                    "epoch": self.epoch}
        if update.base_version is not None:
            if (self.params is None or update.base_version != self.version
                    or update.epoch != self.epoch):
                # an XOR against any other bits would be garbage: fence it
                self.rejects["base_fence"] += 1
                obs.metric("sync_integrity_failures_total").inc(reason="base_fence")
                return {"type": "nack", "replica": self.name, "reason": "base_fence",
                        "version": update.version}
            self.params = apply_update(update, base_params=self.params, device=self.device)
        else:
            self.params = apply_update(update, device=self.device)
        self.version, self.epoch = update.version, update.epoch
        self.applied += 1
        return {"type": "ack", "replica": self.name, "version": self.version,
                "epoch": self.epoch}


class _Link:
    """Trainer-side protocol state of one replica."""

    __slots__ = ("failures", "escalation", "next_try", "quarantined")

    def __init__(self):
        self.reset_hard()

    def reset(self):  # an accepted ack: the path works again
        self.failures = 0
        self.escalation = 0
        self.next_try = 0

    def reset_hard(self):  # link creation, trainer restart
        self.reset()
        self.quarantined = False


class SyncFleet:
    """Round-driven trainer and N simulated replicas (module docstring)."""

    def __init__(self, engine: WeightSyncEngine, replica_names, *,
                 cfg: FleetConfig = None, wire: FaultyWire = None,
                 fault_plan: Optional[FaultPlan] = None, device="cuda"):
        self.engine = engine
        self.cfg = cfg or FleetConfig()
        if self.cfg.broadcast not in BROADCAST_KINDS:
            raise ValueError(f"unknown broadcast kind {self.cfg.broadcast!r}; "
                             f"expected one of {BROADCAST_KINDS}")
        self.device = kernels.resolve_device(device)
        # one plan drives both the wire's message faults and the fleet's
        # lifecycle events, off one seed
        self.fault_plan = fault_plan
        self.wire = wire if wire is not None else FaultyWire(fault_plan)
        self.replicas: dict = {}
        self._links: dict = {}
        # subtree members stranded by a dead interior forwarder: direct full
        # sends from the trainer until their ack brings them back
        self._orphans: set = set()
        self._round = 0
        self._publishes = 0
        self._ckpt = None
        self.trace: list = []  # (round, event string), deterministic
        self.stats = {"retries": 0, "timeouts": 0, "nacks": 0, "escalations": 0,
                      "quarantines": 0, "corrupt_seen": 0, "corrupt_lost": 0,
                      "checksum_rejects": 0, "fence_rejects": 0, "max_link_failures": 0,
                      "trainer_restarts": 0, "forwards": 0, "forward_bytes": 0,
                      "trainer_egress_bytes": 0, "reparents": 0, "max_hop_depth": 0}
        for name in replica_names:
            self._add_replica(name)

    # -- membership ----------------------------------------------------------

    def _add_replica(self, name: str) -> Replica:
        rep = Replica(name, self.device)
        self.replicas[name] = rep
        self._links[name] = _Link()
        self._export_live()
        return rep

    def join(self, name: str) -> Replica:
        """Mid-epoch join: no ack on file, so it is sent the full wire."""
        rep = self.replicas.get(name)
        if rep is not None and rep.alive:
            return rep
        self.trace.append((self._round, f"join {name}"))
        return self._add_replica(name)

    def kill(self, name: str) -> None:
        """Mid-epoch leave or crash: messages in flight to it evaporate."""
        rep = self.replicas.get(name)
        if rep is None or not rep.alive:
            return
        rep.alive = False
        rep.params = None  # its memory is gone
        self.trace.append((self._round, f"kill {name}"))
        self._export_live()

    def live_replicas(self) -> tuple:
        return tuple(n for n, r in self.replicas.items() if r.alive)

    def _export_live(self) -> None:
        obs.metric("fleet_live_replicas").set(len(self.live_replicas()))

    def _targets(self) -> tuple:
        """Replicas the protocol still owes convergence: live, not
        quarantined."""
        return tuple(n for n in self.live_replicas() if not self._links[n].quarantined)

    # -- trainer lifecycle ---------------------------------------------------

    def ckpt(self):
        if self._ckpt is None:
            from repro_torch.checkpoint.manager import CheckpointManager

            d = self.cfg.ckpt_dir or tempfile.mkdtemp(prefix="fleet_ckpt_")
            self._ckpt = CheckpointManager(d, keep=3)
        return self._ckpt

    def publish(self, params) -> int:
        """Publish a new version; snapshots the store every
        ``ckpt_every_publishes`` publishes (the point a later
        ``restart_trainer`` rewinds to)."""
        version = self.engine.publish(params)
        self._publishes += 1
        if self._publishes % max(self.cfg.ckpt_every_publishes, 1) == 0:
            self.ckpt().save(self._publishes, self.engine.store.state_dict())
        self.trace.append((self._round, f"publish v{version}"))
        return version

    def restart_trainer(self) -> None:
        """Simulated trainer failover: the trainer's state (store, acks,
        links, memoised encodes) is lost; the ``VersionedStore`` is rebuilt
        from the latest checkpoint on the fleet's device (possibly rewinding
        versions) and the epoch is fenced, so every next send is full until
        the replicas ack under the new epoch."""
        with obs.span("fleet:restart", round=self._round):
            ckpt = self.ckpt()
            if ckpt.latest_step() is None:
                # nothing snapshotted yet: take one now (a real trainer
                # checkpoints before it serves)
                ckpt.save(self._publishes, self.engine.store.state_dict())
            state_like = self.engine.store.state_dict()
            restored, _ = ckpt.restore(state_like, device=self.device)
            old = self.engine
            self.engine = WeightSyncEngine(policy=old.policy, axis_name=old.axis_name,
                                           history=self.cfg.history,
                                           plan_cache=old.plan_cache)
            self.engine.store = VersionedStore.from_state_dict(restored,
                                                               history=self.cfg.history)
            self.engine.advance_epoch()  # the fence: full sends only
            for link in self._links.values():
                link.reset_hard()  # the trainer's memory is gone
        self.stats["trainer_restarts"] += 1
        self.trace.append((self._round, f"trainer_restart v{self.engine.store.version}"
                           f"@e{self.engine.store.epoch}"))

    # -- the round -----------------------------------------------------------

    def round(self) -> dict:
        """One distribute/ack round: lifecycle events fire, the wire
        advances (matured delayed messages surface), the trainer sends to
        every owed replica whose backoff allows it, replicas verify, fence,
        apply and answer, and sends left unanswered become timeouts.  Never
        waits on any one replica."""
        self._round += 1
        with obs.span("fleet:round", round=self._round):
            obs.metric("fleet_rounds_total").inc()
            if self.fault_plan is not None:
                for ev in self.fault_plan.events_for_round(self._round):
                    self._apply_event(ev)
            self.wire.advance_round()
            sent = self._send_updates()
            self._deliver_to_replicas()
            responded = self._drain_trainer()
            for name in sent - responded:
                self.stats["timeouts"] += 1
                # a lost message is not a corrupt one: retry on the same
                # rung, later
                self._record_failure(name, escalate=False, reason="timeout")
        return {"round": self._round, "sent": len(sent), "responded": len(responded)}

    def _apply_event(self, ev) -> None:
        if ev.kind == "kill":
            self.kill(ev.target)
        elif ev.kind == "join":
            self.join(ev.target)
        elif ev.kind == "trainer_restart":
            self.restart_trainer()
        else:
            raise ValueError(f"unknown lifecycle fault {ev.kind!r}")

    def _send_updates(self) -> set:
        """One distribute pass: owed replicas split into groups of one
        ``(base, force)``, the engine's memo key, so each member of a group
        gets the same encoded update, and each group rides its compiled
        :class:`BroadcastSchedule`.  Star (or a group of one) is a direct
        send a member; tree and pipeline send only to the schedule's root
        children, the rest of the group nested in each envelope's
        ``route``.  Orphans bypass the schedule: a direct full send until
        they ack and rejoin the tree."""
        store = self.engine.store
        sent = set()
        if store.version == 0:
            return sent  # nothing published yet
        owed = []
        for name in self._targets():
            link = self._links[name]
            if self._round < link.next_try:
                continue  # backing off; the round does not wait
            if store.acked_version(name) == store.version and link.escalation == 0:
                self._orphans.discard(name)  # current: back in the tree
                continue
            owed.append(name)
        groups: dict = {}
        for name in owed:
            if name in self._orphans:
                update = self.engine.update_for(name, force=MODE_FULL)
                self._trainer_send(name, update)
                sent.add(name)
                continue
            force = (None, MODE_FULL, MODE_RAW)[self._links[name].escalation]
            base = None if force is not None else store.base_for(name)
            groups.setdefault((base, force), []).append(name)
        for base, force in sorted(groups, key=lambda k: (k[0] is None, k[0] or 0, k[1] or "")):
            names = sorted(groups[(base, force)])
            update = self.engine.update_for(names[0], force=force)
            schedule = self._schedule_for(len(names))
            if schedule is None:
                for name in names:
                    self._trainer_send(name, update)
            else:
                for child, subroute in schedule.route_for(names):
                    self._trainer_send(child, update, route=subroute)
            sent.update(names)
        return sent

    def _schedule_for(self, m: int):
        """The compiled fan-out of an ``m``-receiver group, or None for
        direct sends (star).  Compiled through the plan cache
        (``engine.plan_for``): a stable group size hits, a changed one
        recompiles, and a plan whose schedule does not fit the group raises
        instead of mis-routing."""
        if self.cfg.broadcast == BROADCAST_STAR or m <= 1:
            return None
        params, _ = self.engine.store.latest()
        plan = self.engine.plan_for(params, broadcast=self.cfg.broadcast,
                                    fanout=self.cfg.fanout, n_receivers=m)
        schedule = plan.broadcast
        if schedule is None or schedule.n_receivers != m:
            raise RuntimeError(
                f"stale wsync broadcast schedule: plan recorded "
                f"{getattr(schedule, 'n_receivers', None)} receivers, the fleet is "
                f"routing {m}")
        return schedule

    def _trainer_send(self, name: str, update, route=()) -> None:
        """One send from the trainer: the bare update for a direct send, a
        hop-1 :class:`RoutedUpdate` when ``name`` must forward a subtree."""
        payload = update if not route else RoutedUpdate(update, tuple(route), hop=1)
        self.wire.send(name, payload)
        w = int(update.wire_bytes)
        self.stats["trainer_egress_bytes"] += w
        obs.metric("fleet_trainer_egress_bytes_total").inc(w)

    def _deliver_to_replicas(self) -> None:
        # delivery is multi-hop: a verified interior wire re-enters the
        # queues for its children, so drain until this round's traffic is
        # done (delayed messages stay with the wire).  Finite: every forward
        # uses up one node of a finite route.
        progress = True
        while progress:
            progress = False
            for name, rep in self.replicas.items():
                for payload, corrupted in self.wire.drain(name, with_flags=True):
                    progress = True
                    update, route, hop = (
                        (payload.update, payload.route, payload.hop)
                        if isinstance(payload, RoutedUpdate) else (payload, (), 1))
                    if not rep.alive:
                        # messages to a dead replica evaporate; corrupted ones
                        # are counted, so injected == seen + lost holds, and
                        # a dead interior node orphans its whole subtree
                        if corrupted:
                            self.stats["corrupt_lost"] += 1
                        if route:
                            self._orphan_subtree(name, route)
                        continue
                    if corrupted:
                        self.stats["corrupt_seen"] += 1
                    if hop > self.stats["max_hop_depth"]:
                        self.stats["max_hop_depth"] = hop
                        obs.metric("fleet_hop_depth").set(hop)
                    resp = rep.receive(update)
                    self.wire.send(TRAINER, resp)
                    if route and not (resp["type"] == "nack" and resp["reason"] == "checksum"):
                        # forward the same wire object, never decoded and
                        # re-encoded.  A checksum reject means this hop's copy
                        # is damaged: forwarding would spread it, so the
                        # subtree retries through its timeouts instead.
                        self._forward(name, update, route, hop)

    def _forward(self, name: str, update, route, hop: int) -> None:
        w = int(update.wire_bytes)
        for child, subroute in route:
            self.wire.send(child, RoutedUpdate(update, tuple(subroute), hop + 1))
            self.stats["forwards"] += 1
            self.stats["forward_bytes"] += w
            obs.metric("fleet_forwards_total").inc()
            obs.metric("fleet_forwarded_bytes_total").inc(w)
            obs.instant("fleet:forward", src=name, dst=child, hop=hop + 1)

    def _orphan_subtree(self, at: str, route) -> None:
        """Re-parent every receiver below a dead forwarder: direct full sends
        from the trainer from the next round, back into the tree on ack."""
        for child, subroute in route:
            if child not in self._orphans:
                self._orphans.add(child)
                self.stats["reparents"] += 1
                obs.metric("fleet_reparents_total").inc()
                self.trace.append((self._round, f"reparent {child} (via dead {at})"))
            self._orphan_subtree(at, subroute)

    def _drain_trainer(self) -> set:
        responded = set()
        for resp in self.wire.drain(TRAINER):
            name = resp["replica"]
            link = self._links.get(name)
            rep = self.replicas.get(name)
            if link is None or rep is None or not rep.alive:
                continue
            responded.add(name)
            if resp["type"] == "ack":
                if self.engine.ack(name, resp["version"], resp["epoch"]):
                    link.reset()  # the path works: clear the streak
                    self._orphans.discard(name)  # back in the tree
                # a fenced (old-epoch) ack is ignored; the full send in
                # flight will bring a current one
            else:
                self.stats["nacks"] += 1
                self.stats[{"checksum": "checksum_rejects",
                            "base_fence": "fence_rejects"}[resp["reason"]]] += 1
                self._record_failure(name, escalate=True, reason=resp["reason"])
        return responded

    def _record_failure(self, name: str, *, escalate: bool, reason: str) -> None:
        link = self._links[name]
        if link.quarantined:
            return
        link.failures += 1
        self.stats["retries"] += 1
        self.stats["max_link_failures"] = max(self.stats["max_link_failures"],
                                              link.failures)
        obs.metric("fleet_retries_total").inc()
        if escalate and link.escalation < 2:
            link.escalation += 1
            self.stats["escalations"] += 1
            obs.metric("fleet_escalations_total").inc(
                to=(MODE_FULL, MODE_RAW)[link.escalation - 1])
            self.trace.append((self._round, f"escalate {name} -> "
                               f"{(MODE_FULL, MODE_RAW)[link.escalation - 1]} ({reason})"))
        if link.failures > self.cfg.max_retries:
            link.quarantined = True
            self.stats["quarantines"] += 1
            obs.metric("fleet_quarantines_total").inc()
            self.trace.append((self._round, f"quarantine {name}"))
            return
        backoff = min(int(self.cfg.backoff_base
                          * self.cfg.backoff_factor ** (link.failures - 1)),
                      self.cfg.backoff_cap)
        link.next_try = self._round + max(backoff, 1)

    # -- convergence ---------------------------------------------------------

    def converged(self) -> bool:
        """Trainer-view convergence: every owed replica has an epoch-current
        ack at the latest version (acks follow only a verified, fenced
        apply; ``verify_bitexact`` checks the bits on their own)."""
        store = self.engine.store
        return all(store.acked_version(n) == store.version for n in self._targets())

    def settle(self, max_rounds: int = 200) -> int:
        """Run rounds until convergence; returns how many it took.  Raises
        after ``max_rounds``: under a finite fault schedule the fleet must
        converge."""
        start = self._round
        while not self.converged():
            if self._round - start >= max_rounds:
                raise RuntimeError(f"fleet failed to converge within {max_rounds} rounds "
                                   f"(round {self._round}, stats {self.stats})")
            self.round()
        rounds = self._round - start
        obs.metric("fleet_convergence_rounds").set(rounds)
        return rounds

    def integrity_ledger(self) -> dict:
        """The corruption accounting the chaos checks hold, per delivery, so
        it holds under multi-hop schedules too:

        * ``injected``: corruptions the wire applied;
        * ``seen``: corrupted deliveries that reached a live replica;
        * ``lost``: corrupted deliveries that evaporated at a dead one;
        * ``detected``: replica-side checksum rejections (counted in
          ``Replica.receive``, so a nack lost on its way back still counts);
        * ``silent``: ``seen - detected``, corrupted updates a replica
          accepted.  Must be zero."""
        detected = sum(r.rejects["checksum"] for r in self.replicas.values())
        return {"injected": self.wire.counts.get("corrupt", 0),
                "seen": self.stats["corrupt_seen"], "lost": self.stats["corrupt_lost"],
                "detected": detected, "silent": self.stats["corrupt_seen"] - detected}

    def verify_bitexact(self) -> bool:
        """Every owed replica's weights equal the latest published tree bit
        for bit (``tree_util.bits_equal``, NaN payloads included), whatever
        the schedule that delivered them."""
        params, _ = self.engine.store.latest()
        ref = [leaf.to(self.device) for leaf in tree_leaves(params)]
        return all(self.replicas[name].params is not None
                   and bits_equal(ref, tree_leaves(self.replicas[name].params))
                   for name in self._targets())

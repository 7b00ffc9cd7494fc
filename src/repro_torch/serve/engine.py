"""Serving engine: continuous batching, colocated or PD-disaggregated (torch
port of ``repro.serve.engine``).

The inference side of the paper's §5.3.2 workload.  Two deployment modes:

  * **colocated**: one worker runs prefill and decode;
  * **PD-disaggregated** (``ServeConfig.pd_disaggregated``): every admitted
    request's prefilled cache crosses the prefill -> decode boundary through
    the compressed host wire (``kv_transfer.ship_cache`` then
    ``unpack_cache``), with the codec schedule read from a kind-"kv"
    ``CommPlan`` cached on the cache signature.  The wire is bit-exact, so
    the tokens are those of colocated serving.

``ServeEngine`` keeps a fixed number of decode slots, each holding one
request's cache position; finished slots are refilled from the queue
between decode steps; ``ingest_weights`` hot-swaps the model's weights from
the weight-sync wire (``sync/engine.py``).  The reference's semantics are
kept where they look odd: one engine-wide ``pos = max(slot pos)`` per decode step, prompts
left-padded with zeros to a multiple of ``prefill_chunk``, and the splice
of an admitted cache on the stacked dimension 1.  Sampling is greedy.

Observability (``obs``): the ``serve:admit``, ``serve:prefill``,
``serve:kv_ship`` and ``serve:decode_step`` spans, the queue, slot and
token metrics, ingest rejects and KV-ship retries, and each shipment's live
wire ratio against its plan's in the drift detector.  A span reads the
host clock: an admission's span ends when its host work does, and the
decode step's when the sampled tokens reach the host.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.integrity import WireIntegrityError
from repro_torch.models import transformer
from repro_torch.models.config import ArchConfig
from repro_torch.tree_util import tree_flatten, tree_leaves


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    batch_slots: int = 8
    max_len: int = 256
    temperature: float = 0.0  # 0 = greedy, the only mode ported so far
    eos_token: int = -1  # -1 = never stops early
    prefill_chunk: int = 64  # pad prompts to a multiple of this
    # PD-disaggregation boundary: admitted caches cross prefill -> decode
    # through the compressed host wire, scheduled by a cached kv CommPlan
    pd_disaggregated: bool = False


def sample(logits: torch.Tensor, temperature: float) -> torch.Tensor:
    """Greedy: the first index of the largest logit, int32."""
    if temperature > 0.0:
        raise NotImplementedError("sampling at temperature > 0 is not ported; "
                                  "greedy (temperature 0) is")
    return torch.argmax(logits, dim=-1).to(torch.int32)


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # (L,) int32
    max_new: int = 32
    out: Optional[list] = None
    done: bool = False


class ServeEngine:
    """Slot-based continuous batching on one worker.

    Decode runs over all ``batch_slots`` every step; finished slots are
    masked and refilled between steps.  Per-slot KV caches live inside one
    batched cache; admission writes a freshly prefilled single-request cache
    into its slot (in place).  ``model`` is a ``transformer.Transformer``;
    the engine runs on its device."""

    def __init__(self, cfg: ArchConfig, model: transformer.Transformer,
                 scfg: ServeConfig, *, kv_policy=None, kv_plan_cache=None,
                 kv_codec: str = "packed"):
        self.cfg, self.model, self.scfg = cfg, model, scfg
        self.device = model.params["embed"].device
        self.kv_policy = kv_policy
        self.kv_plan_cache = kv_plan_cache
        self.kv_compressor = None
        if scfg.pd_disaggregated:
            from repro_torch.core.policy import CompressionPolicy
            from repro_torch.p2p.engine import Compressor
            from repro_torch.sched.cache import default_cache

            if self.kv_policy is None:
                self.kv_policy = CompressionPolicy(min_bytes=0)
            if self.kv_plan_cache is None:
                self.kv_plan_cache = default_cache()
            self.kv_compressor = Compressor(codec_name=kv_codec,
                                            device=self.device)
        # KV-wire integrity recovery: re-pack budget per shipment, and a
        # test seam that interposes on the packed wire (fault injection)
        self._kv_max_tries = 3
        self.kv_fault_injector: Optional[Callable] = None
        self.cache = transformer.init_cache(cfg, scfg.batch_slots, scfg.max_len,
                                            self.device)
        self.tokens = torch.zeros((scfg.batch_slots, 1), dtype=torch.int32,
                                  device=self.device)
        self.slots: list = [None] * scfg.batch_slots
        self.pos = np.zeros(scfg.batch_slots, np.int64)
        self.budget = np.zeros(scfg.batch_slots, np.int64)
        self.queue: list = []
        self.finished: list = []
        # weight-sync state (None until the first ingest): the version and
        # epoch of the model's weights under the sync protocol
        self.weight_version: Optional[int] = None
        self.weight_epoch: Optional[int] = None

    # -- weight-sync ingestion -----------------------------------------------

    def ingest_weights(self, update) -> int:
        """Hot-swap the model's weights from a weight-sync update
        (``sync.WeightSyncEngine.update_for``); returns the new version.

        The payload checksum is verified first: a corrupt update raises
        ``WireIntegrityError`` and the weights stay as they are.  A full
        update applies unconditionally and adopts the stream's epoch; a
        delta applies only when this engine holds exactly its base
        (version and epoch), since XOR against other bits would be garbage,
        and raises otherwise (the caller should ask for a full send).  The
        whole new tree is decoded before the first parameter is overwritten
        (a delta decodes against the current bits), then copied into the
        model's parameters in place, so the decode loop keeps its tensors."""
        from repro_torch.sync.engine import apply_update, verify_update

        if update.checksum is not None and not verify_update(update):
            obs.metric("serve_ingest_rejects_total").inc(reason="checksum")
            raise WireIntegrityError(
                f"update v{update.version} failed its payload checksum; "
                f"re-send it (escalate delta -> full -> raw)")
        if update.base_version is not None:
            if (update.base_version != self.weight_version
                    or update.epoch != self.weight_epoch):
                obs.metric("serve_ingest_rejects_total").inc(reason="fence")
                raise ValueError(
                    f"delta update v{update.version} assumes base "
                    f"v{update.base_version}@e{update.epoch} but this engine "
                    f"holds v{self.weight_version}@e{self.weight_epoch}; "
                    f"request a full send")
            new = apply_update(update, base_params=self.model.tree(), device=self.device)
        else:
            new = apply_update(update, device=self.device)
        params, got = self.model.leaves(), tree_leaves(new)
        if len(got) != len(params) or any(
                g.shape != p.shape or g.dtype != p.dtype for g, p in zip(got, params)):
            raise ValueError(f"update v{update.version} does not hold this model's "
                             f"weights")
        with torch.no_grad():
            for p, g in zip(params, got):
                p.copy_(g)
        self.weight_version = update.version
        self.weight_epoch = update.epoch
        return self.weight_version

    # -- admission -----------------------------------------------------------

    def submit(self, req: Request):
        req.out = []
        self.queue.append(req)
        obs.metric("serve_queue_depth").set(len(self.queue))

    @staticmethod
    def _splice_impl(batched_cache: dict, one_cache: dict, slot: int) -> dict:
        """Write a single-request cache (batch 1) into slot ``slot`` of the
        batched cache, in place.  The batch dimension is 0 or, for stacked
        blocks, 1; ``pos`` is per engine (slot positions live on the host)."""
        def leafwise(b, o):
            if b.dim() == 0:
                return
            if o.shape[0] == 1 and b.shape[:1] != o.shape[:1]:
                b[slot:slot + 1] = o
            elif o.dim() >= 2 and o.shape[1] == 1:
                b[:, slot:slot + 1] = o

        for k, v in batched_cache.items():
            if k == "pos":
                continue
            for b, o in zip(tree_flatten(v)[0], tree_flatten(one_cache[k])[0]):
                leafwise(b, o)
        return batched_cache

    def _admit(self):
        admitted = 0
        for s in range(self.scfg.batch_slots):
            if self.slots[s] is not None or not self.queue:
                continue
            req = self.queue.pop(0)
            admitted += 1
            with obs.span("serve:admit", rid=req.rid, slot=s):
                pad = -len(req.prompt) % self.scfg.prefill_chunk
                toks = np.concatenate([np.zeros(pad, np.int32), req.prompt])
                one_cache = transformer.init_cache(self.cfg, 1, self.scfg.max_len,
                                                   self.device)
                with obs.span("serve:prefill", tokens=len(toks)):
                    logits, one_cache = transformer.prefill(
                        self.model,
                        torch.from_numpy(toks[None].astype(np.int64)).to(self.device),
                        one_cache)
                if self.scfg.pd_disaggregated:
                    one_cache = self._ship_kv(one_cache)
                nxt = sample(logits[:, -1], self.scfg.temperature)
                self._splice_impl(self.cache, one_cache, s)
                self.tokens[s, 0] = nxt[0]
                req.out.append(int(nxt[0]))
                if req.max_new <= 1:  # the prefill's token was the whole budget
                    req.done = True
                    self.finished.append(req)
                    continue
                self.slots[s] = req
                self.pos[s] = len(toks)
                self.budget[s] = req.max_new - 1  # 1st token from prefill
        if admitted:
            obs.metric("serve_admitted_total").inc(admitted)
        obs.metric("serve_queue_depth").set(len(self.queue))
        obs.metric("serve_active_slots").set(sum(r is not None for r in self.slots))

    def _ship_kv(self, one_cache: dict) -> dict:
        """Cross the prefill -> decode boundary: pack the prefilled cache with
        the host compressor and unpack it on the decode side.

        The codec schedule comes from a kind-"kv" CommPlan keyed on the
        cache signature: the first admission compiles it, every later one
        hits.  ``unpack_cache`` verifies the wire's checksum before decoding;
        on a mismatch the shipment is re-packed from the prefill cache that
        is still held, at most ``_kv_max_tries`` times.  ``kv_fault_injector``
        (None outside tests) interposes on the wire between pack and
        unpack.  Each retry counts in ``serve_kv_retries_total``."""
        from repro_torch.serve.kv_transfer import ship_cache, unpack_cache

        with obs.span("serve:kv_ship"):
            last_err = None
            for _ in range(max(self._kv_max_tries, 1)):
                wire, plan = ship_cache(one_cache, self.kv_compressor,
                                        policy=self.kv_policy,
                                        plan_cache=self.kv_plan_cache)
                if self.kv_fault_injector is not None:
                    wire = self.kv_fault_injector(wire)
                try:
                    out = unpack_cache(wire, self.kv_compressor)
                except WireIntegrityError as e:
                    last_err = e
                    obs.metric("serve_kv_retries_total").inc()
                    continue
                self._observe_kv_drift(wire, plan)
                return out
            raise WireIntegrityError(
                f"KV shipment failed integrity {self._kv_max_tries} times"
            ) from last_err

    @staticmethod
    def _observe_kv_drift(wire: dict, plan) -> None:
        """Feed one KV shipment's live wire ratio into the drift detector
        against its plan's compile-time prediction.  The packed codec's
        wire is sized from shapes (stationary traffic observes live ==
        predicted); the rANS codec's ``used_bytes`` is the data-dependent
        term a KV distribution shift moves."""
        if not obs.enabled() or plan is None:
            return
        from repro_torch.obs import drift as drift_lib

        live_wire = live_raw = 0
        for m in wire.get("messages", ()):
            if hasattr(m, "wire_bytes"):
                live_wire += m.wire_bytes()
                live_raw += m.raw_bytes
        if live_raw > 0 and plan.raw_bytes > 0:
            drift_lib.observe((plan.key, "host"), plan.kind, plan.ratio,
                              live_wire / live_raw)

    # -- decode loop -----------------------------------------------------------

    def step(self) -> bool:
        """One batched decode step over all active slots."""
        if all(s is None for s in self.slots):
            self._admit()
            if all(s is None for s in self.slots):
                return False
        # engine-wide cache pos = max slot pos (slot caches padded before it)
        active = sum(r is not None for r in self.slots)
        with obs.span("serve:decode_step", active=active):
            self.cache["pos"] = torch.tensor(int(self.pos.max()), dtype=torch.int32,
                                             device=self.device)
            logits, self.cache = transformer.decode_step(self.model, self.tokens,
                                                         self.cache)
            nxt = sample(logits[:, -1], self.scfg.temperature)
            self.tokens = nxt[:, None]
            host = nxt.cpu().numpy()
            produced = 0
            for s, req in enumerate(self.slots):
                if req is None:
                    continue
                t = int(host[s])
                req.out.append(t)
                produced += 1
                self.pos[s] += 1
                self.budget[s] -= 1
                if self.budget[s] <= 0 or t == self.scfg.eos_token or \
                   self.pos[s] >= self.scfg.max_len - 1:
                    req.done = True
                    self.finished.append(req)
                    self.slots[s] = None
        obs.metric("serve_decode_steps_total").inc()
        obs.metric("serve_tokens_total").inc(produced)
        obs.metric("serve_tokens_per_step").set(produced)
        self._admit()
        return True

    def run(self, max_steps: int = 10_000) -> list:
        steps = 0
        while steps < max_steps and (self.queue or any(
                s is not None for s in self.slots)):
            if not self.step():
                break
            steps += 1
        return self.finished

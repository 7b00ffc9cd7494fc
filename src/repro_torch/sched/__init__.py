"""Communication plans (torch port of ``repro.sched``): a wire's decisions
(leaf buckets, compress gates, codec widths, chunk grids, expected bytes)
are compiled once into a ``CommPlan`` (``plan.py``, ``compile.py``), cached
on the signature of what they ship (``cache.py``) and replayed by
``executor.py``: the collective kinds ``psum``, ``reduce_scatter``,
``all_gather``, ``zero1`` and ``fsdp_gather``, and the P2P kinds ``p2p``,
``kv`` and ``wsync`` (the host serve and weight-sync engines also read
``kv`` and ``wsync`` plans; a ``wsync`` plan may carry a
``BroadcastSchedule``, the fleet's fan-out).  ``save_plans`` and
``load_plans`` carry the cache's plans across a restart."""
from repro_torch.sched.cache import (PlanCache, cache_info, cache_stats, default_cache,
                                     load_plans, save_plans)
from repro_torch.sched.compile import (PLAN_KINDS, cached_fsdp_gather_plan, cached_kv_plan,
                                       cached_p2p_plan, cached_wsync_plan,
                                       compile_broadcast_schedule, compile_fsdp_gather_plan,
                                       compile_kv_plan, compile_p2p_plan,
                                       compile_wsync_plan)
from repro_torch.sched.executor import (Zero1Execution, all_gather_with_plan,
                                        execute_kv_transfer, execute_p2p, execute_psum,
                                        execute_wsync, execute_wsync_broadcast,
                                        gather_from_plan, p2p_send_with_plan, psum_with_plan,
                                        reduce_scatter_with_plan, sync_weights_with_plan,
                                        transfer_cache_with_plan, wsync_hop_perms)
from repro_torch.sched.plan import BROADCAST_KINDS, BroadcastSchedule

__all__ = ["BROADCAST_KINDS", "BroadcastSchedule", "PLAN_KINDS", "PlanCache",
           "Zero1Execution", "all_gather_with_plan", "cache_info", "cache_stats",
           "cached_fsdp_gather_plan", "cached_kv_plan", "cached_p2p_plan",
           "cached_wsync_plan", "compile_broadcast_schedule", "compile_fsdp_gather_plan",
           "compile_kv_plan", "compile_p2p_plan", "compile_wsync_plan", "default_cache",
           "execute_kv_transfer", "execute_p2p", "execute_psum", "execute_wsync",
           "execute_wsync_broadcast", "gather_from_plan", "load_plans",
           "p2p_send_with_plan", "psum_with_plan", "reduce_scatter_with_plan",
           "save_plans", "sync_weights_with_plan", "transfer_cache_with_plan",
           "wsync_hop_perms"]

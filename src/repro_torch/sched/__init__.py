"""Communication plans (torch port of ``repro.sched``): a wire's decisions
(leaf buckets, compress gates, codec widths, chunk grids, expected bytes)
are compiled once into a ``CommPlan`` (``plan.py``, ``compile.py``), cached
on the signature of what they ship (``cache.py``) and replayed
(``executor.py`` for the collective kinds ``psum``, ``reduce_scatter``,
``all_gather`` and ``zero1``; the serve and weight-sync engines for ``kv``
and ``wsync``)."""
from repro_torch.sched.executor import (Zero1Execution, all_gather_with_plan,
                                        execute_psum, psum_with_plan,
                                        reduce_scatter_with_plan)

__all__ = ["Zero1Execution", "all_gather_with_plan", "execute_psum",
           "psum_with_plan", "reduce_scatter_with_plan"]

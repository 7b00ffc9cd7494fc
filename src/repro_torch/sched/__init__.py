"""Communication plans (torch port of ``repro.sched``; the ``kv`` and
``wsync`` kinds so far): a wire's decisions (leaf buckets, compress gates,
codec widths, expected bytes) are compiled once into a ``CommPlan``
(``plan.py``, ``compile.py``) and cached on the signature of what they ship
(``cache.py``)."""

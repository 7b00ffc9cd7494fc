"""Plan persistence (``sched/cache.py``'s ``save_plans``/``load_plans``,
``CheckpointManager.save_plans``/``restore_plans``), the process cache's
``REPRO_PLAN_CACHE_CAP`` and the module's ``cache_info``/``cache_stats``,
held against the reference's behaviour on the same sequence of calls.

* a saved cache loads into a fresh one with every plan equal and under its
  own key; loading again inserts nothing; present entries stay; loading
  counts neither hit nor miss; another version is refused: the counts and
  refusals of the reference's functions, exactly;
* ``validate_backend`` drops the plans of another device (a plan of the
  card in a CPU process, and the other way round);
* a plan saved here replays in a fresh ``python`` process: a hit, no
  compile, and the shipment's wire bytes equal these;
* a ZeRO-1 step resumed with its plans restored from a checkpoint
  compiles nothing and gives the live step's bits.
"""
import dataclasses
import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro import sched as jsched
from repro.checkpoint.manager import CheckpointManager as JCheckpointManager
from repro.core.policy import CompressionPolicy as JPolicy
from repro.sched import cache as jcache
from repro_torch import configs, sched
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core.policy import CompressionPolicy
from repro_torch.launch import train as launch_train
from repro_torch.p2p.engine import Compressor
from repro_torch.sched import cache as sched_cache
from repro_torch.sched import compile as sched_compile
from repro_torch.serve import kv_transfer
from repro_torch.train import step as step_lib
from repro_torch.tree_util import bits_equal

SRC = Path(__file__).resolve().parents[1] / "src"
SHAPES = ((1, 2, 16, 2, 8), (1, 16, 2, 8))


def _cache(seed: int, framework="torch"):
    """A gemma3-like KV cache (a stacked and an unstacked leaf pair, pos)
    of seeded values: torch tensors, or the same values for the reference."""
    rng = np.random.default_rng(seed)
    vals = {f"{n}{i}": rng.normal(0, 1, s).astype(np.float32)
            for i, s in enumerate(SHAPES) for n in "kv"}
    if framework == "jax":
        import jax.numpy as jnp

        t = {k: jnp.asarray(v, jnp.bfloat16) for k, v in vals.items()}
        pos = jnp.asarray(16, jnp.int32)
    else:
        t = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in vals.items()}
        pos = torch.tensor(16, dtype=torch.int32)
    return {"pos": pos, "blocks": ({"kv": {"k": t["k0"], "v": t["v0"]}},),
            "prefix_0": {"kv": {"k": t["k1"], "v": t["v1"]}}}


def _fill(module, cache_cls, framework, **kw):
    """Three plans compiled into a fresh cache of ``module``'s kind."""
    pc = cache_cls()
    policy = (CompressionPolicy if framework == "torch" else JPolicy)
    for i, mb in enumerate((0, 1, 2)):
        module.cached_kv_plan(_cache(i, framework), "data", policy=policy(min_bytes=mb),
                              n_dev=1, plan_cache=pc, **kw)
    return pc


def _sequence(cache_mod, make, tmp, **load_kw) -> dict:
    """save, load into a fresh cache, load again, load into a cache holding
    one of them, a file of another version: the counts each call gives."""
    full = make()
    path = os.path.join(tmp, "plans.pkl")
    out = {"saved": cache_mod.save_plans(path, full)}
    fresh = type(full)()
    out["loaded"] = cache_mod.load_plans(path, fresh, **load_kw)
    out["again"] = cache_mod.load_plans(path, fresh, **load_kw)
    out["stats"] = (fresh.stats.hits, fresh.stats.misses, fresh.stats.evictions)
    out["same"] = [fresh._plans[k] == p for k, p in full._plans.items()]
    partial = type(full)()
    key, plan = next(iter(full._plans.items()))
    partial._plans[key] = plan
    out["partial"] = cache_mod.load_plans(path, partial, **load_kw)
    out["kept"] = partial._plans[key] is plan
    with open(path, "wb") as f:
        pickle.dump({"version": 1, "plans": ()}, f)
    with pytest.raises(ValueError, match="unsupported plan-cache version"):
        cache_mod.load_plans(path, type(full)(), **load_kw)
    return out


def test_save_and_load_behave_as_the_reference(tmp_path):
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    want = _sequence(jcache, lambda: _fill(jsched, jcache.PlanCache, "jax"),
                     str(tmp_path / "j"))
    got = _sequence(sched_cache, lambda: _fill(sched_compile, sched.PlanCache, "torch"),
                    str(tmp_path / "t"), device="cpu")
    assert got == want
    assert got["saved"] == 3 and got["loaded"] == 3 and got["again"] == 0
    assert got["stats"] == (0, 0, 0) and all(got["same"]) and got["partial"] == 2
    assert sched_cache._PLANS_VERSION == jcache._PLANS_VERSION


def test_validate_backend_drops_plans_of_the_other_device(tmp_path, monkeypatch):
    pc = _fill(sched_compile, sched.PlanCache, "torch")
    cpu_plans = list(pc._plans.values())
    assert all((p.backend, p.use_kernels) == ("cpu", False) for p in cpu_plans)
    # a plan compiled on the card: its probe (and so its key) says cuda
    card = dataclasses.replace(cpu_plans[0], key=cpu_plans[0].key[:-1] + (("cuda", True),),
                               backend="cuda", use_kernels=True)
    pc._plans[card.key] = card
    path = str(tmp_path / "plans.pkl")
    assert sched.save_plans(path, pc) == 4
    here = sched.PlanCache()
    assert sched.load_plans(path, here, device="cpu") == 3
    assert card.key not in here and all(p.key in here for p in cpu_plans)
    assert sched.load_plans(path, sched.PlanCache(), validate_backend=False) == 4
    # in a process on the card, only the card's plan is kept
    monkeypatch.setattr(sched_compile, "probe_backend", lambda device="cuda": ("cuda", True))
    there = sched.PlanCache()
    assert sched.load_plans(path, there) == 1 and card.key in there


def test_load_evicts_over_capacity_as_the_reference(tmp_path):
    path = str(tmp_path / "plans.pkl")
    sched.save_plans(path, _fill(sched_compile, sched.PlanCache, "torch"))
    small = sched.PlanCache(capacity=2)
    assert sched.load_plans(path, small, device="cpu") == 3
    jpath = str(tmp_path / "jplans.pkl")
    jsched.save_plans(jpath, _fill(jsched, jcache.PlanCache, "jax"))
    jsmall = jcache.PlanCache(capacity=2)
    assert jsched.load_plans(jpath, jsmall) == 3
    assert small.cache_info() == jsmall.cache_info()
    assert (len(small), small.stats.evictions) == (2, 1)


def _cap_in_a_fresh_process(env_cap, package):
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
    env.pop("REPRO_PLAN_CACHE_CAP", None)
    if env_cap is not None:
        env["REPRO_PLAN_CACHE_CAP"] = env_cap
    code = (f"import json; from {package}.sched import cache; "
            "print(json.dumps(cache.cache_info()))")
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, check=True, timeout=120).stdout
    return json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("cap", [None, "7"])
def test_process_cache_capacity_comes_from_the_environment(cap):
    got = _cap_in_a_fresh_process(cap, "repro_torch")
    assert got["capacity"] == (512 if cap is None else 7) and got["size"] == 0
    if cap is not None:
        assert got == _cap_in_a_fresh_process(cap, "repro")


def test_module_cache_info_and_stats_read_the_process_cache():
    default = sched.default_cache()
    assert sched.cache_stats() is default.stats
    before = sched.cache_info()
    assert before == default.cache_info()
    cache = _cache(11)
    policy = CompressionPolicy(min_bytes=0)
    for _ in range(2):
        sched_compile.cached_kv_plan(cache, "data", policy=policy, n_dev=1)
    after = sched.cache_info()
    assert (after["misses"] - before["misses"], after["hits"] - before["hits"]) in \
        ((1, 1), (0, 2))  # another test of this process may have compiled it
    assert set(after) == set(jsched.cache_info())


def test_checkpoint_manager_saves_and_restores_plans(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    assert mgr.PLAN_CACHE_FILE == JCheckpointManager.PLAN_CACHE_FILE
    assert mgr.restore_plans(sched.PlanCache(), device="cpu") == 0  # nothing saved
    pc = _fill(sched_compile, sched.PlanCache, "torch")
    path = mgr.save_plans(pc)
    assert path == os.path.join(str(tmp_path / "ckpt"), "plan_cache.pkl")
    assert os.path.exists(path) and not os.path.exists(path + ".tmp")
    fresh = sched.PlanCache()
    assert mgr.restore_plans(fresh, device="cpu") == 3
    assert {k: p for k, p in fresh._plans.items()} == dict(pc._plans)
    # the reference's manager reads the same file name from its directory
    jmgr = JCheckpointManager(str(tmp_path / "jckpt"))
    jmgr.save_plans(_fill(jsched, jcache.PlanCache, "jax"))
    assert sorted(os.listdir(tmp_path / "jckpt")) == sorted(os.listdir(tmp_path / "ckpt"))


def wire_bytes(wire) -> np.ndarray:
    """Every payload byte of a packed KV wire, in message order."""
    parts = []
    for m in wire["messages"]:
        if hasattr(m, "lo_payload"):
            parts.append(m.lo_payload)
            parts += [np.asarray(m.exp_payload[k]) for k in sorted(m.exp_payload)]
        else:
            parts.append(np.asarray(m))
    return np.concatenate([np.ascontiguousarray(a).view(np.uint8).ravel() for a in parts])


_REPLAY = """
import json, sys
import numpy as np
sys.path.insert(0, {tests!r})
from test_torch_plan_cache import _cache, wire_bytes
from repro_torch.core.policy import CompressionPolicy
from repro_torch.p2p.engine import Compressor
from repro_torch.sched.cache import PlanCache, load_plans
from repro_torch.serve import kv_transfer
pc = PlanCache()
n = load_plans({path!r}, pc, device="cpu")
wire, plan = kv_transfer.ship_cache(_cache(21), Compressor(codec_name="packed", device="cpu"),
                                    policy=CompressionPolicy(min_bytes=0), plan_cache=pc)
np.save({out!r}, wire_bytes(wire))
print(json.dumps({{"loaded": n, "hits": pc.stats.hits, "misses": pc.stats.misses}}))
"""


def test_a_saved_plan_replays_in_a_fresh_process(tmp_path):
    pc = sched.PlanCache()
    eng = Compressor(codec_name="packed", device="cpu")
    wire, plan = kv_transfer.ship_cache(_cache(21), eng, policy=CompressionPolicy(min_bytes=0),
                                        plan_cache=pc)
    path, out = str(tmp_path / "plans.pkl"), str(tmp_path / "wire.npy")
    sched.save_plans(path, pc)
    env = dict(os.environ, PYTHONPATH=str(SRC))
    code = _REPLAY.format(tests=str(Path(__file__).parent), path=path, out=out)
    res = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert json.loads(res.stdout.strip().splitlines()[-1]) == \
        {"loaded": 1, "hits": 1, "misses": 0}
    assert np.array_equal(np.load(out), wire_bytes(wire))


def test_resumed_zero1_step_replays_restored_plans(tmp_path):
    """The chip run's check at smoke size: a step from a restored state
    whose plans come from the checkpoint directory compiles nothing and
    gives the live step's loss and bits."""
    cfg = configs.get_smoke("smollm_135m")
    tcfg = step_lib.TrainConfig(loss_chunk=16, policy=CompressionPolicy(min_bytes=0))
    batch = {k: torch.from_numpy(np.random.default_rng(4).integers(0, cfg.vocab, (2, 16)))
             for k in ("tokens", "labels")}
    mgr = CheckpointManager(str(tmp_path))
    with launch_train.single_process_group("cpu") as group, launch_train.deterministic():
        states, losses = [], []
        for restore in (False, True):
            state = step_lib.build_train_state(
                cfg, tcfg, generator=torch.Generator().manual_seed(0), group=group,
                device="cpu")
            pc = sched.PlanCache()
            if restore:
                assert mgr.restore_plans(pc, device="cpu") == 1
            plan = step_lib.zero1_plan(state, tcfg, group, cache=pc)
            m = step_lib.train_step(state, batch, tcfg, group=group, plan=plan)
            if not restore:
                mgr.save_plans(pc)
            else:
                assert (pc.stats.misses, pc.stats.hits) == (0, 1)
            states.append(state)
            losses.append(float(m["loss"]))
    assert losses[0] == losses[1]
    assert bits_equal(states[0].model.tree(), states[1].model.tree())

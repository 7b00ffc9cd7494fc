"""The port's checkpoints (``repro_torch.checkpoint.CheckpointManager``)
held against the reference's (``repro.checkpoint.manager``):

  * round trips of f32, f16, bf16, both fp8 formats and int32 tensors (every
    bit pattern, NaN payloads included), numpy leaves and nested sequences;
  * a file whose sha256 differs from the manifest's raises ``IOError``;
  * ``keep`` retention, a save through ``.tmp`` (a stale ``.tmp`` is no
    step), ``latest_step``, ``available_steps``, ``save_async``/``wait``;
  * the on-disk layout is the reference's: a checkpoint written by the
    reference restores bit-identically in the port (but its float8_e5m2
    leaves, which numpy cannot load back in either package), and one written
    by the port in the reference, every format included, with the same file
    names, shapes and dtype names in the manifest.

The port restores on the CPU here (``device="cpu"``).  Tolerance: none.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JCheckpointManager
from repro_torch.checkpoint import CheckpointManager
from repro_torch.tree_util import tree_leaves
from torch_port_util import FORMATS, np_of, random_bits, to_jax, to_torch


def state_np(seed=0) -> dict:
    """A checkpointable state: every codec float format (random bit patterns:
    NaN payloads, infinities, subnormals), int32, a nested list, and the
    numpy int64 counters of ``VersionedStore.state_dict``."""
    params = {fmt: random_bits(fmt, 37 + i, seed + i).reshape(-1, 1)
              for i, fmt in enumerate(FORMATS)}
    rng = np.random.default_rng(seed)
    return {"params": params, "step": rng.integers(-2**31, 2**31, (3, 4)).astype(np.int32),
            "blocks": [rng.integers(0, 9, 5).astype(np.int32),
                       rng.integers(0, 9, ()).astype(np.int32)],
            "version": np.asarray(5, np.int64), "epoch": np.asarray(2, np.int64)}


def port_state(s):
    return {"params": {f: to_torch(b, f) for f, b in s["params"].items()},
            "step": torch.from_numpy(s["step"].copy()),
            "blocks": [torch.from_numpy(b.copy()) for b in s["blocks"]],
            "version": s["version"], "epoch": s["epoch"]}


def ref_state(s):
    return {"params": {f: to_jax(b, f) for f, b in s["params"].items()},
            "step": jnp.asarray(s["step"]), "blocks": [jnp.asarray(b) for b in s["blocks"]],
            "version": s["version"], "epoch": s["epoch"]}


def leaf_bits(tree, leaves=tree_leaves):
    return [(tuple(np.shape(leaf)), np_of(leaf).tobytes()) for leaf in leaves(tree)]


def test_round_trip_every_format(tmp_path):
    s = state_np()
    state = port_state(s)
    mgr = CheckpointManager(str(tmp_path))
    path = mgr.save(3, state)
    assert os.path.basename(path) == "step_00000003" and mgr.latest_step() == 3
    got, step = mgr.restore(state, device="cpu")
    assert step == 3
    assert [t.dtype for t in tree_leaves(got)] == [
        torch.int32, torch.int32, torch.int64, torch.bfloat16, torch.float16, torch.float32,
        torch.float8_e4m3fn, torch.float8_e5m2, torch.int32, torch.int64]
    assert leaf_bits(got) == leaf_bits(state)
    assert all(t.device.type == "cpu" for t in tree_leaves(got))
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["files"]["params/bfloat16"]["dtype"] == "bfloat16"
    assert manifest["files"]["blocks/1"]["shape"] == []
    assert manifest["files"]["params/float8_e5m2"]["file"] == "params__float8_e5m2.npy"


def test_checksum_mismatch_raises(tmp_path):
    state = port_state(state_np())
    mgr = CheckpointManager(str(tmp_path))
    path = mgr.save(1, state)
    f = os.path.join(path, "params__bfloat16.npy")
    raw = bytearray(open(f, "rb").read())
    raw[-1] ^= 0x10
    open(f, "wb").write(bytes(raw))
    with pytest.raises(IOError, match="checksum mismatch for params/bfloat16"):
        mgr.restore(state, device="cpu")
    got, _ = mgr.restore(state, device="cpu", verify=False)  # unchecked: the flipped bit
    assert leaf_bits(got) != leaf_bits(state)
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(state, device="cpu")


def test_keep_retention_tmp_atomicity_and_async(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    states = [port_state(state_np(seed)) for seed in range(4)]
    os.makedirs(tmp_path / "step_00000009.tmp")  # a save that never finished
    for step, s in enumerate(states):
        mgr.save(step, s)
    assert mgr.available_steps() == (3, 2) and mgr.latest_step() == 3
    assert sorted(os.listdir(tmp_path)) == ["latest", "step_00000002", "step_00000003",
                                            "step_00000009.tmp"]
    got, step = mgr.restore(states[0], step=2, device="cpu")
    assert step == 2 and leaf_bits(got) == leaf_bits(states[2])
    mgr.save_async(7, states[1])
    mgr.wait()
    assert mgr.available_steps() == (7, 3) and not os.path.exists(
        tmp_path / "step_00000007.tmp")
    assert leaf_bits(mgr.restore(states[1], device="cpu")[0]) == leaf_bits(states[1])
    os.makedirs(tmp_path / "step_00000008.tmp")
    open(tmp_path / "step_00000008.tmp" / "x", "w").close()
    mgr.save(8, states[3])  # a stale .tmp of the same step is replaced
    assert mgr.latest_step() == 8 and mgr.available_steps() == (8, 7)
    bad = CheckpointManager(str(tmp_path / "f"))
    open(tmp_path / "f" / "step_00000001.tmp", "w").close()  # a file where the dir goes
    bad.save_async(1, states[0])
    with pytest.raises(OSError):
        bad.wait()
    bad.wait()  # the error is raised once


def test_restore_defaults_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("the refusal without a GPU; the card's restore is a gpu test")
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"x": torch.zeros(1)})
    with pytest.raises(RuntimeError, match="cuda"):
        mgr.restore({"x": torch.zeros(1)})


def test_reference_checkpoint_restores_in_the_port_and_back(tmp_path):
    s = state_np(11)
    jmgr, mgr = JCheckpointManager(str(tmp_path / "ref")), CheckpointManager(
        str(tmp_path / "port"))
    jmgr.save(4, ref_state(s))
    mgr.save(4, port_state(s))
    jman = json.load(open(tmp_path / "ref" / "step_00000004" / "manifest.json"))
    man = json.load(open(tmp_path / "port" / "step_00000004" / "manifest.json"))
    assert {k: (v["file"], v["shape"], v["dtype"]) for k, v in man["files"].items()} == {
        k: (v["file"], v["shape"], v["dtype"]) for k, v in jman["files"].items()}
    # the reference's files, in the port.  numpy writes the reference's
    # float8_e5m2 leaf under the descriptor '<f1', which np.load refuses in
    # either package; every other leaf restores bit for bit
    like = port_state(s)
    e5m2 = like["params"].pop("float8_e5m2")
    got, step = CheckpointManager(str(tmp_path / "ref")).restore(like, device="cpu")
    assert step == 4 and leaf_bits(got) == leaf_bits(like)
    with pytest.raises(ValueError, match="'<f1'"):
        CheckpointManager(str(tmp_path / "ref")).restore({"params": {"float8_e5m2": e5m2}},
                                                          device="cpu")
    with pytest.raises(ValueError, match="'<f1'"):
        JCheckpointManager(str(tmp_path / "ref")).restore(ref_state(s))
    # the port's files, in the reference
    jgot, jstep = JCheckpointManager(str(tmp_path / "port")).restore(ref_state(s))
    assert jstep == 4
    # (JAX without x64 holds the int64 counters as int32: compared by value)
    assert (int(jgot.pop("version")), int(jgot.pop("epoch"))) == (5, 2)
    want = port_state(s)
    del want["version"], want["epoch"]
    assert leaf_bits(jgot, jax.tree_util.tree_leaves) == leaf_bits(want)
    assert [str(a.dtype) for a in jax.tree_util.tree_leaves(jgot)] == [
        str(t.dtype).removeprefix("torch.") for t in tree_leaves(want)]

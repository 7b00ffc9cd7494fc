"""One compressed FSDP step of whisper SMOKE (the encoder's leaves
gathered once with the top-level leaves) and of jamba SMOKE cut to (Mamba
+ SwiGLU, attention + SwiGLU) (an f32 leaf sharded beside bf16 ones)
against the reference's (``build_train_step`` at ``partition="fsdp"``, one
rank, every leaf sharded: ``fsdp_min_bytes=0``), from the reference's
state carried across by ``load_reference_fsdp_state``.  Apart from
``test_torch_zoo_mixers_train`` because the reference compiles each FSDP
step for ~40 s on the CPU.  Tolerances: ``test_torch_zoo_mixers_train``'s
for a whole step.
"""
import pytest
import torch

from repro_torch.launch import train as launch_train
from repro_torch.sched.cache import PlanCache
from repro_torch.train import step as step_lib
from test_torch_zoo_mixers_train import JAMBA_STEP, _batches, _cfgs, _holds_f32_update
from test_torch_zoo_train import _holds_step, _reference_step, _tcfgs


@pytest.mark.parametrize("arch", ["jamba_v0_1_52b", "whisper_small"])
def test_fsdp_step_matches_reference(arch):
    """jamba cut (:func:`_cfgs`), whisper SMOKE."""
    jcfg, cfg = _cfgs(arch, cut=arch.startswith("jamba"))
    tcfg, jtcfg = _tcfgs("fsdp")
    jb, b = _batches(jcfg, cfg)
    tree, jnew, jm = _reference_step(jcfg, jtcfg, jb)
    state = step_lib.load_reference_fsdp_state(tree, cfg, tcfg, device="cpu")
    assert {t.dtype for t in state.model.leaves()} == (
        {torch.bfloat16, torch.float32} if arch.startswith("jamba") else {torch.bfloat16})
    f32 = {k: t.detach().clone() for k, t in state.model.params.items()
           if t.dtype == torch.float32}
    with launch_train.single_process_group("cpu") as g, launch_train.deterministic():
        m = step_lib.fsdp_train_step(state, b, tcfg, group=g, cache=PlanCache())
    _holds_step(state, m, jnew, jm, tcfg, **(JAMBA_STEP if arch.startswith("jamba") else {}))
    if f32:
        _holds_f32_update(state, f32, jnew, tcfg)

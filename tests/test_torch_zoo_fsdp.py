"""One compressed FSDP step of the dense zoo's new layouts against the
reference's (``build_train_step`` at ``partition="fsdp"``, one rank, every
leaf sharded: ``fsdp_min_bytes=0``), from the reference's state carried
across by ``load_reference_fsdp_state``: gemma3 SMOKE (its prefix layer
gathered once with the top-level leaves, tied embeddings) and qwen2-vl
SMOKE (vision embeddings in the batch).  Apart from
``test_torch_zoo_train`` because the reference compiles its FSDP step for
20-50 s on the CPU.  Tolerances: ``test_torch_zoo_train``'s for a whole
step.
"""
import pytest

from repro_torch.launch import train as launch_train
from repro_torch.sched.cache import PlanCache
from repro_torch.train import step as step_lib
from test_torch_zoo_train import ARCHS, _batches, _cfgs, _holds_step, _reference_step, _tcfgs


@pytest.mark.parametrize("arch", ARCHS)
def test_fsdp_step_matches_reference(arch):
    jcfg, cfg = _cfgs(arch)
    tcfg, jtcfg = _tcfgs("fsdp")
    jb, b = _batches(jcfg, cfg)
    tree, jnew, jm = _reference_step(jcfg, jtcfg, jb)
    state = step_lib.load_reference_fsdp_state(tree, cfg, tcfg, device="cpu")
    with launch_train.single_process_group("cpu") as g, launch_train.deterministic():
        m = step_lib.fsdp_train_step(state, b, tcfg, group=g, cache=PlanCache())
    _holds_step(state, m, jnew, jm, tcfg)

"""The dry run's inputs (``launch/dryrun.input_specs``) against the
reference's: for every live cell of ``launch/cells`` at both production
meshes, (16, 16) and (2, 16, 16), each input leaf's per-device shape (the
port's ``local_shapes`` on an ``AbstractMesh``) equals the reference's
``sharding.shard_shape(shape)`` of the same leaf of its ``input_specs``,
in leaf order, argument by argument.  The reference runs in one
subprocess a mesh on 512 forced host devices (importing
``repro.launch.dryrun`` first sets the flag); nothing is lowered or
compiled.

Tolerances: none; shapes are compared exactly."""
import json
import os
import subprocess
import sys

import pytest

from repro_torch.launch import cells, dryrun
from repro_torch.launch import mesh as mesh_lib

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}
LIVE = [(c.arch, c.shape.name) for c in cells.live_cells()]


def reference_shard_shapes(kind: str, out: str) -> None:
    """The reference's per-device input shapes of every live cell on the
    production mesh of ``kind``, as JSON ``{"arch/shape": [[shape, ...] an
    argument, ...]}`` at ``out``.  Its ``abstract_params`` is cached per
    config (it traces the whole init each call)."""
    import functools

    from repro.launch import dryrun as jdryrun  # sets the 512-device flag first

    import jax

    from repro.launch import cells as jcells
    from repro.launch.mesh import make_production_mesh
    from repro.models import transformer as jtransformer

    jtransformer.abstract_params = functools.lru_cache(maxsize=None)(
        jtransformer.abstract_params)
    mesh = make_production_mesh(multi_pod=kind == "multi")
    res = {}
    for c in jcells.live_cells():
        args = jdryrun.input_specs(c.arch, c.shape.name, mesh)
        res[f"{c.arch}/{c.shape.name}"] = [
            [list(leaf.sharding.shard_shape(leaf.shape)) for leaf in jax.tree_util.tree_leaves(a)]
            for a in args]
    with open(out, "w") as f:
        json.dump(res, f)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
        [os.path.join(os.path.dirname(here), "src"), here, os.environ.get("PYTHONPATH", "")]))
    env.pop("XLA_FLAGS", None)
    d = tmp_path_factory.mktemp("dryrun_specs")
    procs = {kind: subprocess.Popen(
        [sys.executable, "-c", f"import test_torch_dryrun_specs as t; "
         f"t.reference_shard_shapes({kind!r}, {str(d / kind)!r})"],
        env=env, stderr=subprocess.PIPE, text=True) for kind in MESHES}
    out = {}
    for kind, p in procs.items():
        _, err = p.communicate(timeout=600)
        assert p.returncode == 0, err[-3000:]
        with open(d / kind) as f:
            out[kind] = json.load(f)
    return out


def test_the_live_cells_are_the_reference_s(reference):
    for kind in MESHES:
        assert sorted(reference[kind]) == sorted(f"{a}/{s}" for a, s in LIVE)


@pytest.mark.parametrize("kind", MESHES)
@pytest.mark.parametrize("arch,shape", LIVE)
def test_per_device_input_shapes_equal_the_reference_s(reference, arch, shape, kind):
    mesh = mesh_lib.AbstractMesh(*MESHES[kind])
    got = [[list(s) for s in dryrun.local_shapes(a, mesh)]
           for a in dryrun.input_specs(arch, shape, mesh)]
    assert got == reference[kind][f"{arch}/{shape}"]


# -- the repairs the dry run needed -------------------------------------------

def test_aligned_returns_a_cpu_tensor_as_it_is():
    """Only a CUDA kernel stages by 16-byte copies: a CPU view off a
    16-byte boundary, real or fake, is handed on unchanged (a fake tensor
    has no address to read)."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch import kernels

    view = torch.zeros(10)[1:]
    assert view.data_ptr() % kernels.ALIGN and kernels.aligned(view) is view
    with FakeTensorMode():
        fake = torch.zeros(10)[1:]
        assert kernels.is_fake(fake) and kernels.aligned(fake) is fake
    assert not kernels.is_fake(view)


def test_host_int_reads_a_real_scalar_under_a_fake_mode():
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch import kernels

    pos = torch.tensor(41, dtype=torch.int32)
    assert kernels.host_int(pos) == 41
    with FakeTensorMode(allow_non_fake_inputs=True):
        assert kernels.host_int(pos) == 41
        with pytest.raises(ValueError, match="fake"):
            kernels.host_int(torch.zeros((), dtype=torch.int32))


def test_cli_mesh_runs_on_the_card_unless_asked(monkeypatch):
    """``cli_mesh`` defaults to the card, as every other entry point of the
    port: without one it raises, and the CPU is taken only when asked."""
    import inspect

    import torch
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch import train as launch_train

    assert inspect.signature(launch_train.cli_mesh).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=1)
    try:
        with pytest.raises(RuntimeError, match="cuda"):
            launch_train.cli_mesh(1)
        assert mesh_lib.axis_sizes(launch_train.cli_mesh(1, device="cpu")) == {
            "data": 1, "model": 1}
    finally:
        dist.destroy_process_group()

"""ZeRO-1 over a (pod 2, data 2, model 1) mesh: the reference on 4 forced
host devices (one subprocess), the port on 4 gloo ranks.

* the shared cases (``torch_mesh_cases``): the ranks' pod-major DP index,
  the reduce-scattered f32 gradient shards bit for bit (fused, unfused,
  raw), one step from the reference's state at the one-device test's
  tolerances, compressed and raw twins identical (the port's through the
  launcher on the mesh);
* the checkpoint is interchangeable with the reference's (shared
  cases): its step-1 checkpoint, restored with ``restore(shardings=)``
  through ``ElasticController.rescale``, gives each rank the reference's
  rows and parameters bit for bit; the port's own 4-rank save of that
  state is the reference's checkpoint; restored either way, each rank's
  leaves hold only its own rows; a restore at 2 ranks raises
  ``ValueError``;
* the launcher's CLI under ``torchrun`` at 4 ranks with ``--pods 2``: the
  reference's smoke mesh (pod, data, model) = (2, 1, 2), tensor parallel
  over 'model'.

Tolerances: as ``torch_mesh_cases`` states."""
import os
import re
import subprocess
import sys

import pytest

from torch_mesh_cases import (test_compressed_and_raw_twins_are_identical,  # noqa: F401
                              test_port_checkpoint_is_the_reference_s,
                              test_ranks_take_the_pod_major_dp_index,
                              test_reduce_scatter_shards_equal_the_reference,
                              test_reference_checkpoint_restores_its_rows_on_every_rank,
                              test_restored_leaves_hold_only_this_rank_s_part,
                              test_step_from_the_reference_state_matches_it)
from torch_port_util import mesh_rank, mesh_restore_refused, run_gloo_ranks, run_mesh_reference

KIND = "zero1"


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    ref_dir = tmp_path_factory.mktemp(f"{KIND}_ref")
    ref = run_mesh_reference(KIND, ref_dir)
    ranks = run_gloo_ranks(mesh_rank, 4, tmp_path_factory.mktemp(f"{KIND}_ranks"), KIND,
                           str(ref_dir), timeout=400)
    return KIND, ref, ranks, ref_dir


def test_restore_at_another_dp_size_raises(mesh_run, tmp_path):
    _, _, _, ref_dir = mesh_run
    for res in run_gloo_ranks(mesh_restore_refused, 2, tmp_path, str(ref_dir / "port_ckpt")):
        msg = str(res["msg"])
        assert "is stored as (4," in msg and "the state holds (2," in msg, msg


def test_launcher_cli_runs_on_a_pod_mesh_under_torchrun(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"),
         os.environ.get("PYTHONPATH", "")]))
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "4",
         "-m", "repro_torch.launch.train", "--arch", "smollm_135m", "--smoke", "--steps", "2",
         "--batch", "8", "--seq", "32", "--device", "cpu", "--pods", "2",
         "--ckpt-dir", str(tmp_path / "ck")],
        env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    # the ranks' lines interleave: each writes one final line
    finals = re.findall(r"final loss \S+ \| [^\n]*?\| mesh=\{[^}]*\}", res.stdout)
    assert len(finals) == 4 and len(set(finals)) == 1, res.stdout[-2000:]
    # ZeRO-1 runs on the reference's smoke mesh: 4 ranks in 2 pods are (2, 1, 2)
    assert finals[0].endswith("mesh={'pod': 2, 'data': 1, 'model': 2}")

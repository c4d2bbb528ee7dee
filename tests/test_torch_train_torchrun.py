"""The training launcher under ``torchrun`` on the CPU: two ``gloo`` ranks
(``python -m torch.distributed.run --standalone``, a free local port)
train the reduced qwen3-0.6b data-parallel on a 4 x 2 mesh, each rank
holding two whole nodes; node 2 (rank 1's) fails at step 6 and is
recovered from the replica logs. Both ranks reach the last step and
print the same losses."""

import os
import re
import subprocess
import sys

import numpy as np

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def test_launcher_under_torchrun_on_two_gloo_ranks(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC),
               OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
           "--arch", "qwen3-0.6b", "--reduced", "--steps", "11",
           "--mesh", "4x2", "--seq-len", "32", "--global-batch", "8",
           "--fail-node", "2", "--fail-step", "6",
           "--workdir", str(tmp_path / "run"), "--device", "cpu"]
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True,
                          timeout=240)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    out = proc.stdout
    losses = {}
    for rank, step, loss in re.findall(
            r"rank (\d)/2: step +(\d+) loss (\S+)", out):
        losses.setdefault(int(rank), {})[int(step)] = float(loss)
    assert set(losses) == {0, 1} and set(losses[0]) == {0, 10}
    assert losses[0] == losses[1]
    assert all(np.isfinite(list(losses[0].values())))
    for rank in (0, 1):
        assert f"rank {rank}/2: training qwen3-0.6b-reduced" in out
        assert "2 ranks (gloo)" in out
        rec = [line for line in out.splitlines()
               if line.startswith(f"rank {rank}/2: event:")
               and "'recovery'" in line]
        assert len(rec) == 1 and "'unrecoverable': 0" in rec[0]
        assert "'cm_rank': 0" in rec[0]
    assert sorted(os.listdir(tmp_path / "run")) == ["rank00000",
                                                    "rank00001"]

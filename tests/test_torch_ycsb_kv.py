"""The port's YCSB key-value demo against the JAX package's.

``examples/ycsb_kv.py`` (JAX, on the CPU) and its twin
``repro_torch.examples.ycsb_kv --device cpu`` run in two subprocesses
side by side. Both draw the same ``default_rng(0)`` operation stream,
so every printed line must be equal: the dumps, the failure, the
recovered record count and its exact match, the read / write counts and
the zero Logging Unit drops. Each asserts its own exact recovery and
zero drops and must exit 0.
"""

import os
import subprocess
import sys

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def test_twin_prints_what_the_jax_example_prints():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    cmds = {"jax": [sys.executable, os.path.join(ROOT, "examples",
                                                 "ycsb_kv.py")],
            "port": [sys.executable, "-m", "repro_torch.examples.ycsb_kv",
                     "--device", "cpu"]}
    procs = {k: subprocess.Popen(c, env=env, cwd=ROOT, text=True,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE)
             for k, c in cmds.items()}
    out = {k: p.communicate(timeout=300) for k, p in procs.items()}
    for k, p in procs.items():
        assert p.returncode == 0, (k, out[k][1][-2000:])
    jax_lines = out["jax"][0].splitlines()
    assert out["port"][0].splitlines() == jax_lines
    assert any("exact match: True" in line for line in jax_lines)
    assert "logging-unit drops: 0 (must be 0)" in jax_lines

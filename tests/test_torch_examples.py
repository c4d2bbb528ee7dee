"""The 100M fault-tolerant training example's twin against the JAX
package's ``examples/train_100m_ft.py``.

The example's run (``make_run``: the (4, 2) data x model mesh, proactive,
N_r 2, 8 buckets, log capacity 2, lr 6e-4, warmup ``steps // 20``) with
``MODEL_100M`` narrowed by ``dataclasses.replace`` to 2 layers of width
64 in f32, on both sides: the JAX ``Trainer`` with the JAX example's
model and run fields on the 8-device host mesh, the port's through the
example's own ``make_run`` / ``make_trainer`` on logical nodes from the
JAX trainer's initial weights (``params_from_jax``). The JAX trainer's
step is jitted without donating its state (see ``jax_run``). Four steps of
losses agree at the trainer parity tests' rel 1e-4
(``test_torch_train.py::test_train_steps_match_jax``). In the example's
bf16, a failure of node 1 at step 2 is recovered from the replica logs
and leaves parameters ``==`` an unfailed run's (the logs are bf16, so
f32 weights would not come back whole); ``main`` runs on the CPU.
"""

import dataclasses
import importlib.util
import os
import shutil
import tempfile

import jax
import numpy as np
import pytest
import torch

from repro.config import MeshConfig as JMesh
from repro.config import ReplicationConfig as JRep
from repro.config import RunConfig as JRun
from repro.config import ShapeConfig as JShape
from repro.config import TrainConfig as JTrain
from repro.core.failures import FailureInjector as JInjector
from repro.training.steps import make_train_step as jax_make_train_step
from repro.training.trainer import Trainer as JTrainer
from repro_torch.examples import train_100m_ft as ex
from repro_torch.models.model_zoo import params_from_jax
from repro_torch.optim.optimizers import tree_leaves
from repro_torch.training.steps import init_train_state

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
STEPS, SEQ, BATCH = 4, 32, 8
NARROW = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
              vocab_size=512, head_dim=16, dtype="float32")


def _jax_example():
    spec = importlib.util.spec_from_file_location(
        "jax_train_100m_ft", os.path.join(ROOT, "examples",
                                          "train_100m_ft.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def workdir():
    d = tempfile.mkdtemp()
    yield d
    shutil.rmtree(d, ignore_errors=True)


def test_model_100m_is_the_jax_example_model():
    jmodel = _jax_example().MODEL_100M
    assert dataclasses.asdict(ex.MODEL_100M) == dataclasses.asdict(jmodel)
    assert 90e6 < ex.MODEL_100M.param_count() < 110e6


def _port_trainer(workdir, fail_step, jparams):
    model = dataclasses.replace(ex.MODEL_100M, **NARROW)
    run = ex.make_run(STEPS, SEQ, BATCH, model=model)
    tr = ex.make_trainer(run, workdir, fail_step, device="cpu")
    tr.state = init_train_state(
        run, tr.model, run.train.seed, tr.engine,
        params=params_from_jax(model, jax.tree.map(np.asarray, jparams),
                               device="cpu"))
    return tr


@pytest.fixture(scope="module")
def jax_run(mesh8):
    """The JAX example's wiring at the narrowed width: its model and run
    fields, an unfailed run of ``STEPS`` steps."""
    model = dataclasses.replace(_jax_example().MODEL_100M, **NARROW)
    run = JRun(
        model=model,
        shape=JShape("train", seq_len=SEQ, global_batch=BATCH, kind="train"),
        mesh=JMesh((4, 2), ("data", "model")),
        replication=JRep(variant="proactive", n_replicas=2, n_buckets=8,
                         dump_interval=50, log_capacity=2),
        train=JTrain(total_steps=STEPS, warmup_steps=max(STEPS // 20, 1),
                     learning_rate=6e-4))
    d = tempfile.mkdtemp()
    try:
        tr = JTrainer(run, mesh8, d, injector=JInjector([]))
        # the JAX Trainer donates its state to the jitted step; with f32
        # weights the optimizer's f32 master copy is the weight buffer
        # itself, and XLA refuses to donate one buffer twice. The same
        # step, jitted without donation:
        tr._step_fn = jax.jit(jax_make_train_step(run, tr.model, tr.engine))
        params0 = jax.tree.map(np.asarray, tr.state.params)
        hist = tr.train(STEPS)
        tr.ckpt.wait()
    finally:
        shutil.rmtree(d, ignore_errors=True)
    return params0, [h["loss"] for h in hist], run


def test_run_config_is_the_jax_examples(jax_run):
    _, _, jrun = jax_run
    run = ex.make_run(STEPS, SEQ, BATCH,
                      model=dataclasses.replace(ex.MODEL_100M, **NARROW))
    for f in ("shape", "mesh", "replication", "train"):
        assert dataclasses.asdict(getattr(run, f)) == \
            dataclasses.asdict(getattr(jrun, f)), f


def test_losses_match_the_jax_example(jax_run, workdir):
    params0, jlosses, _ = jax_run
    tr = _port_trainer(workdir, fail_step=STEPS + 1, jparams=params0)
    losses = [h["loss"] for h in tr.train(STEPS)]
    tr.ckpt.wait()
    assert len(losses) == len(jlosses) == STEPS
    for i, (a, b) in enumerate(zip(losses, jlosses)):
        assert a == pytest.approx(b, rel=1e-4), i


def test_failure_at_step_2_recovered_exactly(workdir):
    """In the example's own dtype (bf16 weights and logs), node 1 failing
    at step 2 is recovered from the replica logs: every bucket from a
    replica, and the parameters after four steps ``==`` an unfailed
    run's."""
    run = ex.make_run(STEPS, SEQ, BATCH, model=dataclasses.replace(
        ex.MODEL_100M, **{k: v for k, v in NARROW.items() if k != "dtype"}))
    clean = ex.make_trainer(run, workdir + "/a", STEPS + 1, device="cpu")
    failed = ex.make_trainer(run, workdir + "/b", 2, device="cpu")
    for t in (clean, failed):
        t.train(STEPS)
        t.ckpt.wait()
    rec = [e for e in failed.events if e["event"] == "recovery"]
    assert len(rec) == 1 and rec[0]["step"] == 2
    assert rec[0]["recovered"] == ex.FAIL_NODE
    assert rec[0]["stats"]["unrecoverable"] == 0
    assert rec[0]["stats"]["recovered_from_replicas"] == 8
    for a, b in zip(tree_leaves(clean.state.params),
                    tree_leaves(failed.state.params)):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)


def test_main_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(ex, "MODEL_100M",
                        dataclasses.replace(ex.MODEL_100M, **NARROW))
    ex.main(["--steps", "6", "--seq-len", str(SEQ), "--batch", str(BATCH),
             "--device", "cpu"])
    out = capsys.readouterr().out
    assert "qwen3-100m" in out and "on cpu" in out
    assert "'event': 'fail'" in out and "'node': 1" in out
    assert "'event': 'recovery'" in out and "'unrecoverable': 0" in out
    assert "step    0  loss" in out

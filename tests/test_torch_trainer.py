"""The port's fault-tolerant trainer on logical nodes: twins of
``tests/test_system.py``.

Each test of the JAX package's system tests runs here on a (data 4,
model 2) ``MeshContext`` of logical nodes on the CPU, with the same run
config: a fail-stop node mid-run recovered from the replica Logging
Units, recovered parameters ``==`` an unfailed run's, WB's data loss,
checkpoint restart, the variants' losses, stragglers and sequential
failures. Where the JAX test allows the replicating variants to differ
from WB by XLA's fusion choices (atol 5e-4), eager torch runs every
variant's arithmetic in the same order: all four give ``==`` losses.
The launcher and the quickstart run on the CPU too.
"""

import shutil
import tempfile

import numpy as np
import pytest
import torch

from repro_torch import config as TC
from repro_torch.core.failures import FailureEvent, FailureInjector
from repro_torch.distributed.context import make_context
from repro_torch.examples import quickstart
from repro_torch.launch import train as train_launcher
from repro_torch.optim.optimizers import tree_leaves
from repro_torch.training.trainer import Trainer

SMOKE = TC.ShapeConfig("smoke", seq_len=32, global_batch=8, kind="train")


def _run_cfg(variant="proactive", **kw):
    return TC.RunConfig(
        model=TC.get_reduced_config("qwen3-0.6b"),
        shape=SMOKE,
        mesh=TC.MeshConfig((4, 2), ("data", "model")),
        replication=TC.ReplicationConfig(
            variant=variant, n_replicas=2, n_buckets=4, log_capacity=2,
            dump_interval=6, **kw),
        train=TC.TrainConfig(total_steps=30, warmup_steps=2,
                             learning_rate=1e-3),
    )


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """A step at this size is many small ops, fastest on one intra-op
    thread; one thread also keeps the step walls steady when test workers
    share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def ctx8():
    return make_context((4, 2), ("data", "model"), device="cpu")


@pytest.fixture
def workdir():
    d = tempfile.mkdtemp()
    yield d
    shutil.rmtree(d, ignore_errors=True)


def test_training_survives_node_failure(ctx8, workdir):
    """The paper's end-to-end claim: a fail-stop node mid-run, recovery
    from replica Logging Units, training continues with consistent state."""
    inj = FailureInjector([FailureEvent(step=8, node=2)])
    tr = Trainer(_run_cfg(), ctx8, workdir, injector=inj)
    hist = tr.train(16)
    events = {e["event"] for e in tr.events}
    assert "recovery" in events
    rec = next(e for e in tr.events if e["event"] == "recovery")
    assert rec["stats"]["unrecoverable"] == 0
    assert rec["stats"]["recovered_from_replicas"] > 0
    losses = [h["loss"] for h in hist]
    assert all(np.isfinite(losses))
    assert np.mean(losses[-4:]) < np.mean(losses[:4])
    for p in tree_leaves(tr.state.params):
        assert p.is_leaf and p.requires_grad


def test_recovery_state_identical_to_unfailed_run(ctx8, workdir):
    """With snapshot-mode logs the recovered params must BIT-match an
    identical run without failure."""
    cfg = _run_cfg()
    t1 = Trainer(cfg, ctx8, workdir + "/a")
    t1.train(10)
    truth = tree_leaves(t1.state.params)

    inj = FailureInjector([FailureEvent(step=5, node=1)])
    t2 = Trainer(cfg, ctx8, workdir + "/b", injector=inj)
    t2.train(10)
    assert any(e["event"] == "recovery" for e in t2.events)
    got = tree_leaves(t2.state.params)
    assert len(got) == len(truth)
    for a, b in zip(truth, got):
        assert torch.equal(a, b)


def test_installed_shard_equals_pre_failure_params(ctx8, workdir):
    """The shard installed on the spare is ``==`` the parameters the
    failed node held just before the failure, read from the replica logs
    only: node 3's blocks of the live state are overwritten with NaN
    first, as a fail-stop loses them."""
    from repro_torch.core.replication import tree_flatten
    from repro_torch.distributed.elastic import _block_slices
    tr = Trainer(_run_cfg(), ctx8, workdir)
    tr.train(4)
    before = [p.detach().clone() for p in tree_leaves(tr.state.params)]
    with torch.no_grad():
        for p, spec in zip(tree_leaves(tr.state.params),
                           tree_flatten(tr.specs)[0]):
            for m in range(2):
                p[_block_slices(tuple(p.shape), spec, ctx8,
                                {"data": 3, "model": m})] = float("nan")
    tr.detector.mark_failed(3)
    tr._recover(3, 4)
    rec = tr.events[-1]
    assert rec["event"] == "recovery" and rec["stats"]["unrecoverable"] == 0
    for a, b in zip(tree_leaves(tr.state.params), before):
        assert torch.equal(a, b)


def test_wb_crash_is_fatal(ctx8, workdir):
    """variant='none' (the paper's WB): node failure must be
    unrecoverable -- that is exactly the gap ReCXL closes."""
    inj = FailureInjector([FailureEvent(step=4, node=1)])
    tr = Trainer(_run_cfg(variant="none"), ctx8, workdir, injector=inj)
    with pytest.raises(RuntimeError, match="data loss|state is lost"):
        tr.train(8)


def test_checkpoint_restart(ctx8, workdir):
    cfg = _run_cfg()
    tr = Trainer(cfg, ctx8, workdir)
    tr.train(13)          # dumps at steps 5 and 11 (dump_interval=6)
    tr.ckpt.wait()
    step = tr.ckpt.latest_step()
    assert step == 11
    template = {"params": tr.state.params, "opt": tr.state.opt_state}
    restored, extra = tr.ckpt.restore(template)
    assert extra["pipeline_step"] >= step
    n = sum(x.numel() for x in tree_leaves(restored["params"]))
    assert n == sum(x.numel() for x in tree_leaves(tr.state.params))
    assert restored["opt"]["count"] == step + 1


def test_variants_agree_on_loss(ctx8, workdir):
    """Replication is off the numerical path: the three ReCXL variants
    give IDENTICAL losses, and in eager torch so does WB (the JAX test
    allows WB 5e-4 for XLA's fusion choices)."""
    losses = {}
    for variant in ("none", "baseline", "parallel", "proactive"):
        tr = Trainer(_run_cfg(variant=variant), ctx8,
                     workdir + "/" + variant)
        hist = tr.train(5)
        losses[variant] = np.array([h["loss"] for h in hist])
    np.testing.assert_array_equal(losses["baseline"], losses["parallel"])
    np.testing.assert_array_equal(losses["baseline"], losses["proactive"])
    np.testing.assert_array_equal(losses["none"], losses["proactive"])


def test_straggler_detection(ctx8, workdir):
    """A node delayed from step 10 on is flagged. The JAX test delays it
    0.5 s; here the delay is three times the slowest step seen so far
    (warm-up aside), so it stands out however busy the machine is."""
    tr = Trainer(_run_cfg(), ctx8, workdir)
    tr.monitor.factor = 2.0
    tr.monitor.window = 2
    walls = [h["wall_s"] for h in tr.train(10)]
    tr.injector = FailureInjector([FailureEvent(
        step=10, node=3, kind="straggler", delay_s=3 * max(walls[1:]))])
    tr.train(6)
    assert any(e["event"] == "straggler" for e in tr.events)


def test_multi_failure_sequential(ctx8, workdir):
    """Two failures at different steps, both recovered (N_r=2 tolerates
    one failure at a time; sequential failures re-replicate in between)."""
    inj = FailureInjector([FailureEvent(step=5, node=1),
                           FailureEvent(step=10, node=3)])
    tr = Trainer(_run_cfg(), ctx8, workdir, injector=inj)
    hist = tr.train(14)
    recs = [e for e in tr.events if e["event"] == "recovery"]
    assert len(recs) == 2
    assert all(r["stats"]["unrecoverable"] == 0 for r in recs)
    assert all(np.isfinite([h["loss"] for h in hist]))


def test_context_must_match_the_run_mesh(workdir):
    with pytest.raises(ValueError, match="mesh"):
        Trainer(_run_cfg(), make_context((2, 4), ("data", "model"),
                                         device="cpu"), workdir)


def test_train_launcher_on_the_cpu(capsys, workdir):
    train_launcher.main(["--arch", "qwen3-0.6b", "--reduced", "--steps",
                         "12", "--mesh", "4x2", "--fail-node", "2",
                         "--fail-step", "6", "--seq-len", "32",
                         "--global-batch", "8", "--dump-interval", "5",
                         "--workdir", workdir, "--device", "cpu"])
    out = capsys.readouterr().out
    assert "qwen3-0.6b-reduced" in out and "device cpu" in out
    assert "'event': 'recovery'" in out and "'unrecoverable': 0" in out
    assert "step    10 loss" in out


def test_quickstart_on_the_cpu(capsys):
    quickstart.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "'event': 'recovery'" in out and "'unrecoverable': 0" in out
    assert "step  30" in out

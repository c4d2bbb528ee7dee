"""The port's data pipeline and checkpoint manager against the JAX
package's, and the conversions of weights and optimizer state.

The pipeline is numpy on both sides, so its batches are held ``==`` the
JAX package's for the same ``(seed, step)``: 20 steps, after ``seek``
and with the prefetch thread, for every reduced arch (a bf16 stub input
comes from the port as f32 holding the bf16 values). The checkpoint
manager round-trips a bf16 tree bit for bit (its ``uint16`` view),
saves async, keeps ``keep`` steps, and ignores a dump whose manifest was
never written. Twins of ``tests/test_substrates.py``'s pipeline and
checkpoint tests follow.
"""

import json
import os
import shutil
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
from repro.config import ShapeConfig as JShape
from repro.config import TrainConfig as JTrain
from repro.data import SyntheticTokenPipeline as JPipeline
from repro.models import build_model as jax_build_model
from repro.optim import make_optimizer as jax_make_optimizer
from repro_torch import config as TC
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import SyntheticTokenPipeline
from repro_torch.models.model_zoo import (opt_state_from_jax,
                                          params_from_jax, params_to_numpy)
from repro_torch.optim import make_optimizer
from repro_torch.optim.optimizers import tree_leaves

ARCHS = ("qwen3-0.6b", "hymba-1.5b", "moonshot-v1-16b-a3b",
         "whisper-medium", "internvl2-26b")


def _pipes(arch, seed=7, seq=24, batch=3):
    jp = JPipeline(repro.get_reduced_config(arch),
                   JShape("t", seq_len=seq, global_batch=batch, kind="train"),
                   seed=seed)
    tp = SyntheticTokenPipeline(
        TC.get_reduced_config(arch),
        TC.ShapeConfig("t", seq_len=seq, global_batch=batch, kind="train"),
        seed=seed)
    return jp, tp


def _same(tb, jb, what):
    assert tb.keys() == jb.keys(), what
    for k in jb:
        want = np.asarray(jb[k])
        if want.dtype.name == "bfloat16":
            want = want.astype(np.float32)
        assert tb[k].dtype == want.dtype, (what, k)
        assert np.array_equal(tb[k], want), (what, k)


@pytest.mark.parametrize("arch", ARCHS)
def test_batches_equal_jax(arch):
    jp, tp = _pipes(arch)
    for step in range(20):
        _same(tp.next(), jp.next(), f"step {step}")
    jp.seek(5)
    tp.seek(5)
    for step in range(5, 8):
        _same(tp.next(), jp.next(), f"after seek, step {step}")


def test_prefetch_thread_batches_equal_jax():
    jp, tp = _pipes("qwen3-0.6b", seed=3)
    tp.start()
    try:
        for step in range(6):
            _same(tp.next(), jp.next(), f"prefetched step {step}")
        tp.seek(2)
        jp.seek(2)
        _same(tp.next(), jp.next(), "prefetched after seek")
    finally:
        tp.stop()


# ---------------------------------------------------------------------------
# Twins of tests/test_substrates.py (pipeline)
# ---------------------------------------------------------------------------

def test_pipeline_deterministic_and_resumable():
    cfg = TC.get_reduced_config("qwen3-0.6b")
    shape = TC.ShapeConfig("t", seq_len=16, global_batch=2, kind="train")
    p1 = SyntheticTokenPipeline(cfg, shape, seed=7)
    batches = [p1.next() for _ in range(5)]
    p2 = SyntheticTokenPipeline(cfg, shape, seed=7)
    p2.seek(3)
    b3 = p2.next()
    np.testing.assert_array_equal(b3["tokens"], batches[3]["tokens"])
    # labels are next-token shifted
    np.testing.assert_array_equal(batches[0]["labels"][:, :-1],
                                  batches[0]["tokens"][:, 1:])


def test_pipeline_prefetch_thread():
    cfg = TC.get_reduced_config("qwen3-0.6b")
    shape = TC.ShapeConfig("t", seq_len=16, global_batch=2, kind="train")
    p = SyntheticTokenPipeline(cfg, shape, seed=0)
    p.start()
    try:
        a = p.next()
        b = p.next()
        assert a["tokens"].shape == (2, 16)
        assert not np.array_equal(a["tokens"], b["tokens"])
    finally:
        p.stop()


# ---------------------------------------------------------------------------
# Checkpoint manager (MN tier)
# ---------------------------------------------------------------------------

@pytest.fixture
def ckdir():
    d = tempfile.mkdtemp()
    yield d
    shutil.rmtree(d, ignore_errors=True)


def _bf16_tree():
    g = torch.Generator().manual_seed(0)
    return {"params": {"embed": {"tok": torch.randn(6, 4, generator=g)
                                 .to(torch.bfloat16)},
                       "layers": [{"w": torch.randn(3, 5, generator=g)
                                   .to(torch.bfloat16)} for _ in range(2)]},
            "opt": {"m": torch.randn(7, generator=g), "count": 4}}


def test_checkpoint_roundtrip_bf16_bit_exact(ckdir):
    mgr = CheckpointManager(ckdir)
    state = _bf16_tree()
    # values a float round trip would not keep: NaN payloads, -0, subnormal
    special = torch.tensor([0x7FC1, -0x8000, 0x0001], dtype=torch.int16)
    state["params"]["embed"]["tok"].view(torch.int16).view(-1)[:3] = special
    mgr.save(3, state, extra={"k": 1}, blocking=True)
    restored, extra = mgr.restore(state)
    assert extra == {"k": 1}
    for a, b in zip(tree_leaves(restored), tree_leaves(state)):
        if isinstance(b, torch.Tensor):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert torch.equal(a.view(torch.int16) if a.dtype ==
                               torch.bfloat16 else a,
                               b.view(torch.int16) if b.dtype ==
                               torch.bfloat16 else b)
        else:
            assert a == b and type(a) is type(b)
    with open(os.path.join(ckdir, "step_000000003", "manifest.json")) as f:
        leaves = {d["name"]: d for d in json.load(f)["leaves"]}
    assert leaves["params/layers/1/w"] == {"name": "params/layers/1/w",
                                           "shape": [3, 5],
                                           "dtype": "bfloat16"}
    data = np.load(os.path.join(ckdir, "step_000000003", "state.npz"))
    assert data["params/embed/tok"].dtype == np.uint16


def test_checkpoint_matches_jax_layout(ckdir):
    """The port's manifest names and shapes are the JAX manager's for the
    same tree in its stacked layout, less the layer axis: JAX stores
    ``layers/w`` (L, ...), the port ``layers/<i>/w``. Both store bf16 as
    its ``uint16`` view; the JAX manifest records the view's dtype, the
    port's the true one."""
    from repro.checkpoint import CheckpointManager as JManager
    jdir = os.path.join(ckdir, "jax")
    tdir = os.path.join(ckdir, "port")
    tstate = _bf16_tree()
    jstate = jax.tree.map(
        lambda a: jnp.asarray(a, jnp.bfloat16) if a.dtype == np.float32
        and a.ndim > 1 else a, params_to_numpy(tstate["params"]))
    JManager(jdir).save(1, jstate, blocking=True)
    CheckpointManager(tdir).save(1, tstate["params"], blocking=True)

    def leaves(d):
        with open(os.path.join(d, "step_000000001", "manifest.json")) as f:
            return {x["name"]: x for x in json.load(f)["leaves"]}

    jl, tl = leaves(jdir), leaves(tdir)
    assert jl["embed/tok"]["shape"] == tl["embed/tok"]["shape"]
    assert jl["layers/w"]["shape"] == [2] + tl["layers/0/w"]["shape"]
    assert jl["layers/w"]["dtype"] == "uint16"
    assert tl["layers/1/w"]["dtype"] == tl["embed/tok"]["dtype"] == "bfloat16"
    assert {n.split("/")[0] for n in jl} == {n.split("/")[0] for n in tl}


def test_torn_dump_is_ignored(ckdir):
    """A dump cut before its manifest was written does not count."""
    mgr = CheckpointManager(ckdir)
    mgr.save(2, _bf16_tree(), blocking=True)
    torn = os.path.join(ckdir, "step_000000009")
    os.makedirs(torn)
    np.savez(os.path.join(torn, "state.npz"), x=np.zeros(3))
    assert mgr.steps() == [2] and mgr.latest_step() == 2
    restored, _ = mgr.restore(_bf16_tree())
    assert restored["opt"]["count"] == 4


def test_log_dump_roundtrip(ckdir):
    mgr = CheckpointManager(ckdir)
    dump = {0: np.arange(6, dtype=np.float32), 3: np.ones(2, np.float32)}
    mgr.save(5, {"a": torch.zeros(2)}, log_dump=dump, blocking=True)
    assert np.array_equal(mgr.load_log_dump(5, 0), dump[0])
    assert np.array_equal(mgr.load_log_dump(5, 3), dump[3])
    assert mgr.load_log_dump(5, 1) is None


def test_checkpoint_roundtrip_and_gc(ckdir):
    """Twin of ``test_substrates.py::test_checkpoint_roundtrip_and_gc``."""
    mgr = CheckpointManager(ckdir, keep=2)
    state = {"a": torch.arange(6.0).reshape(2, 3),
             "nested": {"b": torch.ones((4,), dtype=torch.bfloat16)}}
    for step in (5, 11, 17):
        mgr.save(step, state, extra={"x": step}, blocking=True)
    assert mgr.steps() == [11, 17]          # gc keeps 2
    restored, extra = mgr.restore(state)
    assert extra["x"] == 17
    np.testing.assert_allclose(restored["a"].numpy(), state["a"].numpy())
    assert restored["nested"]["b"].dtype == state["nested"]["b"].dtype


def test_checkpoint_async(ckdir):
    """Twin of ``test_substrates.py::test_checkpoint_async``; the state is
    copied before the write goes async, so changing it after ``save``
    returns changes nothing on disk."""
    mgr = CheckpointManager(ckdir)
    state = {"a": torch.zeros((8,))}
    mgr.save(3, state, blocking=False)
    state["a"].fill_(5.0)
    mgr.wait()
    assert mgr.latest_step() == 3
    restored, _ = mgr.restore({"a": torch.empty(8)})
    assert float(restored["a"].abs().max()) == 0.0


# ---------------------------------------------------------------------------
# Weights and optimizer state across the two packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen3-0.6b", "whisper-medium"])
def test_params_to_numpy_inverts_params_from_jax(arch):
    jp = jax_build_model(repro.get_reduced_config(arch)).init(
        jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jp)
    back = params_to_numpy(params_from_jax(TC.get_reduced_config(arch),
                                           tree, device="cpu"))
    same = jax.tree.map(lambda a, b: np.array_equal(
        np.asarray(a, np.float32), b), tree, back)
    assert all(jax.tree.leaves(same))


@pytest.mark.parametrize("opt", ["adamw", "adafactor", "sgd"])
def test_opt_state_from_jax(opt):
    """The JAX package's optimizer state after two updates, brought over:
    every leaf ``==``, and one more update from it agrees with JAX's."""
    arch = "qwen3-0.6b"
    jcfg = repro.get_reduced_config(arch)
    tcfg = TC.get_reduced_config(arch)
    jp = jax_build_model(jcfg).init(jax.random.PRNGKey(1))
    train_kw = dict(optimizer=opt, learning_rate=1e-2)
    jinit, jupdate = jax_make_optimizer(JTrain(**train_kw))
    js = jinit(jp)
    rng = np.random.default_rng(2)

    def grads():
        return jax.tree.map(lambda a: jnp.asarray(
            rng.standard_normal(a.shape) * 0.1, a.dtype), jp)

    for _ in range(2):
        jp, js = jupdate(grads(), js, jp, jnp.float32(1e-2))
    np_state = jax.tree.map(np.asarray, js)
    ts = opt_state_from_jax(tcfg, np_state, device="cpu")
    assert ts["count"] == 2
    for key in set(js) - {"count"}:
        want = np_state[key]
        got = (jax.tree.map(np.asarray, ts[key]) if key == "vs" else
               params_to_numpy(ts[key]))
        if key == "vs":
            got = jax.tree.map(lambda t: t.numpy(), ts[key])
        same = jax.tree.map(lambda a, b: np.array_equal(
            np.asarray(a, np.float32), np.asarray(b, np.float32)), want, got)
        assert all(jax.tree.leaves(same)), key
    tp = params_from_jax(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    g = grads()
    jp2, _ = jupdate(g, js, jp, jnp.float32(1e-2))
    _, tupdate = make_optimizer(TC.TrainConfig(**train_kw))
    tg = params_from_jax(tcfg, jax.tree.map(np.asarray, g), device="cpu")
    tp2, _ = tupdate(tg, ts, tp, 1e-2)
    got, want = params_to_numpy(tp2), jax.tree.map(
        lambda a: np.asarray(a, np.float32), jp2)
    diff = jax.tree.map(lambda a, b: float(np.max(np.abs(a - b))
                                           / (np.max(np.abs(b)) + 1e-30)),
                        want, got)
    # bf16 parameters: the two updates may round one bf16 ulp apart
    assert max(jax.tree.leaves(diff)) <= 2.0 ** -7

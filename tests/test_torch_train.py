"""The port's gradients and train step against the JAX package's.

* The explicit attention gradient (``kernels/flash_attn/ref.py::
  attention_bwd_ref``, the formulas of the backward kernel) against torch
  autograd of the plain forward (``attention_ref``, ``_blockwise_attention``,
  ``_full_attention``) and against ``jax.grad`` of the reference's
  ``_blockwise_attention`` / ``_full_attention``: causal and unmasked,
  ``Sq != Skv``, GQA. f32 at 1e-5 of each gradient's max |value| (sums in
  another order); bf16 against autograd of the bf16 plain forward at
  2e-2, the forward's bf16 class (the two round dP and dS at other
  points).
* For every reduced arch in f32, the gradient of the port's ``loss_fn``
  against ``jax.grad`` of the reference's, from the same weights
  (``params_from_jax``) and batch: each leaf within 1e-4 of its max
  |grad|, the reference model test's f32 tolerance (1e-4).
* ``remat`` "full", "selective" and "none" give ``==`` loss and
  gradients.
* Five train steps of reduced qwen3 in f32 against JAX's
  ``make_train_step`` from the same state: loss and grad norm within
  rtol 1e-4 (AdamW's first steps divide each gradient by its own
  magnitude, so a rounding-level gradient difference moves a parameter
  by up to ~lr where the gradient is near 0), lr within 1e-6.
* The train step through the kernel route, with the kernels' launches
  replaced by the plain versions (attention's forward with lse and
  ``attention_bwd_ref``; the SSD scan's ``ssd_chunked`` with
  ``ssd_priors_ref`` and ``ssd_bwd_ref``), for qwen3 (attention),
  hymba (attention and SSD in every layer) and mamba2 (SSD): under
  ``remat="full"`` every layer launches each forward twice and each
  backward once a step, and the loss and gradients equal the CPU
  route's within f32 rounding.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
from repro.config import RunConfig as JRun
from repro.config import ShapeConfig as JShape
from repro.config import TrainConfig as JTrain
from repro.models import attention as jattn
from repro.models import build_model as jax_build_model
from repro.training.steps import init_train_state as jax_init_train_state
from repro.training.steps import make_eval_step as jax_make_eval_step
from repro.training.steps import make_train_step as jax_make_train_step
from repro_torch import config as TC
from repro_torch.data import SyntheticTokenPipeline
from repro_torch.kernels.flash_attn import kernel as fa_kernel
from repro_torch.kernels.flash_attn import ops as fa_ops
from repro_torch.kernels.flash_attn.ref import (attention_bwd_ref,
                                                attention_lse_ref,
                                                attention_ref)
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan.ref import ssd_bwd_ref, ssd_priors_ref
from repro_torch.models import attention as tattn
from repro_torch.models import build_model
from repro_torch.models.model_zoo import params_from_jax, params_to_numpy
from repro_torch.models.ssm import ssd_chunked
from repro_torch.optim.optimizers import tree_leaves
from repro_torch.training.steps import (init_train_state, make_eval_step,
                                        make_train_step)

ARCHS = ("hymba-1.5b", "qwen3-0.6b", "mamba2-2.7b", "moonshot-v1-16b-a3b",
         "grok-1-314b", "deepseek-67b", "stablelm-12b", "starcoder2-15b",
         "whisper-medium", "internvl2-26b")
# (b, sq, skv, h, kh, d, causal)
GRAD_CASES = [
    (2, 40, 40, 4, 2, 16, True),       # GQA, causal
    (1, 24, 70, 6, 2, 32, True),       # Sq != Skv, right-aligned causal
    (2, 30, 50, 4, 4, 16, False),      # unmasked cross-attention shape
    (1, 33, 33, 4, 1, 8, False),       # MQA, unmasked
]
GRAD_IDS = ["gqa-causal", "sq-lt-skv-causal", "cross-unmasked",
            "mqa-unmasked"]


def _qkv(case, dtype, seed=0):
    b, sq, skv, h, kh, d, _ = case
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((b, sq, h, d), (b, skv, kh, d), (b, skv, kh, d),
                      (b, sq, h, d))]
    return arrs, [torch.from_numpy(a).to(dtype) for a in arrs]


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)),
                                                 1e-30))


def attention_grads_autograd(q, k, v, dout, causal, fn=attention_ref):
    """``(dq, dk, dv)`` by torch autograd of ``fn(q, k, v, causal)``
    against ``dout``: the plain version's own gradient."""
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    out = fn(*leaves, causal)
    out.backward(dout.to(out.dtype))
    return tuple(t.grad for t in leaves)


def _explicit(q, k, v, do, causal):
    o = attention_ref(q, k, v, causal)
    return attention_bwd_ref(q, k, v, o, attention_lse_ref(q, k, causal),
                             do, causal)


@pytest.mark.parametrize("case", GRAD_CASES, ids=GRAD_IDS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_explicit_gradient_matches_autograd(case, dtype):
    causal = case[-1]
    _, (q, k, v, do) = _qkv(case, getattr(torch, dtype))
    want = attention_grads_autograd(q, k, v, do, causal)
    got = _explicit(q, k, v, do, causal)
    tol = 2e-2 if dtype == "bfloat16" else 1e-5
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert _rel(g.float(), w.float()) <= tol, name
    if dtype == "float32":
        for fn in (tattn._full_attention, tattn._blockwise_attention):
            def plain(q, k, v, c, fn=fn):
                if fn is tattn._full_attention:
                    return fn(q, k, v, c)
                return fn(q, k, v, c, q_block=16, kv_block=16)
            want = attention_grads_autograd(q, k, v, do, causal, fn=plain)
            for name, g, w in zip("qkv", got, want):
                assert _rel(g, w) <= 1e-5, (fn.__name__, name)


@pytest.mark.parametrize("case", GRAD_CASES, ids=GRAD_IDS)
def test_explicit_gradient_matches_jax_grad(case):
    causal = case[-1]
    (qn, kn, vn, don), (q, k, v, do) = _qkv(case, torch.float32, seed=1)
    got = _explicit(q, k, v, do, causal)
    for name, fn in (("full", lambda a, b, c: jattn._full_attention(
                          a, b, c, causal)),
                     ("blockwise", lambda a, b, c: jattn._blockwise_attention(
                          a, b, c, causal, q_block=16, kv_block=16))):
        want = jax.jit(lambda a, b, c, d, fn=fn: jax.vjp(fn, a, b, c)[1](d))(
            jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn),
            jnp.asarray(don))
        for n, g, w in zip("qkv", got, want):
            assert _rel(g.numpy(), np.asarray(w)) <= 1e-5, (name, n)


# ---------------------------------------------------------------------------
# Gradients of every reduced arch
# ---------------------------------------------------------------------------

def _models(arch):
    jcfg = dataclasses.replace(repro.get_reduced_config(arch),
                               dtype="float32")
    tcfg = dataclasses.replace(TC.get_reduced_config(arch), dtype="float32")
    jm = jax_build_model(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    tparams = params_from_jax(tcfg, jax.tree.map(np.asarray, jparams),
                              device="cpu")
    return jcfg, jm, jparams, tcfg, build_model(tcfg), tparams


def _batch(tcfg, seq=16, batch=2, seed=3):
    shape = TC.ShapeConfig("t", seq_len=seq, global_batch=batch,
                           kind="train")
    return SyntheticTokenPipeline(tcfg, shape, seed=seed).next()


def _port_grads(tm, tparams, nb, remat="full"):
    leaves = tree_leaves(tparams)
    for p in leaves:
        p.requires_grad_(True)
        p.grad = None
    batch = {k: torch.from_numpy(v) for k, v in nb.items()}
    loss, _ = tm.loss_fn(tparams, batch, remat=remat)
    loss.backward()
    return float(loss.detach()), params_to_numpy(_grad_tree(tparams))


def _grad_tree(tree):
    if isinstance(tree, dict):
        return {k: _grad_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_grad_tree(x) for x in tree]
    return tree.grad if tree.grad is not None else torch.zeros_like(tree)


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_jax(arch):
    jcfg, jm, jparams, tcfg, tm, tparams = _models(arch)
    nb = _batch(tcfg)
    jbatch = {k: jnp.asarray(v) for k, v in nb.items()}
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jm.loss_fn(p, jbatch), has_aux=True))(jparams)
    tloss, tgrads = _port_grads(tm, tparams, nb)
    assert tloss == pytest.approx(float(jloss), rel=1e-5)
    flat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    for path, w in flat:
        g = tgrads
        for p in path:
            g = g[p.key]
        assert _rel(g, w) <= 1e-4, jax.tree_util.keystr(path)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "hymba-1.5b",
                                  "moonshot-v1-16b-a3b", "whisper-medium"])
def test_remat_modes_give_equal_gradients(arch):
    *_, tcfg, tm, tparams = _models(arch)
    nb = _batch(tcfg, seq=24)
    base_loss, base = _port_grads(tm, tparams, nb, remat="none")
    for remat in ("full", "selective"):
        loss, grads = _port_grads(tm, tparams, nb, remat=remat)
        assert loss == base_loss, remat
        same = jax.tree.map(np.array_equal, grads, base)
        assert all(jax.tree.leaves(same)), remat


def test_unknown_remat_raises():
    *_, tcfg, tm, tparams = _models("qwen3-0.6b")
    batch = {k: torch.from_numpy(v) for k, v in _batch(tcfg).items()}
    with pytest.raises(ValueError, match="remat"):
        tm.loss_fn(tparams, batch, remat="some")


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------

def _runs(variant="proactive", steps=5):
    kw = dict(total_steps=20, warmup_steps=2, learning_rate=1e-3)
    shape = dict(seq_len=32, global_batch=4, kind="train")
    jcfg = dataclasses.replace(repro.get_reduced_config("qwen3-0.6b"),
                               dtype="float32")
    tcfg = dataclasses.replace(TC.get_reduced_config("qwen3-0.6b"),
                               dtype="float32")
    jrun = JRun(model=jcfg, shape=JShape("t", **shape), train=JTrain(**kw),
                replication=repro.config.ReplicationConfig(variant=variant))
    trun = TC.RunConfig(model=tcfg, shape=TC.ShapeConfig("t", **shape),
                        train=TC.TrainConfig(**kw),
                        replication=TC.ReplicationConfig(variant=variant))
    return jrun, trun


def test_train_steps_match_jax():
    jrun, trun = _runs()
    jm, tm = jax_build_model(jrun.model), build_model(trun.model)
    jstate = jax_init_train_state(jrun, jm, jax.random.PRNGKey(0), None)
    tparams = params_from_jax(trun.model,
                              jax.tree.map(np.asarray, jstate.params),
                              device="cpu")
    tstate = init_train_state(trun, tm, 0, None, params=tparams)
    jstep = jax.jit(jax_make_train_step(jrun, jm, None))
    tstep = make_train_step(trun, tm, None)
    pipe = SyntheticTokenPipeline(trun.model, trun.shape, seed=0)
    for i in range(5):
        nb = pipe.next()
        jstate, jm_ = jstep(jstate, {k: jnp.asarray(v) for k, v in
                                     nb.items()})
        tstate, tm_ = tstep(tstate, {k: torch.from_numpy(v) for k, v in
                                     nb.items()})
        assert float(tm_["loss"]) == pytest.approx(float(jm_["loss"]),
                                                   rel=1e-4), i
        assert float(tm_["grad_norm"]) == pytest.approx(
            float(jm_["grad_norm"]), rel=1e-4), i
        assert float(tm_["lr"]) == pytest.approx(float(jm_["lr"]),
                                                 rel=1e-6), i
    assert tstate.step == int(jstate.step) == 5
    assert tstate.opt_state["count"] == int(jstate.opt_state["count"])
    jeval, teval = jax_make_eval_step(jrun, jm), make_eval_step(trun, tm)
    nb = pipe.next()
    je = jeval(jstate.params, {k: jnp.asarray(v) for k, v in nb.items()})
    te = teval(tstate.params, {k: torch.from_numpy(v) for k, v in
                               nb.items()})
    assert set(te) == set(je)
    assert float(te["loss"]) == pytest.approx(float(je["loss"]), rel=1e-4)


@pytest.mark.parametrize("variant", ["writethrough", "none"])
def test_train_step_variants(variant):
    """WT copies every update into its bf16 staging buffer; WB (none)
    keeps no logs. Both give the replicating variant's loss: replication
    is off the numerical path, and eager torch runs in program order."""
    _, trun = _runs(variant)
    _, prun = _runs("proactive")
    tm = build_model(trun.model)
    losses = {}
    for run in (trun, prun):
        state = init_train_state(run, tm, 0, None, device="cpu")
        step = make_train_step(run, tm, None)
        pipe = SyntheticTokenPipeline(run.model, run.shape, seed=0)
        out = []
        for _ in range(2):
            state, m = step(state, {k: torch.from_numpy(v) for k, v in
                                    pipe.next().items()})
            out.append(float(m["loss"]))
        losses[run.replication.variant] = out
        if run.replication.variant == "writethrough":
            for w, p in zip(tree_leaves(state.wt_buffer),
                            tree_leaves(state.params)):
                assert w.dtype == torch.bfloat16
                assert torch.equal(w, p.detach().to(torch.bfloat16))
        else:
            assert state.wt_buffer is None and state.logs == {}
    assert losses[variant] == losses["proactive"]


def _fake_launch(q, k, v, causal, which=None, with_lse=False):
    out = attention_ref(q, k, v, causal)
    return (out, attention_lse_ref(q, k, causal)) if with_lse else out


def _fake_launch_bwd(q, k, v, out, lse, dout, causal, need_dq=True,
                     need_dkv=True, which=None):
    dq, dk, dv = attention_bwd_ref(q, k, v, out, lse, dout.contiguous(),
                                   causal)
    return (dq if need_dq else None, dk if need_dkv else None,
            dv if need_dkv else None)


def _fake_ssd_launch(x, dt, A, B, C, chunk, init_state=None, which=None,
                     with_priors=False):
    chunk = min(chunk, x.shape[1])
    y, state = ssd_chunked(x, dt, A, B, C, chunk, init_state)
    if not with_priors:
        return y, state
    return y, state, ssd_priors_ref(x, dt, A, B, C, chunk, init_state)


def _fake_ssd_launch_bwd(x, dt, A, B, C, chunk, priors, dy, dstate=None,
                         dinit_dtype=None, need=(True,) * 5):
    grads = ssd_bwd_ref(x, dt, A, B, C, chunk, dy.contiguous(), dstate,
                        None, priors)
    return tuple(g if n else None for g, n in zip(grads[:5], need)) + (None,)


#: one arch per kind of mixer: attention, attention + SSD, SSD
KERNEL_ROUTE_ARCHS = ["qwen3-0.6b", "hymba-1.5b", "mamba2-2.7b"]


@pytest.mark.parametrize("arch", KERNEL_ROUTE_ARCHS)
def test_train_step_through_the_kernel_route(monkeypatch, arch):
    """The card's path of a train step on CPU tensors: every attention
    and every SSD scan takes its op's CUDA route, whose launches are the
    plain versions. With ``remat="full"`` each layer launches each
    forward twice (the step's forward and the recompute) and each
    backward once; with ``remat="none"`` each once; loss and gradients
    equal the CPU route's within f32 rounding."""
    *_, tcfg, tm, tparams = _models(arch)
    nb = _batch(tcfg, seq=40)
    want_loss, want = _port_grads(tm, tparams, nb)
    monkeypatch.setattr(tattn, "_on_card", lambda t: True)
    monkeypatch.setattr(fa_ops, "_route", lambda t: "cuda")
    monkeypatch.setattr(fa_kernel, "launch", _fake_launch)
    monkeypatch.setattr(fa_kernel, "launch_bwd", _fake_launch_bwd)
    monkeypatch.setattr(ssd_ops, "_route", lambda t: "cuda")
    monkeypatch.setattr(ssd_kernel, "launch", _fake_ssd_launch)
    monkeypatch.setattr(ssd_kernel, "launch_bwd", _fake_ssd_launch_bwd)
    fa_ops.reset_counts()
    ssd_ops.reset_counts()
    loss, got = _port_grads(tm, tparams, nb, remat="full")
    n = tcfg.n_layers
    n_attn = 0 if tcfg.family == "ssm" else n
    n_ssd = n if tcfg.family in ("ssm", "hybrid") else 0
    assert fa_ops.flash_attention.launches == 2 * n_attn
    assert fa_ops.flash_attention.bwd_launches == n_attn
    which = fa_kernel.bwd_kernel_for(getattr(torch, tcfg.dtype))
    assert fa_ops.flash_attention.bwd_launches_by_kernel == {
        "mma": n_attn * (which == "mma"), "simt": n_attn * (which == "simt")}
    assert ssd_ops.ssd_scan.launches == 2 * n_ssd
    assert ssd_ops.ssd_scan.bwd_launches == n_ssd
    assert ssd_ops.ssd_scan.bwd_launches_by_kernel == {"simt": n_ssd}
    assert loss == pytest.approx(want_loss, rel=1e-6)
    diffs = jax.tree.map(_rel, got, want)
    assert max(jax.tree.leaves(diffs)) <= 1e-5
    fa_ops.reset_counts()
    ssd_ops.reset_counts()
    _port_grads(tm, tparams, nb, remat="none")
    assert fa_ops.flash_attention.launches == n_attn
    assert fa_ops.flash_attention.bwd_launches == n_attn
    assert ssd_ops.ssd_scan.launches == n_ssd
    assert ssd_ops.ssd_scan.bwd_launches == n_ssd

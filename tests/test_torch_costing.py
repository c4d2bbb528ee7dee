"""The port's cost pass (``launch/costing.py``) against the JAX
package's ``jaxpr_cost``: the twin of ``tests/test_costing.py``.

The JAX test's trip-count cases carry over to the port's eager loops,
which run every trip on the ``meta`` device:

* a matmul's FLOPs are exactly ``2 m n k``;
* a loop of N matmuls counts N times, nested loops N x M;
* ``remat_apply``'s recompute is counted where the backward runs it;
* flash accounting (the JAX package's ``vmem_scan_lengths``) suppresses
  attention's bytes, not its FLOPs;
* an op over the leading node dimensions counts globally (the JAX
  package's ``shard_map`` device multiplier).

The JAX file's two HLO collective-parser tests have no twin: a logical
mesh on one card issues no collectives, and the port has no parser
(ROADMAP A8, A4(d)).

On a whole model: reduced qwen3's prefill, counted on ``meta`` through
the plain path, has the FLOPs ``jaxpr_cost`` gives the JAX package's
prefill, ``==`` (both count ``2 m n k`` per product of the same
algorithm); so does its train step (forward, remat recompute, backward:
the optimizer and the replication add no product). Bytes are not held to
the reference on a whole model: the two op sets differ (the ratio is in
PERF.md). The kernels' formula is held to ``chip_smoke.py``'s bound
helpers, and the dry-run cells' pair walks to the JAX package's.
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
from repro.launch.costing import jaxpr_cost
from repro.models import attention as jattn
from repro.models import build_model as jax_build_model
from repro.training.steps import init_train_state as jax_init_train_state
from repro.training.steps import make_serve_fns as jax_make_serve_fns
from repro.training.steps import make_train_step as jax_make_train_step
from repro_torch import config as TC
from repro_torch import kernels
from repro_torch.kernels.flash_attn import ops as fa_ops
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.launch.costing import step_cost
from repro_torch.models import attention as tattn
from repro_torch.models import build_model
from repro_torch.models.layers import remat_apply
from repro_torch.models.model_zoo import batch_struct
from repro_torch.optim.optimizers import tree_leaves
from repro_torch.training.steps import (init_train_state, make_serve_fns,
                                        make_train_step)

META = torch.device("meta")


def _m(*shape, dtype=torch.float32, grad=False):
    return torch.empty(shape, dtype=dtype, device=META, requires_grad=grad)


def test_dot_flops_exact():
    c = step_cost(lambda a, b: a @ b, _m(8, 32), _m(32, 16))
    assert c["flops"] == 2 * 8 * 32 * 16


def test_loop_trip_count_multiplies():
    def f(w, x):
        h = x
        for _ in range(7):
            h = h @ w
        return h

    c = step_cost(f, _m(16, 16), _m(4, 16))
    assert c["flops"] == 7 * 2 * 4 * 16 * 16


def test_nested_loops_multiply():
    def f(w):
        h = torch.zeros(2, 8, device=META)
        for _ in range(5):
            for _ in range(3):
                h = h @ w
        return h

    c = step_cost(f, _m(8, 8))
    assert c["flops"] == 5 * 3 * 2 * 2 * 8 * 8


@pytest.mark.parametrize("remat", ["full", "none"])
def test_remat_counts_recompute(remat):
    """grad-of-remat >= 3x the forward's matmul FLOPs (the JAX test's
    bound); exactly, remat "full" adds the two forward products again."""
    def block(x, w):
        return torch.tanh(x @ w)

    def grad(w, x):
        y = remat_apply(block, remat, remat_apply(block, remat, x, w), w)
        y.sum().backward()

    plain = step_cost(lambda w, x: block(block(x, w), w), _m(16, 16),
                      _m(4, 16))
    g = step_cost(grad, _m(16, 16, grad=True), _m(4, 16))
    mm = 2 * 4 * 16 * 16
    assert plain["flops"] == 2 * mm
    # forward 2, backward dW 2 and dX 1 (x needs no gradient), recompute 2
    assert g["flops"] == (7 if remat == "full" else 5) * mm
    if remat == "full":
        assert g["flops"] >= 3 * plain["flops"] * 0.9


def _attend(q, k, v, causal, blockwise=False):
    return tattn._attend(q, k, v, causal, blockwise)


def test_flash_accounting_suppresses_bytes_not_flops():
    """Unmasked attention: the kernel's formula counts the plain path's
    products exactly, and only q, k, v and out as bytes."""
    q, k, v = _m(2, 512, 4, 64), _m(2, 512, 2, 64), _m(2, 512, 2, 64)
    plain = step_cost(_attend, q, k, v, False)
    flash = step_cost(_attend, q, k, v, False, flash_accounting=True)
    assert flash["kernel_calls"] == {"repro_torch::flash_attention_fwd": 1}
    assert plain["kernel_calls"] == {}
    assert flash["flops"] == plain["flops"] == 4 * 64 * 512 * 512 * 2 * 4
    assert flash["bytes"] < plain["bytes"] * 0.2
    # causal: the kernel counts the allowed pairs only; the blockwise
    # path computes whole blocks
    flash_c = step_cost(_attend, q, k, v, True, flash_accounting=True)
    block_c = step_cost(_attend, q, k, v, True, True)
    assert flash_c["flops"] == 4 * 64 * (512 * 513 // 2) * 2 * 4
    assert flash_c["flops"] < block_c["flops"]
    assert flash_c["bytes"] < block_c["bytes"] * 0.2


def test_flash_accounting_counts_the_backward_launch():
    q = _m(1, 256, 4, 64, grad=True)
    k, v = _m(1, 256, 2, 64, grad=True), _m(1, 256, 2, 64, grad=True)

    def f(q, k, v):
        _attend(q, k, v, True).sum().backward()

    c = step_cost(f, q, k, v, flash_accounting=True)
    assert c["kernel_calls"] == {"repro_torch::flash_attention_fwd": 1,
                                 "repro_torch::flash_attention_bwd": 1}
    pairs = 256 * 257 // 2 * 4
    assert c["flops"] == (4 + 10) * 64 * pairs
    assert not kernels.ON_META


def test_node_dims_count_globally():
    """The JAX package multiplies a ``shard_map`` body by the device
    count; the port's op over the leading node dimension is the global
    op."""
    c = step_cost(lambda w: torch.bmm(w, w), _m(8, 16, 16))
    assert c["flops"] == 8 * 2 * 16 * 16 * 16


def test_attention_cost_is_chip_smokes_bound(monkeypatch):
    """The kernels' formula counts the bytes and operations of
    ``chip_smoke.py``'s ``attn_bound_ms`` / ``bwd_bound_ms``."""
    import chip_smoke
    seen = []
    monkeypatch.setattr(chip_smoke, "bound",
                        lambda nbytes, ops, rate: seen.append((nbytes, ops)))
    for causal in (True, False):
        for dt in (torch.bfloat16, torch.float32):
            q = torch.empty(2, 96, 8, 64, dtype=dt, device=META)
            k = torch.empty(2, 128, 2, 64, dtype=dt, device=META)
            chip_smoke.attn_bound_ms(torch, q, k, causal)
            chip_smoke.bwd_bound_ms(torch, q, k, causal)
            fwd = fa_ops.attention_cost(q.shape, k.shape, causal,
                                        q.element_size())
            bwd = fa_ops.attention_cost(q.shape, k.shape, causal,
                                        q.element_size(), backward=True)
            assert seen[-2:] == [(fwd["bytes"], fwd["flops"]),
                                 (bwd["bytes"], bwd["flops"])]


def test_ssd_cost_is_chip_smokes_bound(monkeypatch):
    import chip_smoke
    seen = []
    monkeypatch.setattr(chip_smoke, "bound",
                        lambda nbytes, ops, rate: seen.append((nbytes, ops)))
    for l, chunk in ((512, 128), (500, 128), (64, 256)):
        for dt in (torch.bfloat16, torch.float32):
            x = torch.empty(2, l, 4, 32, dtype=dt, device=META)
            B = torch.empty(2, l, 16, dtype=dt, device=META)
            priors = torch.empty(2, 4, -(-l // min(chunk, l)), 32, 16,
                                 dtype=dt, device=META)
            chip_smoke.ssd_bound_ms(torch, x, B, chunk)
            chip_smoke.ssd_bwd_bound_ms(torch, x, B, chunk, priors)
            fwd = ssd_ops.ssd_cost(x.shape, 16, chunk, x.element_size())
            bwd = ssd_ops.ssd_cost(x.shape, 16, chunk, x.element_size(),
                                   backward=True)
            assert seen[-2:] == [(fwd["bytes"], fwd["flops"]),
                                 (bwd["bytes"], bwd["flops"])]


def test_kernel_accounting_routes_every_kernel_op():
    """A hybrid model's train step on meta: inside ``kernels.on_meta``
    every attention and SSD scan is one shape-only op a launch (the
    forward, remat's recompute, the backward), as on the card; outside
    it the plain versions run, with no kernel op."""
    cfg = TC.get_reduced_config("hymba-1.5b")
    tm = build_model(cfg)
    params = tm.init(0, device=META)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    shape = TC.ShapeConfig("t", seq_len=64, global_batch=2, kind="train")

    def step(params, batch):
        tm.loss_fn(params, batch, remat="full")[0].backward()

    batch = _meta_batch(cfg, shape)
    kern = step_cost(step, params, batch, flash_accounting=True)
    L = cfg.n_layers
    assert kern["kernel_calls"] == {
        "repro_torch::flash_attention_fwd": 2 * L,
        "repro_torch::flash_attention_bwd": L,
        "repro_torch::ssd_scan_fwd": 2 * L, "repro_torch::ssd_scan_bwd": L}
    plain = step_cost(step, params, batch)
    assert plain["kernel_calls"] == {} and plain["flops"] > 0


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "whisper-medium",
                                  "hymba-1.5b"])
def test_pair_walks_match_jax(arch):
    tcfg, jcfg = TC.get_model_config(arch), repro.get_model_config(arch)
    for name in TC.SHAPES:
        got = tattn.n_pair_scan_lengths(tcfg, TC.SHAPES[name])
        assert got == jattn.n_pair_scan_lengths(jcfg, repro.config.SHAPES[
            name]), name
        s = TC.SHAPES[name].seq_len
        if s > tattn.BLOCKWISE_THRESHOLD:
            n = -(-s // tattn.Q_BLOCK)
            assert len(tattn._causal_pairs(n, n, tattn.Q_BLOCK,
                                           tattn.KV_BLOCK, 0, True)) in got


# ---------------------------------------------------------------------------
# A whole model against jaxpr_cost
# ---------------------------------------------------------------------------

SEQ, BATCH = 64, 4


def _cfgs(dtype="bfloat16"):
    return (dataclasses.replace(repro.get_reduced_config("qwen3-0.6b"),
                                dtype=dtype),
            dataclasses.replace(TC.get_reduced_config("qwen3-0.6b"),
                                dtype=dtype))


def _meta_batch(cfg, shape):
    return {k: torch.empty(s.shape, dtype=s.dtype, device=META)
            for k, s in batch_struct(cfg, shape).items()}


def test_prefill_flops_match_jax():
    jcfg, tcfg = _cfgs()
    shape = TC.ShapeConfig("p", seq_len=SEQ, global_batch=BATCH,
                           kind="prefill")
    jshape = JShape("p", seq_len=SEQ, global_batch=BATCH, kind="prefill")
    jm = jax_build_model(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    jprefill, _ = jax_make_serve_fns(JRun(model=jcfg, shape=jshape), jm)
    jbatch = {"tokens": jnp.zeros((BATCH, SEQ), jnp.int32)}
    ref = jaxpr_cost(jprefill, (jparams, jbatch), mesh_size=1)
    tm = build_model(tcfg)
    prefill, _ = make_serve_fns(tm)
    port = step_cost(torch.no_grad()(prefill), tm.init(0, device=META),
                     _meta_batch(tcfg, shape))
    assert port["flops"] == ref["flops"] > 0
    assert port["bytes"] > 0


def test_train_step_flops_match_jax():
    """The train step (remat "full", AdamW, proactive replication on a
    (4, 2) mesh): forward, recompute and backward products ``==`` the
    JAX package's count."""
    from repro.core.replication import ReplicationEngine as JEngine
    from repro.distributed.context import make_context as jax_ctx
    from repro.distributed.context import make_mesh, mesh_context
    from repro.distributed.sharding import param_specs as jax_specs
    from repro_torch.core.replication import ReplicationEngine
    from repro_torch.distributed.context import make_context
    from repro_torch.distributed.sharding import param_specs
    jcfg, tcfg = _cfgs()
    kw = dict(total_steps=20, warmup_steps=2)
    rep = dict(variant="proactive", n_replicas=2, n_buckets=4,
               log_capacity=2)
    shape = dict(seq_len=SEQ, global_batch=BATCH * 2, kind="train")
    jrun = JRun(model=jcfg, shape=JShape("t", **shape), train=JTrain(**kw),
                replication=repro.config.ReplicationConfig(**rep))
    trun = TC.RunConfig(model=tcfg, shape=TC.ShapeConfig("t", **shape),
                        train=TC.TrainConfig(**kw),
                        replication=TC.ReplicationConfig(**rep))
    if jax.device_count() < 8:
        pytest.skip("needs 8 host devices")
    mesh = make_mesh((4, 2), ("data", "model"))
    jctx = jax_ctx(mesh)
    jm = jax_build_model(jcfg)
    with mesh_context(jctx):
        key = jax.random.PRNGKey(0)
        pstruct = jax.eval_shape(jm.init, key)
        jeng = JEngine(jrun.replication, jctx,
                       jax_specs(pstruct, jcfg, jctx), pstruct)
        jstate = jax.eval_shape(lambda k: jax_init_train_state(
            jrun, jm, k, jeng), key)
        jbatch = {k: jax.ShapeDtypeStruct((BATCH * 2, SEQ), jnp.int32)
                  for k in ("tokens", "labels")}
        ref = jaxpr_cost(jax_make_train_step(jrun, jm, jeng),
                         (jstate, jbatch), mesh_size=8)
    ctx = make_context((4, 2), ("data", "model"), device=META)
    tm = build_model(tcfg)
    params = tm.init(0, device=META)
    eng = ReplicationEngine(trun.replication, ctx,
                            param_specs(params, tcfg, ctx), params)
    state = init_train_state(trun, tm, 0, eng, params=params)
    port = step_cost(make_train_step(trun, tm, eng), state,
                     _meta_batch(tcfg, trun.shape))
    assert port["flops"] == ref["flops"] > 0

"""The worker side of ``tests/test_torch_tp_train.py``: the port's train
step with the ``model`` axis split across ``gloo`` ranks, on the CPU.

:func:`start` spawns a world with ``torch.multiprocessing`` (``spawn``, a
``file://`` rendezvous in the test's temporary directory); every rank
builds a context whose ranks split ``model``
(``make_context(..., split_model=True)``), places the JAX package's
weights by their specs (``named_shardings``), and takes the train step's
gradient (``training.steps.make_grad_fn``) of each reduced config on its
node block's rows of a seeded masked batch (``trainer.batch_rows``). It
pickles, numpy only, each leaf's block of the reduced gradient, the
clipped gradient, the loss and global norm, its collective counts and
its MoE's smallest top-k margin; then the same under each planted fault,
a ``Trainer`` run of 3 steps with an MN dump, and the refusals. This
module imports torch, numpy and ``repro_torch`` only, and every worker
checks that no JAX was imported.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import pickle
import sys
from typing import Any, Dict, List

import numpy as np
import torch

#: the per-world time limit of a collective (a fault must not hang)
TIMEOUT_S = 120.0
SEED = 0
BATCH = 4
SEQ = 40                         # past the reduced SSD configs' chunk of 32
#: a grad_clip below every case's global norm, so that the clip acts
CLIP = 0.5
#: world -> (data, model) mesh
MESHES = {2: (1, 2), 4: (2, 2)}
#: name -> (arch, changes to its reduced config); every config in f32:
#: the KV heads split with qk-norm (qwen3), attention FSDP-only with the
#: SSD split and an unsplit vocabulary (hymba: 5 heads, 511 tokens), EP
#: with the shared experts' ff split (moonshot), the encoder, decoder and
#: cross-attention split (whisper)
CONFIGS = {
    "qwen3": ("qwen3-0.6b", {}),
    "hymba": ("hymba-1.5b", {"n_heads": 5, "n_kv_heads": 1,
                             "vocab_size": 511}),
    "moonshot": ("moonshot-v1-16b-a3b", {}),
    "whisper": ("whisper-medium", {}),
}
#: gradient case -> (config, remat)
GRADS = {"qwen3": ("qwen3", "none"), "qwen3_remat": ("qwen3", "full"),
         "hymba": ("hymba", "none"), "moonshot": ("moonshot", "none"),
         "whisper": ("whisper", "none")}
#: gradient cases under the ``seq_model`` activation policy: case ->
#: (config, remat, sequence length); ``whisper_odd``'s 39 decoder
#: positions are not divided by ``m`` (its decoder keeps the batch layout
#: while its 16 encoder frames live as spans)
SEQ_GRADS = {"qwen3_seq": ("qwen3", "none", SEQ),
             "qwen3_seq_remat": ("qwen3", "full", SEQ),
             "hymba_seq": ("hymba", "none", SEQ),
             "moonshot_seq": ("moonshot", "none", SEQ),
             "whisper_seq": ("whisper", "none", SEQ),
             "whisper_odd": ("whisper", "none", SEQ - 1)}
#: planted faults of the ``seq_model`` step -> the case they are planted in
SEQ_FAULTS = {"seq_scatter_bwd_identity": "qwen3_seq",
              "seq_norm_unsummed": "qwen3_seq",
              "seq_other_span": "hymba_seq"}
#: planted fault -> the gradient case it is planted in
FAULTS = {"model_sum_bwd_summed": "qwen3", "entry_dropped": "qwen3",
          "ssd_leaves_unsummed": "hymba", "fsdp_bwd_sliced": "qwen3",
          "norm_unweighted": "qwen3", "rows_by_rank": "qwen3"}
#: the faults only a world of several node blocks runs: the FSDP gather
#: (none at one block), and the rows by rank (at one block every rank's
#: slice, wrapped into the batch, is the whole batch: no fault to see)
SPLIT_FAULTS = ("fsdp_bwd_sliced", "rows_by_rank")
#: the Trainer runs: config -> steps, on a (2 data x 2 model) mesh at
#: both worlds (a Trainer needs a replica node: two data nodes), so that
#: a world of 2 holds one block of 2 nodes and a world of 4 two blocks of
#: one. Both dispatch the MoE's 2 data blocks on their own, whose aux
#: term the reference takes from block 0 alone (ROADMAP C7): the MoE runs
#: with the aux coefficient 0 in both packages (``AUX_OFF``)
TRAIN = {"qwen3": 3, "moonshot": 3}
TRAIN_MESH = (2, 2)
AUX_OFF = ("moonshot",)
TRAIN_BATCH, TRAIN_SEQ, DUMP_INTERVAL = 4, 16, 2
#: the Adafactor ``Trainer`` runs (config -> steps), on ``TRAIN_MESH``
TRAIN_ADAFACTOR = {"qwen3": 3}
#: Adafactor's update alone: case -> (config, changes to its reduced
#: config, {world: (mesh shape, axes)}); ``parts`` is a (pod 2, data 2,
#: model 1) layout of 4 node blocks whose d_model of 66 only ``pod``
#: divides, so two blocks hold each FSDP part
ADAFACTOR = {
    "qwen3": ("qwen3", {}, {w: (MESHES[w], ("data", "model"))
                            for w in MESHES}),
    "hymba": ("hymba", {}, {w: (MESHES[w], ("data", "model"))
                            for w in MESHES}),
    "moonshot": ("moonshot", {}, {w: (MESHES[w], ("data", "model"))
                                  for w in MESHES}),
    "parts": ("qwen3", {"d_model": 66},
              {4: ((2, 2, 1), ("pod", "data", "model"))}),
}
ADA_STEPS, ADA_LR = 5, 1e-2
#: planted faults of the Adafactor update -> the case they are planted in
ADA_FAULTS = {"ada_rows_unsummed": "qwen3", "ada_rms_unweighted": "parts",
              "ada_parts_twice": "parts"}


def config(name: str, configs=None):
    """The reduced f32 config of ``name`` from ``configs`` (the port's
    ``repro_torch.config`` by default, or the JAX package's)."""
    if configs is None:
        from repro_torch import config as configs
    arch, change = CONFIGS[name]
    return dataclasses.replace(configs.get_reduced_config(arch),
                               dtype="float32", **change)


def ada_config(case: str, configs=None):
    """The reduced f32 config of an :data:`ADAFACTOR` case."""
    if configs is None:
        from repro_torch import config as configs
    name, change, _ = ADAFACTOR[case]
    return dataclasses.replace(config(name, configs), **change)


def ada_grads(tree: Any, step: int) -> Any:
    """A seeded gradient tree shaped as the JAX-layout numpy ``tree``
    (dicts walked by sorted key), step ``step``'s."""
    rng = np.random.default_rng(7000 + step)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(node[k]) for k in sorted(node)}
        return (rng.standard_normal(np.shape(node)) * 0.1).astype(
            np.float32)

    return walk(tree)


def objective(name: str, world: int) -> str:
    """The loss a case's gradient is taken of: the total, or, for the
    MoE where the reference's aux term is data block 0's (ROADMAP C7),
    ``ce_loss``."""
    return "ce_loss" if name == "moonshot" and world == 4 else "loss"


def batch_data(name: str, seq: int = SEQ) -> Dict[str, np.ndarray]:
    """The seeded global batch of ``name`` at ``seq`` positions: tokens,
    labels, a mask of ~80% ones (the node blocks' token shares differ)
    and an enc-dec's frames."""
    cfg = config(name)
    rng = np.random.default_rng(2000 + sorted(CONFIGS).index(name))
    out = {"tokens": rng.integers(0, cfg.vocab_size, (BATCH, seq),
                                  dtype=np.int32),
           "labels": rng.integers(0, cfg.vocab_size, (BATCH, seq),
                                  dtype=np.int32),
           "mask": (rng.random((BATCH, seq)) < 0.8).astype(np.float32)}
    if cfg.is_encdec:
        out["frames"] = (rng.standard_normal(
            (BATCH, cfg.n_frames, cfg.d_model)) * 0.02).astype(np.float32)
    return out


def run_config(name: str, world: int, remat: str = "none", **train):
    from repro_torch import config as TC
    return TC.RunConfig(
        model=config(name),
        shape=TC.ShapeConfig("tp_train", SEQ, BATCH, "train"),
        mesh=TC.MeshConfig(MESHES[world], ("data", "model")),
        replication=TC.ReplicationConfig(variant="none"),
        train=TC.TrainConfig(remat=remat, grad_clip=CLIP, **train))


def named(tree: Any, prefix: str = "") -> List[tuple]:
    """``(path, leaf)`` in the trees' leaf order, e.g.
    ``layers/0/attn/wq``."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in named(tree[k],
                                                       f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [x for i, t in enumerate(tree)
                for x in named(t, f"{prefix}{i}/")]
    return [(prefix[:-1], tree)]


# ---------------------------------------------------------------------------
# One gradient
# ---------------------------------------------------------------------------

def grad_case(ctx, case: str, tree, fault: str = None) -> Dict[str, Any]:
    """``case``'s gradient on this rank: per leaf its path, this rank's
    block of the reduced gradient and of the clipped one, the block's
    slices of the global leaf (``None``: the whole leaf), and whether
    ``model`` splits the leaf; the loss, the global norm, the collective
    counts and the MoE's smallest top-k margin."""
    from repro_torch.distributed import collectives, sharding
    from repro_torch.models import build_model, moe
    from repro_torch.models.model_zoo import params_from_jax
    from repro_torch.training import steps, trainer
    name, remat, seq = (SEQ_GRADS[case] if case in SEQ_GRADS
                        else GRADS[case] + (SEQ,))
    policy = "seq_model" if case in SEQ_GRADS else "batch"
    world = ctx.world
    run = run_config(name, world, remat)
    model = build_model(run.model)
    key = objective(name, world)
    if key != "loss":
        loss_fn = model.loss_fn

        def only(p, b, **kw):
            total, metrics = loss_fn(p, b, **kw)
            return metrics[key], {**metrics, "total": total}
        model = dataclasses.replace(model, loss_fn=only)
    params = sharding.named_shardings(
        params_from_jax(run.model, tree, device="cpu"), run.model, ctx)
    for p in named(sharding.locals_of(params)):
        p[1].requires_grad_(True)
    rec = {"margin": float("inf")}
    own = moe.top_k_gates

    def margins(probs, k):
        top = probs.detach().sort(dim=-1, descending=True).values
        rec["margin"] = min(rec["margin"],
                            float((top[:, k - 1] - top[:, k]).min()))
        return own(probs, k)

    moe.top_k_gates = margins
    try:
        sharding.set_activation_policy(policy)
        with plant(fault):
            rows = trainer.batch_rows(BATCH, ctx)
            batch = {k: torch.from_numpy(v[rows])
                     for k, v in batch_data(name, seq).items()}
            collectives.reset_counts()
            loss, metrics, clipped, gnorm = steps.make_grad_fn(
                run, model, ctx)(params, batch)
            counts = dict(collectives.COUNTS)
            # the clip's scale, to read the reduced gradient back
            scale = min(1.0, CLIP / max(float(gnorm), 1e-6))
    finally:
        moe.top_k_gates = own
        sharding.set_activation_policy("batch")
    leaves = []
    for (path, leaf), (_, g) in zip(named(params), named(clipped)):
        shard = isinstance(leaf, sharding.Shard)
        sl = (tuple((s.start, s.stop) for s in sharding.block_slices(
            leaf.spec, leaf.shape, ctx)) if shard else None)
        c = g.detach().numpy().copy()
        leaves.append({"path": path, "slices": sl,
                       "split": shard and bool(leaf.split),
                       "clipped": c, "grad": c / np.float32(scale)})
    return {"leaves": leaves, "loss": float(loss.detach()),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "grad_norm": float(gnorm), "counts": counts,
            "margin": rec["margin"], "block": ctx.block,
            "model_rank": ctx.model_rank}


class _SummedSum(torch.autograd.Function):
    """``model_sum`` with its backward summed over the group (a fault:
    the gradient counted ``m`` times)."""

    @staticmethod
    def forward(fctx, x, ctx):
        fctx.ctx = ctx
        out = x.clone()
        torch.distributed.all_reduce(out, group=ctx.model_group)
        return out

    @staticmethod
    def backward(fctx, g):
        g = g.clone()
        torch.distributed.all_reduce(g, group=fctx.ctx.model_group)
        return g, None


@contextlib.contextmanager
def plant(fault: str = None):
    """A planted fault in the split train step for the length of a
    ``with`` (nothing for ``None``)."""
    if fault is None:
        yield
        return
    from repro_torch.distributed import collectives, sharding
    from repro_torch.optim import optimizers
    from repro_torch.training import steps, trainer
    saved = []

    def swap(obj, name, value):
        saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    if fault == "model_sum_bwd_summed":
        real = collectives.model_sum

        def summed(x, ctx):
            if ctx is None or ctx.model_group is None or \
                    not (torch.is_grad_enabled() and x.requires_grad):
                return real(x, ctx)
            return _SummedSum.apply(x, ctx)
        swap(collectives, "model_sum", summed)
    elif fault == "entry_dropped":
        swap(sharding, "enter", lambda x, *a, **kw: x)
    elif fault == "ssd_leaves_unsummed":
        swap(sharding, "part_weight", sharding.weight)
    elif fault == "fsdp_bwd_sliced":
        def sliced(fctx, g):
            dim, starts, ctx = fctx.dim, fctx.starts, fctx.ctx
            n = g.shape[dim] // len(set(starts))
            part = sorted(set(starts)).index(starts[ctx.block])
            return g.narrow(dim, part * n, n), None, None, None
        swap(collectives._FsdpGather, "backward", staticmethod(sliced))
    elif fault == "norm_unweighted":
        real = optimizers.clip_by_global_norm

        def unweighted(grads, max_norm, holders=None, group=None):
            return real(grads, max_norm,
                        None if holders is None else [1] * len(holders),
                        group)
        swap(steps, "clip_by_global_norm", unweighted)
    elif fault == "rows_by_rank":
        def by_rank(rows, ctx):
            # by rank, wrapped into the batch (past its end a rank would
            # get no rows, which no layer takes)
            per = rows // ctx.n_nodes * ctx.nodes_per_rank
            lo = ctx.rank * per % rows
            return slice(lo, lo + per)
        swap(trainer, "batch_rows", by_rank)
    elif fault == "seq_scatter_bwd_identity":
        def spanned(fctx, g):
            # the rank's span of the gradient alone, zeros elsewhere
            n, pos = g.shape[1], fctx.ctx.model_rank
            out = g.new_zeros((g.shape[0], n * fctx.ctx.model_size)
                              + tuple(g.shape[2:]))
            out.narrow(1, pos * n, n).copy_(g)
            return out, None
        swap(collectives._SeqScatter, "backward", staticmethod(spanned))
    elif fault == "seq_norm_unsummed":
        from repro_torch.models import layers, transformer
        real = layers.rmsnorm
        swap(transformer, "rmsnorm",
             lambda p, x, eps=1e-5, seq=False: real(p, x, eps))
    elif fault == "seq_other_span":
        def other(x, seq=True):
            if not seq:
                return x
            ctx = get_mesh_context()
            n = x.shape[1] // ctx.model_size
            pos = (ctx.model_rank + 1) % ctx.model_size
            return x.narrow(1, pos * n, n)
        from repro_torch.distributed.context import get_mesh_context
        swap(sharding, "to_span", other)
    elif fault == "ada_rows_unsummed":
        real = collectives.all_reduce_sum

        def cols_only(tensors, scale, ctx, group=None, name=None, **kw):
            if name == "adafactor_factors":      # (rows, cols) pairs
                return real(list(tensors)[1::2], scale, ctx, group, name)
            return real(tensors, scale, ctx, group, name or
                        "all_reduce_sum")
        swap(collectives, "all_reduce_sum", cols_only)
    elif fault == "ada_rms_unweighted":
        swap(optimizers, "_square_sum",
             lambda step, q: torch.sum(torch.square(step)))
    elif fault == "ada_parts_twice":
        swap(sharding, "sharers", lambda leaf, ctx, dims: 1)
    else:
        raise ValueError(fault)
    try:
        yield
    finally:
        for obj, name, value in reversed(saved):
            setattr(obj, name, value)


# ---------------------------------------------------------------------------
# Adafactor's update across split ranks
# ---------------------------------------------------------------------------

def stacked_named(tree: Any, prefix: str = "") -> List[tuple]:
    """``(path, leaf)`` of a stacked tree (``optimizers._stacked``: a
    layer list's leaves as lists), a list counting as one leaf; the vs
    dicts (``vr`` / ``vc`` or ``v``) also count as one."""
    if isinstance(tree, dict) and not ("vr" in tree or "v" in tree):
        return [x for k in sorted(tree)
                for x in stacked_named(tree[k], f"{prefix}{k}/")]
    return [(prefix[:-1], tree)]


def adafactor_case(group, case: str, tree, fault: str = None
                   ) -> Dict[str, Any]:
    """:data:`ADA_STEPS` Adafactor updates of ``case``'s blocks on this
    rank from the seeded global gradients (:func:`ada_grads`): per
    stacked leaf its path, the block's slices of the global stacked leaf
    (``None``: whole), the updated block and its ``vr`` / ``vc`` (or
    ``v``); the collective counts."""
    from repro_torch import config as TC
    from repro_torch.distributed import collectives, sharding
    from repro_torch.distributed.context import make_context, mesh_context
    from repro_torch.models.model_zoo import params_from_jax
    from repro_torch.optim import make_optimizer
    from repro_torch.optim.optimizers import _stacked
    world = torch.distributed.get_world_size(group)
    shape, axes = ADAFACTOR[case][2][world]
    ctx = make_context(shape, axes, device="cpu", group=group,
                       split_model=True, timeout_s=TIMEOUT_S)
    cfg = ada_config(case)
    init, update = make_optimizer(TC.TrainConfig(optimizer="adafactor"))

    def placed(t):
        return sharding.named_shardings(
            params_from_jax(cfg, t, device="cpu"), cfg, ctx)

    params = placed(tree)
    held = sharding.locals_of(params)
    with mesh_context(ctx), plant(fault):
        state = init(held)
        collectives.reset_counts()
        for step in range(ADA_STEPS):
            grads = sharding.locals_of(placed(ada_grads(tree, step)))
            update(grads, state, held, ADA_LR, params)
        counts = dict(collectives.COUNTS)
    leaves = []
    for (path, leaf), (_, v) in zip(stacked_named(_stacked(params)),
                                    stacked_named(state["vs"])):
        first = leaf[0] if isinstance(leaf, list) else leaf
        lead = [None] if isinstance(leaf, list) else []
        sl = None
        if isinstance(first, sharding.Shard):
            sl = lead + [(s.start, s.stop) for s in sharding.block_slices(
                first.spec, first.shape, ctx)]
        local = [sharding.locals_of(x) for x in leaf] \
            if isinstance(leaf, list) else [sharding.locals_of(leaf)]
        block = torch.stack(local) if lead else local[0]
        leaves.append({"path": path, "slices": sl,
                       "param": block.detach().numpy().copy(),
                       "vs": {k: t.numpy().copy() for k, t in v.items()}})
    return {"leaves": leaves, "counts": counts, "count": state["count"],
            "vs_bytes": sum(t.numel() * t.element_size()
                            for _, v in stacked_named(state["vs"])
                            for t in v.values()),
            "block_bytes": sum(
                t.numel() * t.element_size()
                for _, t in named(sharding.locals_of(params)))}


# ---------------------------------------------------------------------------
# The Trainer, the refusals
# ---------------------------------------------------------------------------

def train_run(name: str, configs=None, optimizer: str = "adamw"):
    """The ``Trainer``'s run config of ``name``: AdamW (or
    ``optimizer``), variant ``none``, a dump every ``DUMP_INTERVAL``
    steps (``configs``: the port's or the JAX package's ``config``
    module)."""
    if configs is None:
        from repro_torch import config as configs
    steps = (TRAIN_ADAFACTOR if optimizer == "adafactor" else TRAIN)[name]
    return configs.RunConfig(
        model=config(name, configs),
        shape=configs.ShapeConfig("tp_train", TRAIN_SEQ, TRAIN_BATCH,
                                  "train"),
        mesh=configs.MeshConfig(TRAIN_MESH, ("data", "model")),
        replication=configs.ReplicationConfig(
            variant="none", n_replicas=1, dump_interval=DUMP_INTERVAL),
        train=configs.TrainConfig(total_steps=steps, warmup_steps=1,
                                  learning_rate=1e-3, optimizer=optimizer))


def _host(tree) -> List[np.ndarray]:
    from repro_torch.distributed import sharding
    return [t.detach().numpy().copy() if torch.is_tensor(t) else
            np.asarray(t) for _, t in named(sharding.locals_of(tree))]


def trainer_case(group, name: str, tree, workdir: str,
                 optimizer: str = "adamw") -> Dict[str, Any]:
    """``TRAIN[name]`` (``TRAIN_ADAFACTOR[name]``) steps of the
    ``Trainer`` with ``optimizer`` on ``TRAIN_MESH`` from the JAX
    package's weights: the losses, whether the restored dump ``==`` the
    state at its step, and the optimizer state's bytes against the
    blocks'."""
    from repro_torch.distributed import sharding
    from repro_torch.distributed.context import make_context
    from repro_torch.models import transformer
    from repro_torch.models.model_zoo import params_from_jax
    from repro_torch.training.steps import init_train_state
    from repro_torch.training.trainer import Trainer
    ctx = make_context(TRAIN_MESH, ("data", "model"), device="cpu",
                       group=group, split_model=True, timeout_s=TIMEOUT_S)
    run = train_run(name, optimizer=optimizer)
    tr = Trainer(run, ctx, workdir)
    params = sharding.named_shardings(
        params_from_jax(run.model, tree, device="cpu"), run.model, ctx)
    tr.state = init_train_state(run, tr.model, run.train.seed, None,
                                params=params, ctx=ctx)
    coef = transformer.MOE_AUX_COEF
    if name in AUX_OFF:
        transformer.MOE_AUX_COEF = 0.0
    try:
        hist = tr.train(DUMP_INTERVAL)
        snap = _host({"params": tr.state.params, "opt": tr.state.opt_state})
        hist += tr.train(run.train.total_steps - DUMP_INTERVAL)
    finally:
        transformer.MOE_AUX_COEF = coef
    tr.ckpt.wait()
    restored, extra = tr.ckpt.restore(
        {"params": tr.state.params, "opt": tr.state.opt_state},
        step=DUMP_INTERVAL - 1)
    back = _host(restored)
    same = len(back) == len(snap) and all(
        a.dtype == b.dtype and np.array_equal(a, b)
        for a, b in zip(back, snap))
    kinds = [type(x).__name__ for _, x in named(restored["params"])]
    opt = tr.state.opt_state
    opt_bytes = sum(t.numel() * t.element_size()
                    for k in ("m", "v", "master", "vs") if k in opt
                    for _, t in named(opt[k]))
    # Adafactor's reckoning: per stacked leaf of the rank's blocks
    # (L, ..., r, c) the f32 vr (L, ..., r) and vc (L, ..., c), or an
    # unfactored leaf's v of its own shape
    from repro_torch.optim.optimizers import _stacked
    vs_reckoned = 0
    for _, x in stacked_named(_stacked(sharding.locals_of(
            tr.state.params))):
        shape = ((len(x),) + tuple(x[0].shape) if isinstance(x, list)
                 else tuple(x.shape))
        vs_reckoned += 4 * (int(np.prod(shape[:-1]))
                            + int(np.prod(shape[:-2] + shape[-1:]))
                            if len(shape) >= 2 else int(np.prod(shape)))
    block_elems = sum(
        int(np.prod([len(range(*s.indices(n))) for s, n in zip(
            sharding.block_slices(x.spec, x.shape, ctx), x.shape)]))
        if isinstance(x, sharding.Shard)
        else x.numel() for _, x in named(tr.state.params))
    return {"history": hist, "restored_equal": same,
            "restored_kinds": kinds, "opt_bytes": opt_bytes,
            "opt_trees": sum(k in opt for k in ("m", "v", "master")),
            "vs_reckoned": vs_reckoned,
            "block_elems": block_elems, "n_blocks": ctx.n_blocks,
            "dump_dir": os.path.basename(tr.ckpt.dir),
            "pipeline_step": extra.get("pipeline_step")}


def refusal_cases(ctx, workdir: str) -> Dict[str, str]:
    """Each refusal's exception type and message (``"none"`` if it
    passed): a fail-stop under variant ``none`` (the WB data-loss error)
    on the ``Trainer``'s mesh; and a replicating variant (proactive) and
    Adafactor (A4(d2b3)) across split ranks, each of which builds and
    takes a step."""
    from repro_torch import config as TC
    from repro_torch.core.failures import FailureEvent, FailureInjector
    from repro_torch.distributed.context import make_context
    from repro_torch.training.trainer import Trainer

    def name_of(fn):
        try:
            fn()
        except Exception as e:           # noqa: BLE001 - the type is read
            return f"{type(e).__name__}: {e}"
        return "none"

    rep = dataclasses.replace(train_run("qwen3"),
                              replication=TC.ReplicationConfig(
                                  variant="proactive", n_replicas=1,
                                  n_buckets=2, log_capacity=2))
    ada = train_run("qwen3", optimizer="adafactor")
    tctx = make_context(TRAIN_MESH, ("data", "model"), device="cpu",
                        group=ctx.group, split_model=True,
                        timeout_s=TIMEOUT_S)
    fail = FailureInjector([FailureEvent(step=1, node=1)])
    return {"replicating": name_of(lambda: Trainer(rep, tctx,
                                                   workdir).train(1)),
            "adafactor": name_of(lambda: Trainer(
                ada, tctx, os.path.join(workdir, "ada")).train(1)),
            "fail_stop": name_of(lambda: Trainer(
                train_run("qwen3"), tctx, workdir, injector=fail).train(2))}


def repeated_parts_case(group) -> Dict[str, Any]:
    """``fsdp_gather`` over a world of 4 node blocks (a (pod 2, data 2,
    model 1) mesh) of a dimension of 6 rows that only ``pod`` divides:
    each pod's two blocks hold the same part (``starts`` repeats), so the
    backward is an all-reduce and the block's slice. Each rank weighs the
    gathered tensor by ``rank + 1`` times a fixed pattern."""
    from repro_torch.distributed import collectives
    from repro_torch.distributed.context import make_context
    ctx = make_context((2, 2, 1), ("pod", "data", "model"), device="cpu",
                       group=group, split_model=True, timeout_s=TIMEOUT_S)
    base = torch.arange(12, dtype=torch.float32).reshape(6, 2)
    part = ctx.block // 2
    x = base[3 * part:3 * part + 3].clone().requires_grad_(True)
    full = collectives.fsdp_gather(x, 0, (0, 0, 3, 3), ctx)
    (full * base * (ctx.rank + 1)).sum().backward()
    return {"gathered": full.detach().numpy(), "grad": x.grad.numpy(),
            "part": part, "base": base.numpy()}


# ---------------------------------------------------------------------------
# Spawning a world
# ---------------------------------------------------------------------------

def _main(rank: int, world: int, tmpdir: str) -> None:
    torch.set_num_threads(1)
    assert "jax" not in sys.modules
    from repro_torch.distributed.context import make_context, node_group
    group = node_group("cpu", init_method=f"file://{tmpdir}/pg",
                       world_size=world, rank=rank, timeout_s=TIMEOUT_S)
    with open(os.path.join(tmpdir, "inputs.pkl"), "rb") as f:
        trees = pickle.load(f)
    ctx = make_context(MESHES[world], ("data", "model"), device="cpu",
                       group=group, split_model=True, timeout_s=TIMEOUT_S)
    out: Dict[str, Any] = {"rank": rank, "block": ctx.block,
                           "model_rank": ctx.model_rank}
    out["grads"] = {case: grad_case(ctx, case, trees[GRADS[case][0]])
                    for case in GRADS}
    out["faults"] = {f: grad_case(ctx, case, trees[GRADS[case][0]], f)
                     for f, case in FAULTS.items()
                     if ctx.n_blocks > 1 or f not in SPLIT_FAULTS}
    out["seq_grads"] = {case: grad_case(ctx, case, trees[SEQ_GRADS[case][0]])
                        for case in SEQ_GRADS}
    out["seq_faults"] = {f: grad_case(ctx, case,
                                      trees[SEQ_GRADS[case][0]], f)
                         for f, case in SEQ_FAULTS.items()}
    out["train"] = {name: trainer_case(group, name, trees[name],
                                       os.path.join(tmpdir, f"tr_{name}"))
                    for name in TRAIN}
    out["train_adafactor"] = {
        name: trainer_case(group, name, trees[name],
                           os.path.join(tmpdir, f"tra_{name}"), "adafactor")
        for name in TRAIN_ADAFACTOR}
    out["adafactor"] = {case: adafactor_case(group, case, trees[f"ada_{case}"])
                        for case, (_, _, meshes) in ADAFACTOR.items()
                        if world in meshes}
    out["adafactor_faults"] = {
        f: adafactor_case(group, case, trees[f"ada_{case}"], f)
        for f, case in ADA_FAULTS.items() if world in ADAFACTOR[case][2]}
    out["refusals"] = refusal_cases(ctx, os.path.join(tmpdir, "refused"))
    if world == 4:
        out["repeated_parts"] = repeated_parts_case(group)
    out["jax_imported"] = "jax" in sys.modules
    with open(os.path.join(tmpdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    torch.distributed.destroy_process_group()


def start(world: int, tmpdir: str, trees: Dict[str, Any]):
    """Spawn a ``gloo`` world of ``world`` ranks training from ``trees``
    (each config's JAX parameters as f32 numpy); returns the handle for
    :func:`finish`."""
    with open(os.path.join(tmpdir, "inputs.pkl"), "wb") as f:
        pickle.dump(trees, f)
    return torch.multiprocessing.start_processes(
        _main, args=(world, tmpdir), nprocs=world, join=False,
        start_method="spawn")


def finish(handle, world: int, tmpdir: str) -> List[Dict[str, Any]]:
    """Wait for the world; every rank's results, in rank order. A rank
    that raised raises here."""
    while not handle.join():
        pass
    out = []
    for r in range(world):
        with open(os.path.join(tmpdir, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out

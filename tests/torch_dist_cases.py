"""The worker side of ``tests/test_torch_distributed.py``: the port's
ReCXL mechanism and ``Trainer`` across ``gloo`` ranks on the CPU.

:func:`start` spawns a world of processes with ``torch.multiprocessing``
(``spawn``, a ``file://`` rendezvous in the test's temporary directory,
so parallel test workers never share a port); each rank runs every
case below and pickles its results, numpy only, which
:func:`finish` collects. This module imports torch, numpy and
``repro_torch`` only, and every worker checks that no JAX was imported.
The states and configurations are those of ``test_torch_replication.py``
and ``test_torch_trainer.py``.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import shutil
import sys
import tempfile
from typing import Any, Callable, Dict, List

import numpy as np
import torch

#: the per-world time limit of a collective (a fault must not hang)
TIMEOUT_S = 120.0
VARIANTS = ("baseline", "parallel", "proactive")
N_STEPS = 3
TRAIN_STEPS = 6
TRAIN_FAIL = (3, 2)                 # (step, node)
#: (name, failure, dtype) of the Trainer runs: the reduced config's bf16
#: with and without the failure, and an f32 copy
TRAIN_RUNS = (("unfailed", None, "bfloat16"),
              ("failed", TRAIN_FAIL, "bfloat16"), ("f32", None, "float32"))
MESH8 = ((4, 2), ("data", "model"))
POD_MESH8 = ((2, 2, 2), ("pod", "data", "model"))
COPY = dict(n_replicas=2, n_buckets=2, log_capacity=3, log_dtype="float32")
PARITY = dict(variant="proactive", n_replicas=1, n_buckets=2,
              log_capacity=2, mode="parity", parity_group=2,
              log_dtype="float32")
#: the pod mesh's rings: the joined (pod, data) ring of 4 (N_r 2) for
#: every variant, and each pod's own ring of 2 (N_r 1)
POD_CASES = [(v, c, True) for v in VARIANTS for c in (True, False)] \
    + [("proactive", c, False) for c in (True, False)]


def state() -> Dict[str, np.ndarray]:
    """``test_torch_replication.py``'s state: not symmetric across
    nodes, so a wrong ``ppermute`` direction shows."""
    return {
        "w1": np.arange(48, dtype=np.float32).reshape(8, 6),
        "w2": np.arange(32, dtype=np.float32).reshape(4, 8) * 0.5,
        "scale": np.linspace(0.25, 2.0, 6).astype(np.float32),
    }


def specs(pod: bool) -> Dict[str, tuple]:
    """The state's partition specs as axis tuples (the node dimensions
    sharded over (pod, data) joined, pod-major, on the pod mesh)."""
    node = ("pod", "data") if pod else "data"
    return {"w1": (node, "model"), "w2": ("model", node), "scale": (None,)}


def copy_update(x):
    return x * 1.5 + 1.0


def parity_update(x):
    return x * 1.25 + 0.5


def train_run(dtype: str = "bfloat16"):
    """``test_torch_trainer.py``'s run config: reduced qwen3-0.6b (its
    bf16, or ``dtype``), batch 8 x 32, proactive, N_r 2, 4 buckets, 2
    log slots."""
    from repro_torch import config as TC
    return TC.RunConfig(
        model=dataclasses.replace(TC.get_reduced_config("qwen3-0.6b"),
                                  dtype=dtype),
        shape=TC.ShapeConfig("smoke", seq_len=32, global_batch=8,
                             kind="train"),
        mesh=TC.MeshConfig(*MESH8),
        replication=TC.ReplicationConfig(
            variant="proactive", n_replicas=2, n_buckets=4, log_capacity=2,
            dump_interval=6),
        train=TC.TrainConfig(total_steps=30, warmup_steps=2,
                             learning_rate=1e-3))


# ---------------------------------------------------------------------------
# Results as plain data
# ---------------------------------------------------------------------------

def result_data(res) -> Dict[str, Any]:
    """A ``RecoveryResult`` as numpy and builtins."""
    return {
        "failed": tuple(res.failed),
        "stats": dataclasses.astuple(res.stats),
        "messages": [(t.value, {k: getattr(v, "addrs", v)
                                for k, v in m.items()})
                     for t, m in res.message_log],
        "shards": {b: (s.bucket, s.ts, s.source, s.values.numpy())
                   for b, s in res.shards.items()},
    }


def logs_data(logs) -> Dict[str, np.ndarray]:
    return {k: v.numpy().copy() for k, v in logs.items()}


# ---------------------------------------------------------------------------
# The engine and recovery
# ---------------------------------------------------------------------------

def ring_run(ctx, pod: bool, update: Callable, st=None, **rep):
    """The rank's engine, global state and local logs after ``N_STEPS``
    of ``x -> update(x)``."""
    from repro_torch.config import ReplicationConfig
    from repro_torch.core.replication import ReplicationEngine
    from repro_torch.distributed.context import P
    st = state() if st is None else st
    sp = {k: P(*specs(pod)[k]) for k in st}
    params = {k: torch.from_numpy(v.copy()) for k, v in st.items()}
    eng = ReplicationEngine(ReplicationConfig(**rep), ctx, sp, params)
    logs = eng.init_logs()
    for i in range(N_STEPS):
        params = {k: update(x) for k, x in params.items()}
        logs, params = eng.replicate(params, logs, i, params)
    return eng, params, logs


def recover_all(eng, logs) -> List[Dict[str, Any]]:
    """Every ring node recovered on this rank (every rank runs each)."""
    from repro_torch.core import recovery as R
    out = []
    for ring in range(eng.n_nodes):
        res = R.recover_node(eng, logs, eng.shard_directory(),
                             failed_coord=eng.node_coord(ring))
        data = result_data(res)
        data["tree"] = [{k: v.numpy() for k, v in
                         eng.unflatten(leaves).items()}
                        for leaves in R.reassemble_shard(eng, res)]
        out.append(data)
    return out


def ring_cases(group) -> Dict[str, Any]:
    from repro_torch.core import recovery as R
    from repro_torch.distributed.context import P, make_context
    out: Dict[str, Any] = {}
    ctx = make_context(*MESH8, device="cpu", group=group)
    out["local_starts"] = ctx.local_starts
    out["local_sizes"] = ctx.local_sizes
    for v in VARIANTS:
        for c in (True, False):
            eng, _, logs = ring_run(ctx, False, copy_update, variant=v,
                                    coalescing=c, **COPY)
            out[("ring", v, c)] = logs_data(logs)
            out[("recover", v, c)] = recover_all(eng, logs)
    st = {k: v for k, v in state().items() if k != "scale"}
    eng, params, logs = ring_run(ctx, False, parity_update, st=st, **PARITY)
    out["parity_ring"] = logs_data(logs)
    sp = {k: P(*specs(False)[k]) for k in st}
    out["parity_recover"] = {
        failed: result_data(R.recover_node_parity(eng, logs, params, sp,
                                                  failed_coord=(failed,)))
        for failed in (0, 3)}
    pctx = make_context(*POD_MESH8, device="cpu", group=group)
    out["pod_local_starts"] = pctx.local_starts
    out["pod_local_sizes"] = pctx.local_sizes
    for v, c, x in POD_CASES:
        eng, _, logs = ring_run(pctx, True, copy_update, variant=v,
                                coalescing=c, cross_pod_replicas=x,
                                **dict(COPY, n_replicas=2 if x else 1))
        out[("pod_ring", v, c, x)] = logs_data(logs)
        if x:
            out[("pod_recover", v, c)] = recover_all(eng, logs)
    return out


def planted_ring_cases(group) -> Dict[str, Any]:
    """The copy ring with a fault planted in the collectives: a
    cross-rank REPL sent to ``(s - off)``, and one cross-rank VAL
    dropped. Every rank plants the same fault, so the plans still pair
    up; each ring must differ from the reference's."""
    from repro_torch.distributed import collectives
    from repro_torch.distributed.context import make_context
    ctx = make_context(*MESH8, device="cpu", group=group)
    real = collectives.ppermute
    n = ctx.n_nodes

    def cross(perm):
        return [(s, t) for s, t in perm if ctx.owner(s) != ctx.owner(t)]

    def repl_backwards(x, out, perm, c):
        if x.dtype != torch.int32:
            bad = set(cross(perm))
            perm = [(s, (2 * s - t) % n) if (s, t) in bad else (s, t)
                    for s, t in perm]
        return real(x, out, perm, c)

    def val_dropped(x, out, perm, c):
        if x.dtype == torch.int32 and cross(perm):
            perm = [p for p in perm if p != cross(perm)[0]]
        return real(x, out, perm, c)

    out = {}
    try:
        for name, fake in (("repl_backwards", repl_backwards),
                           ("val_dropped", val_dropped)):
            collectives.ppermute = fake
            _, _, logs = ring_run(ctx, False, copy_update,
                                  variant="proactive", coalescing=False,
                                  **COPY)
            out[name] = logs_data(logs)
    finally:
        collectives.ppermute = real
    return out


def refusal_cases(group, world: int) -> Dict[str, str]:
    """The context's refusals, each message (or "no error")."""
    from repro_torch.distributed.context import make_context
    out = {}
    for name, args in (("cuda_on_gloo", ((4, 2), ("data", "model"),
                                         "cuda")),
                       ("world_not_dividing", ((world + 1, 2),
                                               ("data", "model"), "cpu"))):
        try:
            make_context(*args[:2], device=args[2], group=group)
            out[name] = "no error"
        except ValueError as e:
            out[name] = f"ValueError: {e}"
    return out


# ---------------------------------------------------------------------------
# The data-parallel Trainer
# ---------------------------------------------------------------------------

def trainer(group, workdir: str, params0, fail=None,
            dtype: str = "bfloat16"):
    """A rank's ``Trainer`` from the given initial parameters (the JAX
    Trainer's bf16 values as f32 numpy, in its layout) in ``dtype``,
    with a fail-stop ``fail``."""
    from repro_torch.core.failures import FailureEvent, FailureInjector
    from repro_torch.distributed.context import make_context
    from repro_torch.models.model_zoo import params_from_jax
    from repro_torch.optim.optimizers import tree_map
    from repro_torch.training.steps import init_train_state
    from repro_torch.training.trainer import Trainer
    run = train_run(dtype)
    ctx = make_context(*MESH8, device="cpu", group=group)
    inj = FailureInjector([FailureEvent(step=fail[0], node=fail[1])]
                          if fail else [])
    tr = Trainer(run, ctx, workdir, injector=inj)
    params = params_from_jax(dataclasses.replace(run.model, dtype="float32"),
                             params0, device="cpu")
    tr.state = init_train_state(
        run, tr.model, run.train.seed, tr.engine,
        params=tree_map(lambda x: x.to(getattr(torch, dtype)), params))
    return tr


def params_data(tr) -> List[np.ndarray]:
    from repro_torch.optim.optimizers import tree_leaves
    return [p.detach().float().numpy().copy()
            for p in tree_leaves(tr.state.params)]


def train_cases(group, params0) -> Dict[str, Any]:
    from repro_torch.distributed import collectives
    from repro_torch.distributed.context import make_context
    from repro_torch.training.steps import rank_weight
    out: Dict[str, Any] = {}
    ctx = make_context(*MESH8, device="cpu", group=group)
    # a masked batch: rank r holds r + 1 loss tokens of 2 r + 2 rows
    mask = torch.zeros(2 * ctx.rank + 2)
    mask[:ctx.rank + 1] = 1.0
    out["rank_weight"] = (rank_weight({"mask": mask}, ctx),
                          rank_weight({}, ctx))
    root = tempfile.mkdtemp()
    try:
        for name, fail, dtype in TRAIN_RUNS:
            tr = trainer(group, os.path.join(root, name), params0, fail,
                         dtype)
            hist = tr.train(TRAIN_STEPS)
            tr.ckpt.wait()
            out[name] = {
                "losses": [h["loss"] for h in hist],
                "params": params_data(tr),
                "events": [{k: e[k] for k in ("step", "event", "recovered",
                                              "stats", "cm", "cm_rank")
                            if k in e} for e in tr.events],
                "dump_dirs": sorted(os.listdir(os.path.join(root, name))),
            }
        # planted: one rank keeps its own gradient (the sum is still
        # taken with every rank, so nothing hangs)
        real = collectives.all_reduce_sum

        def skipped(tensors, scale, ctx, **kw):
            if ctx.rank == ctx.world - 1:
                real([t.clone() for t in tensors], scale, ctx, **kw)
                return
            real(tensors, scale, ctx, **kw)

        collectives.all_reduce_sum = skipped
        try:
            tr = trainer(group, os.path.join(root, "skip"), params0)
            hist = tr.train(2)
            tr.ckpt.wait()
        finally:
            collectives.all_reduce_sum = real
        out["skip_all_reduce"] = {"losses": [h["loss"] for h in hist],
                                  "params": params_data(tr)}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


# ---------------------------------------------------------------------------
# Spawning a world
# ---------------------------------------------------------------------------

def _main(rank: int, world: int, tmpdir: str) -> None:
    torch.set_num_threads(1)
    assert "jax" not in sys.modules
    from repro_torch.distributed.context import node_group
    group = node_group("cpu", init_method=f"file://{tmpdir}/pg",
                       world_size=world, rank=rank, timeout_s=TIMEOUT_S)
    with open(os.path.join(tmpdir, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    out = {"rank": rank}
    out.update(ring_cases(group))
    out["planted"] = planted_ring_cases(group)
    out["refusals"] = refusal_cases(group, world)
    out["train"] = train_cases(group, inputs["params0"])
    assert "jax" not in sys.modules
    out["jax_imported"] = "jax" in sys.modules
    with open(os.path.join(tmpdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    torch.distributed.destroy_process_group()


def start(world: int, tmpdir: str, params0):
    """Spawn a ``gloo`` world of ``world`` ranks; returns the handle for
    :func:`finish`."""
    with open(os.path.join(tmpdir, "inputs.pkl"), "wb") as f:
        pickle.dump({"params0": params0}, f)
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

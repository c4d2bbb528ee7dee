"""The worker side of ``tests/test_torch_split_replication.py``: the
port's REPL / VAL, recovery and install across ``gloo`` ranks that split
the ``model`` axis, on the CPU.

:func:`start` spawns a world with ``torch.multiprocessing`` (``spawn``, a
``file://`` rendezvous in the test's temporary directory); every rank
builds contexts whose ranks split ``model``
(``make_context(..., split_model=True)``), places
``torch_dist_cases.state()`` as ``sharding.Shard`` blocks by
``torch_dist_cases.specs()``, and runs the replication engine over them:
its part of each ring, every ring node recovered, the recovered shard
installed into holed blocks, the link bytes counted, each under planted
faults too; then the split ``Trainer`` with ``proactive`` and a
fail-stop, and one counted train step for the dry run's bytes. It
pickles numpy only. This module imports torch, numpy and
``repro_torch`` only, and every worker checks that no JAX was imported.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import shutil
import sys
import tempfile
from typing import Any, Dict, List

import numpy as np
import torch

import torch_dist_cases as dc
import torch_tp_train_cases as tc

TIMEOUT_S = 120.0
#: the ring nodes whose shard is installed (one per block at world 4)
INSTALL_NODES = (0, 3)
#: the Trainer runs on ``tc.TRAIN_MESH``: (name, failure) with the
#: failure (step, node) of a fail-stop
TRAIN_STEPS = tc.TRAIN["qwen3"]
TRAIN_FAIL = (2, 1)
TRAIN_RUNS = (("unfailed", None), ("failed", TRAIN_FAIL))
#: the counted step of the dry run's cell: reduced qwen3 (its bf16) at
#: data 2 x model 2, batch 4 x 16, proactive, N_r 1
STEP_MESH = ((2, 2), ("data", "model"))
STEP_SHAPE = ("split_bytes", 16, 4, "train")


def train_rep(configs=None):
    """The Trainer's replication: proactive, N_r 1, 2 buckets, 2 log
    slots, the log in f32 (the state's dtype: the ring is exact)."""
    if configs is None:
        from repro_torch import config as configs
    return configs.ReplicationConfig(
        variant="proactive", n_replicas=1, n_buckets=2, log_capacity=2,
        log_dtype="float32", dump_interval=tc.DUMP_INTERVAL)


def train_run(configs=None):
    """``torch_tp_train_cases.train_run("qwen3")`` with :func:`train_rep`."""
    return dataclasses.replace(tc.train_run("qwen3", configs),
                               replication=train_rep(configs))


#: the dry run's split cells held to a counted step: name -> (the
#: ``TrainConfig`` fields the cell overrides, the activation policy)
STEP_CELLS = {"adamw": ({}, "batch"),
              "adafactor": ({"optimizer": "adafactor"}, "batch"),
              "seq_model": ({}, "seq_model")}


def step_run(cell: str = "adamw"):
    """The run config of the dry run's split cell (``launch/dryrun.py``
    builds the same): the model's default train config with the cell's
    overrides (:data:`STEP_CELLS`), the cell's replication."""
    from repro_torch import config as C
    return C.RunConfig(
        model=C.get_reduced_config("qwen3-0.6b"),
        shape=C.ShapeConfig(*STEP_SHAPE),
        mesh=C.MeshConfig(*STEP_MESH),
        replication=C.ReplicationConfig(variant="proactive", n_replicas=1,
                                        log_capacity=2),
        train=C.TrainConfig(**STEP_CELLS[cell][0]))


# ---------------------------------------------------------------------------
# The engine over Shard blocks
# ---------------------------------------------------------------------------

def placed(ctx, pod: bool, st=None):
    """The state's blocks on this rank: a ``Shard`` a sharded leaf, the
    replicated ``scale`` whole; and the specs."""
    from repro_torch.distributed import sharding
    from repro_torch.distributed.context import P
    st = dc.state() if st is None else st
    sp = {k: P(*dc.specs(pod)[k]) for k in st}
    return ({k: sharding.place(torch.from_numpy(v.copy()), sp[k], ctx)
             for k, v in st.items()}, sp)


def stepped(tree, update):
    """``update`` applied to every block (elementwise: the block of the
    updated global state)."""
    from repro_torch.distributed import sharding
    return {k: dataclasses.replace(v, local=update(v.local))
            if isinstance(v, sharding.Shard) else update(v)
            for k, v in tree.items()}


def split_ring(ctx, pod: bool, update, st=None, **rep):
    """The rank's engine, blocks and ring after ``N_STEPS`` of
    ``update``, and the collectives' counts and bytes of those steps."""
    from repro_torch.config import ReplicationConfig
    from repro_torch.core.replication import ReplicationEngine
    from repro_torch.distributed import collectives
    params, sp = placed(ctx, pod, st)
    eng = ReplicationEngine(ReplicationConfig(**rep), ctx, sp, params)
    logs = eng.init_logs()
    collectives.reset_counts()
    for i in range(dc.N_STEPS):
        params = stepped(params, update)
        logs, params = eng.replicate(params, logs, i, params)
    counts = {"counts": dict(collectives.COUNTS),
              "bytes": dict(collectives.BYTES)}
    return eng, params, logs, counts


def recover_split(eng, logs) -> List[Dict[str, Any]]:
    """Every ring node recovered on this rank: the result as data, its
    position and its row's leaves."""
    from repro_torch.core import recovery as R
    out = []
    for ring in range(eng.n_nodes):
        res = R.recover_node(eng, logs, eng.shard_directory(),
                             failed_coord=eng.node_coord(ring))
        data = dc.result_data(res)
        data["model_pos"] = {s.model_pos for s in res.shards.values()}
        data["tree"] = ([{k: v.numpy() for k, v in
                          eng.unflatten(leaves).items()}
                         for leaves in R.reassemble_shard(eng, res)]
                        if not res.stats.unrecoverable else None)
        out.append(data)
    return out


def holed(tree, ctx, node: int):
    """A copy of the blocks with the failed node's parts NaN (what a
    fail-stop loses), and every replicated leaf NaN."""
    from repro_torch.distributed import sharding
    out = {}
    for k, v in tree.items():
        if isinstance(v, sharding.Shard):
            local = v.local.clone()
            cut = sharding.node_part(v, ctx, node)
            if cut is not None:
                local[cut] = float("nan")
            out[k] = dataclasses.replace(v, local=local)
        else:
            out[k] = torch.full_like(v, float("nan"))
    return out


def install_cases(eng, params, logs, ctx, other_rows: bool = False
                  ) -> Dict[int, Dict[str, np.ndarray]]:
    """For each of ``INSTALL_NODES``: the rank's blocks after the
    recovered shard is installed into the holed blocks (``other_rows``:
    a planted fault, the rows of the next ``model`` position installed)."""
    from repro_torch.core import recovery as R
    from repro_torch.distributed import elastic, sharding
    out = {}
    for node in INSTALL_NODES:
        coord = eng.node_coord(node)
        res = R.recover_node(eng, logs, eng.shard_directory(),
                             failed_coord=coord)
        if other_rows:
            rows = [None] * ctx.model_size
            mine = {b: s.values for b, s in res.shards.items()}
            torch.distributed.all_gather_object(rows, mine,
                                                group=ctx.model_group)
            nxt = rows[(ctx.model_rank + 1) % ctx.model_size]
            for b, s in res.shards.items():
                s.values = nxt[b]
        tree = holed(params, ctx, eng.joined_index(coord))
        got = elastic.install_recovered_shard(tree, eng.param_specs, eng,
                                              res, coord)
        out[node] = {k: (sharding.locals_of(v)).numpy().copy()
                     for k, v in got.items()}
    return out


def ring_cases(group) -> Dict[str, Any]:
    from repro_torch.core import recovery as R
    from repro_torch.distributed.context import make_context
    out: Dict[str, Any] = {}
    ctx = make_context(*dc.MESH8, device="cpu", group=group,
                       split_model=True, timeout_s=TIMEOUT_S)
    out["ctx"] = (ctx.local_starts, ctx.local_sizes, ctx.block,
                  ctx.model_rank)
    for v in dc.VARIANTS:
        for c in (True, False):
            eng, params, logs, counts = split_ring(
                ctx, False, dc.copy_update, variant=v, coalescing=c,
                **dc.COPY)
            out[("ring", v, c)] = dc.logs_data(logs)
            out[("recover", v, c)] = recover_split(eng, logs)
            out[("counts", v, c)] = counts
            if v == "proactive":
                out[("install", c)] = install_cases(eng, params, logs, ctx)
                out[("install_other_rows", c)] = install_cases(
                    eng, params, logs, ctx, other_rows=True)
                out[("blocks", c)] = {
                    k: x.local.numpy().copy() if hasattr(x, "local")
                    else x.numpy().copy() for k, x in params.items()}
    st = {k: v for k, v in dc.state().items() if k != "scale"}
    eng, params, logs, counts = split_ring(ctx, False, dc.parity_update,
                                           st=st, **dc.PARITY)
    out["parity_ring"] = dc.logs_data(logs)
    out["parity_recover"] = {}
    for failed in (0, 3):
        res = R.recover_node_parity(eng, logs, params, eng.param_specs,
                                    failed_coord=(failed,))
        data = dc.result_data(res)
        data["model_pos"] = {s.model_pos for s in res.shards.values()}
        out["parity_recover"][failed] = data
    return out


def pod_cases(group) -> Dict[str, Any]:
    """The pod mesh (2 pod x 2 data x 2 model) at world 4: one pod a
    block; the joined cross-pod ring and each pod's own ring."""
    from repro_torch.distributed.context import make_context
    out: Dict[str, Any] = {}
    ctx = make_context(*dc.POD_MESH8, device="cpu", group=group,
                       split_model=True, timeout_s=TIMEOUT_S)
    out["pod_ctx"] = (ctx.local_starts, ctx.local_sizes)
    for v, c, x in dc.POD_CASES:
        eng, _, logs, _ = split_ring(
            ctx, True, dc.copy_update, variant=v, coalescing=c,
            cross_pod_replicas=x, **dict(dc.COPY, n_replicas=2 if x else 1))
        out[("pod_ring", v, c, x)] = dc.logs_data(logs)
        if x:
            out[("pod_recover", v, c)] = recover_split(eng, logs)
    return out


# ---------------------------------------------------------------------------
# Planted faults
# ---------------------------------------------------------------------------

def _other_position(c):
    """``c`` whose peers on other node blocks sit at the next ``model``
    position: every rank plants the same swap, so the plans pair up."""
    ctx = dataclasses.replace(c)
    real = c.rank_of
    m = c.model_size

    def rank_of(node, model_pos=None):
        if model_pos is None and c.owner(node) != c.block:
            return real(node, (c.model_rank + 1) % m)
        return real(node, model_pos)
    object.__setattr__(ctx, "rank_of", rank_of)
    return ctx


def planted_cases(group) -> Dict[str, Any]:
    """The proactive ring (coalescing off) and its recoveries, under each
    fault: a cross-block REPL sent to the rank of the next ``model``
    position (world 4: one block has no cross-block pair); recovery's
    table summed over the world, not the FSDP group; position 1's VAL of
    one pair dropped."""
    from repro_torch.core import recovery as R
    from repro_torch.distributed import collectives
    from repro_torch.distributed.context import make_context
    ctx = make_context(*dc.MESH8, device="cpu", group=group,
                       split_model=True, timeout_s=TIMEOUT_S)
    ppermute, gather = collectives.ppermute, collectives.gather_rows

    def wrong_position(x, out, perm, c):
        if x.dtype != torch.int32:
            c = _other_position(c)
        return ppermute(x, out, perm, c)

    def summed_over_world(rows, c):
        if c.group is None:
            return rows
        t = torch.from_numpy(np.ascontiguousarray(rows, np.int64))
        torch.distributed.all_reduce(t, group=c.group)
        return t.numpy()

    def no_fetch(engine, logs, coord, rank, slot, bucket):
        # the summed table names slots past the ring: read nothing
        return torch.zeros(engine.local_model_size,
                           engine.layout.bucket_len)

    def val_dropped(x, out, perm, c):
        if x.dtype == torch.int32 and c.model_rank == 1:
            perm = list(perm)[1:]
        return ppermute(x, out, perm, c)

    faults = {"val_dropped": ("ppermute", val_dropped),
              "table_over_world": ("gather_rows", summed_over_world)}
    if ctx.n_blocks > 1:
        faults["repl_wrong_position"] = ("ppermute", wrong_position)
    out = {}
    fetch = R._fetch
    try:
        for name, (attr, fake) in faults.items():
            setattr(collectives, attr, fake)
            if name == "table_over_world":
                R._fetch = no_fetch
            try:
                eng, _, logs, _ = split_ring(
                    ctx, False, dc.copy_update, variant="proactive",
                    coalescing=False, **dc.COPY)
                out[name] = {"ring": dc.logs_data(logs),
                             "recover": recover_split(eng, logs)}
            finally:
                collectives.ppermute, collectives.gather_rows = \
                    ppermute, gather
                R._fetch = fetch
    finally:
        collectives.ppermute, collectives.gather_rows = ppermute, gather
        R._fetch = fetch
    return out


# ---------------------------------------------------------------------------
# The Trainer, and one counted step
# ---------------------------------------------------------------------------

def trainer_case(group, tree, workdir: str, fail=None) -> Dict[str, Any]:
    """``TRAIN_STEPS`` of the split ``Trainer`` on ``tc.TRAIN_MESH`` from
    the JAX package's weights, proactive, with a fail-stop ``fail``
    whose install is handed blocks holed where the failed node's parts
    were (the recovered shard must come from the ring alone)."""
    from repro_torch.core.failures import FailureEvent, FailureInjector
    from repro_torch.distributed import sharding
    from repro_torch.distributed.context import make_context
    from repro_torch.models.model_zoo import params_from_jax
    from repro_torch.optim.optimizers import tree_leaves
    from repro_torch.training import trainer as trainer_mod
    from repro_torch.training.steps import init_train_state
    ctx = make_context(tc.TRAIN_MESH, ("data", "model"), device="cpu",
                       group=group, split_model=True, timeout_s=TIMEOUT_S)
    run = train_run()
    inj = FailureInjector([FailureEvent(step=fail[0], node=fail[1])]
                          if fail else [])
    tr = trainer_mod.Trainer(run, ctx, workdir, injector=inj)
    params = sharding.named_shardings(
        params_from_jax(run.model, tree, device="cpu"), run.model, ctx)
    tr.state = init_train_state(run, tr.model, run.train.seed, tr.engine,
                                params=params, ctx=ctx)
    real = trainer_mod.install_recovered_shard
    nan_left = []

    def holed_install(state, specs, engine, result, target_coord):
        node = engine.joined_index(target_coord)
        with torch.no_grad():
            for leaf in tree_leaves(state):
                if not isinstance(leaf, sharding.Shard):
                    leaf.fill_(float("nan"))
                    continue
                cut = sharding.node_part(leaf, ctx, node)
                if cut is not None:
                    leaf.local[cut] = float("nan")
        got = real(state, specs, engine, result, target_coord)
        nan_left.append(sum(bool(torch.isnan(t).any()) for t in
                            tree_leaves(sharding.locals_of(got))))
        return got

    trainer_mod.install_recovered_shard = holed_install
    try:
        hist = tr.train(TRAIN_STEPS)
    finally:
        trainer_mod.install_recovered_shard = real
    tr.ckpt.wait()
    leaves = sharding.locals_of(tr.state.params)
    ring = dc.logs_data(tr.state.logs)
    values = ring["values"].reshape((-1,) + ring["values"].shape[2:])
    unpacked = {
        (j, r, slot): dict(tc.named(tr.engine.unflatten(
            [x.numpy() for x in tr.engine.unpack(
                torch.from_numpy(values[j, r, slot]))])))
        for j in range(values.shape[0]) for r in range(values.shape[1])
        for slot in range(values.shape[2])}
    return {"history": hist, "ring": ring, "ring_leaves": unpacked,
            "blocks": [t.detach().numpy().copy()
                       for t in tree_leaves(leaves)],
            "requires_grad": all(t.requires_grad and t.is_leaf
                                 for t in tree_leaves(leaves)),
            "nan_left": nan_left,
            "events": [{k: e[k] for k in ("step", "event", "recovered",
                                          "stats", "cm", "cm_rank")
                        if k in e} for e in tr.events],
            "ctx": (ctx.local_starts, ctx.local_sizes)}


def step_bytes_case(group, cell: str = "adamw") -> Dict[str, Any]:
    """One train step of :func:`step_run` (``cell``'s) on this rank under
    its activation policy, its collectives' counts and bytes and its
    optimizer state's bytes (the dry run's split cell costs the same
    step)."""
    from repro_torch.core.replication import ReplicationEngine
    from repro_torch.distributed import collectives, sharding
    from repro_torch.distributed.context import make_context
    from repro_torch.distributed.sharding import param_specs
    from repro_torch.models import build_model
    from repro_torch.models.model_zoo import make_batch
    from repro_torch.training import trainer as trainer_mod
    from repro_torch.optim.optimizers import tree_leaves
    from repro_torch.training.steps import init_train_state, make_train_step
    run = step_run(cell)
    ctx = make_context(*STEP_MESH, device="cpu", group=group,
                       split_model=True, timeout_s=TIMEOUT_S)
    model = build_model(run.model)
    params = model.init(0, ctx=ctx)
    eng = ReplicationEngine(run.replication, ctx,
                            param_specs(params, run.model, ctx), params)
    state = init_train_state(run, model, 0, eng, params=params, ctx=ctx)
    step = make_train_step(run, model, eng, ctx)
    rows = trainer_mod.batch_rows(run.shape.global_batch, ctx)
    batch = {k: v[rows] for k, v in
             make_batch(run.model, run.shape, seed=0, device="cpu").items()}
    collectives.reset_counts()
    try:
        sharding.set_activation_policy(STEP_CELLS[cell][1])
        step(state, batch)
    finally:
        sharding.set_activation_policy("batch")
    opt = {k: v for k, v in state.opt_state.items() if k != "count"}
    return {"counts": dict(collectives.COUNTS),
            "bytes": dict(collectives.BYTES), "rank": ctx.rank,
            "opt_bytes": sum(t.numel() * t.element_size()
                             for t in tree_leaves(opt))}


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
    out: Dict[str, Any] = {"rank": rank}
    out.update(ring_cases(group))
    if world == 4:
        out.update(pod_cases(group))
        out["step_bytes"] = step_bytes_case(group)
        out["step_cells"] = {cell: step_bytes_case(group, cell)
                             for cell in STEP_CELLS if cell != "adamw"}
    out["planted"] = planted_cases(group)
    root = tempfile.mkdtemp()
    try:
        out["train"] = {name: trainer_case(group, inputs["qwen3"],
                                           os.path.join(root, name), fail)
                        for name, fail in TRAIN_RUNS}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["jax_imported"] = "jax" in sys.modules
    with open(os.path.join(tmpdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    torch.distributed.destroy_process_group()


def start(world: int, tmpdir: str, inputs: Dict[str, Any]):
    """Spawn a ``gloo`` world of ``world`` ranks; ``inputs`` holds the
    JAX package's reduced qwen3 weights (``"qwen3"``, f32 numpy).
    Returns the handle for :func:`finish`."""
    with open(os.path.join(tmpdir, "inputs.pkl"), "wb") as f:
        pickle.dump(inputs, f)
    return torch.multiprocessing.start_processes(
        _main, args=(world, tmpdir), nprocs=world, join=False,
        start_method="spawn")


def finish(handle, world: int, tmpdir: str) -> List[Dict[str, Any]]:
    """Wait for the world; every rank's results, in rank order."""
    while not handle.join():
        pass
    out = []
    for r in range(world):
        with open(os.path.join(tmpdir, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out

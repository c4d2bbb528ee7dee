"""Dry-run: prove the distribution config is coherent, and count what a
step costs, without computing anything.

For every (architecture x input-shape) cell that ``shape_applicable``
admits, on both production meshes (16x16 single-pod and 2x16x16
multi-pod, logical nodes), build the model, the train state and the
replication engine on the ``meta`` device -- shapes and dtypes, no
storage: the counterpart of the JAX package's ``ShapeDtypeStruct``
lowering -- and record:

* per-node bytes of the parameters, the optimizer state and the log
  ring, from the sharding specs (``distributed/sharding.py``) and the
  engine's layout;
* the step's global FLOPs, bytes and transcendentals, counted op by op
  as it runs on ``meta`` (``launch/costing.py``);
* the replication traffic of one train step from the engine's layout:
  each node sends its payload to N_r replicas (the JAX package's
  ``collective-permute`` split);
* ``model_params`` and ``active_params``;
* the one-card roofline: the step's FLOPs over 989 TFLOP/s (dense
  bf16) and its bytes over 3.35 TB/s (HBM3), the NVIDIA H100 80GB HBM3
  at 700 W. One card has no link, so no link time is modelled.

With ``split_model`` (``--split-model``) a cell costs rank 0 of the
mesh's layout over ranks that split ``model`` -- one ``model`` position
of a block of nodes, its ``sharding.Shard`` blocks -- in a one-process
``fake`` process group of the mesh's world
(``torch.testing._internal.distributed.fake_pg``), whose collectives
take ``meta`` tensors and move nothing. The record then gains
``collectives``: the rank's link bytes and calls a step, by collective
(``collectives.BYTES`` / ``COUNTS``, counted as the step runs), the
keys of the JAX package's ``collective_bytes``
(``src/repro/launch/costing.py:309``). A fake group cannot run the
REPL / VAL permutes (``batch_isend_irecv`` takes no ``meta`` tensor), so
the step is costed without the replicate and its ``ppermute`` bytes and
calls are the engine's layout: each node's payload and its VAL's
``n_buckets`` int32 to each of N_r replicas (parity: the f32 parity
forward a bucket).

One JSON record per cell goes to ``--out`` (default
``build/dryrun/``, which ``.gitignore`` lists). This entry point runs on
``meta`` by design: it computes nothing, so it needs no card.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b
    PYTHONPATH=src python -m repro_torch.launch.dryrun --workers 8
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import multiprocessing
import os
import time
import traceback
from concurrent.futures import ProcessPoolExecutor
from typing import Any, Dict, List

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import kernels
from repro_torch.config import (
    ReplicationConfig,
    RunConfig,
    SHAPES,
    ShapeConfig,
    TrainConfig,
    get_model_config,
    shape_applicable,
)
from repro_torch.configs import ASSIGNED_ARCHS
from repro_torch.core.replication import ReplicationEngine, tree_flatten
from repro_torch.distributed import collectives, sharding
from repro_torch.distributed.context import MeshContext, make_context
from repro_torch.distributed.sharding import locals_of, param_specs
from repro_torch.launch.costing import step_cost
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import attention
from repro_torch.models.model_zoo import batch_struct, build_model
from repro_torch.training.steps import (ServeState, init_train_state,
                                        make_serve_fns, make_train_step)
from repro_torch.training.trainer import batch_rows

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..",
                                    ".."))
ARTIFACT_DIR = os.path.join(ROOT, "build", "dryrun")

# Roofline constants of the card the port runs on
CARD = "NVIDIA H100 80GB HBM3 / 700 W"
PEAK_FLOPS = 989e12          # dense bf16 tensor-core FLOP/s
HBM_BW = 3.35e12             # HBM3 bytes/s

META = torch.device("meta")


def train_config_for(arch: str) -> TrainConfig:
    """AdamW by default; Adafactor for models whose AdamW state cannot
    fit at 256 nodes (>= 60B parameters), as in the JAX package."""
    if get_model_config(arch).param_count() > 60e9:
        return TrainConfig(optimizer="adafactor")
    return TrainConfig(optimizer="adamw")


def _shape(shape) -> ShapeConfig:
    """A shape cell by name, or the :class:`ShapeConfig` given."""
    return SHAPES[shape] if isinstance(shape, str) else shape


def _meta_batch(cfg, shape: ShapeConfig) -> Dict[str, torch.Tensor]:
    return {k: torch.empty(s.shape, dtype=s.dtype, device=META)
            for k, s in batch_struct(cfg, shape).items()}


def _tensors_only(tree: Any) -> Any:
    """``tree`` without its non-tensor leaves (the optimizer's step
    count)."""
    if isinstance(tree, dict):
        return {k: _tensors_only(v) for k, v in tree.items()
                if isinstance(v, (dict, list, tuple, torch.Tensor))}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tensors_only(x) for x in tree)
    return tree


def per_node_bytes(tree: Any, specs: Any, ctx: MeshContext) -> int:
    """Bytes one node holds of ``tree`` laid out by ``specs``: each
    leaf's block, padded as GSPMD pads an uneven dimension."""
    total = 0
    sizes = ctx.shape
    for leaf, spec in zip(tree_flatten(tree)[0], tree_flatten(specs)[0]):
        if not isinstance(leaf, torch.Tensor):
            continue
        shape = list(leaf.shape)
        for d, ax in enumerate(spec):
            if ax is None:
                continue
            axes = ax if isinstance(ax, tuple) else (ax,)
            div = int(np.prod([sizes[a] for a in axes]))
            shape[d] = -(-shape[d] // div)
        total += int(np.prod(shape)) * leaf.element_size()
    return total


@contextlib.contextmanager
def fake_world(world: int):
    """A one-process ``fake`` default process group of ``world`` ranks,
    this process rank 0: its collectives take ``meta`` tensors and move
    nothing. Raises ``RuntimeError`` if a process group is up."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is up; the split cost pass "
                           "needs its own fake one")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def _cell_context(multi_pod: bool, mesh, group=None) -> MeshContext:
    """The production mesh (or ``mesh``, ``(shape, axes)``) on ``meta``;
    with ``group``, rank 0 of its layout over ranks that split
    ``model``."""
    if mesh is None:
        prod = make_production_mesh(multi_pod=multi_pod, device=META)
        if group is None:
            return prod
        mesh = (prod.axis_sizes, prod.axis_names)
    return make_context(*mesh, device=META, group=group,
                        split_model=group is not None)


def build_cell(arch: str, shape_name, multi_pod: bool,
               variant: str = "proactive",
               model_cfg=None, mesh=None, replication=None,
               group=None, train_overrides=None) -> Dict[str, Any]:
    """Build one cell on ``meta``: the context, the model and its
    parameters, and the step with its arguments (``fn``, ``args``), plus
    the train state and engine for a train cell. ``shape_name`` names a
    cell of ``SHAPES`` or is a :class:`ShapeConfig`; ``model_cfg``
    replaces the registered config (a reduced one, in tests); ``mesh``
    (``(shape, axes)``) the production mesh and ``replication`` the
    cell's ``ReplicationConfig``; ``train_overrides`` change fields of
    the cell's ``TrainConfig`` (the reference's argument,
    ``src/repro/launch/dryrun.py:112-113``: a reduced config costed with
    Adafactor). With ``group`` (:func:`fake_world`)
    the cell is rank 0's of the layout over ranks that split ``model``:
    its blocks, its rows of the batch, and a train step without the
    replicate (module docstring; ``engine`` still gives the layout)."""
    model_cfg = model_cfg or get_model_config(arch)
    shape = _shape(shape_name)
    ok, why = shape_applicable(model_cfg, shape)
    if not ok:
        raise ValueError(f"cell skipped by design: {why}")
    rep = replication or ReplicationConfig(variant=variant, log_capacity=2)
    tc = train_config_for(arch) if model_cfg.name == arch else TrainConfig()
    if train_overrides:
        tc = dataclasses.replace(tc, **train_overrides)
    run = RunConfig(model=model_cfg, shape=shape, replication=rep, train=tc)
    ctx = _cell_context(multi_pod, mesh, group)
    model = build_model(model_cfg)
    params = model.init(0, device=META,
                        ctx=ctx if ctx.split_model else None)
    specs = param_specs(params, model_cfg, ctx)
    cell: Dict[str, Any] = {"run": run, "ctx": ctx, "model": model,
                            "params": params, "specs": specs,
                            "engine": None}
    if shape.kind == "train" and ctx.split_model:
        engine = (ReplicationEngine(rep, ctx, specs, params)
                  if rep.is_replicating else None)
        state = init_train_state(run, model, 0, None, params=params,
                                 ctx=ctx)
        rows = batch_rows(shape.global_batch, ctx)
        batch = {k: v[rows] for k, v in _meta_batch(model_cfg,
                                                     shape).items()}
        cell.update(engine=engine, state=state, step="train_step",
                    fn=make_train_step(run, model, None, ctx),
                    args=(state, batch))
    elif shape.kind == "train":
        engine = (ReplicationEngine(rep, ctx, specs, params)
                  if rep.is_replicating else None)
        state = init_train_state(run, model, 0, engine, params=params)
        cell.update(engine=engine, state=state, step="train_step",
                    fn=make_train_step(run, model, engine),
                    args=(state, _meta_batch(model_cfg, shape)))
    elif shape.kind == "prefill":
        prefill_fn, _ = make_serve_fns(model)
        cell.update(step="prefill_step", fn=torch.no_grad()(prefill_fn),
                    args=(params, _meta_batch(model_cfg, shape)))
    else:
        _, decode_fn = make_serve_fns(model)
        b = shape.global_batch
        with torch.no_grad():
            if model_cfg.is_encdec:
                # the cache holds seq_len - 1 tokens, so the step's new
                # token is the cache's last position
                pre = _meta_batch(model_cfg, dataclasses.replace(
                    shape, kind="prefill", seq_len=shape.seq_len - 1))
                with kernels.on_meta():
                    _, cache = model.prefill(params, pre,
                                             max_len=shape.seq_len)
            else:
                cache = model.init_cache(b, shape.seq_len, device=META)
        tokens = torch.empty((b,), dtype=torch.int32, device=META)
        cell.update(step="serve_step", fn=torch.no_grad()(decode_fn),
                    args=(params, ServeState(cache=cache, tokens=tokens)))
    return cell


def _rank_bytes(tree: Any) -> int:
    """Bytes of the tensors a rank holds of ``tree`` (its blocks)."""
    return sum(t.numel() * t.element_size()
               for t in tree_flatten(locals_of(tree))[0]
               if isinstance(t, torch.Tensor))


def layout_permutes(engine: ReplicationEngine) -> Dict[str, float]:
    """The REPL / VAL permutes of one replicate on this rank, from the
    engine's layout: ``{"bytes": ..., "calls": ...}`` as
    ``collectives.BYTES`` / ``COUNTS`` count them (each permute its
    payload over the rank's nodes)."""
    lay, rep = engine.layout, engine.rep
    k = engine.ctx.nodes_per_rank
    es = torch.empty((), dtype=engine.log_dtype).element_size()
    nb = lay.n_buckets
    if rep.mode == "parity":
        return {"bytes": float(k * nb * lay.bucket_len * 4), "calls": nb}
    per_replica = nb * lay.bucket_len * es + nb * 4   # REPL + VAL
    calls = 2 * (1 if rep.coalescing else nb) * rep.n_replicas
    return {"bytes": float(k * per_replica * rep.n_replicas),
            "calls": calls}


def run_cell(arch: str, shape_name, multi_pod: bool,
             variant: str = "proactive", save: bool = True,
             out_dir: str = ARTIFACT_DIR,
             model_cfg=None, split_model: bool = False, mesh=None,
             replication=None, train_overrides=None,
             act_policy: str = "batch") -> Dict[str, Any]:
    """Build and cost one cell; returns (and saves) its record.

    Attention and the SSD scan are counted by the kernels' formula
    (``launch/costing.py``'s flash accounting): on the card every
    prefill and training attention and SSD scan runs in the kernels.
    ``split_model``: rank 0 of the layout over ranks that split
    ``model``, in a :func:`fake_world` (module docstring); ``mesh``,
    ``replication`` and ``train_overrides`` as for :func:`build_cell`.
    ``act_policy`` (``"batch"`` / ``"seq_model"``,
    ``sharding.set_activation_policy``) is set for the cell and reset to
    ``"batch"`` after it, as the reference does
    (``src/repro/launch/dryrun.py:256-263``); it moves only the split
    train step (serving keeps the batch layout)."""
    t0 = time.time()
    model_cfg = model_cfg or get_model_config(arch)
    shape = _shape(shape_name)
    name = "2x16x16" if multi_pod else "16x16"
    if mesh is not None:
        name = "x".join(map(str, mesh[0]))
    record: Dict[str, Any] = {
        "arch": arch, "shape": shape.name,
        "mesh": name + ("-split" if split_model else ""),
        "variant": variant, "device": "meta", "act_policy": act_policy,
    }
    ok, why = shape_applicable(model_cfg, shape)
    if ok and split_model and shape.kind != "train":
        ok, why = False, "the split cost pass takes train cells"
    if not ok:
        record.update(status="skipped", reason=why)
        if save:
            _save(record, out_dir)
        return record
    try:
        sharding.set_activation_policy(act_policy)
        with contextlib.ExitStack() as stack:
            group = None
            if split_model:
                sizes = (mesh[0] if mesh is not None else
                         make_production_mesh(multi_pod=multi_pod,
                                              device=META).axis_sizes)
                group = stack.enter_context(
                    fake_world(int(np.prod(sizes))))
            _cost_cell(record, t0, arch, shape_name, multi_pod, variant,
                       model_cfg, mesh, replication, group,
                       train_overrides)
    except Exception as e:  # noqa: BLE001 -- a failed cell IS the finding
        record["status"] = "error"
        record["error"] = f"{type(e).__name__}: {e}"
        record["traceback"] = traceback.format_exc()[-2000:]
    finally:
        sharding.set_activation_policy("batch")
    record["wall_s"] = round(time.time() - t0, 2)
    if save:
        _save(record, out_dir)
    return record


def _cost_cell(record: Dict[str, Any], t0: float, arch: str, shape_name,
               multi_pod: bool, variant: str, model_cfg, mesh, replication,
               group, train_overrides) -> None:
    """:func:`run_cell`'s body: build, cost and fill ``record``."""
    shape = _shape(shape_name)
    cell = build_cell(arch, shape_name, multi_pod, variant, model_cfg,
                      mesh, replication, group, train_overrides)
    ctx, engine = cell["ctx"], cell["engine"]
    n_nodes = int(np.prod(ctx.axis_sizes))
    t_build = time.time() - t0
    collectives.reset_counts()
    cost = step_cost(cell["fn"], *cell["args"], flash_accounting=True)
    if ctx.split_model:
        memory = {"params_bytes_per_rank": _rank_bytes(cell["params"])}
    else:
        memory = {"params_bytes_per_node": per_node_bytes(
            cell["params"], cell["specs"], ctx)}
    replication = None
    if "state" in cell and ctx.split_model:
        memory["opt_state_bytes_per_rank"] = _rank_bytes(
            _tensors_only(cell["state"].opt_state))
    elif "state" in cell:
        opt = _tensors_only(cell["state"].opt_state)
        memory["opt_state_bytes_per_node"] = per_node_bytes(
            opt, param_specs(opt, model_cfg, ctx), ctx)
    if ctx.split_model:
        per_kind = {k: v for k, v in collectives.BYTES.items() if v}
        n_ops = {k: v for k, v in collectives.COUNTS.items() if v}
        if engine is not None:
            perm = layout_permutes(engine)
            per_kind["ppermute"] = perm["bytes"]
            n_ops["ppermute"] = perm["calls"]
        record["collectives"] = {
            "rank": ctx.rank, "world": ctx.world,
            "per_kind_bytes": per_kind, "n_ops": n_ops,
            "total_bytes": float(sum(per_kind.values())),
            "replication_bytes": per_kind.get("ppermute", 0.0)}
        if engine is not None:
            memory["log_ring_bytes_per_rank"] = sum(
                int(np.prod(s.shape)) * torch.empty(
                    (), dtype=s.dtype).element_size()
                for s in engine.log_struct().values())
        record["scope"] = f"rank {ctx.rank} of {ctx.world}: its blocks, " \
            f"its rows, its collectives"
        engine = None
    if engine is not None:
        lay = engine.layout
        es = torch.empty((), dtype=engine.log_dtype).element_size()
        n_lead = len(ctx.axis_sizes)
        memory["log_ring_bytes_per_node"] = sum(
            int(np.prod(s.shape[n_lead:])) * torch.empty(
                (), dtype=s.dtype).element_size()
            for s in engine.log_struct().values())
        payload = lay.n_buckets * lay.bucket_len * es
        sends = 1 if engine.rep.mode == "parity" else \
            engine.rep.n_replicas
        replication = {
            "ring_axes": list(engine.repl_axes),
            "ring_nodes": engine.n_nodes,
            "payload_bytes_per_node": payload,
            "send_bytes_per_node_per_step": payload * sends,
            "send_bytes_global_per_step": payload * sends * n_nodes,
        }
    flops, nbytes = cost["flops"], cost["bytes"]
    record.update({
        "status": "ok",
        "step": cell["step"],
        "mesh_shape": list(ctx.axis_sizes),
        "optimizer": cell["run"].train.optimizer,
        "n_nodes": n_nodes,
        "build_s": round(t_build, 2),
        "memory": memory,
        "cost": {
            "flops_global": flops,
            "bytes_global": nbytes,
            "transcendentals_global": cost["transcendentals"],
            "eltwise_flops_global": cost["eltwise_flops"],
            "kernel_calls": cost["kernel_calls"],
        },
        "replication": replication,
        "roofline_one_card": {
            "card": CARD, "peak_flops": PEAK_FLOPS, "hbm_bw": HBM_BW,
            "flops_ms": flops / PEAK_FLOPS * 1e3,
            "bytes_ms": nbytes / HBM_BW * 1e3,
        },
        "attention_pair_walks": sorted(
            attention.n_pair_scan_lengths(model_cfg, shape)),
        "model_params": model_cfg.param_count(),
        "active_params": model_cfg.active_param_count(),
        "tokens": shape.tokens if shape.kind != "decode"
        else shape.global_batch,
    })


def _save(record: Dict[str, Any], out_dir: str) -> None:
    os.makedirs(out_dir, exist_ok=True)
    policy = record.get("act_policy", "batch")
    name = (f"dryrun_{record['arch']}_{record['shape']}_"
            f"{record['mesh'].replace('x', '-')}"
            f"{'' if policy == 'batch' else '_' + policy}.json")
    with open(os.path.join(out_dir, name), "w") as f:
        json.dump(record, f, indent=1)


def format_record(r: Dict[str, Any]) -> str:
    """One line per record, as the JAX package's dry-run prints it."""
    if r["status"] == "ok":
        c, mem = r["cost"], r["memory"]
        held = mem.get("params_bytes_per_node",
                       mem.get("params_bytes_per_rank"))
        extra = (f"flops={c['flops_global']:.3e} "
                 f"bytes={c['bytes_global']:.3e} "
                 f"params/node={held:.3e}B "
                 f"{r['wall_s']}s")
    elif r["status"] == "error":
        extra = r["error"][:120]
    else:
        extra = r["reason"][:80]
    return (f"[{r['status']:7s}] {r['arch']:22s} {r['shape']:12s} "
            f"{r['mesh']:8s} {extra}")


def _cost_rank(cell) -> tuple:
    """Sort key putting the cells that take longest to count first:
    train before prefill before decode, and the SSD families (whose
    plain scan runs chunk by chunk) before the others."""
    arch, shape, _ = cell
    kind = ("train", "prefill", "decode").index(_shape(shape).kind)
    return kind, get_model_config(arch).family not in ("ssm", "hybrid")


def run_all(archs=ASSIGNED_ARCHS, shapes=tuple(SHAPES),
            meshes=(False, True), workers: int = 1,
            **kw) -> List[Dict[str, Any]]:
    """Every (arch, shape, mesh) cell, in that order; ``workers`` > 1
    spreads the cells over that many processes (each a fresh
    interpreter: the cells are independent and CPU-bound)."""
    cells = [(a, s, mp) for a in archs for s in shapes for mp in meshes]
    if workers > 1:
        pool = ProcessPoolExecutor(
            workers, mp_context=multiprocessing.get_context("spawn"))
        with pool:
            # the costliest cells first, so none starts last
            futures = {c: pool.submit(run_cell, *c, **kw)
                       for c in sorted(cells, key=_cost_rank)}
            results = [futures[c].result() for c in cells]
    else:
        results = [run_cell(*c, **kw) for c in cells]
    for r in results:
        print(format_record(r), flush=True)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="all",
                    help="architecture id or 'all'")
    ap.add_argument("--shape", default="all",
                    help="shape cell name or 'all'")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--variant", default="proactive")
    ap.add_argument("--split-model", action="store_true",
                    help="cost rank 0 of the layout over ranks that split "
                    "the model axis (train cells; a fake process group)")
    ap.add_argument("--out", default=ARTIFACT_DIR)
    ap.add_argument("--no-save", action="store_true")
    ap.add_argument("--workers", type=int, default=1,
                    help="processes to spread the cells over")
    args = ap.parse_args(argv)
    archs = list(ASSIGNED_ARCHS) if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    results = run_all(archs, shapes, meshes, workers=args.workers,
                      variant=args.variant, split_model=args.split_model,
                      save=not args.no_save, out_dir=args.out)
    n = {s: sum(r["status"] == s for r in results)
         for s in ("ok", "skipped", "error")}
    print(f"\ndry-run: {n['ok']} ok, {n['skipped']} skipped-by-design, "
          f"{n['error']} errors")
    return 1 if n["error"] else 0


if __name__ == "__main__":
    raise SystemExit(main())

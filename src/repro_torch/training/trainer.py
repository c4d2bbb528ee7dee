"""Fault-tolerant trainer: the control plane around the train step.

The JAX package's ``training/trainer.py`` over the port's logical nodes.
Responsibilities (the paper's SS V, operationally):

* drive the data pipeline + train step (``training/steps.py``);
* heartbeat every node; detect failures (lease expiry / injected
  fail-stop) via :class:`FailureDetector`;
* on failure: promote the lowest live rank to Configuration Manager,
  pause, run Algorithm 1-2 recovery out of the replica Logging Units
  (``core/recovery.py``), install the recovered shard on a spare
  (``distributed/elastic.py``), rewind the pipeline, resume;
* periodic MN dumps (async checkpoint) every ``dump_interval`` steps --
  the 2.5 ms analogue;
* straggler mitigation: per-step timing, flag a step slower than
  ``straggler_factor`` x the median over a window.

Where the JAX package takes a device mesh, the port takes a
:class:`MeshContext` of logical nodes on one device
(``distributed/context.py``), whose axes are ``run.mesh``'s: every
per-node tensor carries the node axes as leading dimensions, and the
parameters live whole on ``ctx.device`` with ``param_specs`` saying
which block each node owns. Each step runs with the context as the
models' mesh context, so a MoE dispatches each data block on its own as
the reference's ``shard_map`` does. A step's wall time is read after a
synchronize of the card, so it covers the step's device work.

With a rank-aware context (``torch.distributed``, one process a rank)
the trainer is data-parallel: every rank holds the whole parameters,
trains on its nodes' rows of each global batch (the reference's
``P(batch_axes, ...)``, ``src/repro/training/trainer.py:109-116``),
sums the gradients over the ranks (``training/steps.py``), replicates
its own nodes' blocks into its part of the log ring, dumps to its own
MN directory, and takes part in every recovery; every rank runs the
same control plane (the failures, the directory, the Configuration
Manager: the lowest live node, on the lowest live rank).

Across ranks that split the ``model`` axis (``make_context(...,
split_model=True)``) each rank holds one ``model`` position of a block
of nodes: its parameters are placed by ``named_shardings`` (its
``Shard`` blocks, as the JAX ``Trainer`` places its state,
``src/repro/training/trainer.py:103-107``), it trains on its node
block's rows (the ``m`` ranks of a block share them), its optimizer
state is its blocks', and its MN dump holds its blocks (params and
optimizer state) in its own directory. A replicating variant
replicates its blocks at its ``model`` position into its part of the
ring, and a fail-stop is recovered by every rank and installed in place
into its blocks (``distributed/elastic.py``); under ``none`` a fail-stop
raises the WB data-loss error on every rank.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.config import RunConfig
from repro_torch.core.directory import ShardDirectory
from repro_torch.core.failures import FailureDetector, FailureInjector
from repro_torch.core.recovery import recover_node
from repro_torch.core.replication import ReplicationEngine
from repro_torch.data import SyntheticTokenPipeline
from repro_torch.distributed.context import MeshContext, mesh_context
from repro_torch.distributed.elastic import install_recovered_shard
from repro_torch.distributed.sharding import (locals_of, named_shardings,
                                              param_specs)
from repro_torch.models.model_zoo import batch_struct, build_model
from repro_torch.optim.optimizers import tree_leaves
from repro_torch.training.steps import (TrainState, init_train_state,
                                        make_train_step)


@dataclasses.dataclass
class StragglerMonitor:
    factor: float = 3.0
    window: int = 5
    history: List[float] = dataclasses.field(default_factory=list)
    slow_streak: int = 0

    def observe(self, dt: float) -> bool:
        """Returns True when the current step is straggler-suspect."""
        self.history.append(dt)
        if len(self.history) < max(self.window * 2, 8):
            return False
        median = float(np.median(self.history[-50:]))
        if dt > self.factor * median:
            self.slow_streak += 1
        else:
            self.slow_streak = 0
        return self.slow_streak >= self.window


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def batch_rows(rows: int, ctx: MeshContext) -> slice:
    """This rank's rows of a global batch of ``rows``: its node block's
    (every row without a group). The ``m`` ranks of a block that split
    ``model`` share them."""
    if ctx.group is None:
        return slice(None)
    if rows % ctx.n_nodes:
        raise ValueError(f"a global batch of {rows} rows does not split "
                         f"over {ctx.n_nodes} nodes")
    per_block = rows // ctx.n_nodes * ctx.nodes_per_rank
    return slice(ctx.block * per_block, (ctx.block + 1) * per_block)


class Trainer:
    def __init__(self, run: RunConfig, ctx: MeshContext, workdir: str,
                 injector: Optional[FailureInjector] = None,
                 model=None):
        if (ctx.axis_names, ctx.axis_sizes) != (tuple(run.mesh.axes),
                                                tuple(run.mesh.shape)):
            raise ValueError(f"the context's axes {ctx.shape} are not the "
                             f"run's mesh {run.mesh}")
        self.run = run
        self.ctx = ctx
        self.model = model or build_model(run.model)
        self.ckpt = CheckpointManager(
            workdir, rank=None if ctx.group is None else ctx.rank)
        self.injector = injector or FailureInjector()
        self.monitor = StragglerMonitor()
        self.events: List[Dict[str, Any]] = []

        params = (self.model.init(run.train.seed, ctx=ctx)
                  if ctx.split_model else named_shardings(
                      self.model.init(run.train.seed, device=ctx.device),
                      run.model, ctx))
        self.specs = param_specs(params, run.model, ctx)
        self.engine: Optional[ReplicationEngine] = None
        if run.replication.is_replicating:
            self.engine = ReplicationEngine(run.replication, ctx, self.specs,
                                            params)
        self.state: TrainState = init_train_state(
            run, self.model, run.train.seed, self.engine, params=params,
            ctx=ctx)
        self._step_fn = make_train_step(run, self.model, self.engine, ctx)

        n_nodes = (self.engine.n_nodes if self.engine else
                   int(np.prod([ctx.shape[a] for a in ctx.batch_axes])))
        n_buckets = (self.engine.layout.n_buckets if self.engine
                     else run.replication.n_buckets)
        self.directory = ShardDirectory(
            n_nodes, n_buckets, run.replication.n_replicas)
        self.detector = FailureDetector(n_nodes, lease_s=30.0)
        self.pipeline = SyntheticTokenPipeline(
            run.model, run.shape, seed=run.train.seed)
        self._batch_dtypes = {k: s.dtype for k, s in
                              batch_struct(run.model, run.shape).items()}
        self._rows = batch_rows(run.shape.global_batch, ctx)

    # ------------------------------------------------------------------
    def _to_device(self, batch: Dict[str, np.ndarray]
                   ) -> Dict[str, torch.Tensor]:
        """This rank's rows of the global batch, on the device (the JAX
        ``Trainer._shard_batch``, ``src/repro/training/trainer.py:109``)."""
        return {k: torch.from_numpy(v[self._rows]).to(
                    device=self.ctx.device, dtype=self._batch_dtypes[k])
                for k, v in batch.items()}

    # ------------------------------------------------------------------
    def train(self, num_steps: int,
              log_every: int = 10,
              on_metrics: Optional[Callable[[int, Dict], None]] = None
              ) -> List[Dict[str, float]]:
        history: List[Dict[str, float]] = []
        dev = self.ctx.device
        for _ in range(num_steps):
            step_no = int(self.state.step)
            # ---- failure control plane -----------------------------------
            for ev in self.injector.poll(step_no):
                if ev.kind == "fail-stop":
                    self.detector.mark_failed(ev.node)
                    self.events.append({"step": step_no, "event": "fail",
                                        "node": ev.node})
                else:
                    self.detector.mark_straggler(ev.node, ev.delay_s)
            failed = [n for n in self.detector.failed_nodes
                      if not any(e.get("recovered") == n
                                 for e in self.events)]
            if failed:
                self._recover(failed[0], step_no)

            # ---- one step ------------------------------------------------
            t0 = time.perf_counter()
            batch = self._to_device(self.pipeline.next())
            with mesh_context(self.ctx):
                self.state, metrics = self._step_fn(self.state, batch)
            _sync(dev)
            dt = time.perf_counter() - t0
            # straggler injection: modeled as an artificial delay
            for node, delay in list(self.detector.stragglers.items()):
                time.sleep(delay)
                dt += delay
            if self.monitor.observe(dt):
                self.events.append({"step": step_no, "event": "straggler"})
                self.detector.stragglers.clear()

            for n in self.detector.live_nodes:
                self.detector.heartbeat(n)
            self.directory.record_commit(step_no)

            # ---- MN dump -------------------------------------------------
            if (step_no + 1) % self.run.replication.dump_interval == 0:
                self._dump(step_no)

            m = {k: float(v) for k, v in metrics.items()
                 if isinstance(v, (int, float)) or v.dim() == 0}
            m["step"] = step_no
            m["wall_s"] = dt
            history.append(m)
            if on_metrics and step_no % log_every == 0:
                on_metrics(step_no, m)
        return history

    # ------------------------------------------------------------------
    def _dump(self, step_no: int) -> None:
        """MN-tier dump: full state (copied to the host, then written
        async) + directory watermark; across ranks each rank into its own
        directory (``src/repro/training/trainer.py:174``), and across
        ranks that split ``model`` its blocks, each stored with its spec
        and global shape (``checkpoint/manager.py``)."""
        t0 = time.perf_counter()
        self.ckpt.save(step_no, {"params": self.state.params,
                                 "opt": self.state.opt_state},
                       extra={"pipeline_step": self.pipeline.state.step,
                              "directory": self.directory.to_json()})
        self.directory.record_dump(step_no)
        self.events.append({"step": step_no, "event": "mn_dump",
                            "snapshot_s": time.perf_counter() - t0})

    # ------------------------------------------------------------------
    def _recover(self, failed_node: int, step_no: int) -> None:
        """CM-driven recovery + spare replacement; across ranks every
        rank recovers and installs the same shard
        (``src/repro/training/trainer.py:184``), and across ranks that
        split ``model`` its position's part, into its blocks in place."""
        if self.engine is None:
            raise RuntimeError(
                f"node {failed_node} failed but replication variant is "
                f"{self.run.replication.variant!r}: state is lost (this is "
                "the WB data-loss case the paper fixes)")
        cm = self.detector.configuration_manager()
        t0 = time.perf_counter()
        # the detector and the directory count ring nodes; the state and
        # the logs are laid out by node coordinate (pod?, data)
        coord = self.engine.node_coord(failed_node)
        result = recover_node(self.engine, self.state.logs, self.directory,
                              failed_coord=coord)
        with torch.no_grad():
            params = install_recovered_shard(
                self.state.params, self.specs, self.engine, result,
                target_coord=coord)
        for p in tree_leaves(locals_of(params)):
            p.requires_grad_(True)
        self.state = self.state._replace(params=params)
        # spare replacement: the rank is re-admitted with recovered state
        self.detector.viral_status[failed_node] = False
        self.detector.heartbeat(failed_node)
        for bucket in range(self.directory.n_buckets):
            self.directory.reassign(failed_node, bucket, failed_node)
        self.pipeline.seek(int(self.state.step))
        _sync(self.ctx.device)
        self.events.append({
            "step": step_no, "event": "recovery", "cm": cm,
            "recovered": failed_node,
            "stats": dataclasses.asdict(result.stats),
            "wall_s": time.perf_counter() - t0,
        })
        if self.ctx.group is not None:
            self.events[-1]["cm_rank"] = self.engine.owner_rank(
                self.engine.node_coord(cm), 0)

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
which block each node owns. A step's wall time is read after a
synchronize of the card, so it covers the step's device work.
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
from repro_torch.distributed.context import MeshContext
from repro_torch.distributed.elastic import install_recovered_shard
from repro_torch.distributed.sharding import named_shardings, param_specs
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
        self.ckpt = CheckpointManager(workdir)
        self.injector = injector or FailureInjector()
        self.monitor = StragglerMonitor()
        self.events: List[Dict[str, Any]] = []

        params = named_shardings(
            self.model.init(run.train.seed, device=ctx.device), run.model,
            ctx)
        self.specs = param_specs(params, run.model, ctx)
        self.engine: Optional[ReplicationEngine] = None
        if run.replication.is_replicating:
            self.engine = ReplicationEngine(run.replication, ctx, self.specs,
                                            params)
        self.state: TrainState = init_train_state(
            run, self.model, run.train.seed, self.engine, params=params)
        self._step_fn = make_train_step(run, self.model, self.engine)

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

    # ------------------------------------------------------------------
    def _to_device(self, batch: Dict[str, np.ndarray]
                   ) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(v).to(device=self.ctx.device,
                                          dtype=self._batch_dtypes[k])
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
        async) + directory watermark."""
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
        """CM-driven recovery + spare replacement."""
        if self.engine is None:
            raise RuntimeError(
                f"node {failed_node} failed but replication variant is "
                f"{self.run.replication.variant!r}: state is lost (this is "
                "the WB data-loss case the paper fixes)")
        cm = self.detector.configuration_manager()
        t0 = time.perf_counter()
        result = recover_node(self.engine, self.state.logs, self.directory,
                              failed_coord=(failed_node,))
        with torch.no_grad():
            params = install_recovered_shard(
                self.state.params, self.specs, self.engine, result,
                target_coord=(failed_node,))
        for p in tree_leaves(params):
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

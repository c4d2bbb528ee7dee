"""End-to-end example: train a ~100M-parameter qwen3-family model for a
few hundred steps with full ReCXL fault tolerance, killing a node a third
of the way through.

The twin of the JAX package's ``examples/train_100m_ft.py``: the same
model (``MODEL_100M``), the same run (a 4 data x 2 model mesh of logical
nodes, ReCXL-proactive, N_r 2, 8 buckets, a log capacity of 2, an MN
dump every 50 steps) and the same failure (node 1 at ``steps // 3``),
on random weights made from the run's seed and the synthetic token
pipeline. The MN dumps go to a temporary directory.

    PYTHONPATH=src python -m repro_torch.examples.train_100m_ft --steps 300
    PYTHONPATH=src python -m repro_torch.examples.train_100m_ft \
        --steps 6 --device cpu

Without ``--device`` it runs on the card, where every attention of the
forward and of its gradient goes through the ``flash_attn`` kernels.
"""

from __future__ import annotations

import argparse
import tempfile
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.config import (
    MeshConfig,
    ModelConfig,
    ReplicationConfig,
    RunConfig,
    ShapeConfig,
    TrainConfig,
)
from repro_torch.core.failures import FailureEvent, FailureInjector
from repro_torch.distributed.context import make_context
from repro_torch.training.trainer import Trainer

MODEL_100M = ModelConfig(
    name="qwen3-100m",
    family="dense",
    n_layers=14,
    d_model=640,
    n_heads=10,
    n_kv_heads=2,
    d_ff=2560,
    vocab_size=32768,
    head_dim=64,
    qk_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
)

MESH = MeshConfig((4, 2), ("data", "model"))
FAIL_NODE = 1


def make_run(steps: int, seq_len: int = 128, batch: int = 8,
             variant: str = "proactive",
             model: Optional[ModelConfig] = None) -> RunConfig:
    """The example's run config for ``steps`` steps, of ``model``
    (``None``: ``MODEL_100M``)."""
    return RunConfig(
        model=MODEL_100M if model is None else model,
        shape=ShapeConfig("train", seq_len=seq_len, global_batch=batch,
                          kind="train"),
        mesh=MESH,
        replication=ReplicationConfig(variant=variant, n_replicas=2,
                                      n_buckets=8, dump_interval=50,
                                      # the log ring is params x N_r x
                                      # capacity: keep it lean
                                      log_capacity=2),
        train=TrainConfig(total_steps=steps,
                          warmup_steps=max(steps // 20, 1),
                          learning_rate=6e-4),
    )


def make_trainer(run: RunConfig, workdir: str, fail_step: int,
                 device=None) -> Trainer:
    """A :class:`Trainer` of ``run`` on the example's logical mesh, on
    ``device`` (``None``: the card), with node 1 failing at
    ``fail_step``."""
    ctx = make_context(MESH.shape, MESH.axes, device=device)
    injector = FailureInjector([FailureEvent(step=fail_step,
                                             node=FAIL_NODE)])
    return Trainer(run, ctx, workdir, injector=injector)


def train(steps: int, seq_len: int = 128, batch: int = 8,
          fail_step: Optional[int] = None, variant: str = "proactive",
          device=None,
          on_metrics: Optional[Callable[[int, Dict], None]] = None,
          ) -> Tuple[Trainer, List[Dict[str, float]]]:
    """Train ``steps`` steps in a temporary directory and return the
    trainer and its per-step metrics; ``fail_step`` defaults to
    ``steps // 3``."""
    run = make_run(steps, seq_len, batch, variant)
    fail_step = fail_step or steps // 3
    with tempfile.TemporaryDirectory() as workdir:
        trainer = make_trainer(run, workdir, fail_step, device=device)
        hist = trainer.train(steps, on_metrics=on_metrics)
        trainer.ckpt.wait()
    return trainer, hist


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--fail-step", type=int, default=None)
    ap.add_argument("--variant", default="proactive")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    print(f"{MODEL_100M.name}: {MODEL_100M.param_count() / 1e6:.1f}M params")
    trainer, hist = train(
        args.steps, args.seq_len, args.batch, args.fail_step, args.variant,
        device=args.device, on_metrics=lambda s, m: print(
            f"step {s:4d}  loss {m['loss']:.4f}  gnorm "
            f"{m['grad_norm']:.2f}  {m['wall_s'] * 1e3:.0f} ms"))

    n = min(10, len(hist))
    first = sum(h["loss"] for h in hist[:n]) / n
    last = sum(h["loss"] for h in hist[-n:]) / n
    print(f"\nloss {first:.3f} -> {last:.3f} over {args.steps} steps "
          f"on {trainer.ctx.device}")
    for e in trainer.events:
        if e["event"] in ("fail", "recovery"):
            print("event:", e)


if __name__ == "__main__":
    main()

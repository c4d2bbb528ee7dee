"""Quickstart: fault-tolerant training in ~40 lines.

The twin of the JAX package's ``examples/quickstart.py``: trains a
reduced qwen3-family model on 8 logical nodes (4 data x 2 model) with
ReCXL-proactive replication, injects a node failure halfway, and shows
recovery from the replica Logging Units.

    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu

Without ``--device`` it runs on the card.
"""

import argparse
import tempfile

from repro_torch.config import (
    MeshConfig,
    ReplicationConfig,
    RunConfig,
    ShapeConfig,
    TrainConfig,
    get_reduced_config,
)
from repro_torch.core.failures import FailureEvent, FailureInjector
from repro_torch.distributed.context import make_context
from repro_torch.training.trainer import Trainer


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    run = RunConfig(
        model=get_reduced_config("qwen3-0.6b"),
        shape=ShapeConfig("quickstart", seq_len=64, global_batch=8,
                          kind="train"),
        mesh=MeshConfig((4, 2), ("data", "model")),
        replication=ReplicationConfig(variant="proactive", n_replicas=2,
                                      n_buckets=4, dump_interval=10),
        train=TrainConfig(total_steps=40, warmup_steps=4,
                          learning_rate=1e-3),
    )
    ctx = make_context((4, 2), ("data", "model"), device=args.device)
    injector = FailureInjector([FailureEvent(step=20, node=2)])
    with tempfile.TemporaryDirectory() as workdir:
        trainer = Trainer(run, ctx, workdir, injector=injector)

        print(f"model: {run.model.name} "
              f"({run.model.param_count() / 1e3:.0f}K params), "
              f"mesh 4x2, variant=proactive, N_r=2, device {ctx.device}")
        trainer.train(40, on_metrics=lambda s, m: print(
            f"  step {s:3d}  loss {m['loss']:.4f}  {m['wall_s']*1e3:.0f} ms"))
        trainer.ckpt.wait()

    print("\nevents:")
    for e in trainer.events:
        print(f"  {e}")


if __name__ == "__main__":
    main()

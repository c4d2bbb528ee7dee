"""Training launcher: fault-tolerant training on a logical node mesh.

Examples (the card)::

    # fault-tolerant training of a reduced qwen3 on a 4x2 logical mesh
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
        --reduced --steps 100 --mesh 4x2 --variant proactive

    # inject a node failure at step 50 and watch recovery
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
        --reduced --steps 100 --mesh 4x2 --fail-node 2 --fail-step 50

and on the CPU (``--device cpu``)::

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
        --reduced --steps 20 --mesh 4x2 --fail-node 2 --fail-step 10 \\
        --device cpu

The JAX launcher's flags, with ``--device`` (default: the card) in place
of ``--host-devices``: the mesh is ``MeshContext`` of logical nodes on
one device (``distributed/context.py``), not a set of devices, so
``--mesh 4x2`` means 4 data nodes x 2 model ranks whatever the device.
"""

from __future__ import annotations

import argparse

from repro_torch.config import (
    MeshConfig,
    ReplicationConfig,
    RunConfig,
    ShapeConfig,
    TrainConfig,
    get_model_config,
    get_reduced_config,
)
from repro_torch.core.failures import FailureEvent, FailureInjector
from repro_torch.distributed.context import make_context
from repro_torch.training.trainer import Trainer


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="use the reduced same-family config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--mesh", default="4x2", help="DATAxMODEL, e.g. 4x2")
    ap.add_argument("--variant", default="proactive",
                    choices=["none", "writethrough", "baseline", "parallel",
                             "proactive"])
    ap.add_argument("--n-replicas", type=int, default=3)
    ap.add_argument("--n-buckets", type=int, default=8)
    ap.add_argument("--dump-interval", type=int, default=50)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--workdir", default="/tmp/recxl_train")
    ap.add_argument("--fail-node", type=int, default=-1)
    ap.add_argument("--fail-step", type=int, default=-1)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the "
                    "plain versions)")
    args = ap.parse_args(argv)

    model_cfg = (get_reduced_config(args.arch) if args.reduced
                 else get_model_config(args.arch))
    mesh_shape = tuple(int(x) for x in args.mesh.split("x"))
    axes = ("data", "model")[:len(mesh_shape)] if len(mesh_shape) == 2 else \
        ("pod", "data", "model")
    mesh_cfg = MeshConfig(mesh_shape, axes)
    n_rep = min(args.n_replicas, mesh_shape[axes.index("data")] - 1)

    run = RunConfig(
        model=model_cfg,
        shape=ShapeConfig("cli", seq_len=args.seq_len,
                          global_batch=args.global_batch, kind="train"),
        mesh=mesh_cfg,
        replication=ReplicationConfig(
            variant=args.variant, n_replicas=max(n_rep, 1),
            n_buckets=args.n_buckets, dump_interval=args.dump_interval),
        train=TrainConfig(total_steps=args.steps, learning_rate=args.lr,
                          warmup_steps=max(args.steps // 10, 1)),
    )
    ctx = make_context(mesh_shape, axes, device=args.device)
    injector = FailureInjector(
        [FailureEvent(step=args.fail_step, node=args.fail_node)]
        if args.fail_node >= 0 and args.fail_step >= 0 else [])

    trainer = Trainer(run, ctx, args.workdir, injector=injector)
    print(f"training {model_cfg.name} ({model_cfg.param_count()/1e6:.1f}M "
          f"params) on mesh {mesh_shape}, variant={args.variant}, "
          f"device {ctx.device}")

    def log(step: int, m: dict) -> None:
        print(f"step {step:5d} loss {m['loss']:.4f} "
              f"gnorm {m['grad_norm']:.3f} {m['wall_s']*1e3:.0f} ms")

    trainer.train(args.steps, on_metrics=log)
    trainer.ckpt.wait()
    for e in trainer.events:
        print("event:", e)


if __name__ == "__main__":
    main()

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

``--arch`` takes every registered config: on the card the attention's
and the SSD scan's gradients go through their hand-written backward
kernels (hymba-1.5b, mamba2-2.7b), MoE and enc-dec configs through the
attention's (moonshot-v1-16b-a3b, whisper-medium).

The JAX launcher's flags, with ``--device`` (default: the card) in place
of ``--host-devices``: the mesh is ``MeshContext`` of logical nodes on
one device (``distributed/context.py``), not a set of devices, so
``--mesh 4x2`` means 4 data nodes x 2 model ranks whatever the device.
``--log-capacity`` sets the replica log slots per node (the default's 8
do not fit beside a billion-parameter model's state on one card).

Under ``torchrun`` (``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` set) the
run is data-parallel over the ranks, where the JAX launcher
(``src/repro/launch/train.py:22``) is one process over a device mesh: each rank holds ``nodes / world``
whole nodes of the mesh, on ``cuda:LOCAL_RANK`` with ``nccl``, or on the
CPU with ``gloo`` when ``--device cpu``; every line is prefixed with the
rank::

    torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.train \
        --arch qwen3-0.6b --reduced --steps 100 --mesh 4x2

A single process without those variables runs as before.

With ``--split-model`` the ranks split the ``model`` axis too
(``make_context(..., split_model=True)``): a rank holds one ``model``
position of a block of nodes, its parameter and optimizer blocks placed
by their specs, and the world must be the model size times a number of
node blocks. Every variant runs: a replicating one replicates the
rank's blocks at its ``model`` position, and a failed node is recovered
into every rank's blocks::

    PYTHONPATH=src torchrun --standalone --nproc-per-node 4 \
        -m repro_torch.launch.train --arch qwen3-0.6b --reduced \
        --steps 20 --mesh 2x2 --split-model --fail-node 1 --fail-step 10 \
        --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import torch

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
from repro_torch.distributed.context import make_context, node_group
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
    ap.add_argument("--log-capacity", type=int,
                    default=ReplicationConfig.log_capacity,
                    help="replica log slots (steps) per node")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--workdir", default="/tmp/recxl_train")
    ap.add_argument("--fail-node", type=int, default=-1)
    ap.add_argument("--fail-step", type=int, default=-1)
    ap.add_argument("--dtype", default=None,
                    choices=["bfloat16", "float32"],
                    help="the parameters' and activations' type (default: "
                    "the config's)")
    ap.add_argument("--log-every", type=int, default=10,
                    help="print the loss every this many steps")
    ap.add_argument("--split-model", action="store_true",
                    help="under torchrun, each rank one model position of "
                    "a block of nodes")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the "
                    "plain versions)")
    args = ap.parse_args(argv)

    model_cfg = (get_reduced_config(args.arch) if args.reduced
                 else get_model_config(args.arch))
    if args.dtype is not None:
        model_cfg = dataclasses.replace(model_cfg, dtype=args.dtype)
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
            n_buckets=args.n_buckets, dump_interval=args.dump_interval,
            log_capacity=args.log_capacity),
        train=TrainConfig(total_steps=args.steps, learning_rate=args.lr,
                          warmup_steps=max(args.steps // 10, 1)),
    )
    group, device, tag = None, args.device, ""
    if "WORLD_SIZE" in os.environ:
        if device is None:
            device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
        group = node_group(device)
        tag = f"rank {os.environ['RANK']}/{os.environ['WORLD_SIZE']}: "
    if args.split_model and group is None:
        ap.error("--split-model needs ranks: run under torchrun")
    ctx = make_context(mesh_shape, axes, device=device, group=group,
                       split_model=args.split_model)
    injector = FailureInjector(
        [FailureEvent(step=args.fail_step, node=args.fail_node)]
        if args.fail_node >= 0 and args.fail_step >= 0 else [])

    trainer = Trainer(run, ctx, args.workdir, injector=injector)

    def say(line: str) -> None:
        # one write a line, newline included: the ranks of a torchrun
        # share one stdout, and print() writes the newline apart (two
        # writes when the stream is unbuffered)
        sys.stdout.write(tag + line + "\n")
        sys.stdout.flush()

    say(f"training {model_cfg.name} "
        f"({model_cfg.param_count()/1e6:.1f}M params) on mesh "
        f"{mesh_shape}, variant={args.variant}, device {ctx.device}"
        + (f", {ctx.world} ranks ({torch.distributed.get_backend(group)})"
           if group is not None else "")
        + (f", the model axis split (block {ctx.block}, model position "
           f"{ctx.model_rank})" if ctx.split_model else ""))

    def log(step: int, m: dict) -> None:
        say(f"step {step:5d} loss {m['loss']:.6f} "
            f"gnorm {m['grad_norm']:.3f} {m['wall_s']*1e3:.0f} ms")

    try:
        trainer.train(args.steps, log_every=args.log_every, on_metrics=log)
        trainer.ckpt.wait()
        for e in trainer.events:
            say(f"event: {e}")
    finally:
        if group is not None:
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()

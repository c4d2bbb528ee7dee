"""Serving launcher: batched prefill + greedy decode with a KV/SSM cache.

Example (the card)::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b \\
        --batch 4 --prompt-len 4096 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch moonshot-v1-16b-a3b --batch 4 --prompt-len 2048 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch whisper-medium --batch 8 --prompt-len 224 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch internvl2-26b --batch 4 --prompt-len 1024 --gen 32

and on the CPU, at the reduced config::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b \\
        --reduced --prompt-len 64 --device cpu

``--arch`` takes every registered config (``config.list_models()``):
hymba-1.5b, qwen3-0.6b, mamba2-2.7b, moonshot-v1-16b-a3b, grok-1-314b,
deepseek-67b, stablelm-12b, starcoder2-15b, whisper-medium (enc-dec)
and internvl2-26b (vlm). As in the JAX launcher there is no depth flag:
a config is served at its published depth, or its reduced one with
``--reduced``.

Weights come from the port's seeded init and the prompts from
``make_batch`` (both from ``--seed``): tokens, and for whisper-medium
the stub frame embeddings, for internvl2-26b the stub patch embeddings
that take the prompt's leading positions; the prefill gets the whole
batch. ``--gen`` tokens are answered
per request: the first from the prefill, the rest one per decode step,
as the JAX package's launcher does. It prints the prefill time, the
decode time, tokens/s and sequence 0.

``--mesh DxM`` lays the run out on a ``data x model`` mesh, as the JAX
launcher's does (there the default is 4x2; here no mesh unless asked).
Under ``torchrun`` (``WORLD_SIZE`` set) the ranks split the mesh: an
``env://`` group from ``node_group`` (``nccl`` on the cards, ``gloo``
with ``--device cpu``), each rank one ``model`` position of a block of
data positions, the parameters placed by their specs (FSDP over
``data``, tensor parallel over ``model``, the MoE's EP / TP), each rank
serving its rows of the batch; rank 0 prints. Without a group the mesh
is the one-card logical context, on which a MoE dispatches each data
block on its own, as the JAX launcher's ``shard_map`` does::

    torchrun --nproc-per-node 4 -m repro_torch.launch.serve \\
        --arch moonshot-v1-16b-a3b --mesh 1x4 --batch 4 --prompt-len 2048
    torchrun --nproc-per-node 4 -m repro_torch.launch.serve \\
        --arch whisper-medium --mesh 1x4 --batch 8 --prompt-len 224
    torchrun --nproc-per-node 4 -m repro_torch.launch.serve \\
        --arch hymba-1.5b --mesh 2x2 --batch 1 --prompt-len 4096
    PYTHONPATH=src python -m torch.distributed.run --standalone \\
        --nproc-per-node 4 -m repro_torch.launch.serve --arch qwen3-0.6b \\
        --reduced --mesh 2x2 --device cpu

A batch the data positions do not divide (``--batch 1`` on a ``2x2``
mesh) is served whole on every rank, and each rank's KV cache holds its
data position's span of the ``prompt + gen`` positions (the reference's
``cache_specs`` split of a B = 1 cache); decode attention merges the
spans' partial softmax over the data positions.

The JAX launcher's ``--host-devices`` has no meaning here and is left
out.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.config import (
    ModelConfig,
    ShapeConfig,
    get_model_config,
    get_reduced_config,
)
from repro_torch.device import resolve_device
from repro_torch.distributed import collectives, sharding
from repro_torch.distributed.context import (MeshContext, make_context,
                                             node_group)
from repro_torch.models import build_model
from repro_torch.models.model_zoo import make_batch
from repro_torch.training.steps import make_serve_fns


@dataclasses.dataclass
class ServeResult:
    cfg: ModelConfig
    params: Dict[str, Any]
    prompts: torch.Tensor              # (batch, prompt_len) tokens
    inputs: Dict[str, torch.Tensor]    # the prefill's whole batch
    tokens: torch.Tensor               # (batch, gen) generated, on the host
    prefill_s: float                   # wall, ending in a synchronise
    decode_s: float                    # wall of the gen - 1 decode steps
    device: torch.device
    ctx: Optional[MeshContext] = None  # the mesh, when one was asked
    rows: slice = slice(None)          # this rank's rows of the batch
                                       # (all of one the blocks don't divide)
    held_bytes: Optional[int] = None    # the card's memory before init
    placed_bytes: Optional[int] = None  # ... after placement
    peak_bytes: Optional[int] = None    # ... and its peak over the run
    #: calls of the serving collectives, {"prefill": {...}, "decode": {...}}
    collectives: Dict[str, Dict[str, int]] = dataclasses.field(
        default_factory=dict)

    @property
    def decode_steps(self) -> int:
        return self.tokens.shape[1] - 1

    @property
    def decode_tok_per_s(self) -> float:
        return (self.decode_steps * self.tokens.shape[0]
                / max(self.decode_s, 1e-9))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(arch: str, reduced: bool = False, batch: int = 4,
          prompt_len: int = 64, gen: int = 32, seed: int = 0,
          device=None, mesh: Optional[Tuple[int, int]] = None,
          group=None) -> ServeResult:
    """Serve ``batch`` prompts of ``prompt_len`` tokens with ``gen`` greedy
    tokens each on ``device`` (``None``: the card, raising without one).
    ``mesh`` ``(data, model)``, given, lays the run out on that mesh:
    across the ranks of ``group`` (each rank one ``model`` position,
    :func:`~repro_torch.distributed.context.make_context` with
    ``split_model``), or on one device as logical nodes. The result holds
    this rank's rows (``rows``) of the tokens."""
    if gen < 1:
        raise ValueError(f"gen must be at least 1, got {gen}")
    dev = resolve_device(device)
    cfg = get_reduced_config(arch) if reduced else get_model_config(arch)
    model = build_model(cfg)
    ctx = None
    if mesh is not None:
        ctx = make_context(tuple(mesh), ("data", "model"), device=dev,
                           group=group, split_model=group is not None)
    prefill_fn, decode_fn = make_serve_fns(model, ctx)
    shape = ShapeConfig("serve", seq_len=prompt_len, global_batch=batch,
                        kind="prefill")
    held = None
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
        held = torch.cuda.memory_allocated(dev)
    params = model.init(seed, device=dev, ctx=ctx)
    prompts = make_batch(cfg, shape, seed=seed, device=dev)
    placed = (torch.cuda.memory_allocated(dev) if dev.type == "cuda"
              else None)
    max_len = prompt_len + gen
    counts = {}

    with torch.inference_mode():
        collectives.reset_counts()
        _sync(dev)
        t0 = time.perf_counter()
        toks, state = prefill_fn(params, prompts, max_len=max_len)
        _sync(dev)
        prefill_s = time.perf_counter() - t0
        counts["prefill"] = dict(collectives.COUNTS)

        collectives.reset_counts()
        out: List[torch.Tensor] = [toks]
        t0 = time.perf_counter()
        for _ in range(gen - 1):
            toks, state = decode_fn(params, state)
            out.append(toks)
        _sync(dev)
        decode_s = time.perf_counter() - t0
        counts["decode"] = dict(collectives.COUNTS)
    rows = slice(None)
    if ctx is not None and ctx.group is not None:
        lo, n = sharding.rows_block(batch, ctx)
        rows = slice(lo, lo + n)
    return ServeResult(cfg=cfg, params=params, prompts=prompts["tokens"],
                       inputs=prompts, tokens=torch.stack(out, dim=1).cpu(),
                       prefill_s=prefill_s, decode_s=decode_s, device=dev,
                       ctx=ctx, rows=rows, held_bytes=held,
                       placed_bytes=placed,
                       peak_bytes=(torch.cuda.max_memory_allocated(dev)
                                   if dev.type == "cuda" else None),
                       collectives=counts)


def parse_mesh(text: Optional[str]) -> Optional[Tuple[int, int]]:
    """``"DxM"`` -> ``(D, M)``; ``None`` stays ``None``."""
    if text is None:
        return None
    d, m = (int(v) for v in text.lower().split("x"))
    return d, m


def main(argv: Optional[List[str]] = None) -> ServeResult:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--mesh", default=None,
                    help="DxM data x model mesh (default: none); under "
                    "torchrun the ranks split it")
    args = ap.parse_args(argv)
    mesh = parse_mesh(args.mesh)
    group = None
    if mesh is not None and "WORLD_SIZE" in os.environ:
        group = node_group(args.device)
    res = serve(args.arch, reduced=args.reduced, batch=args.batch,
                prompt_len=args.prompt_len, gen=args.gen, seed=args.seed,
                device=args.device, mesh=mesh, group=group)
    if res.ctx is None or res.ctx.rank == 0:
        where = "" if res.ctx is None else (
            f" on a {args.mesh} mesh" + ("" if group is None else
                                         f", {res.ctx.world} ranks"))
        print(f"{res.cfg.name}: prefill {args.batch}x{args.prompt_len} in "
              f"{res.prefill_s * 1e3:.1f} ms; {res.decode_steps} decode "
              f"steps in {res.decode_s * 1e3:.1f} ms "
              f"({res.decode_tok_per_s:.0f} tok/s) on {res.device}{where}")
        print("sample generation (seq 0):", res.tokens[0].tolist())
    if group is not None:
        torch.distributed.destroy_process_group()
    return res


if __name__ == "__main__":
    main()

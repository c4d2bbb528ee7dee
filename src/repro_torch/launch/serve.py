"""Serving launcher: batched prefill + greedy decode with a KV/SSM cache.

Example (the card)::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b \\
        --batch 4 --prompt-len 4096 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch moonshot-v1-16b-a3b --batch 4 --prompt-len 2048 --gen 32

and on the CPU, at the reduced config::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b \\
        --reduced --prompt-len 64 --device cpu

``--arch`` takes every registered config (``config.list_models()``):
hymba-1.5b, qwen3-0.6b, mamba2-2.7b, moonshot-v1-16b-a3b, grok-1-314b,
deepseek-67b, stablelm-12b and starcoder2-15b. As in the JAX launcher
there is no depth flag: a config is served at its published depth, or
its reduced one with ``--reduced``.

Weights come from the port's seeded init and the prompts from
``make_batch`` (both from ``--seed``). ``--gen`` tokens are answered
per request: the first from the prefill, the rest one per decode step,
as the JAX package's launcher does. It prints the prefill time, the
decode time, tokens/s and sequence 0. The JAX launcher's ``--mesh`` and
``--host-devices`` have no meaning on one card and are left out.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Dict, List, Optional

import torch

from repro_torch.config import (
    ModelConfig,
    ShapeConfig,
    get_model_config,
    get_reduced_config,
)
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.models.model_zoo import make_batch
from repro_torch.training.steps import make_serve_fns


@dataclasses.dataclass
class ServeResult:
    cfg: ModelConfig
    params: Dict[str, Any]
    prompts: torch.Tensor              # (batch, prompt_len)
    tokens: torch.Tensor               # (batch, gen) generated, on the host
    prefill_s: float                   # wall, ending in a synchronise
    decode_s: float                    # wall of the gen - 1 decode steps
    device: torch.device

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
          device=None) -> ServeResult:
    """Serve ``batch`` prompts of ``prompt_len`` tokens with ``gen`` greedy
    tokens each on ``device`` (``None``: the card, raising without one)."""
    if gen < 1:
        raise ValueError(f"gen must be at least 1, got {gen}")
    dev = resolve_device(device)
    cfg = get_reduced_config(arch) if reduced else get_model_config(arch)
    model = build_model(cfg)
    prefill_fn, decode_fn = make_serve_fns(model)
    shape = ShapeConfig("serve", seq_len=prompt_len, global_batch=batch,
                        kind="prefill")
    params = model.init(seed, device=dev)
    prompts = make_batch(cfg, shape, seed=seed, device=dev)
    max_len = prompt_len + gen

    with torch.inference_mode():
        _sync(dev)
        t0 = time.perf_counter()
        toks, state = prefill_fn(params, prompts, max_len=max_len)
        _sync(dev)
        prefill_s = time.perf_counter() - t0

        out: List[torch.Tensor] = [toks]
        t0 = time.perf_counter()
        for _ in range(gen - 1):
            toks, state = decode_fn(params, state)
            out.append(toks)
        _sync(dev)
        decode_s = time.perf_counter() - t0
    return ServeResult(cfg=cfg, params=params, prompts=prompts["tokens"],
                       tokens=torch.stack(out, dim=1).cpu(),
                       prefill_s=prefill_s, decode_s=decode_s, device=dev)


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
    args = ap.parse_args(argv)
    res = serve(args.arch, reduced=args.reduced, batch=args.batch,
                prompt_len=args.prompt_len, gen=args.gen, seed=args.seed,
                device=args.device)
    print(f"{res.cfg.name}: prefill {args.batch}x{args.prompt_len} in "
          f"{res.prefill_s * 1e3:.1f} ms; {res.decode_steps} decode steps in "
          f"{res.decode_s * 1e3:.1f} ms ({res.decode_tok_per_s:.0f} tok/s) "
          f"on {res.device}")
    print("sample generation (seq 0):", res.tokens[0].tolist())
    return res


if __name__ == "__main__":
    main()

"""The worker side of ``tests/test_torch_tensor_parallel.py``: the port's
serving with the ``model`` axis split across ``gloo`` ranks, on the CPU.

:func:`start` spawns a world with ``torch.multiprocessing`` (``spawn``, a
``file://`` rendezvous in the test's temporary directory); every rank
builds a context whose ranks split ``model``
(``make_context(..., split_model=True)``), places the JAX package's
weights by their specs (``named_shardings``), serves each reduced config
through ``make_serve_fns`` -- the prefill and ``N_DECODE`` greedy decode
steps -- and pickles its rows of the gathered logits and tokens, numpy
only, with its collective counts; then the planted faults, the refusals
and the init blocks. This module imports torch, numpy and
``repro_torch`` only, and every worker checks that no JAX was imported.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import pickle
import sys
from typing import Any, Dict, List

import numpy as np
import torch

#: the per-world time limit of a collective (a fault must not hang)
TIMEOUT_S = 120.0
SEED = 0
BATCH = 4
PROMPT = 40                      # past the reduced SSD configs' chunk of 32
N_DECODE = 3
#: world -> (data, model) mesh
MESHES = {2: (1, 2), 4: (2, 2)}
#: name -> (arch, changes to its reduced config); every config in f32.
#: Between them every branch of the parameter rules is hit at model 2:
#: KV heads split (qwen3), query heads split with the KV whole and
#: sliced to the group's head (qwen3_kv1) or expanded to each query
#: head's copy (qwen3_gqa3: 3 heads a rank, groups of 2), experts split
#: (moonshot: EP), ff split (moonshot_e3: MoE TP), the sanitizer dropping ``model`` from the experts and the
#: shared experts (moonshot_e3_odd: 45 does not divide 2), from the
#: vocabulary (hymba: 511) and heads that do not divide (hymba: 5, FSDP
#: only), the SSD split with its gated-norm sum (hymba, mamba2), and the
#: vlm's patch embeddings split with the batch (internvl2)
CONFIGS = {
    "qwen3": ("qwen3-0.6b", {}),
    "qwen3_kv1": ("qwen3-0.6b", {"n_kv_heads": 1}),
    "qwen3_gqa3": ("qwen3-0.6b", {"n_heads": 6, "n_kv_heads": 3}),
    "moonshot": ("moonshot-v1-16b-a3b", {}),
    "moonshot_e3": ("moonshot-v1-16b-a3b", {"n_experts": 3}),
    "moonshot_e3_odd": ("moonshot-v1-16b-a3b",
                        {"n_experts": 3, "moe_d_ff": 45}),
    "hymba": ("hymba-1.5b", {"n_heads": 5, "n_kv_heads": 1,
                             "vocab_size": 511}),
    "mamba2": ("mamba2-2.7b", {}),
    "internvl2": ("internvl2-26b", {}),
}
#: planted fault -> the config it is planted in
FAULTS = {"wo_sum_skipped": "qwen3", "gated_norm_sum_skipped": "hymba",
          "e_start_zero": "moonshot", "vocab_mask_dropped": "qwen3"}
BLOCK_CONFIGS = ("qwen3", "moonshot_e3", "hymba")


def config(name: str, configs=None):
    """The reduced config of ``name`` in f32, from ``configs`` (the
    port's ``repro_torch.config`` by default, or the JAX package's)."""
    if configs is None:
        from repro_torch import config as configs
    arch, change = CONFIGS[name]
    return dataclasses.replace(configs.get_reduced_config(arch),
                               dtype="float32", **change)


def batch_data(name: str) -> Dict[str, np.ndarray]:
    """The seeded prompts of ``name``: tokens, and a vlm's patch
    embeddings (normal x 0.02)."""
    cfg = config(name)
    rng = np.random.default_rng(1000 + sorted(CONFIGS).index(name))
    out = {"tokens": rng.integers(0, cfg.vocab_size, (BATCH, PROMPT),
                                  dtype=np.int32)}
    if cfg.family == "vlm":
        out["patch_embeds"] = (rng.standard_normal(
            (BATCH, cfg.n_patches, cfg.d_model)) * 0.02).astype(np.float32)
    return out


# ---------------------------------------------------------------------------
# One served config
# ---------------------------------------------------------------------------

def serve_case(ctx, name: str, tree, fault: str = None) -> Dict[str, Any]:
    """``name`` served on this rank: its rows of the gathered prefill
    logits ``(rows, PROMPT, V)``, of each decode step's ``(rows, V)``,
    its tokens ``(rows, 1 + N_DECODE)``, the smallest top-k margin of its
    MoE calls and the collective counts of the prefill and the decode."""
    from repro_torch.distributed import collectives, sharding
    from repro_torch.models import build_model
    from repro_torch.models import moe
    from repro_torch.models.model_zoo import params_from_jax
    from repro_torch.training.steps import make_serve_fns
    cfg = config(name)
    model = build_model(cfg)
    params = sharding.named_shardings(
        params_from_jax(cfg, tree, device="cpu"), cfg, ctx)
    rec: Dict[str, Any] = {"decode": [], "margin": float("inf")}

    def gathered(logits, embed):
        """The logits gathered for the record, a gather not counted."""
        n = collectives.COUNTS["model_gather"]
        full = sharding.constrain_logits(logits, embed).numpy().copy()
        collectives.COUNTS["model_gather"] = n
        return full

    def prefill(p, b, **kw):
        logits, cache = model.prefill(p, b, **kw)
        rec["prefill"] = gathered(logits, p["embed"])
        return logits, cache

    def decode_step(p, c, t):
        logits, cache = model.decode_step(p, c, t)
        rec["decode"].append(gathered(logits, p["embed"]))
        return logits, cache

    own = moe.top_k_gates

    def margins(probs, k):
        top = probs.sort(dim=-1, descending=True).values
        rec["margin"] = min(rec["margin"],
                            float((top[:, k - 1] - top[:, k]).min()))
        return own(probs, k)

    prefill_fn, decode_fn = make_serve_fns(
        dataclasses.replace(model, prefill=prefill, decode_step=decode_step),
        ctx)
    batch = {k: torch.from_numpy(v) for k, v in batch_data(name).items()}
    moe.top_k_gates = margins
    try:
        with torch.no_grad(), plant(fault):
            collectives.reset_counts()
            toks, st = prefill_fn(params, batch,
                                  max_len=PROMPT + N_DECODE + 1)
            counts = {"prefill": dict(collectives.COUNTS)}
            out = [toks]
            collectives.reset_counts()
            for _ in range(N_DECODE):
                toks, st = decode_fn(params, st)
                out.append(toks)
            counts["decode"] = dict(collectives.COUNTS)
    finally:
        moe.top_k_gates = own
    n = BATCH // ctx.n_blocks
    return {"rows": (ctx.block * n, n), "prefill": rec["prefill"],
            "decode": rec["decode"],
            "tokens": torch.stack(out, dim=1).numpy(),
            "margin": rec["margin"], "counts": counts}


@contextlib.contextmanager
def plant(fault: str = None):
    """A planted fault in the rank-aware layers for the length of a
    ``with`` (nothing for ``None``)."""
    if fault is None:
        yield
        return
    from repro_torch.distributed import sharding
    from repro_torch.models import attention, layers, moe, ssm
    saved = []

    def swap(mod, name, fn):
        saved.append((mod, name, getattr(mod, name)))
        setattr(mod, name, fn)

    if fault == "wo_sum_skipped":
        def out_proj(params, o):
            b, s = o.shape[:2]
            return o.reshape(b, s, -1) @ sharding.weight(params["wo"])
        swap(attention, "_out_proj", out_proj)
    elif fault == "gated_norm_sum_skipped":
        norm = ssm._gated_norm
        swap(ssm, "_gated_norm",
             lambda y, z, scale, eps, d_inner=None: norm(y, z, scale, eps))
    elif fault == "e_start_zero":
        dc = moe._dispatch_and_compute
        swap(moe, "_dispatch_and_compute",
             lambda x, p, cfg, e_start, e_count, *w: dc(x, p, cfg, 0,
                                                        e_count, *w))
    elif fault == "vocab_mask_dropped":
        from repro_torch.distributed import collectives
        from repro_torch.distributed.context import get_mesh_context

        def embed_tokens(params, tokens):
            leaf = params["tok"]
            tok = sharding.weight(leaf)
            v0, nv = sharding.model_block(leaf, 0, leaf.shape[0])
            rows = tok[(tokens - v0).clamp(0, nv - 1)]
            return collectives.model_sum(rows, get_mesh_context())
        swap(layers, "embed_tokens", embed_tokens)
        from repro_torch.models import transformer
        swap(transformer, "embed_tokens", embed_tokens)
    else:
        raise ValueError(fault)
    try:
        yield
    finally:
        for mod, name, fn in reversed(saved):
            setattr(mod, name, fn)


# ---------------------------------------------------------------------------
# Refusals and init blocks
# ---------------------------------------------------------------------------

def refusal_cases(group, world: int, tree) -> Dict[str, str]:
    """Each refusal's exception type name (``"none"`` if it passed)."""
    from repro_torch.distributed.context import make_context
    from repro_torch.models import build_model
    from repro_torch.training.steps import make_serve_fns

    def name_of(fn):
        try:
            fn()
        except Exception as e:           # noqa: BLE001 - the type is read
            return type(e).__name__
        return "none"

    out = {
        "uneven_world": name_of(lambda: make_context(
            (1, 3), ("data", "model"), device="cpu", group=group,
            split_model=True)),
        "wrong_backend": name_of(lambda: make_context(
            MESHES[world], ("data", "model"), device="cuda", group=group,
            split_model=True)),
    }
    if world == 4:
        from repro_torch.distributed import sharding
        from repro_torch.models.model_zoo import params_from_jax
        ctx = make_context(MESHES[world], ("data", "model"), device="cpu",
                           group=group, split_model=True,
                           timeout_s=TIMEOUT_S)
        cfg = config("qwen3")
        model = build_model(cfg)
        params = sharding.named_shardings(
            params_from_jax(cfg, tree, device="cpu"), cfg, ctx)
        prefill_fn, _ = make_serve_fns(model, ctx)
        toks = torch.zeros((3, 8), dtype=torch.int32)
        out["batch_not_divided"] = name_of(
            lambda: prefill_fn(params, {"tokens": toks}))
    return out


def block_cases(ctx) -> Dict[str, bool]:
    """Whether ``Model.init(seed, ctx=)``'s blocks are ``==`` the
    one-card init's slices, leaf for leaf, for each of
    ``BLOCK_CONFIGS``."""
    from repro_torch.distributed import sharding
    from repro_torch.models import build_model
    out = {}
    for name in BLOCK_CONFIGS:
        model = build_model(config(name))
        placed = model.init(SEED, device="cpu", ctx=ctx)
        whole = model.init(SEED, device="cpu")
        specs = sharding.param_specs(whole, model.cfg, ctx)

        def walk(a, b, s):
            if isinstance(a, dict):
                return all(walk(a[k], b[k], s[k]) for k in a)
            if isinstance(a, (list, tuple)):
                return all(walk(x, y, z) for x, y, z in zip(a, b, s))
            if not isinstance(a, sharding.Shard):
                return not any(s) and torch.equal(a, b)
            return a.spec == s and torch.equal(
                a.local, b[sharding.block_slices(s, b.shape, ctx)])
        out[name] = walk(placed, whole, specs)
    return out


# ---------------------------------------------------------------------------
# Spawning a world
# ---------------------------------------------------------------------------

def _main(rank: int, world: int, tmpdir: str) -> None:
    torch.set_num_threads(1)
    assert "jax" not in sys.modules
    from repro_torch.distributed.context import make_context, node_group
    group = node_group("cpu", init_method=f"file://{tmpdir}/pg",
                       world_size=world, rank=rank, timeout_s=TIMEOUT_S)
    with open(os.path.join(tmpdir, "inputs.pkl"), "rb") as f:
        trees = pickle.load(f)
    ctx = make_context(MESHES[world], ("data", "model"), device="cpu",
                       group=group, split_model=True, timeout_s=TIMEOUT_S)
    out: Dict[str, Any] = {"rank": rank, "block": ctx.block,
                           "model_rank": ctx.model_rank}
    out["serve"] = {name: serve_case(ctx, name, trees[name])
                    for name in CONFIGS}
    out["faults"] = {f: serve_case(ctx, name, trees[name], fault=f)
                     for f, name in FAULTS.items()}
    out["refusals"] = refusal_cases(group, world, trees["qwen3"])
    out["blocks"] = block_cases(ctx)
    assert "jax" not in sys.modules
    out["jax_imported"] = "jax" in sys.modules
    with open(os.path.join(tmpdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    torch.distributed.destroy_process_group()


def start(world: int, tmpdir: str, trees: Dict[str, Any]):
    """Spawn a ``gloo`` world of ``world`` ranks serving ``trees`` (each
    config's JAX parameters as f32 numpy); returns the handle for
    :func:`finish`."""
    with open(os.path.join(tmpdir, "inputs.pkl"), "wb") as f:
        pickle.dump(trees, f)
    return torch.multiprocessing.start_processes(
        _main, args=(world, tmpdir), nprocs=world, join=False,
        start_method="spawn")


def finish(handle, world: int, tmpdir: str) -> List[Dict[str, Any]]:
    """Wait for the world; every rank's results, in rank order. A rank
    that raised raises here."""
    while not handle.join():
        pass
    out = []
    for r in range(world):
        with open(os.path.join(tmpdir, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out

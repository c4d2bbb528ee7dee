"""The worker side of ``tests/test_torch_tensor_parallel.py``: the port's
serving with the ``model`` axis split across ``gloo`` ranks, on the CPU.

:func:`start` spawns a world with ``torch.multiprocessing`` (``spawn``, a
``file://`` rendezvous in the test's temporary directory); every rank
builds a context whose ranks split ``model``
(``make_context(..., split_model=True)``), places the JAX package's
weights by their specs (``named_shardings``), serves each reduced config
through ``make_serve_fns`` -- the prefill and ``N_DECODE`` greedy decode
steps -- and pickles its rows of the gathered logits and tokens, numpy
only, with its collective counts and cache bytes; then the batches of
one row (``ONE_ROW``), whose caches split their sequence over the
blocks, the planted faults, the refusals and the init blocks. This
module imports torch, numpy and ``repro_torch`` only, and every worker
checks that no JAX was imported.
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
#: only), the SSD split with its gated-norm sum (hymba, mamba2), the
#: vlm's patch embeddings split with the batch (internvl2), and the
#: enc-dec's encoder, decoder and cross-attention heads split (whisper:
#: 4 heads, kv 4, 16 frames)
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
    "whisper": ("whisper-medium", {}),
}
#: a batch of one row, which no data axis of 2 divides: name -> (config,
#: cache length). At PROMPT + N_DECODE + 1 = 44 the prompt straddles the
#: two blocks' spans of 22 and the decode steps write into block 1; at
#: 88 the prompt and every step land in block 0 and block 1 stays empty;
#: 45 the blocks do not divide, so each keeps the whole cache. The KV
#: heads split (qwen3), attention FSDP-only with the SSD split (hymba),
#: EP with one dispatch block (moonshot), the cross cache split on the
#: frames (whisper).
ONE_ROW = {
    "qwen3_b1": ("qwen3", PROMPT + N_DECODE + 1),
    "hymba_b1": ("hymba", PROMPT + N_DECODE + 1),
    "moonshot_b1": ("moonshot", PROMPT + N_DECODE + 1),
    "whisper_b1": ("whisper", PROMPT + N_DECODE + 1),
    "qwen3_b1_empty": ("qwen3", 88),
    "whisper_b1_empty": ("whisper", 88),
    "qwen3_b1_uneven": ("qwen3", 45),
}
#: the ONE_ROW cases that only a world of several blocks tells apart
SPLIT_ONLY = ("qwen3_b1_empty", "whisper_b1_empty", "qwen3_b1_uneven")
#: planted fault -> the case it is planted in (a CONFIGS or ONE_ROW name)
FAULTS = {"wo_sum_skipped": "qwen3", "gated_norm_sum_skipped": "hymba",
          "e_start_zero": "moonshot", "vocab_mask_dropped": "qwen3",
          "cross_sum_skipped": "whisper", "merge_skipped": "qwen3_b1",
          "empty_guard_dropped": "qwen3_b1_empty",
          "row_in_every_block": "qwen3_b1"}
#: the faults in the sequence split, which a world of one block never runs
SPLIT_FAULTS = ("merge_skipped", "empty_guard_dropped",
                "row_in_every_block")
#: the prompt of ``batch_not_divided``: 3 rows over 2 data positions
UNDIVIDED = (3, 8)
BLOCK_CONFIGS = ("qwen3", "moonshot_e3", "hymba", "whisper")


def config_of(name: str) -> str:
    """The CONFIGS entry a CONFIGS or ONE_ROW name serves."""
    return ONE_ROW[name][0] if name in ONE_ROW else name


def config(name: str, configs=None):
    """The reduced config of ``name`` (a CONFIGS or ONE_ROW name) in f32,
    from ``configs`` (the port's ``repro_torch.config`` by default, or
    the JAX package's)."""
    if configs is None:
        from repro_torch import config as configs
    arch, change = CONFIGS[config_of(name)]
    return dataclasses.replace(configs.get_reduced_config(arch),
                               dtype="float32", **change)


def serve_shape(name: str):
    """(rows, cache length) ``name`` is served at."""
    if name in ONE_ROW:
        return 1, ONE_ROW[name][1]
    return BATCH, PROMPT + N_DECODE + 1


def batch_data(name: str) -> Dict[str, np.ndarray]:
    """The seeded prompts of ``name``: tokens, and a vlm's patch
    embeddings or an enc-dec's frames (normal x 0.02); a ONE_ROW case
    takes the first row of its config's."""
    if name in ONE_ROW:
        return {k: v[:1] for k, v in batch_data(config_of(name)).items()}
    cfg = config(name)
    rng = np.random.default_rng(1000 + sorted(CONFIGS).index(name))
    out = {"tokens": rng.integers(0, cfg.vocab_size, (BATCH, PROMPT),
                                  dtype=np.int32)}
    if cfg.family == "vlm":
        out["patch_embeds"] = (rng.standard_normal(
            (BATCH, cfg.n_patches, cfg.d_model)) * 0.02).astype(np.float32)
    if cfg.is_encdec:
        out["frames"] = (rng.standard_normal(
            (BATCH, cfg.n_frames, cfg.d_model)) * 0.02).astype(np.float32)
    return out


# ---------------------------------------------------------------------------
# One served config
# ---------------------------------------------------------------------------

def serve_case(ctx, name: str, tree, fault: str = None) -> Dict[str, Any]:
    """``name`` served on this rank at :func:`serve_shape`: its rows of
    the gathered prefill logits ``(rows, PROMPT, V)``, of each decode
    step's ``(rows, V)``, its tokens ``(rows, 1 + N_DECODE)``, the
    smallest top-k margin of its MoE calls, the collective counts of the
    prefill and the decode, and the bytes of each cache leaf after the
    prefill."""
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
        rec["bytes"] = {k: v.numel() * v.element_size()
                        for k, v in cache.items() if torch.is_tensor(v)}
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
    rows, max_len = serve_shape(name)
    moe.top_k_gates = margins
    try:
        with torch.no_grad(), plant(fault):
            collectives.reset_counts()
            toks, st = prefill_fn(params, batch, max_len=max_len)
            counts = {"prefill": dict(collectives.COUNTS)}
            out = [toks]
            collectives.reset_counts()
            for _ in range(N_DECODE):
                toks, st = decode_fn(params, st)
                out.append(toks)
            counts["decode"] = dict(collectives.COUNTS)
    finally:
        moe.top_k_gates = own
    return {"rows": sharding.rows_block(rows, ctx),
            "prefill": rec["prefill"], "decode": rec["decode"],
            "tokens": torch.stack(out, dim=1).numpy(),
            "margin": rec["margin"], "counts": counts,
            "bytes": rec["bytes"]}


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
    elif fault == "cross_sum_skipped":
        def unsummed(params, o):
            b, s = o.shape[:2]
            return o.reshape(b, s, -1) @ sharding.weight(params["wo"])

        def cross_attend(params, x, k, v, cfg):
            q = attention._cross_q(params, x, cfg)
            return unsummed(params, attention._attend(q, k, v, False, False))

        def decode_cross(params, x, cfg, k_cache, v_cache, frames):
            start, n = sharding.cache_span(frames)
            return unsummed(params, attention._decode_attention(
                attention._cross_q(params, x, cfg), k_cache, v_cache,
                frames, start if n < frames else None))
        swap(attention, "cross_attend", cross_attend)
        swap(attention, "decode_cross_attention", decode_cross)
    elif fault == "merge_skipped":
        from repro_torch.distributed import collectives
        swap(collectives, "attn_merge",
             lambda m, l, o, ctx: o / l[..., None])
    elif fault == "empty_guard_dropped":
        def partials(q, k_cache, v_cache, cache_len, start):
            b, _, h, hd = q.shape
            s, kh = k_cache.shape[1], k_cache.shape[2]
            qg = q.reshape(b, 1, kh, h // kh, hd)
            scores = torch.einsum("bqkgd,bskd->bkgqs", qg,
                                  k_cache).float() / np.sqrt(hd)
            valid = attention._valid(cache_len, start + torch.arange(s))
            scores = torch.where(valid[:, None, None, None, :], scores,
                                 float("-inf"))
            m = scores.amax(dim=-1)
            p = torch.exp(scores - m[..., None])      # -inf - -inf: NaN
            o = torch.einsum("bkgqs,bskd->bkgqd", p, v_cache)
            return m, p.sum(dim=-1), o
        swap(attention, "_decode_partials", partials)
    elif fault == "row_in_every_block":
        def write_row(cache, new, pos, start):
            cache[:, (pos - start) % cache.shape[1]] = new.to(cache.dtype)
        swap(attention, "_write_row", write_row)
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
        toks = torch.zeros(UNDIVIDED, dtype=torch.int32)
        served = []
        out["batch_not_divided"] = name_of(
            lambda: served.append(prefill_fn(params, {"tokens": toks})[0]))
        out["batch_not_divided_tokens"] = (served[0].numpy() if served
                                           else None)
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
    split = ctx.n_blocks > 1
    out["serve"] = {name: serve_case(ctx, name, trees[config_of(name)])
                    for name in list(CONFIGS) + list(ONE_ROW)
                    if split or name not in SPLIT_ONLY}
    out["faults"] = {f: serve_case(ctx, name, trees[config_of(name)],
                                   fault=f)
                     for f, name in FAULTS.items()
                     if split or f not in SPLIT_FAULTS}
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

"""The port's model stack against the JAX package's, on the CPU.

Every ported module gets the same numpy inputs (or, for whole models,
the JAX package's own initialised weights through ``params_from_jax``)
on both sides. Module-level tolerances are f32 rounding (atol 1e-5 /
rtol 1e-5 unless stated); bf16 comparisons are relative to the largest
magnitude, since XLA and torch round bf16 at other points. The whole
slice -- ``prefill`` plus 4 ``decode_step``s of reduced hymba, qwen3 and
mamba2 -- is held at atol = rtol = 1e-4 in f32 (with greedy tokens equal
wherever the JAX top-2 margin exceeds 1e-3) and at 3e-2 of max |logit|
in bf16.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.config as JC
from repro.models import attention as jattn
from repro.models import build_model as jax_build_model
from repro.models import layers as jlayers
from repro.models import ssm as jssm
from repro_torch import config as TC
from repro_torch.launch import serve as tserve
from repro_torch.models import attention as tattn
from repro_torch.models import build_model
from repro_torch.models import layers as tlayers
from repro_torch.models import ssm as tssm
from repro_torch.models.model_zoo import (batch_struct, make_batch,
                                          params_from_jax)

ARCHS = ("hymba-1.5b", "qwen3-0.6b", "mamba2-2.7b")
RNG = np.random.default_rng(7)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


def _pair(a, dtype="float32"):
    """The same numpy array as a JAX array and a torch tensor."""
    a = np.asarray(a, np.float32)
    return jnp.asarray(a, dtype), torch.from_numpy(a).to(getattr(torch, dtype))


def _tree_np(tree):
    return jax.tree.map(np.array, tree)     # writable copies


def _cfgs(arch, dtype="float32"):
    return (dataclasses.replace(JC.get_reduced_config(arch), dtype=dtype),
            dataclasses.replace(TC.get_reduced_config(arch), dtype=dtype))


def _close(got, want, atol=1e-5, rtol=1e-5, what=""):
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=rtol,
                               err_msg=what)


def _close_rel(got, want, rel, what=""):
    g, w = _np(got), _np(want)
    scale = float(np.max(np.abs(w))) + 1e-9
    assert float(np.max(np.abs(g - w))) / scale <= rel, what


# ---------------------------------------------------------------------------
# Configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_are_copies(arch):
    for getter in ("get_model_config", "get_reduced_config"):
        j, t = getattr(JC, getter)(arch), getattr(TC, getter)(arch)
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
        assert j.param_count() == t.param_count()
        for prop in ("resolved_head_dim", "q_dim", "kv_dim", "d_inner",
                     "ssm_n_heads", "is_moe", "supports_long_context"):
            assert getattr(j, prop) == getattr(t, prop), prop
        for name, shape in JC.SHAPES.items():
            assert dataclasses.asdict(shape) == dataclasses.asdict(
                TC.SHAPES[name])
            assert JC.shape_applicable(j, shape) == TC.shape_applicable(
                t, TC.SHAPES[name])


def test_registry_lists_the_ported_models():
    assert set(TC.list_models()) == set(ARCHS)
    assert TC.get_model_config("hymba-1.5b").param_count() == 1_640_768_896
    with pytest.raises(KeyError):
        TC.get_model_config("grok-1-314b")


@pytest.mark.parametrize("change", [dict(n_experts=4, top_k=2),
                                    dict(encoder_layers=2),
                                    dict(family="vlm", n_patches=4)],
                         ids=["moe", "enc-dec", "vlm"])
def test_unported_families_raise(change):
    cfg = dataclasses.replace(TC.get_reduced_config("qwen3-0.6b"), **change)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_model(cfg)


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

def test_rope_freqs_exact():
    for hd, theta in ((16, 10_000.0), (64, 10_000.0), (128, 1e6)):
        assert np.array_equal(tlayers.rope_freqs(hd, theta).numpy(),
                              np.asarray(jlayers.rope_freqs(hd, theta)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_rope_and_norms(dtype):
    jx, tx = _pair(RNG.standard_normal((2, 9, 3, 16)), dtype)
    pos = np.tile(np.arange(5, 14), (2, 1))
    got = tlayers.apply_rope(tx, torch.from_numpy(pos), 10_000.0)
    want = jlayers.apply_rope(jx, jnp.asarray(pos), 10_000.0)
    rel = 1e-5 if dtype == "float32" else 1e-2
    _close_rel(got, want, rel, "apply_rope")
    js, ts = _pair(RNG.uniform(0.5, 1.5, 16), dtype)
    _close_rel(tlayers.head_rmsnorm(ts, tx), jlayers.head_rmsnorm(js, jx),
               rel, "head_rmsnorm")
    _close_rel(tlayers.rmsnorm({"scale": ts}, tx, 1e-6),
               jlayers.rmsnorm({"scale": js}, jx, 1e-6), rel, "rmsnorm")


@pytest.mark.parametrize("mlp", ["swiglu", "gelu"])
def test_mlp_apply(mlp):
    jcfg, tcfg = _cfgs("qwen3-0.6b")
    jcfg, tcfg = (dataclasses.replace(c, mlp=mlp) for c in (jcfg, tcfg))
    p = _tree_np(jlayers.mlp_init(jax.random.PRNGKey(1), jcfg))
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    jx, tx = _pair(RNG.standard_normal((2, 5, jcfg.d_model)))
    _close(tlayers.mlp_apply(tp, tx, tcfg),
           jlayers.mlp_apply({k: jnp.asarray(v) for k, v in p.items()}, jx,
                             jcfg))


@pytest.mark.parametrize("tie", [True, False])
def test_embed_unembed_and_loss(tie):
    jcfg, tcfg = _cfgs("qwen3-0.6b")
    jcfg, tcfg = (dataclasses.replace(c, tie_embeddings=tie)
                  for c in (jcfg, tcfg))
    p = _tree_np(jlayers.embedding_init(jax.random.PRNGKey(2), jcfg))
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    toks = RNG.integers(0, jcfg.vocab_size, (2, 6)).astype(np.int32)
    te = tlayers.embed_tokens(tp, torch.from_numpy(toks))
    je = jlayers.embed_tokens(jp, jnp.asarray(toks))
    _close(te, je, 0, 0)
    tl, jl = tlayers.unembed(tp, te, tcfg), jlayers.unembed(jp, je, jcfg)
    _close(tl, jl)
    mask = (RNG.uniform(size=(2, 6)) > 0.3).astype(np.float32)
    for m in (None, mask):
        got = tlayers.cross_entropy_loss(
            tl, torch.from_numpy(toks),
            None if m is None else torch.from_numpy(m))
        want = jlayers.cross_entropy_loss(
            jl, jnp.asarray(toks), None if m is None else jnp.asarray(m))
        _close(got, want)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def _qkv(b, sq, skv, h, kh, d, dtype="float32"):
    return [_pair(RNG.standard_normal(s), dtype) for s in
            ((b, sq, h, d), (b, skv, kh, d), (b, skv, kh, d))]


@pytest.mark.parametrize("sq,skv", [(128, 128), (96, 96), (64, 256)])
def test_full_and_blockwise_attention(sq, skv):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(2, sq, skv, 4, 2, 32)
    for causal in (True, False):
        jfull = jattn._full_attention(jq, jk, jv, causal)
        _close(tattn._full_attention(tq, tk, tv, causal), jfull, 2e-5, 2e-5)
        _close(tattn._blockwise_attention(tq, tk, tv, causal, 32, 32),
               jattn._blockwise_attention(jq, jk, jv, causal, 32, 32),
               2e-5, 2e-5)


def test_blockwise_pair_count_exact_causal():
    assert len(tattn._causal_pairs(4, 4, 32, 32, 0, True)) == 10
    assert len(tattn._causal_pairs(4, 4, 32, 32, 0, False)) == 16
    assert len(tattn._causal_pairs(2, 8, 32, 32, 192, True)) == 15


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention(dtype):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(2, 1, 12, 4, 2, 16, dtype)
    rel = 1e-5 if dtype == "float32" else 2e-2
    for ln in (5, 12):
        _close_rel(tattn._decode_attention(tq, tk, tv, ln),
                   jattn._decode_attention(jq, jk, jv, jnp.int32(ln)), rel)
    lens = np.array([3, 9], np.int32)
    _close_rel(tattn._decode_attention(tq, tk, tv, torch.from_numpy(lens)),
               jattn._decode_attention(jq, jk, jv, jnp.asarray(lens)), rel)


def _attn_params(arch, key=3):
    jcfg, tcfg = _cfgs(arch)
    p = _tree_np(jattn.attention_init(jax.random.PRNGKey(key), jcfg))
    return (jcfg, {k: jnp.asarray(v) for k, v in p.items()},
            tcfg, {k: torch.from_numpy(v) for k, v in p.items()})


@pytest.mark.parametrize("arch", ["hymba-1.5b", "qwen3-0.6b"])
@pytest.mark.parametrize("blockwise", [False, True])
def test_self_attention_paths(arch, blockwise):
    jcfg, jp, tcfg, tp = _attn_params(arch)
    jx, tx = _pair(RNG.standard_normal((2, 40, jcfg.d_model)))
    for causal in (True, False):
        _close(tattn.self_attention(tp, tx, tcfg, causal=causal,
                                    force_blockwise=blockwise),
               jattn.self_attention(jp, jx, jcfg, causal=causal,
                                    force_blockwise=blockwise), 2e-5, 2e-5)


def test_prefill_and_decode_self_attention():
    jcfg, jp, tcfg, tp = _attn_params("hymba-1.5b")
    jx, tx = _pair(RNG.standard_normal((2, 24, jcfg.d_model)))
    got, want = (tattn.prefill_self_attention(tp, tx, tcfg),
                 jattn.prefill_self_attention(jp, jx, jcfg))
    for g, w in zip(got, want):
        _close(g, w, 2e-5, 2e-5)
    jc = jnp.pad(want[1], ((0, 0), (0, 4), (0, 0), (0, 0)))
    jv = jnp.pad(want[2], ((0, 0), (0, 4), (0, 0), (0, 0)))
    tk = torch.nn.functional.pad(got[1], (0, 0, 0, 0, 0, 4))
    tv = torch.nn.functional.pad(got[2], (0, 0, 0, 0, 0, 4))
    jy, ty = _pair(RNG.standard_normal((2, 1, jcfg.d_model)))
    jo, jk2, jv2 = jattn.decode_self_attention(jp, jy, jcfg, jc, jv,
                                               jnp.int32(24))
    to, tk2, tv2 = tattn.decode_self_attention(tp, ty, tcfg, tk, tv, 24)
    _close(to, jo, 2e-5, 2e-5)
    _close(tk2, jk2, 2e-5, 2e-5)
    _close(tv2, jv2, 2e-5, 2e-5)


# ---------------------------------------------------------------------------
# SSM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv_and_gated_norm(dtype):
    jx, tx = _pair(RNG.standard_normal((2, 11, 24)), dtype)
    jw, tw = _pair(RNG.standard_normal((4, 24)) * 0.3, dtype)
    jb, tb = _pair(RNG.standard_normal(24) * 0.1, dtype)
    rel = 1e-5 if dtype == "float32" else 2e-2
    _close_rel(tssm._causal_conv(tx, tw, tb), jssm._causal_conv(jx, jw, jb),
               rel, "causal_conv")
    jz, tz = _pair(RNG.standard_normal((2, 11, 24)), dtype)
    js, ts = _pair(RNG.uniform(0.5, 1.5, 24), dtype)
    _close_rel(tssm._gated_norm(tx, tz, ts, 1e-5),
               jssm._gated_norm(jx, jz, js, 1e-5), rel, "gated_norm")


def _ssm_params(arch):
    jcfg, tcfg = _cfgs(arch)
    p = _tree_np(jssm.ssm_init(jax.random.PRNGKey(4), jcfg))
    return (jcfg, {k: jnp.asarray(v) for k, v in p.items()},
            tcfg, {k: torch.from_numpy(v) for k, v in p.items()})


@pytest.mark.parametrize("arch", ["hymba-1.5b", "mamba2-2.7b"])
@pytest.mark.parametrize("length", [2, 40, 64])
def test_ssm_apply_and_decode(arch, length):
    jcfg, jp, tcfg, tp = _ssm_params(arch)
    ju, tu = _pair(RNG.standard_normal((2, length, jcfg.d_model)))
    jout, (jconv, jstate) = jssm.ssm_apply(jp, ju, jcfg, return_cache=True)
    tout, (tconv, tstate) = tssm.ssm_apply(tp, tu, tcfg, return_cache=True)
    _close(tout, jout, 2e-5, 2e-4, "out")
    _close(tconv, jconv, 2e-5, 2e-4, "conv cache")
    _close(tstate, jstate, 2e-5, 2e-4, "state")
    jy, ty = _pair(RNG.standard_normal((2, 1, jcfg.d_model)))
    got = tssm.ssm_decode_step(tp, ty, tcfg, tconv, tstate)
    want = jssm.ssm_decode_step(jp, jy, jcfg, jconv, jstate)
    for g, w, what in zip(got, want, ("out", "conv", "state")):
        _close(g, w, 2e-5, 2e-4, what)
    # a second call from the first call's state continues the sequence
    _, s2 = tssm.ssm_apply(tp, tu, tcfg, init_state=tstate)
    _, js2 = jssm.ssm_apply(jp, ju, jcfg, init_state=jstate)
    _close(s2, js2, 2e-5, 2e-4, "continued state")


def test_init_ssm_and_kv_cache_layout():
    jcfg, tcfg = _cfgs("hymba-1.5b", "bfloat16")
    j = jssm.init_ssm_cache(jcfg, 3)
    t = tssm.init_ssm_cache(tcfg, 3, device="cpu")
    assert {k: tuple(v.shape) for k, v in t.items()} == \
        {k: tuple(v.shape) for k, v in j.items()}
    jk = jattn.init_kv_cache(jcfg, 3, 17)
    tk = tattn.init_kv_cache(tcfg, 3, 17, device="cpu")
    assert tk["k"].shape == jk["k"].shape and tk["k"].dtype == torch.bfloat16
    assert tk["length"] == 0


# ---------------------------------------------------------------------------
# The whole slice: prefill + decode from the same weights
# ---------------------------------------------------------------------------

def _models(arch, dtype):
    jcfg, tcfg = _cfgs(arch, dtype)
    jm, tm = jax_build_model(jcfg), build_model(tcfg)
    jparams = jm.init(jax.random.PRNGKey(5))
    tparams = params_from_jax(tcfg, _tree_np(jparams), device="cpu")
    return jcfg, jm, jparams, tcfg, tm, tparams


def test_params_from_jax_keeps_keys_shapes_and_types():
    jcfg, _, jparams, tcfg, tm, tparams = _models("hymba-1.5b", "bfloat16")
    own = tm.init(0, device="cpu")
    flat_j = jax.tree_util.tree_flatten_with_path(jparams)[0]
    for path, leaf in flat_j:
        keys = [p.key for p in path]
        node = tparams
        for i, k in enumerate(keys):
            node = node[k]
            if k == "layers":
                node = node[0]
        mine = own
        for k in keys:
            mine = mine[k][0] if k == "layers" else mine[k]
        want_shape = leaf.shape[1:] if keys[0] == "layers" else leaf.shape
        assert tuple(node.shape) == tuple(want_shape), keys
        assert tuple(mine.shape) == tuple(want_shape), keys
        assert node.dtype == mine.dtype, keys
        assert str(node.dtype).endswith(str(leaf.dtype)), keys
    assert len(tparams["layers"]) == tcfg.n_layers
    assert torch.equal(tparams["embed"]["tok"].float(),
                       torch.from_numpy(np.asarray(
                           jparams["embed"]["tok"], np.float32)))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_jax(arch, dtype):
    jcfg, jm, jparams, tcfg, tm, tparams = _models(arch, dtype)
    seq, gen = 48, 4
    toks = RNG.integers(0, jcfg.vocab_size, (2, seq)).astype(np.int32)
    jlog, jcache = jax.jit(lambda p, b: jm.prefill(p, b, max_len=seq + gen))(
        jparams, {"tokens": jnp.asarray(toks)})
    tlog, tcache = tm.prefill(tparams, {"tokens": torch.from_numpy(toks)},
                              max_len=seq + gen)
    steps = [(tlog, jlog)]
    jdec = jax.jit(jm.decode_step)
    nxt = jnp.argmax(jlog[:, -1], axis=-1).astype(jnp.int32)
    for _ in range(gen):
        jl, jcache = jdec(jparams, jcache, nxt)
        tl, tcache = tm.decode_step(tparams, tcache,
                                    torch.from_numpy(np.array(nxt)))
        steps.append((tl, jl))
        nxt = jnp.argmax(jl, axis=-1).astype(jnp.int32)
    assert tcache["length"] == seq + gen
    for i, (tl, jl) in enumerate(steps):
        if dtype == "float32":
            _close(tl, jl, 1e-4, 1e-4, f"step {i}")
            last = _np(jl)[..., -1, :] if i == 0 else _np(jl)
            tlast = _np(tl)[..., -1, :] if i == 0 else _np(tl)
            top2 = np.sort(last, axis=-1)[..., -2:]
            clear = top2[..., 1] - top2[..., 0] > 1e-3
            assert np.array_equal(tlast.argmax(-1)[clear],
                                  last.argmax(-1)[clear]), f"step {i}"
        else:
            _close_rel(tl, jl, 3e-2, f"step {i}")


# ---------------------------------------------------------------------------
# Model facade and launcher
# ---------------------------------------------------------------------------

def test_batch_struct_and_make_batch():
    cfg = TC.get_reduced_config("hymba-1.5b")
    shape = TC.ShapeConfig("s", seq_len=12, global_batch=3, kind="train")
    spec = batch_struct(cfg, shape)
    assert spec["tokens"].shape == (3, 12) and "labels" in spec
    a = make_batch(cfg, shape, seed=4, device="cpu")
    b = make_batch(cfg, shape, seed=4, device="cpu")
    assert torch.equal(a["tokens"], b["tokens"])
    assert a["tokens"].dtype == torch.int32
    assert 0 <= int(a["tokens"].min()) and int(a["tokens"].max()) < 512
    dec = batch_struct(cfg, TC.ShapeConfig("d", 12, 3, "decode"))
    assert dec["tokens"].shape == (3,)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_jax(arch):
    jcfg, jm, jparams, tcfg, tm, tparams = _models(arch, "float32")
    toks = RNG.integers(0, jcfg.vocab_size, (2, 24)).astype(np.int32)
    jl, _ = jm.forward(jparams, {"tokens": jnp.asarray(toks)})
    tl, _ = tm.forward(tparams, {"tokens": torch.from_numpy(toks)})
    _close(tl, jl, 1e-4, 1e-4)
    jloss, _ = jm.loss_fn(jparams, {"tokens": jnp.asarray(toks),
                                    "labels": jnp.asarray(toks)})
    tloss, _ = tm.loss_fn(tparams, {"tokens": torch.from_numpy(toks),
                                    "labels": torch.from_numpy(toks)})
    _close(tloss, jloss, 1e-5, 1e-5)


def test_serve_launcher_on_the_cpu(capsys):
    res = tserve.main(["--arch", "hymba-1.5b", "--reduced", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "40", "--gen", "5"])
    out = capsys.readouterr().out
    assert "hymba-1.5b-reduced: prefill 2x40" in out and "tok/s" in out
    assert res.tokens.shape == (2, 5) and res.device.type == "cpu"
    assert 0 <= int(res.tokens.min()) and int(res.tokens.max()) < 512
    # the first token is the prefill's greedy answer; the rest decode
    model = build_model(res.cfg)
    logits, _ = model.prefill(res.params, {"tokens": res.prompts})
    assert torch.equal(logits[:, -1].argmax(-1).to(torch.int32),
                       res.tokens[:, 0])

"""The port's enc-dec and vlm families against the JAX package's, on the
CPU.

The same numpy inputs (stub frame and patch embeddings drawn normal x
0.02, as the JAX package's ``make_batch`` draws them) and the JAX
package's own weights (through ``params_from_jax``) go through both
packages. Module tolerances are f32 rounding (2e-5) and, in bf16, 2e-2
of the largest magnitude. The whole slice (prefill + 4 decode steps) of
both archs is held in ``test_torch_models.py``, whose tests run over
every ported arch; here are the modules, the twins of
``tests/test_archs_smoke.py``, and the routing of every prefill
attention through the kernel op on its CUDA route.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro.config as JC
from repro.models import attention as jattn
from repro.models import build_model as jax_build_model
from repro.models import encdec as jencdec
from repro.models.model_zoo import make_batch as jax_make_batch
from repro_torch import config as TC
from repro_torch.kernels.flash_attn import attention_ref
from repro_torch.kernels.flash_attn import kernel as fa_kernel
from repro_torch.kernels.flash_attn import ops as fa_ops
from repro_torch.models import attention as tattn
from repro_torch.models import build_model
from repro_torch.models import encdec as tencdec
from repro_torch.models.model_zoo import (batch_struct, make_batch,
                                          params_from_jax)

NEW_ARCHS = ("whisper-medium", "internvl2-26b")
RNG = np.random.default_rng(21)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


def _rel(got, want):
    g, w = _np(got), _np(want)
    return float(np.max(np.abs(g - w))) / (float(np.max(np.abs(w))) + 1e-9)


def _tol(dtype):
    return 2e-5 if dtype == "float32" else 2e-2


def _pair(a, dtype):
    a = np.asarray(a, np.float32)
    return jnp.asarray(a, dtype), torch.from_numpy(a).to(getattr(torch,
                                                                  dtype))


def _cfgs(arch, dtype="float32"):
    return (dataclasses.replace(JC.get_reduced_config(arch), dtype=dtype),
            dataclasses.replace(TC.get_reduced_config(arch), dtype=dtype))


def _models(arch, dtype):
    jcfg, tcfg = _cfgs(arch, dtype)
    jm, tm = jax_build_model(jcfg), build_model(tcfg)
    jparams = jm.init(jax.random.PRNGKey(5))
    tparams = params_from_jax(tcfg, jax.tree.map(np.array, jparams),
                              device="cpu")
    return jcfg, jm, jparams, tcfg, tm, tparams


def _stub(shape):
    return (RNG.standard_normal(shape) * 0.02).astype(np.float32)


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_attention_matches_jax(dtype):
    """Decoder queries (S 10) attend to 16 context frames, no mask, no
    RoPE; the port's split into ``cross_kv`` / ``cross_attend`` gives the
    same function."""
    jcfg, tcfg = _cfgs("whisper-medium", dtype)
    p = jax.tree.map(np.array, jattn.attention_init(
        jax.random.PRNGKey(3), jcfg, cross=True))
    assert set(p) == {"wq", "wk", "wv", "wo"}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v.astype(np.float32)).to(getattr(torch, dtype))
          for k, v in p.items()}
    jx, tx = _pair(RNG.standard_normal((2, 10, jcfg.d_model)), dtype)
    jc, tc = _pair(RNG.standard_normal((2, 16, jcfg.d_model)), dtype)
    want = jattn.cross_attention(jp, jx, jc, jcfg)
    got = tattn.cross_attention(tp, tx, tc, tcfg)
    assert got.shape == (2, 10, jcfg.d_model) and got.dtype == tx.dtype
    assert _rel(got, want) <= _tol(dtype)
    k, v = tattn.cross_kv(tp, tc, tcfg)
    assert k.shape == (2, 16, tcfg.n_kv_heads, tcfg.resolved_head_dim)
    assert torch.equal(tattn.cross_attend(tp, tx, k, v, tcfg), got)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_matches_jax(dtype):
    jcfg, jm, jparams, tcfg, tm, tparams = _models("whisper-medium", dtype)
    jf, tf = _pair(_stub((2, jcfg.n_frames, jcfg.d_model)), dtype)
    want = jencdec.encode(jparams, jf, jcfg)
    got = tencdec.encode(tparams, tf, tcfg)
    assert got.shape == (2, jcfg.n_frames, jcfg.d_model)
    assert got.dtype == getattr(torch, dtype)
    assert _rel(got, want) <= _tol(dtype)


def _without_encoder_rope(monkeypatch):
    own = tattn.self_attention

    def no_rope(params, x, cfg, causal=True, **kw):
        kw["use_rope"] = causal        # the encoder's call is non-causal
        return own(params, x, cfg, causal=causal, **kw)

    monkeypatch.setattr(tattn, "self_attention", no_rope)


def _rope_on_cross(monkeypatch):
    def with_rope(params, x, k, v, cfg):
        b, s, _ = x.shape
        q = (x @ params["wq"]).reshape(b, s, cfg.n_heads,
                                       cfg.resolved_head_dim)
        q = tattn.apply_rope(q, torch.arange(s).expand(b, s),
                             cfg.rope_theta)
        f = k.shape[1]
        k = tattn.apply_rope(k, torch.arange(f).expand(b, f),
                             cfg.rope_theta)
        o = tattn._full_attention(q, k, v, causal=False)
        return o.reshape(b, s, -1) @ params["wo"]

    monkeypatch.setattr(tattn, "cross_attend", with_rope)


@pytest.mark.parametrize("fault", [_without_encoder_rope, _rope_on_cross],
                         ids=["encoder-without-rope", "cross-with-rope"])
def test_parity_sees_rope_faults(fault, monkeypatch):
    """The f32 forward parity at 1e-4 of ``test_torch_models.py`` reads
    a port that drops the encoder's RoPE, or adds RoPE to the
    cross-attention, far above its limit."""
    jcfg, jm, jparams, tcfg, tm, tparams = _models("whisper-medium",
                                                   "float32")
    toks = RNG.integers(0, jcfg.vocab_size, (2, 12)).astype(np.int32)
    frames = _stub((2, jcfg.n_frames, jcfg.d_model))
    want, _ = jm.forward(jparams, {"tokens": jnp.asarray(toks),
                                   "frames": jnp.asarray(frames)})
    tbatch = {"tokens": torch.from_numpy(toks),
              "frames": torch.from_numpy(frames)}
    assert _rel(tm.forward(tparams, tbatch)[0], want) < 1e-5
    fault(monkeypatch)
    assert _rel(tm.forward(tparams, tbatch)[0], want) > 1e-2


def test_params_from_jax_carries_the_encdec_leaves():
    """Every leaf of the JAX tree (``enc_layers``, ``enc_norm``, each
    decoder layer's ``ln_cross`` and ``cross``) lands at its key with its
    shape, type and value, and the port's own init has the same tree."""
    jcfg, _, jparams, tcfg, tm, tparams = _models("whisper-medium",
                                                  "bfloat16")
    own = tm.init(0, device="cpu")
    assert len(tparams["enc_layers"]) == tcfg.encoder_layers
    assert len(tparams["layers"]) == tcfg.n_layers
    n = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(jparams)[0]:
        keys = [p.key for p in path]
        stacked = keys[0] in ("layers", "enc_layers")
        for i in range(leaf.shape[0] if stacked else 1):
            node, mine = tparams, own
            for k in keys:
                node, mine = node[k], mine[k]
                if k in ("layers", "enc_layers"):
                    node, mine = node[i], mine[i]
            want = np.asarray(leaf[i] if stacked else leaf, np.float32)
            assert tuple(node.shape) == tuple(mine.shape) == want.shape, keys
            assert node.dtype == mine.dtype == torch.bfloat16, keys
            assert np.array_equal(node.float().numpy(), want), keys
            n += 1
    assert "q_norm" not in tparams["layers"][0]["cross"]
    assert n > 0


def test_patch_embeds_replace_the_leading_positions():
    """vlm: the first n_patches positions take the patch embeddings (cast
    to the activation type), the rest their tokens'; a batch without
    patches embeds its tokens only."""
    from repro_torch.models import transformer
    tcfg = TC.get_reduced_config("internvl2-26b")
    params = build_model(tcfg).init(0, device="cpu")
    toks = torch.randint(0, tcfg.vocab_size, (2, 12))
    pe = torch.from_numpy(_stub((2, tcfg.n_patches, tcfg.d_model)))
    x = transformer._embed_inputs(params, {"tokens": toks,
                                           "patch_embeds": pe}, tcfg)
    tok = params["embed"]["tok"][toks]
    assert x.dtype == torch.bfloat16 and x.shape == tok.shape
    assert torch.equal(x[:, :tcfg.n_patches], pe.to(torch.bfloat16))
    assert torch.equal(x[:, tcfg.n_patches:], tok[:, tcfg.n_patches:])
    assert torch.equal(
        transformer._embed_inputs(params, {"tokens": toks}, tcfg), tok)


def test_more_patches_than_tokens_matches_jax():
    """n_patches > S: as in the JAX package, the prefill runs over the
    n_patches positions, and decode goes on from length S."""
    jcfg, jm, jparams, tcfg, tm, tparams = _models("internvl2-26b",
                                                   "float32")
    toks = RNG.integers(0, jcfg.vocab_size, (2, 5)).astype(np.int32)
    pe = _stub((2, jcfg.n_patches, jcfg.d_model))
    jl, jc = jm.prefill(jparams, {"tokens": jnp.asarray(toks),
                                  "patch_embeds": jnp.asarray(pe)},
                        max_len=7)
    tl, tc = tm.prefill(tparams, {"tokens": torch.from_numpy(toks),
                                  "patch_embeds": torch.from_numpy(pe)},
                        max_len=7)
    assert tl.shape == jl.shape == (2, jcfg.n_patches, jcfg.vocab_size)
    assert tc["k"].shape == jc["k"].shape and tc["length"] == 5
    np.testing.assert_allclose(_np(tl), _np(jl), atol=1e-4, rtol=1e-4)
    nxt = np.array([3, 4], np.int32)
    jd, _ = jm.decode_step(jparams, jc, jnp.asarray(nxt))
    td, _ = tm.decode_step(tparams, tc, torch.from_numpy(nxt))
    np.testing.assert_allclose(_np(td), _np(jd), atol=1e-4, rtol=1e-4)


def test_decode_writes_the_cache_in_place_and_keeps_the_cross_caches():
    tcfg = TC.get_reduced_config("whisper-medium")
    model = build_model(tcfg)
    params = model.init(0, device="cpu")
    batch = make_batch(tcfg, TC.ShapeConfig("s", 10, 2, "prefill"),
                       device="cpu")
    _, cache = model.prefill(params, batch, max_len=14)
    L, kh, hd = tcfg.n_layers, tcfg.n_kv_heads, tcfg.resolved_head_dim
    assert cache["k"].shape == (L, 2, 14, kh, hd)
    assert cache["cross_k"].shape == (L, 2, tcfg.n_frames, kh, hd)
    assert cache["length"] == 10 and not cache["k"][:, :, 10:].any()
    ids = {k: cache[k].data_ptr() for k in ("k", "v", "cross_k", "cross_v")}
    cross = cache["cross_k"].clone()
    _, out = model.decode_step(params, cache, batch["tokens"][:, 0])
    assert out is cache and out["length"] == 11
    assert {k: out[k].data_ptr() for k in ids} == ids
    assert out["k"][:, :, 10].any() and not out["k"][:, :, 11:].any()
    assert torch.equal(out["cross_k"], cross)


def test_batch_struct_and_make_batch_give_the_stub_inputs():
    shape = TC.ShapeConfig("s", seq_len=12, global_batch=3, kind="prefill")
    for arch, name, n in (("whisper-medium", "frames", "n_frames"),
                          ("internvl2-26b", "patch_embeds", "n_patches")):
        cfg = TC.get_reduced_config(arch)
        spec = batch_struct(cfg, shape)
        assert set(spec) == {"tokens", name}
        assert spec[name].shape == (3, getattr(cfg, n), cfg.d_model)
        assert spec[name].dtype == torch.bfloat16
        a = make_batch(cfg, shape, seed=4, device="cpu")
        b = make_batch(cfg, shape, seed=4, device="cpu")
        assert torch.equal(a[name], b[name]) and a[name].dtype == torch.bfloat16
        assert 0.01 < float(a[name].float().std()) < 0.03
        # the tokens are drawn first, as for every other config
        plain = make_batch(TC.get_reduced_config("qwen3-0.6b"), shape,
                           seed=4, device="cpu")
        assert torch.equal(a["tokens"], plain["tokens"])
        assert batch_struct(cfg, TC.ShapeConfig("d", 12, 3, "decode")) == {
            "tokens": batch_struct(cfg, shape)["tokens"]._replace(shape=(3,))}


# ---------------------------------------------------------------------------
# The kernel route: every prefill attention through the op
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_prefill_attention_all_through_the_kernel_op(arch, monkeypatch):
    """With the kernel route taken on CPU tensors (its launch replaced by
    the oracle, so the counters move): a whisper prefill launches the op
    once per encoder layer and twice per decoder layer (self, cross), an
    internvl2 prefill once per layer; decode launches nothing; the logits
    equal the CPU route's within f32 rounding."""
    cfg = TC.get_reduced_config(arch)
    cfg = dataclasses.replace(cfg, dtype="float32")
    model = build_model(cfg)
    params = model.init(2, device="cpu")
    batch = make_batch(cfg, TC.ShapeConfig("s", 20, 2, "prefill"),
                       device="cpu")
    want, _ = model.prefill(params, batch, max_len=22)
    calls = []

    def oracle(q, k, v, causal, which=None):
        calls.append((q.shape[1], k.shape[1], causal))
        return attention_ref(q, k, v, causal)

    monkeypatch.setattr(tattn, "_on_card", lambda t: True)
    monkeypatch.setattr(fa_ops, "_route", lambda t: "cuda")
    monkeypatch.setattr(fa_kernel, "launch", oracle)
    fa_ops.reset_counts()
    got, cache = model.prefill(params, batch, max_len=22)
    n = cfg.encoder_layers + 2 * cfg.n_layers if cfg.is_encdec \
        else cfg.n_layers
    assert fa_ops.flash_attention.launches_by_kernel == {"mma": 0, "simt": n}
    if cfg.is_encdec:
        f = cfg.n_frames
        assert calls == ([(f, f, False)] * cfg.encoder_layers
                         + [(20, 20, True), (20, f, False)] * cfg.n_layers)
    else:
        assert calls == [(20, 20, True)] * cfg.n_layers
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5,
                               rtol=1e-5)
    model.decode_step(params, cache, batch["tokens"][:, 0])
    assert fa_ops.flash_attention.launches == n


# ---------------------------------------------------------------------------
# Twins of tests/test_archs_smoke.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_prefill_decode_agreement(arch):
    """Twin of ``test_archs_smoke.py::test_prefill_decode_agreement``:
    decode(prefill(t[:-1]), t[-1]) == prefill(t)[-1] within its 0.05
    (bf16), the frames / patches the same in both."""
    cfg = TC.get_reduced_config(arch)
    model = build_model(cfg)
    params = model.init(1, device="cpu")
    batch = make_batch(cfg, TC.ShapeConfig("smoke", 48, 2, "prefill"),
                       device="cpu")
    full, _ = model.prefill(params, batch, max_len=64)
    short = dict(batch, tokens=batch["tokens"][:, :-1])
    _, cache = model.prefill(params, short, max_len=64)
    dec, _ = model.decode_step(params, cache, batch["tokens"][:, -1])
    err = float((dec.float() - full[:, -1].float()).abs().max())
    assert err <= 0.05, f"{arch}: decode/prefill mismatch {err}"


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_full_config_registered(arch):
    """Twin of ``test_archs_smoke.py::test_full_config_registered``."""
    cfg = TC.get_model_config(arch)
    assert cfg.param_count() > 0
    red = TC.get_reduced_config(arch)
    assert red.family == cfg.family
    assert red.is_moe == cfg.is_moe
    assert red.is_encdec == cfg.is_encdec
    assert red.param_count() < 1e6 * 5
    # the JAX package's make_batch gives the same keys and shapes
    shape = JC.ShapeConfig("s", 8, 2, "prefill")
    want = {k: tuple(v.shape)
            for k, v in jax_make_batch(repro.get_reduced_config(arch),
                                       shape).items()}
    assert {k: s.shape for k, s in batch_struct(
        red, TC.ShapeConfig("s", 8, 2, "prefill")).items()} == want


@pytest.mark.parametrize("arch,published,within",
                         [("whisper-medium", 0.77e9, 0.20),
                          ("internvl2-26b", 19.9e9, 0.05)])
def test_param_counts_match_published(arch, published, within):
    """The two lines of ``test_archs_smoke.py::
    test_param_counts_match_published`` for these archs (internvl2
    models the LM backbone only; InternViT is stubbed)."""
    got = TC.get_model_config(arch).param_count()
    assert abs(got - published) / published < within

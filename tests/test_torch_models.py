"""The port's model stack against the JAX package's, on the CPU.

Every ported module gets the same numpy inputs (or, for whole models,
the JAX package's own initialised weights through ``params_from_jax``)
on both sides. Module-level tolerances are f32 rounding (atol 1e-5 /
rtol 1e-5 unless stated); bf16 comparisons are relative to the largest
magnitude, since XLA and torch round bf16 at other points. The whole
slice -- ``prefill`` plus 4 ``decode_step``s of every ported arch at its
reduced config -- is held at atol = rtol = 1e-4 in f32 (with greedy
tokens equal wherever the JAX top-2 margin exceeds 1e-3) and at 3e-2 of
max |logit| in bf16.

MoE archs route each token to its top-k experts, and where two experts'
probabilities nearly tie, rounding alone can change the choice and the
token's FFN output by O(1), not by rounding; the change then reaches
later positions through attention. So for MoE the JAX side's choices and
their top-k margins (the k-th minus the (k+1)-th probability) are read
from its own ``jax.lax.top_k`` calls, and the port's probabilities from
its own ``top_k_gates`` calls, and the port is held to JAX (a) unpinned,
on each sequence's positions before the first near tie at any layer --
where JAX's margin, or the port's margin of JAX's top-k set (the port's
k-th largest probability among JAX's experts minus its largest among
the others; negative where the port ranks another expert in), is below
1e-3; a call ranks the tokens competing for an expert's capacity in its
flat (sequence, position) order, so a near tie also reaches every later
sequence of the call -- and (b) pinned to JAX's expert indices (its gates still its
own), on every position, both under the rules above. In f32 the two
packages' probabilities agree to rounding, so the port may rank another
expert in only where JAX's own margin is below 1e-3; in bf16 they round
the router's input at other points, so a set can flip at a larger JAX
margin, and only the port's own margin shows it. The prefill / decode
case of each MoE arch runs over three token draws.
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
from repro_torch.models import moe as tmoe
from repro_torch.models import ssm as tssm
from repro_torch.models.model_zoo import (batch_struct, make_batch,
                                          params_from_jax)

ARCHS = ("hymba-1.5b", "qwen3-0.6b", "mamba2-2.7b", "moonshot-v1-16b-a3b",
         "grok-1-314b", "deepseek-67b", "stablelm-12b", "starcoder2-15b",
         "whisper-medium", "internvl2-26b")
MOE_ARCHS = ("moonshot-v1-16b-a3b", "grok-1-314b")
#: the archs of the MoE slice (the enc-dec and vlm twins of the tests
#: over them are in test_torch_encdec.py)
MOE_SLICE_ARCHS = ARCHS[3:8]
#: router top-k margins below this are near ties (see the docstring)
ROUTER_MARGIN = 1e-3
RNG = np.random.default_rng(7)
#: the enc-dec and vlm cases draw their inputs from a generator of their
#: own, so the cases of the other archs draw what they drew before those
#: were added: the bf16 MoE case is sensitive to its tokens (a routing
#: flip at a router margin just above ROUTER_MARGIN, ROADMAP C)
FAMILY_RNG = np.random.default_rng(21)
#: token draws of the MoE prefill / decode case: the first from RNG, as
#: before, the others from generators of their own (the same tokens
#: whichever tests ran first)
MOE_DRAWS = 3


def _rng(cfg):
    return FAMILY_RNG if cfg.is_encdec or cfg.family == "vlm" else RNG


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
                     "ssm_n_heads", "is_moe", "expert_d_ff",
                     "supports_long_context"):
            assert getattr(j, prop) == getattr(t, prop), prop
        assert j.active_param_count() == t.active_param_count()
        for name, shape in JC.SHAPES.items():
            assert dataclasses.asdict(shape) == dataclasses.asdict(
                TC.SHAPES[name])
            assert JC.shape_applicable(j, shape) == TC.shape_applicable(
                t, TC.SHAPES[name])


def test_registry_lists_the_ported_models():
    assert set(TC.list_models()) == set(ARCHS)
    assert TC.get_model_config("hymba-1.5b").param_count() == 1_640_768_896
    assert TC.get_model_config(
        "moonshot-v1-16b-a3b").param_count() == 28_888_467_456
    assert TC.get_model_config("whisper-medium").param_count() == 810_986_496
    assert TC.get_model_config(
        "internvl2-26b").param_count() == 19_861_260_288
    with pytest.raises(KeyError):
        TC.get_model_config("whisper-large")


@pytest.mark.parametrize("change", [dict(encoder_layers=2),
                                    dict(family="vlm", n_patches=4),
                                    dict(family="retnet")],
                         ids=["enc-dec", "vlm", "unknown-family"])
def test_families_build_or_raise(change):
    """``build_model`` builds the enc-dec and vlm families (an enc-dec
    model has no cache before its prefill, as in the JAX package); a
    family the port's models do not know still raises."""
    cfg = TC.get_reduced_config("qwen3-0.6b")
    if change.get("family") == "retnet":
        # ModelConfig refuses the name itself; set it past the check
        object.__setattr__(cfg := dataclasses.replace(cfg), "family",
                           "retnet")
        with pytest.raises(NotImplementedError, match="retnet"):
            build_model(cfg)
        return
    model = build_model(dataclasses.replace(cfg, **change))
    params = model.init(0, device="cpu")
    assert ("enc_layers" in params) == ("encoder_layers" in change)
    if "encoder_layers" in change:
        with pytest.raises(NotImplementedError, match="prefill"):
            model.init_cache(2, 8, device="cpu")
    else:
        assert model.init_cache(2, 8, device="cpu")["k"].shape[2] == 8


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


def test_params_from_jax_carries_the_moe_leaves():
    """The stacked expert leaves (layer axis first, then the expert axis)
    and the f32 router keep their shapes, types and values."""
    jcfg, _, jparams, tcfg, tm, tparams = _models("moonshot-v1-16b-a3b",
                                                  "bfloat16")
    own = tm.init(0, device="cpu")["layers"][1]["moe"]
    E, d, ff = tcfg.n_experts, tcfg.d_model, tcfg.expert_d_ff
    for i in range(tcfg.n_layers):
        moe = tparams["layers"][i]["moe"]
        for key, shape in (("w_up", (E, d, ff)), ("w_gate", (E, d, ff)),
                           ("w_down", (E, ff, d)), ("router", (d, E))):
            want = np.asarray(jparams["layers"]["moe"][key][i], np.float32)
            assert tuple(moe[key].shape) == shape == want.shape, key
            assert moe[key].dtype == own[key].dtype, key
            assert np.array_equal(moe[key].float().numpy(), want), key
        assert moe["router"].dtype == torch.float32
        assert moe["shared"]["w_up"].shape == (d, ff * tcfg.n_shared_experts)


class JaxRouting:
    """The JAX side's expert choices, in call order: while it is set up,
    each ``jax.lax.top_k`` call of the JAX package's MoE layers records
    (indices, top-k margin) through an ordered debug callback, so the
    calls inside ``jit`` and the layer ``scan`` are read too."""

    def __init__(self, monkeypatch):
        self.calls = []
        top_k = jax.lax.top_k

        def recording(probs, k):
            vals, idx = top_k(probs, min(k + 1, probs.shape[-1]))
            margin = (vals[..., k - 1] - vals[..., k] if vals.shape[-1] > k
                      else jnp.full(probs.shape[:-1], jnp.inf))
            jax.debug.callback(self._record, idx[..., :k], margin,
                               ordered=True)
            return vals[..., :k], idx[..., :k]

        monkeypatch.setattr(jax.lax, "top_k", recording)

    def _record(self, idx, margin):
        self.calls.append((np.array(idx), np.array(margin)))

    def read(self):
        jax.effects_barrier()
        return list(self.calls)


class PortRouting:
    """The port's own router probabilities, in call order: while it is
    set up, each ``moe.top_k_gates`` call records its ``probs`` and then
    routes as before."""

    def __init__(self, monkeypatch):
        self.probs = []
        top_k_gates = tmoe.top_k_gates

        def recording(probs, k):
            self.probs.append(probs.detach().float().numpy())
            return top_k_gates(probs, k)

        monkeypatch.setattr(tmoe, "top_k_gates", recording)


def _margin_of_set(probs, idx):
    """Per row, the smallest of ``probs`` at the experts ``idx`` (``(T,
    k)``) minus the largest elsewhere: the margin by which ``probs``
    choose that top-k set, negative where they rank another expert in."""
    probs = probs.reshape(idx.shape[0], -1)
    chosen = np.take_along_axis(probs, idx, axis=-1).min(axis=-1)
    others = probs.copy()
    np.put_along_axis(others, idx, -np.inf, axis=-1)
    return chosen - others.max(axis=-1)


def _pin_port_routing(monkeypatch, calls):
    """Pin the port's expert choices to JAX's recorded ones, call by
    call; its gates stay its own probabilities at those experts. Returns
    the queue of choices not yet taken."""
    queue = [torch.from_numpy(idx).long() for idx, _ in calls]

    def pinned(probs, k):
        idx = queue.pop(0)
        gate = probs.gather(-1, idx)
        return gate / gate.sum(dim=-1, keepdim=True), idx

    monkeypatch.setattr(tmoe, "top_k_gates", pinned)
    return queue


def _near_tie_horizon(calls, n_layers, batch, seq, port_probs=None):
    """Per sequence, the first position a near tie can reach (inf if
    none): a router top-k margin below ROUTER_MARGIN at any layer --
    JAX's margin or, given ``port_probs`` (the port's probabilities of
    the same calls), the smaller of it and the port's margin of JAX's
    set. A call ranks each expert's tokens for its capacity in the call's
    flat (sequence, position) order, so a flip at one token can change
    which *later* tokens of the call an expert drops: a near tie at
    sequence b, position s also reaches every later sequence of the call
    from the call's first position on. The first ``n_layers`` calls are a
    full-sequence pass over ``seq`` positions; each later group of
    ``n_layers`` is one decode step."""
    horizon = np.full(batch, np.inf)
    for c, (idx, margin) in enumerate(calls):
        step = c // n_layers
        margin = margin.reshape(-1)
        if port_probs is not None:
            margin = np.minimum(margin, _margin_of_set(
                port_probs[c], idx.reshape(margin.shape[0], -1)))
        near = np.nonzero(margin < ROUTER_MARGIN)[0]
        if not near.size:
            continue
        first_pos = 0 if step == 0 else seq + step - 1
        b, s = divmod(int(near[0]), margin.shape[0] // batch)
        horizon[b] = min(horizon[b], first_pos + s)
        horizon[b + 1:] = np.minimum(horizon[b + 1:], first_pos)
    return horizon


def _check_step(tl, jl, dtype, what, rows=None):
    """Hold one step's logits (``(B, S, V)`` or ``(B, V)``) to JAX's on
    ``rows`` (a bool mask over the leading dims; all by default): f32 at
    atol = rtol = 1e-4 with the greedy token equal at the last position
    wherever JAX's top-2 margin exceeds 1e-3, bf16 at 3e-2 of max
    |logit|. Returns the number of rows compared."""
    g, w = _np(tl), _np(jl)
    if rows is None:
        rows = np.ones(g.shape[:-1], bool)
    if not rows.any():
        return 0
    if dtype == "float32":
        _close(g[rows], w[rows], 1e-4, 1e-4, what)
        last_rows = rows[:, -1] if g.ndim == 3 else rows
        last = w[:, -1] if w.ndim == 3 else w
        tlast = g[:, -1] if g.ndim == 3 else g
        top2 = np.sort(last, axis=-1)[..., -2:]
        clear = (top2[..., 1] - top2[..., 0] > 1e-3) & last_rows
        assert np.array_equal(tlast.argmax(-1)[clear],
                              last.argmax(-1)[clear]), what
    else:
        _close_rel(g[rows], w[rows], 3e-2, what)
    return int(rows.sum())


def _stub_inputs(cfg, batch):
    """The stub embeddings a config's batch carries besides its tokens
    (``frames`` for enc-dec, ``patch_embeds`` for vlm), as numpy f32 drawn
    normal x 0.02, as the JAX package's ``make_batch`` draws them."""
    out = {}
    if cfg.family == "vlm":
        out["patch_embeds"] = (FAMILY_RNG.standard_normal(
            (batch, cfg.n_patches, cfg.d_model)) * 0.02).astype(np.float32)
    if cfg.is_encdec:
        out["frames"] = (FAMILY_RNG.standard_normal(
            (batch, cfg.n_frames, cfg.d_model)) * 0.02).astype(np.float32)
    return out


def _jax_batch(toks, stub, dtype):
    return {"tokens": jnp.asarray(toks),
            **{k: jnp.asarray(v, dtype) for k, v in stub.items()}}


def _port_batch(toks, stub, dtype):
    return {"tokens": torch.from_numpy(toks),
            **{k: torch.from_numpy(v).to(getattr(torch, dtype))
               for k, v in stub.items()}}


def _jax_steps(jm, jparams, toks, gen, stub=None):
    """JAX's prefill and ``gen`` greedy decode steps: its logits and the
    tokens it fed each step."""
    seq = toks.shape[1]
    jlog, jcache = jax.jit(lambda p, b: jm.prefill(p, b, max_len=seq + gen))(
        jparams, _jax_batch(toks, stub or {}, jm.cfg.dtype))
    logits, fed = [jlog], []
    jdec = jax.jit(jm.decode_step)
    nxt = jnp.argmax(jlog[:, -1], axis=-1).astype(jnp.int32)
    for _ in range(gen):
        fed.append(np.array(nxt))
        jl, jcache = jdec(jparams, jcache, nxt)
        logits.append(jl)
        nxt = jnp.argmax(jl, axis=-1).astype(jnp.int32)
    return logits, fed


def _port_steps(tm, tparams, toks, fed, stub=None):
    """The port's prefill and decode steps on JAX's tokens."""
    seq = toks.shape[1]
    tlog, tcache = tm.prefill(tparams,
                              _port_batch(toks, stub or {}, tm.cfg.dtype),
                              max_len=seq + len(fed))
    logits = [tlog]
    for nxt in fed:
        tl, tcache = tm.decode_step(tparams, tcache, torch.from_numpy(nxt))
        logits.append(tl)
    return logits, tcache


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_jax(arch, dtype, monkeypatch):
    jcfg, jm, jparams, tcfg, tm, tparams = _models(arch, dtype)
    seq, gen = 48, 4
    toks = _rng(jcfg).integers(0, jcfg.vocab_size, (2, seq)).astype(np.int32)
    stub = _stub_inputs(jcfg, 2)
    if not tcfg.is_moe:
        jsteps, fed = _jax_steps(jm, jparams, toks, gen, stub)
        tsteps, tcache = _port_steps(tm, tparams, toks, fed, stub)
        assert tcache["length"] == seq + gen
        for i, (tl, jl) in enumerate(zip(tsteps, jsteps)):
            _check_step(tl, jl, dtype, f"step {i}")
        return
    compared = 0
    routing = JaxRouting(monkeypatch)
    for draw in range(MOE_DRAWS):
        if draw:
            toks = np.random.default_rng((31, draw)).integers(
                0, jcfg.vocab_size, (2, seq)).astype(np.int32)
        compared += _moe_prefill_and_decode(jm, jparams, tm, tparams, toks,
                                            gen, dtype, routing, monkeypatch,
                                            f"draw {draw}")
    if dtype == "float32":
        assert compared > 0, "some positions precede every near tie"


def _moe_prefill_and_decode(jm, jparams, tm, tparams, toks, gen, dtype,
                            routing, monkeypatch, what):
    """One token draw of the MoE case: unpinned before each sequence's
    first near tie (JAX's margins and the port's own, see the
    docstring), then pinned to JAX's experts everywhere. Returns the
    number of rows compared unpinned."""
    tcfg, seq = tm.cfg, toks.shape[1]
    n_calls = tcfg.n_layers * (gen + 1)
    done = len(routing.read())
    jsteps, fed = _jax_steps(jm, jparams, toks, gen)
    calls = routing.read()[done:]
    with monkeypatch.context() as mp:
        port = PortRouting(mp)
        tsteps, tcache = _port_steps(tm, tparams, toks, fed)
    assert tcache["length"] == seq + gen
    assert len(calls) == len(port.probs) == n_calls
    if dtype == "float32":
        # f32 agrees to rounding: the port ranks another expert in only
        # at JAX's own near ties
        for (idx, margin), probs in zip(calls, port.probs):
            margin = margin.reshape(-1)
            own = _margin_of_set(probs, idx.reshape(margin.shape[0], -1))
            assert np.all((own >= 0) | (margin < ROUTER_MARGIN)), what
    horizon = _near_tie_horizon(calls, tcfg.n_layers, toks.shape[0], seq,
                                port.probs)
    compared = 0
    for i, (tl, jl) in enumerate(zip(tsteps, jsteps)):
        pos = np.arange(seq) if i == 0 else np.array([seq + i - 1])
        rows = pos[None, :] < horizon[:, None]
        compared += _check_step(tl, jl, dtype, f"{what}, step {i}, unpinned",
                                rows if i == 0 else rows[:, 0])
    with monkeypatch.context() as mp:
        queue = _pin_port_routing(mp, calls)
        tsteps, _ = _port_steps(tm, tparams, toks, fed)
        assert not queue
    for i, (tl, jl) in enumerate(zip(tsteps, jsteps)):
        _check_step(tl, jl, dtype,
                    f"{what}, step {i}, pinned to JAX's experts")
    return compared


@pytest.mark.parametrize("arch", MOE_SLICE_ARCHS)
def test_prefill_decode_agreement(arch):
    """Twin of ``tests/test_archs_smoke.py::test_prefill_decode_agreement``
    for the archs of the MoE slice: decode(prefill(t[:-1]), t[-1]) ==
    prefill(t)[-1] within its 0.05 (bf16). MoE archs at the reference's
    no-drop ``capacity_factor=16.0``, so routing does not depend on how
    many tokens share a call."""
    cfg = TC.get_reduced_config(arch)
    if cfg.is_moe:
        cfg = dataclasses.replace(cfg, capacity_factor=16.0)
    model = build_model(cfg)
    params = model.init(1, device="cpu")
    batch = make_batch(cfg, TC.ShapeConfig("smoke", 48, 2, "prefill"),
                       device="cpu")
    full, _ = model.prefill(params, batch, max_len=64)
    _, cache = model.prefill(params, {"tokens": batch["tokens"][:, :-1]},
                             max_len=64)
    dec, _ = model.decode_step(params, cache, batch["tokens"][:, -1])
    err = float((dec.float() - full[:, -1].float()).abs().max())
    assert err <= 0.05, f"{arch}: decode/prefill mismatch {err}"


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
def test_forward_and_loss_match_jax(arch, monkeypatch):
    """Logits, loss and aux loss; for MoE unpinned before the first near
    tie and pinned to JAX's experts everywhere (see the docstring)."""
    jcfg, jm, jparams, tcfg, tm, tparams = _models(arch, "float32")
    toks = _rng(jcfg).integers(0, jcfg.vocab_size, (2, 24)).astype(np.int32)
    stub = _stub_inputs(jcfg, 2)
    jbatch = {**_jax_batch(toks, stub, "float32"),
              "labels": jnp.asarray(toks)}
    tbatch = {**_port_batch(toks, stub, "float32"),
              "labels": torch.from_numpy(toks)}
    routing = JaxRouting(monkeypatch) if tcfg.is_moe else None
    jl, jaux = jm.forward(jparams, {k: v for k, v in jbatch.items()
                                    if k != "labels"})
    jloss, jparts = jm.loss_fn(jparams, jbatch)

    def port():
        tl, taux = tm.forward(tparams, {k: v for k, v in tbatch.items()
                                        if k != "labels"})
        tloss, tparts = tm.loss_fn(tparams, tbatch)
        assert set(tparts) == set(jparts)
        assert tl.shape == jl.shape and taux.shape == jaux.shape == ()
        return tl, taux, tloss, tparts

    tl, taux, tloss, tparts = port()
    horizon = np.inf
    if routing is not None:
        calls = routing.read()
        assert len(calls) == 2 * tcfg.n_layers
        horizon = _near_tie_horizon(calls[:tcfg.n_layers], tcfg.n_layers,
                                    2, 24)[:, None]
        assert np.any(horizon > 0), "some positions precede every near tie"
    rows = np.arange(24)[None, :] < horizon * np.ones((2, 1))
    _check_step(tl, jl, "float32", "forward logits", rows)
    if rows.all():
        _close(tloss, jloss, 1e-5, 1e-5)
        assert float(taux) == pytest.approx(float(jaux), rel=1e-6, abs=0)
    if routing is not None:
        queue = _pin_port_routing(monkeypatch, calls)
        tl, taux, tloss, tparts = port()
        assert not queue
        _check_step(tl, jl, "float32", "forward logits, pinned")
        _close(tloss, jloss, 1e-5, 1e-5)
        assert float(taux) > 0.0
    for key in ("ce_loss", "aux_loss"):
        _close(tparts[key], jparts[key], 1e-5, 1e-5, key)
    assert float(taux) == pytest.approx(float(jaux), rel=1e-6, abs=0)


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


@pytest.mark.parametrize("arch", ARCHS[3:])
def test_serve_launcher_takes_the_new_archs(arch, capsys):
    res = tserve.main(["--arch", arch, "--reduced", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "24", "--gen", "3"])
    assert f"{arch}-reduced: prefill 2x24" in capsys.readouterr().out
    assert res.tokens.shape == (2, 3)
    assert 0 <= int(res.tokens.min()) and int(res.tokens.max()) < 512

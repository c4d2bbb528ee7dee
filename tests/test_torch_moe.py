"""The port's MoE (``models/moe.py``) against the JAX package's, on the CPU.

The same numpy inputs and the JAX package's own initialised expert
weights go through ``repro.models.moe._dispatch_and_compute`` and the
port's twin. The JAX side's expert indices are read from its own
``jax.lax.top_k`` call (wrapped for the test) and its dropped pairs from
its own sort-based ranking; the port's from ``top_k_gates`` and
``dispatch``. Contracts:

* expert indices and the dropped (token, expert) pairs ``==``, planted
  router ties included (``jax.lax.top_k`` puts the lower index first;
  ``torch.topk`` does not promise to);
* f32 outputs within atol = rtol = 1e-5;
* the aux loss within rtol 1e-6: XLA's and torch's ``exp`` differ by an
  ulp inside the softmax, so the load-balance mean differs by ~1 ulp;
* the bf16 combine ``==`` JAX's ``out.at[tok].add(y * w)`` on the same
  expert outputs, and a whole bf16 dispatch within 2e-2 of max |out|
  (the expert products round to bf16 at other points in XLA and torch).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.config as JC
from repro.models import moe as jmoe
from repro_torch import config as TC
from repro_torch.models import moe as tmoe

#: (arch, tokens, capacity factor): the configs' own 1.25 and a tight
#: 0.5, at which every expert's load past half the mean is dropped
CASES = [(arch, T, cf) for arch in ("grok-1-314b", "moonshot-v1-16b-a3b")
         for T in (16, 64) for cf in (1.25, 0.5)]


_TOP_K = tmoe.top_k_gates
_DISPATCH = tmoe.dispatch


def _cfgs(arch, dtype="float32", **change):
    return (dataclasses.replace(JC.get_reduced_config(arch), dtype=dtype,
                                **change),
            dataclasses.replace(TC.get_reduced_config(arch), dtype=dtype,
                                **change))


def _leaf(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).bfloat16()
    return torch.from_numpy(np.array(a))


def _params(jcfg, seed, tie=None):
    """The JAX package's initialised MoE params as numpy, a JAX tree and
    a torch tree; ``tie`` maps router columns to the column they copy."""
    p = jax.tree.map(np.array, jmoe.moe_init(jax.random.PRNGKey(seed), jcfg))
    for dst, src in (tie or {}).items():
        p["router"][:, dst] = p["router"][:, src]
    return jax.tree.map(jnp.asarray, p), jax.tree.map(_leaf, p)


def _run_both(jcfg, tcfg, jp, tp, x, monkeypatch):
    """Both packages' dispatch on the same x; returns their outputs, aux
    losses, expert indices and dropped (token, expert) pairs."""
    got = {}
    jax_top_k = jax.lax.top_k

    def jax_recording(probs, k):
        gate, idx = jax_top_k(probs, k)
        got["jax_idx"] = np.asarray(idx)
        return gate, idx

    def port_recording(probs, k):
        gate, idx = _TOP_K(probs, k)
        got["port_idx"] = idx.numpy()
        return gate, idx

    slots = {}

    def port_dispatch(x_flat, idx, n_experts, capacity, e_start, e_count):
        out = _DISPATCH(x_flat, idx, n_experts, capacity, e_start, e_count)
        slots["valid"], slots["order"], slots["capacity"] = (
            out[2], out[3], capacity)
        return out

    monkeypatch.setattr(jax.lax, "top_k", jax_recording)
    monkeypatch.setattr(tmoe, "top_k_gates", port_recording)
    monkeypatch.setattr(tmoe, "dispatch", port_dispatch)
    jx = jnp.asarray(x, jcfg.dtype)
    tx = torch.from_numpy(x).to(getattr(torch, tcfg.dtype))
    jo, ja = jmoe._dispatch_and_compute(
        jx, jp, jcfg, 0, jcfg.n_experts, jp.get("w_gate"), jp["w_up"],
        jp["w_down"])
    to, ta = tmoe._dispatch_and_compute(
        tx, tp, tcfg, 0, tcfg.n_experts, tp.get("w_gate"), tp["w_up"],
        tp["w_down"])
    K = tcfg.top_k
    order, valid = slots["order"], slots["valid"]
    flat = torch.from_numpy(got["port_idx"]).reshape(-1)[order]
    port_dropped = {(int(o) // K, int(e)) for o, e, v in
                    zip(order, flat, valid) if not v}
    return {"jax_out": np.asarray(jo.astype(jnp.float32)),
            "port_out": to.float().numpy(), "jax_aux": float(ja),
            "port_aux": float(ta), "jax_idx": got["jax_idx"],
            "port_idx": got["port_idx"],
            "jax_dropped": _jax_dropped(got["jax_idx"], jcfg.n_experts,
                                        slots["capacity"]),
            "port_dropped": port_dropped, "capacity": slots["capacity"]}


def _jax_dropped(idx, n_experts, capacity):
    """The (token, expert) pairs the JAX function drops: its own ranking
    (``moe.py``: stable argsort, left ``searchsorted``) on its indices."""
    K = idx.shape[1]
    flat_e = jnp.asarray(idx).reshape(-1)
    order = jnp.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    starts = jnp.searchsorted(sorted_e, jnp.arange(n_experts,
                                                   dtype=sorted_e.dtype))
    pos = jnp.arange(flat_e.shape[0]) - starts[sorted_e]
    return {(int(o) // K, int(e)) for o, e, p in
            zip(np.asarray(order), np.asarray(sorted_e), np.asarray(pos))
            if p >= capacity}


def _check_exact_routing(r):
    assert np.array_equal(r["port_idx"], r["jax_idx"])
    assert r["port_dropped"] == r["jax_dropped"]


@pytest.mark.parametrize("arch,T,cf", CASES)
def test_dispatch_matches_jax_f32(arch, T, cf, monkeypatch):
    jcfg, tcfg = _cfgs(arch, capacity_factor=cf)
    jp, tp = _params(jcfg, seed=T)
    x = np.random.default_rng(T).standard_normal(
        (T, jcfg.d_model)).astype(np.float32)
    r = _run_both(jcfg, tcfg, jp, tp, x, monkeypatch)
    _check_exact_routing(r)
    if cf < 1.0:
        assert r["jax_dropped"], "a capacity below the mean load drops"
    np.testing.assert_allclose(r["port_out"], r["jax_out"], atol=1e-5,
                               rtol=1e-5)
    assert r["port_aux"] == pytest.approx(r["jax_aux"], rel=1e-6, abs=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_router_ties_take_the_lower_index(dtype, monkeypatch):
    """Router columns 3 and 5 copy column 1, 6 copies 2: their logits tie
    exactly, and both packages pick the lower expert first."""
    jcfg, tcfg = _cfgs("moonshot-v1-16b-a3b", dtype)
    jp, tp = _params(jcfg, seed=3, tie={3: 1, 5: 1, 6: 2})
    x = np.random.default_rng(3).standard_normal(
        (48, jcfg.d_model)).astype(np.float32)
    r = _run_both(jcfg, tcfg, jp, tp, x, monkeypatch)
    _check_exact_routing(r)
    tied = np.isin(r["port_idx"], (1, 2, 3, 5, 6)).sum(axis=1) == 2
    assert tied.any(), "some token routes to two tied experts"
    probs = torch.softmax(torch.from_numpy(
        x @ np.asarray(jp["router"])), dim=-1)
    assert (probs[:, 1] == probs[:, 3]).all()
    if dtype == "float32":
        np.testing.assert_allclose(r["port_out"], r["jax_out"], atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_batch_at_capacity_one(dtype, monkeypatch):
    """T = 4 tokens, 64 experts, top-6 (moonshot's routing at a decode
    step of batch 4): capacity max(1, int(1.25 * 4 * 6 / 64)) = 1, so
    every expert chosen twice drops its later pair, in JAX's order."""
    jcfg, tcfg = _cfgs("moonshot-v1-16b-a3b", dtype, n_experts=64, top_k=6)
    jp, tp = _params(jcfg, seed=4)
    x = np.random.default_rng(4).standard_normal(
        (4, jcfg.d_model)).astype(np.float32)
    r = _run_both(jcfg, tcfg, jp, tp, x, monkeypatch)
    assert r["capacity"] == 1
    _check_exact_routing(r)
    assert r["jax_dropped"]
    if dtype == "float32":
        np.testing.assert_allclose(r["port_out"], r["jax_out"], atol=1e-5,
                                   rtol=1e-5)
    else:
        scale = np.abs(r["jax_out"]).max()
        assert np.abs(r["port_out"] - r["jax_out"]).max() <= 2e-2 * scale


@pytest.mark.parametrize("seed,T,E", [(0, 8, 2), (1, 13, 4), (2, 37, 8),
                                      (3, 64, 8), (4, 50, 4), (5, 24, 2)])
def test_dispatch_capacity_respected(seed, T, E, monkeypatch):
    """Twin of ``tests/test_models.py::test_moe_dispatch_capacity_respected``
    (capacity factor 1.0, bf16 tokens): finite output of x's shape, aux
    >= 0.99, no expert over capacity; and JAX's routing and drops."""
    jcfg, tcfg = _cfgs("grok-1-314b", "bfloat16", n_experts=E, top_k=2,
                       capacity_factor=1.0)
    jp, tp = _params(jcfg, seed=seed)
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((T, jcfg.d_model)) * 0.1).astype(np.float32)
    r = _run_both(jcfg, tcfg, jp, tp, x, monkeypatch)
    out = r["port_out"]
    assert out.shape == x.shape and np.isfinite(out).all()
    assert r["port_aux"] >= 0.99
    _check_exact_routing(r)
    kept = [e for t in range(T) for e in r["port_idx"][t]
            if (t, e) not in r["port_dropped"]]
    assert max(np.bincount(kept, minlength=E)) <= r["capacity"]


def test_no_drop_equals_dense_mixture(monkeypatch):
    """Twin of ``tests/test_models.py::test_moe_no_drop_equals_dense_mixture``:
    with capacity >= all tokens, the output is the explicit gate-weighted
    sum of the chosen experts' MLPs, here at f32 rounding."""
    jcfg, tcfg = _cfgs("grok-1-314b", capacity_factor=64.0)
    jp, tp = _params(jcfg, seed=0)
    T, K = 16, tcfg.top_k
    x = (np.random.default_rng(3).standard_normal((T, tcfg.d_model))
         * 0.2).astype(np.float32)
    r = _run_both(jcfg, tcfg, jp, tp, x, monkeypatch)
    assert not r["port_dropped"]
    xt = torch.from_numpy(x)
    probs = torch.softmax(xt @ tp["router"], dim=-1)
    gate, idx = _TOP_K(probs, K)
    truth = torch.zeros_like(xt)
    for t in range(T):
        for j in range(K):
            e = int(idx[t, j])
            h = xt[t]
            act = (torch.nn.functional.silu(h @ tp["w_gate"][e])
                   * (h @ tp["w_up"][e]))
            truth[t] += gate[t, j] * (act @ tp["w_down"][e])
    np.testing.assert_allclose(r["port_out"], truth.numpy(), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(r["port_out"], r["jax_out"], atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("T,E,K,cap", [(16, 8, 2, 3), (64, 64, 6, 4),
                                       (200, 8, 2, 40), (4, 64, 6, 1)])
def test_bf16_combine_rounds_as_jax(T, E, K, cap):
    """On the same bf16 expert outputs and gates, the port's combine
    ``==`` JAX's scatter-add: each token's K weighted rows added into a
    zero bf16 row in sorted (expert-ascending) order."""
    rng = np.random.default_rng(T)
    idx = np.stack([rng.choice(E, K, replace=False)
                    for _ in range(T)]).astype(np.int32)
    gate = rng.uniform(0.05, 1.0, (T, K)).astype(np.float32)
    gate /= gate.sum(axis=1, keepdims=True)
    out_buf = rng.standard_normal((E * cap, 32)).astype(np.float32)
    _, slot, valid, order = tmoe.dispatch(torch.zeros(T, 1),
                                          torch.from_numpy(idx).long(), E,
                                          cap, 0, E)
    got = tmoe.combine(torch.from_numpy(out_buf).bfloat16(), slot, valid,
                       order, torch.from_numpy(gate))
    jo, js, jv = (jnp.asarray(t.numpy()) for t in (order, slot, valid))
    y = jnp.asarray(out_buf, jnp.bfloat16)[jnp.where(jv, js, 0)] * jv[:, None]
    w = jnp.asarray(gate).reshape(-1)[jo].astype(jnp.bfloat16)
    want = jnp.zeros((T, 32), jnp.bfloat16).at[jo // K].add(y * w[:, None])
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.float().numpy(),
                          np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("arch", ["grok-1-314b", "moonshot-v1-16b-a3b"])
def test_bf16_dispatch_matches_jax(arch, monkeypatch):
    jcfg, tcfg = _cfgs(arch, "bfloat16")
    jp, tp = _params(jcfg, seed=9)
    x = np.random.default_rng(9).standard_normal(
        (32, jcfg.d_model)).astype(np.float32)
    r = _run_both(jcfg, tcfg, jp, tp, x, monkeypatch)
    _check_exact_routing(r)
    scale = np.abs(r["jax_out"]).max()
    assert np.abs(r["port_out"] - r["jax_out"]).max() <= 2e-2 * scale
    assert r["port_aux"] == pytest.approx(r["jax_aux"], rel=1e-6, abs=0)


@pytest.mark.parametrize("arch", ["grok-1-314b", "moonshot-v1-16b-a3b"])
def test_moe_apply_and_init_layout(arch):
    """``moe_apply`` adds the shared experts after the routed ones, as
    the JAX local path does; ``moe_init`` gives JAX's keys, shapes and
    types (an f32 router, stacked experts)."""
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(jcfg, seed=1)
    own = tmoe.moe_init(torch.Generator().manual_seed(0), tcfg)
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    for path, leaf in flat:
        node = own
        for p in path:
            node = node[p.key]
        assert tuple(node.shape) == leaf.shape
        assert str(node.dtype).endswith(str(leaf.dtype))
    assert own["router"].dtype == torch.float32
    x = np.random.default_rng(5).standard_normal(
        (2, 7, jcfg.d_model)).astype(np.float32)
    jo, ja = jmoe.moe_apply(jp, jnp.asarray(x), jcfg)
    to, ta = tmoe.moe_apply(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-5,
                               rtol=1e-5)
    assert float(ta) == pytest.approx(float(ja), rel=1e-6, abs=0)
    if "shared" in tp:
        routed, _ = tmoe.moe_apply({k: v for k, v in tp.items()
                                    if k != "shared"},
                                   torch.from_numpy(x), tcfg)
        assert not torch.allclose(routed, to, atol=1e-3)


# ---------------------------------------------------------------------------
# Under a mesh context: the dispatch per data block (R1), the aux loss
# (ROADMAP C7) and the shared experts (ROADMAP C6)
# ---------------------------------------------------------------------------

from repro.distributed.context import make_context as jax_make_context
from repro.distributed.context import make_mesh
from repro.distributed.context import mesh_context as jax_mesh_context
from repro_torch.distributed.context import make_context as t_make_context
from repro_torch.distributed.context import mesh_context as t_mesh_context


def _mesh_case(seed=3):
    """Reduced moonshot in f32, its JAX weights, a 4 x 16 batch."""
    jcfg, tcfg = _cfgs("moonshot-v1-16b-a3b")
    jp, tp = _params(jcfg, seed=seed)
    x = np.random.default_rng(seed).standard_normal(
        (4, 16, jcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, jp, tp, x


def _jax_on_mesh(mesh, jp, x, jcfg):
    with jax_mesh_context(jax_make_context(mesh)):
        out, aux = jax.jit(lambda p, v: jmoe.moe_apply(p, v, jcfg))(
            jp, jnp.asarray(x))
    return np.asarray(out), float(aux)


def test_moe_dispatches_each_data_block_as_the_reference(mesh8):
    """R1: on a (4 data, 2 model) context the port routes each batch row
    block on its own, with its own capacity, as the reference's
    ``shard_map`` does on ``mesh8``: within 1e-5 of max |out| (the whole
    batch routed at once reads ~0.4 away)."""
    jcfg, tcfg, jp, tp, x = _mesh_case()
    want, _ = _jax_on_mesh(mesh8, jp, x, jcfg)
    ctx = t_make_context((4, 2), ("data", "model"), device="cpu")
    with t_mesh_context(ctx):
        got, _ = tmoe.moe_apply(tp, torch.from_numpy(x), tcfg)
    scale = np.abs(want).max()
    assert np.abs(got.numpy() - want).max() <= 1e-5 * scale
    whole, _ = tmoe.moe_apply(tp, torch.from_numpy(x), tcfg)
    assert np.abs(whole.numpy() - want).max() > 1e-2 * scale


def test_dense_forward_unchanged_under_the_context():
    """R1 leaves a dense model alone: a reduced qwen3's forward under the
    (4, 2) context is ``==`` the one without."""
    from repro_torch import config as TCfg
    from repro_torch.models import build_model
    model = build_model(TCfg.get_reduced_config("qwen3-0.6b"))
    params = model.init(0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, 512, (4, 16), dtype=np.int32))
    with torch.no_grad():
        plain, _ = model.forward(params, {"tokens": toks}, remat="none")
        ctx = t_make_context((4, 2), ("data", "model"), device="cpu")
        with t_mesh_context(ctx):
            under, _ = model.forward(params, {"tokens": toks}, remat="none")
    assert torch.equal(plain, under)


def test_reference_aux_is_data_block_zeros_contract(mesh8):
    """ROADMAP C7, pinned: on ``mesh8`` the reference's aux loss is data
    block 0's (``pmean`` over ``model`` only, returned under
    ``out_specs P()``), not the blocks' mean; the port returns the mean.
    If this fails, the reference was fixed and the port can be held
    ``==`` to it."""
    jcfg, tcfg, jp, tp, x = _mesh_case()
    _, ref_aux = _jax_on_mesh(mesh8, jp, x, jcfg)
    blocks = [float(jmoe.moe_apply(jp, jnp.asarray(x[i:i + 1]), jcfg)[1])
              for i in range(4)]
    assert ref_aux == pytest.approx(blocks[0], rel=1e-6, abs=0)
    assert abs(ref_aux - np.mean(blocks)) > 1e-4
    ctx = t_make_context((4, 2), ("data", "model"), device="cpu")
    with t_mesh_context(ctx):
        _, aux = tmoe.moe_apply(tp, torch.from_numpy(x), tcfg)
    assert float(aux) == pytest.approx(float(np.mean(blocks)), rel=1e-6,
                                       abs=0)


def test_reference_drops_shared_experts_without_model_axis_contract():
    """ROADMAP C6, pinned: on a ``("data",)`` mesh the reference takes its
    local path and adds the shared experts only without a context, so
    its output differs from its own no-mesh output; the port adds them
    under every context: its output on the same context ``==`` its
    no-mesh output."""
    if jax.device_count() < 4:
        pytest.skip("needs 4 host devices")
    jcfg, tcfg, jp, tp, x = _mesh_case()
    mesh = make_mesh((4,), ("data",), devices=jax.devices()[:4])
    on_mesh, _ = _jax_on_mesh(mesh, jp, x, jcfg)
    no_mesh = np.asarray(jmoe.moe_apply(jp, jnp.asarray(x), jcfg)[0])
    assert np.abs(on_mesh - no_mesh).max() > 0.1 * np.abs(no_mesh).max()
    plain, aux = tmoe.moe_apply(tp, torch.from_numpy(x), tcfg)
    ctx = t_make_context((4,), ("data",), device="cpu")
    with t_mesh_context(ctx):
        under, aux_under = tmoe.moe_apply(tp, torch.from_numpy(x), tcfg)
    assert torch.equal(plain, under) and torch.equal(aux, aux_under)
    np.testing.assert_allclose(plain.numpy(), no_mesh, atol=1e-5, rtol=1e-5)

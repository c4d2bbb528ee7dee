"""The port's optimizers and schedules against the JAX package's.

The same numpy parameters and gradients -- a tree with a ``layers``
subtree, stacked on a leading axis for the JAX package and a list of
per-layer dicts for the port -- go through both packages' updates for
several steps. AdamW (with and without the f32 master copy), Adafactor
and SGD-momentum agree within f32 rounding: rtol 1e-6 with an absolute
floor of 1e-6 of the leaf's scale (XLA on the CPU contracts ``a * b +
c`` into FMAs, and a global norm sums in another order; a few ulps).
The schedules agree at every step up to ``total_steps`` at the same
rtol, and ``clip_by_global_norm`` likewise. Twins of
``tests/test_substrates.py``'s optimizer tests follow.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import TrainConfig as JTrain
from repro.optim import make_optimizer as jax_make_optimizer
from repro.optim import make_schedule as jax_make_schedule
from repro.optim.optimizers import clip_by_global_norm as jax_clip
from repro.optim.optimizers import global_norm as jax_global_norm
from repro_torch.config import TrainConfig
from repro_torch.models.model_zoo import params_to_numpy
from repro_torch.optim import make_optimizer, make_schedule
from repro_torch.optim.optimizers import (clip_by_global_norm, global_norm,
                                          tree_leaves)

RTOL = 1e-6
N_LAYERS = 3


def _stacked_tree(rng, scale=1.0):
    """A parameter-shaped numpy tree in the JAX package's layout."""
    return {
        "embed": {"tok": rng.standard_normal((16, 8)) * scale},
        "final_norm": {"scale": 1.0 + rng.standard_normal((8,)) * scale},
        "layers": {
            "attn": {"wq": rng.standard_normal((N_LAYERS, 8, 12)) * scale,
                     "q_norm": rng.standard_normal((N_LAYERS, 4)) * scale},
            "mlp": {"w_up": rng.standard_normal((N_LAYERS, 8, 6)) * scale},
        },
    }


def _as_f32(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _port_tree(tree, dtype):
    """The stacked numpy tree as the port's tensors (layers as a list)."""
    def walk(node, i=None):
        if isinstance(node, dict):
            return {k: walk(v, i) for k, v in node.items()}
        a = node if i is None else node[i]
        return torch.from_numpy(np.array(a, np.float32)).to(dtype)

    return {k: ([walk(v, i) for i in range(N_LAYERS)] if k == "layers"
                else walk(v)) for k, v in tree.items()}


def _jax_tree(tree, dtype):
    return jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)


def _close(got, want, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.max(np.abs(want))), 1e-30)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * scale,
                               err_msg=what)


def _close_trees(port_tree, jax_tree, what=""):
    got = params_to_numpy(port_tree)
    want = jax.tree.map(lambda a: np.asarray(a, np.float32), jax_tree)
    paths = jax.tree_util.tree_flatten_with_path(want)[0]
    for path, w in paths:
        g = got
        for p in path:
            g = g[p.key]
        _close(g, w, f"{what} {jax.tree_util.keystr(path)}")


CASES = {
    "adamw-master": dict(optimizer="adamw"),
    "adamw-f32": dict(optimizer="adamw", param_dtype="float32"),
    "adafactor": dict(optimizer="adafactor"),
    "sgd": dict(optimizer="sgd"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_updates_match_jax(case):
    """Five updates from the same parameters and gradients: parameters
    and every piece of state agree (AdamW with the master copy keeps f32
    parameters here, so the comparison sees f32 arithmetic)."""
    kw = dict(learning_rate=1e-2, weight_decay=0.1, total_steps=10,
              warmup_steps=2, **CASES[case])
    jcfg, tcfg = JTrain(**kw), TrainConfig(**kw)
    rng = np.random.default_rng(3)
    p0 = _stacked_tree(rng)
    jinit, jupdate = jax_make_optimizer(jcfg)
    tinit, tupdate = make_optimizer(tcfg)
    jp, tp = _jax_tree(p0, jnp.float32), _port_tree(p0, torch.float32)
    js, ts = jinit(jp), tinit(tp)
    jsched, tsched = jax_make_schedule(jcfg), make_schedule(tcfg)
    for step in range(5):
        g = _stacked_tree(rng, scale=0.5)
        lr_j, lr_t = jsched(jnp.int32(step)), tsched(step)
        _close(float(lr_t), float(lr_j), f"lr {step}")
        jp, js = jupdate(_jax_tree(g, jnp.float32), js, jp, lr_j)
        tp, ts = tupdate(_port_tree(g, torch.float32), ts, tp, lr_t)
        _close_trees(tp, jp, f"{case} params step {step}")
    assert ts["count"] == int(js["count"]) == 5
    for key in set(js) - {"count"}:
        if key == "vs":      # Adafactor: the stacked layout on both sides
            jl = jax.tree.leaves(js["vs"])
            tl = tree_leaves(ts["vs"])
            assert len(jl) == len(tl)
            for a, b in zip(tl, jl):
                _close(a.numpy(), np.asarray(b), "vs")
        else:
            _close_trees(ts[key], js[key], f"{case} {key}")
    assert set(ts) == set(js)


def test_adamw_bf16_params_match_jax():
    """bf16 parameters with the f32 master copy: the master agrees within
    f32 rounding, the bf16 parameters are its rounding."""
    cfg = dict(learning_rate=1e-2, total_steps=10, warmup_steps=1)
    rng = np.random.default_rng(4)
    p0 = _stacked_tree(rng)
    jinit, jupdate = jax_make_optimizer(JTrain(**cfg))
    tinit, tupdate = make_optimizer(TrainConfig(**cfg))
    jp, tp = _jax_tree(p0, jnp.bfloat16), _port_tree(p0, torch.bfloat16)
    js, ts = jinit(jp), tinit(tp)
    for step in range(3):
        g = _stacked_tree(rng, scale=0.3)
        jp, js = jupdate(_jax_tree(g, jnp.bfloat16), js, jp,
                         jnp.float32(1e-2))
        tp, ts = tupdate(_port_tree(g, torch.bfloat16), ts, tp, 1e-2)
    _close_trees(ts["master"], js["master"], "master")
    for t, m in zip(tree_leaves(tp), tree_leaves(ts["master"])):
        assert t.dtype == torch.bfloat16
        assert torch.equal(t, m.to(torch.bfloat16))


@pytest.mark.parametrize("kind", ["cosine", "linear", "constant"])
def test_schedules_match_jax(kind):
    kw = dict(schedule=kind, learning_rate=3e-4, warmup_steps=7,
              total_steps=50)
    j, t = jax_make_schedule(JTrain(**kw)), make_schedule(TrainConfig(**kw))
    for step in range(51):
        got, want = float(t(step)), float(j(jnp.int32(step)))
        assert got == pytest.approx(want, rel=RTOL, abs=1e-12), step
        assert t(step).dtype == torch.float32


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm_matches_jax(max_norm):
    rng = np.random.default_rng(5)
    g = _stacked_tree(rng)
    jg, jn = jax_clip(_jax_tree(g, jnp.float32), max_norm)
    tg, tn = clip_by_global_norm(_port_tree(g, torch.float32), max_norm)
    _close(float(tn), float(jn), "norm")
    _close(float(global_norm(tg)), float(jax_global_norm(jg)), "clipped")
    _close_trees(tg, jg, "clipped grads")


# ---------------------------------------------------------------------------
# Twins of tests/test_substrates.py (optimizers)
# ---------------------------------------------------------------------------

def _quad_problem():
    params = {"w": torch.tensor([3.0, -2.0, 1.0]), "b": torch.tensor([0.5])}

    def loss(p):
        return torch.sum(torch.square(p["w"])) + torch.sum(
            torch.square(p["b"]))

    return params, loss


@pytest.mark.parametrize("opt", ["adamw", "adafactor", "sgd"])
def test_optimizers_descend(opt):
    cfg = TrainConfig(optimizer=opt, learning_rate=0.05, weight_decay=0.0,
                      total_steps=100, warmup_steps=1)
    params, loss = _quad_problem()
    init, update = make_optimizer(cfg)
    state = init(params)
    l0 = float(loss(params))
    for _ in range(60):
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        grads = dict(zip(leaves, torch.autograd.grad(
            loss(leaves), list(leaves.values()))))
        params, state = update(grads, state, params, 0.05)
    assert float(loss(params)) < l0 * 0.25


def test_adamw_master_copy_kept():
    cfg = TrainConfig(optimizer="adamw", master_dtype="float32",
                      param_dtype="bfloat16")
    params = {"w": torch.ones((4,), dtype=torch.bfloat16)}
    init, update = make_optimizer(cfg)
    state = init(params)
    assert "master" in state
    assert state["master"]["w"].dtype == torch.float32
    g = {"w": torch.full((4,), 0.1, dtype=torch.bfloat16)}
    p2, s2 = update(g, state, params, 1e-3)
    assert p2["w"].dtype == torch.bfloat16
    assert s2["master"]["w"].dtype == torch.float32


def test_grad_clip():
    g = {"a": torch.full((10,), 10.0)}
    clipped, norm = clip_by_global_norm(g, 1.0)
    assert float(global_norm(clipped)) <= 1.0 + 1e-5
    assert float(norm) > 1.0


def test_schedules():
    for kind in ("cosine", "linear", "constant"):
        cfg = TrainConfig(schedule=kind, learning_rate=1e-3,
                          warmup_steps=10, total_steps=100)
        f = make_schedule(cfg)
        assert float(f(0)) == 0.0
        assert abs(float(f(10)) - 1e-3) < 1e-9
        if kind != "constant":
            assert float(f(100)) < 1e-4


def test_updates_are_in_place():
    """The port writes state and parameters in place (the docstring's
    contract): the same tensors come back, updated."""
    params = {"layers": [{"w": torch.ones(3)}, {"w": torch.ones(3)}]}
    init, update = make_optimizer(TrainConfig(param_dtype="float32"))
    state = init(params)
    ids = [id(t) for t in tree_leaves(params) + tree_leaves(state["m"])]
    grads = {"layers": [{"w": torch.ones(3)}, {"w": -torch.ones(3)}]}
    p2, s2 = update(grads, state, params, 0.1)
    assert [id(t) for t in tree_leaves(p2) + tree_leaves(s2["m"])] == ids
    assert float(params["layers"][0]["w"][0]) < 1.0 < float(
        params["layers"][1]["w"][0])

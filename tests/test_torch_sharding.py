"""The port's parameter sharding rules against the JAX package's.

``param_specs`` of the port's tree (``layers`` / ``enc_layers`` lists
of per-layer dicts) must be ``==`` the JAX package's specs of its
stacked tree less the leading ``None`` of the layer axis, leaf by leaf,
for every reduced arch, on a (data 4, model 2) and a (pod 2, data 4,
model 2) context, and at full width on the (16, 16) pod. The JAX rules
read only the mesh's axis sizes, so its context is given a stand-in mesh
of those sizes (no devices needed). The specs then feed the replication
engine and ``install_recovered_shard``: a recovered node's blocks land
where the rules say.
"""

import types

import jax
import pytest
import torch

import repro
from repro.distributed.context import MeshContext as JContext
from repro.distributed.sharding import param_specs as jax_param_specs
from repro.models import build_model as jax_build_model
from repro_torch import config as TC
from repro_torch.core.directory import ShardDirectory
from repro_torch.core.recovery import recover_node
from repro_torch.core.replication import ReplicationEngine
from repro_torch.distributed.context import P, make_context
from repro_torch.distributed.elastic import install_recovered_shard
from repro_torch.distributed.sharding import (named_shardings, param_specs,
                                              sanitize_spec)
from repro_torch.models import build_model
from repro_torch.models.layers import dtype_of

ARCHS = ("hymba-1.5b", "qwen3-0.6b", "mamba2-2.7b", "moonshot-v1-16b-a3b",
         "grok-1-314b", "deepseek-67b", "stablelm-12b", "starcoder2-15b",
         "whisper-medium", "internvl2-26b")
MESHES = {"4x2": ((4, 2), ("data", "model")),
          "2x4x2": ((2, 4, 2), ("pod", "data", "model"))}


def _jax_ctx(shape, names):
    batch = tuple(a for a in names if a in ("pod", "data"))
    mesh = types.SimpleNamespace(shape=dict(zip(names, shape)))
    return JContext(mesh=mesh, batch_axes=batch,
                    model_axis="model" if "model" in names else None,
                    fsdp_axes=batch)


def _port_shapes(cfg):
    """The port's parameter tree of ``cfg`` as shape stand-ins (no
    weights allocated), from the JAX package's abstract init."""
    jtree = jax.eval_shape(jax_build_model(_jax_cfg(cfg)).init,
                           jax.random.PRNGKey(0))
    n = {"layers": cfg.n_layers, "enc_layers": cfg.encoder_layers}

    def leaf(x, stacked):
        return types.SimpleNamespace(shape=tuple(x.shape[1:] if stacked
                                                 else x.shape))

    return {k: ([jax.tree.map(lambda x: leaf(x, True), v)
                 for _ in range(n[k])] if k in n
                else jax.tree.map(lambda x: leaf(x, False), v))
            for k, v in jtree.items()}, jtree


def _jax_cfg(cfg):
    name = cfg.name.removesuffix("-reduced")
    reduced = repro.get_reduced_config(name)
    return reduced if reduced.name == cfg.name else \
        repro.get_model_config(name)


def _check(cfg, shape, names):
    tree, jtree = _port_shapes(cfg)
    jspecs = jax_param_specs(jtree, _jax_cfg(cfg), _jax_ctx(shape, names))
    tspecs = param_specs(tree, cfg, make_context(shape, names, device="cpu"))
    n = 0
    for key, jsub in jspecs.items():
        stacked = key in ("layers", "enc_layers")
        tsubs = tspecs[key] if stacked else [tspecs[key]]
        jflat = jax.tree_util.tree_flatten_with_path(
            jsub,
            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
        for tsub in tsubs:
            for path, jspec in jflat:
                t = tsub
                for p in path:
                    t = t[p.key]
                want = tuple(jspec)[1:] if stacked else tuple(jspec)
                assert isinstance(t, P), (key, path)
                assert tuple(t) == want, (key, jax.tree_util.keystr(path),
                                          tuple(t), want)
                n += 1
    return n


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_jax(arch, mesh):
    assert _check(TC.get_reduced_config(arch), *MESHES[mesh]) > 0


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "hymba-1.5b",
                                  "moonshot-v1-16b-a3b", "whisper-medium"])
def test_param_specs_match_jax_at_full_width(arch):
    """The published widths on the (16, 16) pod: the awkward cases (GQA
    heads that do not divide the model axis, hymba's 25 heads, expert
    stacks, uneven dims left unsharded) at the sizes they arise."""
    assert _check(TC.get_model_config(arch), (16, 16),
                  ("data", "model")) > 0


def test_sanitize_keeps_the_longest_dividing_prefix():
    ctx = make_context((2, 4, 2), ("pod", "data", "model"), device="cpu")
    assert sanitize_spec(P("model", ("pod", "data")), (6, 16), ctx) == \
        P("model", ("pod", "data"))
    assert sanitize_spec(P("model", ("pod", "data")), (5, 6), ctx) == \
        P(None, "pod")
    assert sanitize_spec(P(None), (3, 4), ctx) == P(None, None)


def test_named_shardings_is_the_identity_on_one_device():
    cfg = TC.get_reduced_config("qwen3-0.6b")
    params = build_model(cfg).init(0, device="cpu")
    ctx = make_context((4, 2), ("data", "model"), device="cpu")
    placed = named_shardings(params, cfg, ctx)
    wq = params["layers"][1]["attn"]["wq"]
    assert placed["layers"][1]["attn"]["wq"] is wq


def test_specs_place_a_recovered_shard():
    """The rules' specs drive the replication engine and the install of a
    recovered node: after a step is replicated, recovering node 2 and
    installing its shard into a state whose node-2 blocks were zeroed
    gives back the state ``==``."""
    cfg = TC.get_reduced_config("qwen3-0.6b")
    params = build_model(cfg).init(0, device="cpu")
    ctx = make_context((4, 2), ("data", "model"), device="cpu")
    specs = param_specs(params, cfg, ctx)
    rep = TC.ReplicationConfig(n_replicas=2, n_buckets=4, log_capacity=2)
    eng = ReplicationEngine(rep, ctx, specs, params)
    logs, _ = eng.replicate(params, eng.init_logs(), 0, None)
    res = recover_node(eng, logs, ShardDirectory(4, eng.layout.n_buckets, 2),
                       failed_coord=(2,))
    assert res.stats.unrecoverable == 0
    from repro_torch.core.replication import tree_flatten
    from repro_torch.distributed.elastic import _block_slices
    from repro_torch.optim.optimizers import tree_leaves, tree_map
    holed = tree_map(torch.clone, params)
    for leaf, spec in zip(tree_leaves(holed), tree_flatten(specs)[0]):
        for m in range(2):
            leaf[_block_slices(tuple(leaf.shape), spec, ctx,
                               {"data": 2, "model": m})] = 0
    back = install_recovered_shard(holed, specs, eng, res, target_coord=(2,))
    for a, b in zip(tree_leaves(back), tree_leaves(params)):
        assert a.dtype == b.dtype == dtype_of(cfg)
        assert torch.equal(a, b)

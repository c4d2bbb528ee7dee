"""The port's train step with the ``model`` axis split across
``torch.distributed`` ranks, replication off, on the CPU (``gloo``),
against the JAX package on host-device meshes of the same shape.

Two worlds are spawned once for the module (``torch_tp_train_cases.py``):
2 ranks on a (1 data x 2 model) mesh and 4 on a (2 x 2) one, each rank
one ``model`` position of a block of data positions, its parameters
placed by their specs (FSDP over ``data``, tensor parallel over
``model``, the MoE's EP) and requiring grad. Each takes the train step's
gradient (``steps.make_grad_fn``) of reduced f32 qwen3 (KV heads split,
qk-norm; at ``remat="none"`` and ``"full"``), hymba (attention FSDP-only,
the SSD split), moonshot (EP) and whisper (encoder and cross-attention)
on its block's rows of a seeded masked batch of 4 x 40. Against the JAX
``loss_fn`` under ``jax.value_and_grad``, jitted on ``make_mesh((1, 2))``
/ ``make_mesh((2, 2))`` over the conftest's host devices, its
parameters placed by its ``named_shardings`` and the batch sharded
``P(batch_axes)``, from the same weights (``params_from_jax``):

* every leaf's block on every rank within 1e-4 of the leaf's max |value|
  (``sharding.block_slices`` places it in the global leaf), before and
  after the clip; every leaf ``model`` does not split ``==`` across the
  ranks of its ``model`` group; moonshot's gradient of ``ce_loss`` at
  world 4, where the reference's aux term is data block 0's (ROADMAP
  C7), its total at world 2; its smallest top-k margin above
  ``MIN_MARGIN`` (``test_torch_tensor_parallel.py``);
* the global norm within 1e-5 relative, with a clip of 0.5 that acts;
* at world 4 hymba's B / C conv weights against the reference's (1 x 2)
  mesh: on (2 x 2) the reference reads twice the gradient every other
  mesh gives (ROADMAP C8, pinned by a contract test);
* the backward's collective calls the same under ``remat="full"``,
  whose forward ones run again inside the backward;
* each planted fault fails its check: ``model_sum``'s backward summed
  over the group, the entry into a partitioned region left out, the
  SSD's leaves read without the ``model`` sum, ``fsdp_gather``'s
  backward a plain slice, the global norm without the holders' weights,
  the rows sliced by rank;
* the ``Trainer`` (AdamW, variant ``none``, a dump every 2 steps) on a
  (2 x 2) mesh, at both worlds: 3 losses of qwen3 and moonshot within
  1e-5 relative of the JAX ``Trainer``'s on the same mesh (moonshot with
  the aux coefficient 0 in both packages: its 2 data blocks' aux term is
  block 0's in the reference, ROADMAP C7), the restored dump ``==`` the
  state at its step, the optimizer state the blocks' bytes;
* ``fsdp_gather``'s backward where two blocks hold each part of a
  dimension: the group's sum on both, not a share;
* a fail-stop under variant ``none`` raises the WB data-loss error on
  every rank, and a ``proactive`` and an Adafactor ``Trainer`` build and
  step (replication over split ranks:
  ``test_torch_split_replication.py``);
* Adafactor across split ranks: five updates of the reduced qwen3,
  hymba and moonshot blocks (and a layout of 4 node blocks where two
  hold each FSDP part) from seeded global gradients, the blocks and
  their ``vr`` / ``vc`` within 1e-6 of the JAX ``adafactor_update`` on
  the global stacked leaves, three planted faults failing that check;
  the ``Trainer`` with Adafactor within 1e-5 of the JAX ``Trainer``'s
  losses, its dump restoring the ``vs`` blocks;
* ``launch/train.py --split-model --mesh 2x2`` under
  ``torch.distributed.run`` on 4 ranks: the losses within 1e-5 of a
  one-process run's.
"""

import os
import re
import shutil
import subprocess
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as JP

import torch_tp_train_cases as cases
from repro import config as JC
from repro.distributed.context import make_context as jax_make_context
from repro.distributed.context import make_mesh, mesh_context
from repro.distributed.sharding import named_shardings as jax_shardings
from repro.distributed.sharding import \
    set_activation_policy as jax_set_policy
from repro.models import build_model as jax_build_model
from repro.models import transformer as jtransformer
from repro.optim import make_optimizer as jax_make_optimizer
from repro.optim.optimizers import clip_by_global_norm as jax_clip
from repro.training import steps as jsteps
from repro.training.trainer import Trainer as JTrainer

WORLDS = (2, 4)
GRAD_TOL = 1e-4
NORM_RTOL = 1e-5
LOSS_RTOL = 1e-5
#: ``test_torch_optim.py``'s tolerance of the one-card Adafactor
ADA_RTOL = 1e-6
MIN_MARGIN = 1e-5
#: ROADMAP C8: on a mesh that splits both data and model the reference's
#: gradient of the SSD's B / C conv weights is twice its gradient on every
#: other mesh (one device, data only, model only)
C8_LEAVES = ("ssm/conv_wB", "ssm/conv_wC")


def _mesh(world):
    return make_mesh(cases.MESHES[world], ("data", "model"),
                     devices=jax.devices()[:world])


def _jax_named(tree, cfg):
    """The JAX tree's leaves by the port's paths (the stacked layer axis
    as a list index)."""
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                if k in ("layers", "enc_layers") and path == "":
                    n = cfg.n_layers if k == "layers" else cfg.encoder_layers
                    for i in range(n):
                        walk(jax.tree.map(lambda a, i=i: a[i], node[k]),
                             f"{k}/{i}/")
                else:
                    walk(node[k], f"{path}{k}/")
            return
        out[path[:-1]] = np.asarray(node, np.float32)

    walk(tree, "")
    return out


def _jax_grads(name, tree, world, seq=cases.SEQ, policy="batch"):
    """The JAX ``loss_fn``'s gradient (of ``cases.objective``) jitted on a
    mesh of the world's shape under the activation ``policy``, at ``seq``
    positions, and its clip: {path: grad}, {path: clipped}, the global
    norm, the loss."""
    try:
        jax_set_policy(policy)
        return _jax_grads_at(name, tree, world, seq)
    finally:
        jax_set_policy("batch")


def _jax_grads_at(name, tree, world, seq):
    mesh = _mesh(world)
    jcfg = cases.config(name, JC)
    model = jax_build_model(jcfg)
    key = cases.objective(name, world)
    ctx = jax_make_context(mesh)
    with mesh_context(ctx):
        params = jax.tree.map(jnp.asarray, tree)
        params = jax.tree.map(jax.device_put, params,
                              jax_shardings(params, jcfg, ctx))
        batch = {k: jax.device_put(jnp.asarray(v), NamedSharding(
            mesh, JP(ctx.batch_axes, *([None] * (v.ndim - 1)))))
            for k, v in cases.batch_data(name, seq).items()}

        def f(p):
            total, metrics = model.loss_fn(p, batch, remat="none")
            return (total if key == "loss" else metrics[key]), total

        @jax.jit
        def grads_of(p):
            (obj, total), g = jax.value_and_grad(f, has_aux=True)(p)
            clipped, norm = jax_clip(g, cases.CLIP)
            return obj, g, clipped, norm

        obj, g, clipped, norm = grads_of(params)
    return (_jax_named(g, jcfg), _jax_named(clipped, jcfg), float(norm),
            float(obj))


def _jax_trainer(name, tree, workdir, optimizer="adamw"):
    """The JAX ``Trainer``'s history on ``cases.TRAIN_MESH`` from
    ``tree``, jitted without donation (``test_torch_trainer.py``); the
    MoE's aux coefficient 0 (``cases.AUX_OFF``, ROADMAP C7)."""
    jrun = cases.train_run(name, JC, optimizer)
    mesh = make_mesh(cases.TRAIN_MESH, ("data", "model"),
                     devices=jax.devices()[:4])
    jtr = JTrainer(jrun, mesh, workdir)
    with mesh_context(jtr.ctx):
        jtr._step_fn = jax.jit(jsteps.make_train_step(jrun, jtr.model,
                                                      jtr.engine))
    # the Trainer's own init is ``tree``: the same config and seed
    assert all(np.array_equal(np.asarray(a, np.float32), b) for a, b in
               zip(jax.tree.leaves(jtr.state.params),
                   jax.tree.leaves(tree)))
    coef = jtransformer.MOE_AUX_COEF
    if name in cases.AUX_OFF:
        jtransformer.MOE_AUX_COEF = 0.0
    try:
        out = jtr.train(jrun.train.total_steps)
    finally:
        jtransformer.MOE_AUX_COEF = coef
    jtr.ckpt.wait()
    return out


def _jax_adafactor(tree):
    """``cases.ADA_STEPS`` JAX Adafactor updates of the global stacked
    ``tree`` from ``cases.ada_grads``: the parameters and the per-leaf
    ``vs`` dicts, in leaf order, as numpy."""
    init, update = jax_make_optimizer(JC.TrainConfig(optimizer="adafactor"))
    p = jax.tree.map(jnp.asarray, tree)
    s = init(p)
    for step in range(cases.ADA_STEPS):
        p, s = update(jax.tree.map(jnp.asarray, cases.ada_grads(tree, step)),
                      s, p, cases.ADA_LR)
    is_v = lambda x: isinstance(x, dict) and ("vr" in x or "v" in x)  # noqa
    return ([np.asarray(x) for x in jax.tree.leaves(p)],
            [{k: np.asarray(a) for k, a in v.items()}
             for v in jax.tree.leaves(s["vs"], is_leaf=is_v)])


@pytest.fixture(scope="module")
def runs():
    """Both worlds, spawned together; the JAX references are computed
    while they run."""
    if jax.device_count() < 4:
        pytest.skip("needs 4 host devices")
    trees = {name: jax.tree.map(
        lambda x: np.asarray(x, np.float32),
        jax_build_model(cases.config(name, JC)).init(
            jax.random.PRNGKey(cases.SEED)))
        for name in cases.CONFIGS}
    for case in cases.ADAFACTOR:
        trees[f"ada_{case}"] = jax.tree.map(
            lambda x: np.asarray(x, np.float32),
            jax_build_model(cases.ada_config(case, JC)).init(
                jax.random.PRNGKey(cases.SEED)))
    root = tempfile.mkdtemp()
    try:
        handles = {}
        for w in WORLDS:
            os.makedirs(os.path.join(root, f"w{w}"))
            handles[w] = cases.start(w, os.path.join(root, f"w{w}"), trees)
        ref = {(name, w): _jax_grads(name, trees[name], w)
               for name in cases.CONFIGS for w in WORLDS}
        ref.update({(case, w): _jax_grads(
            name, trees[name], w, seq, "seq_model")
            for case, (name, _, seq) in cases.SEQ_GRADS.items()
            if not case.endswith("_remat") for w in WORLDS})
        train = {name: _jax_trainer(name, trees[name],
                                    os.path.join(root, f"j{name}"))
                 for name in cases.TRAIN}
        train.update({
            f"{name}_adafactor": _jax_trainer(
                name, trees[name], os.path.join(root, f"ja{name}"),
                "adafactor") for name in cases.TRAIN_ADAFACTOR})
        train["adafactor_updates"] = {
            case: _jax_adafactor(trees[f"ada_{case}"])
            for case in cases.ADAFACTOR}
        got = {w: cases.finish(h, w, os.path.join(root, f"w{w}"))
               for w, h in handles.items()}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return ref, train, got


def _leaf_errors(rec, want, key="grad"):
    """Each leaf's block against the reference's slice of it, over the
    reference leaf's max |value| (a NaN reads as inf)."""
    errs = {}
    for leaf in rec["leaves"]:
        w = want[leaf["path"]]
        if leaf["slices"] is not None:
            w = w[tuple(slice(a, b) for a, b in leaf["slices"])]
        got = leaf[key]
        if got.shape != w.shape:
            errs[leaf["path"]] = np.inf
            continue
        d = np.abs(got - w).max() / max(np.abs(want[leaf["path"]]).max(),
                                        1e-30)
        errs[leaf["path"]] = np.inf if np.isnan(d) else float(d)
    return errs


def _worst(ranks, kind, case, want):
    return max(max(_leaf_errors(r[kind][case], want).values())
               for r in ranks)


def _reference(ref, name, world, key=None):
    """The JAX gradients, clipped gradients, norm and loss the port is
    held to: the mesh of the world's shape; for the leaves of ROADMAP C8
    on the (2 x 2) mesh, the (1 x 2) mesh's, which every mesh but one
    that splits both data and model gives (hymba routes no experts, so
    its gradient does not depend on the data blocks; the norm moves by
    ~4e-7)."""
    key = key or name
    grads, clipped, norm, obj = ref[(key, world)]
    if name == "hymba" and world == 4:
        other = ref[key, 2]
        grads, clipped = dict(grads), dict(clipped)
        for path in grads:
            if path.endswith(C8_LEAVES):
                grads[path], clipped[path] = other[0][path], other[1][path]
    return grads, clipped, norm, obj


@pytest.mark.parametrize("case", list(cases.GRADS))
@pytest.mark.parametrize("world", WORLDS)
def test_gradients_match_jax_on_a_mesh(runs, world, case):
    ref, _, got = runs
    name = cases.GRADS[case][0]
    grads, clipped, _, obj = _reference(ref, name, world)
    for r in got[world]:
        rec = r["grads"][case]
        errs = _leaf_errors(rec, grads)
        assert max(errs.values()) <= GRAD_TOL, sorted(
            errs.items(), key=lambda kv: -kv[1])[:5]
        errs = _leaf_errors(rec, clipped, key="clipped")
        assert max(errs.values()) <= GRAD_TOL
        assert len(rec["leaves"]) == len(grads)
        assert rec["loss"] == pytest.approx(obj, rel=LOSS_RTOL)
    if name == "moonshot":
        margin = min(r["grads"][case]["margin"] for r in got[world])
        assert margin >= MIN_MARGIN, margin


def _seq_reference(ref, case, world):
    """The JAX reference of a ``seq_model`` case (its ``_remat`` twin
    reads the case's own: remat changes no value)."""
    name = cases.SEQ_GRADS[case][0]
    key = case[:-len("_remat")] if case.endswith("_remat") else case
    return _reference(ref, name, world, key)


@pytest.mark.parametrize("case", list(cases.SEQ_GRADS))
@pytest.mark.parametrize("world", WORLDS)
def test_seq_model_gradients_match_jax_on_a_mesh(runs, world, case):
    """Under ``set_activation_policy("seq_model")`` in both packages: every
    leaf's block on every rank within 1e-4 of the JAX gradient's max
    |value| on the same mesh (hymba's C8 leaves at world 4 against the
    (1 x 2) mesh, as under the batch policy), the loss within 1e-5, and
    every leaf ``model`` does not split ``==`` across the ``model``
    group."""
    ref, _, got = runs
    name = cases.SEQ_GRADS[case][0]
    grads, clipped, norm, obj = _seq_reference(ref, case, world)
    for r in got[world]:
        rec = r["seq_grads"][case]
        errs = _leaf_errors(rec, grads)
        assert max(errs.values()) <= GRAD_TOL, sorted(
            errs.items(), key=lambda kv: -kv[1])[:5]
        errs = _leaf_errors(rec, clipped, key="clipped")
        assert max(errs.values()) <= GRAD_TOL
        assert len(rec["leaves"]) == len(grads)
        assert rec["loss"] == pytest.approx(obj, rel=LOSS_RTOL)
        assert rec["grad_norm"] == pytest.approx(norm, rel=NORM_RTOL)
    blocks = {}
    for r in got[world]:
        blocks.setdefault(r["block"], []).append(r["seq_grads"][case])
    for group in blocks.values():
        for other in group[1:]:
            for a, b in zip(group[0]["leaves"], other["leaves"]):
                if not a["split"]:
                    assert np.array_equal(a["clipped"], b["clipped"]), \
                        a["path"]
    if name == "moonshot":
        margin = min(r["seq_grads"][case]["margin"] for r in got[world])
        assert margin >= MIN_MARGIN, margin


@pytest.mark.parametrize("world", WORLDS)
def test_seq_model_swaps_the_tp_collectives(runs, world):
    """qwen3 under ``seq_model``: no ``model_sum`` is left, each layer's
    two regions enter by a sequence all-gather and leave by a
    reduce-scatter (with the embedding's and the unembedding's), each
    backward run once; under ``remat="full"`` the forward's run again and
    the backward's do not. whisper at 39 decoder positions (not divided
    by ``m``) keeps its decoder's ``model_sum``s while its encoder's
    frames are spans."""
    _, _, got = runs
    layers = cases.config("qwen3").n_layers
    for r in got[world]:
        c = r["seq_grads"]["qwen3_seq"]["counts"]
        full = r["seq_grads"]["qwen3_seq_remat"]["counts"]
        assert c["model_sum"] == 0 and c["seq_scatter"] == 2 * layers + 1
        assert c["seq_gather"] == 2 * layers + 1
        assert c["seq_gather_bwd"] == c["seq_gather"]
        assert c["seq_scatter_bwd"] == c["seq_scatter"]
        for k in c:
            if k.endswith("_bwd"):
                assert full[k] == c[k], k
        assert full["seq_gather"] > c["seq_gather"]
        odd = r["seq_grads"]["whisper_odd"]["counts"]
        assert odd["model_sum"] > 0 and odd["seq_gather"] > 0


@pytest.mark.parametrize("world,fault", [
    (w, f) for w in WORLDS for f in cases.SEQ_FAULTS])
def test_seq_model_planted_fault_fails_the_check(runs, world, fault):
    """The sequence reduce-scatter's backward as the identity on the
    rank's span, a norm's scale read on the span without the ``model``
    sum, and the next position's span taken for this rank's: each fails
    the gradient check."""
    ref, _, got = runs
    case = cases.SEQ_FAULTS[fault]
    grads = _seq_reference(ref, case, world)[0]
    assert _worst(got[world], "seq_faults", fault, grads) > GRAD_TOL


def test_reference_conv_bc_gradient_doubled_on_2x2_contract(runs):
    """ROADMAP C8, pinned: the JAX package's hymba gradient on the (2 x 2)
    mesh is its (1 x 2) mesh's at every leaf but the B / C conv weights,
    which read twice theirs (if this fails, the reference was fixed and
    the port can be held to the (2 x 2) gradient at every leaf)."""
    ref, _, _ = runs
    two, one = ref["hymba", 4][0], ref["hymba", 2][0]
    for path, g in two.items():
        want = 2 * one[path] if path.endswith(C8_LEAVES) else one[path]
        assert np.abs(g - want).max() <= 1e-5 * np.abs(want).max(), path
    assert sum(p.endswith(C8_LEAVES) for p in two) == 4


@pytest.mark.parametrize("case", list(cases.GRADS))
@pytest.mark.parametrize("world", WORLDS)
def test_unsplit_leaves_equal_across_the_model_group(runs, world, case):
    """Every leaf ``model`` does not split holds the same gradient on the
    ranks of a node block, bit for bit, and the blocks the split leaves
    hold differ between its positions."""
    _, _, got = runs
    blocks = {}
    for r in got[world]:
        blocks.setdefault(r["block"], []).append(r["grads"][case])
    for group in blocks.values():
        assert len(group) == cases.MESHES[world][1]
        first = group[0]
        for other in group[1:]:
            for a, b in zip(first["leaves"], other["leaves"]):
                assert a["path"] == b["path"]
                if not a["split"]:
                    assert np.array_equal(a["clipped"], b["clipped"]), \
                        a["path"]
                else:
                    assert a["slices"] != b["slices"]
            assert first["grad_norm"] == other["grad_norm"]
            assert first["loss"] == other["loss"]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", list(cases.CONFIGS))
def test_grad_norm_matches_jax_and_the_clip_acts(runs, world, name):
    ref, _, got = runs
    norm = ref[(name, world)][2]
    assert norm > cases.CLIP
    for r in got[world]:
        assert r["grads"][name]["grad_norm"] == pytest.approx(
            norm, rel=NORM_RTOL)


@pytest.mark.parametrize("world", WORLDS)
def test_remat_reruns_the_forward_collectives_only(runs, world):
    """qwen3 at ``remat="full"``: the backward's collective calls are
    those of ``remat="none"``; the forward's run again inside the
    backward (a layer's recompute stops after its last saved tensor, so
    its last ``model_sum`` is not rerun)."""
    _, _, got = runs
    for r in got[world]:
        none = r["grads"]["qwen3"]["counts"]
        full = r["grads"]["qwen3_remat"]["counts"]
        for k in none:
            if k.endswith("_bwd"):
                assert full[k] == none[k], k
        assert none["model_copy_bwd"] == 2 * 4 + 1
        assert full["model_sum"] > none["model_sum"] == 5
        assert full["model_gather"] == none["model_gather"] == 1
        if world == 4:
            assert none["fsdp_gather_bwd"] == none["fsdp_gather"] > 0
            assert full["fsdp_gather"] > none["fsdp_gather"]
        else:
            assert full["fsdp_gather"] == full["fsdp_gather_bwd"] == 0


@pytest.mark.parametrize("world,fault", [
    (w, f) for w in WORLDS for f in cases.FAULTS
    if w == 4 or f not in cases.SPLIT_FAULTS])
def test_planted_fault_fails_the_check(runs, world, fault):
    ref, _, got = runs
    case = cases.FAULTS[fault]
    name = cases.GRADS[case][0]
    grads, _, norm, _ = _reference(ref, name, world)
    if fault == "norm_unweighted":
        assert all(r["faults"][fault]["grad_norm"] > norm * (1 + NORM_RTOL)
                   for r in got[world])
        return
    assert _worst(got[world], "faults", fault, grads) > GRAD_TOL


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", list(cases.TRAIN))
def test_trainer_losses_match_the_jax_trainer(runs, world, name):
    """On a (2 x 2) mesh: one block of 2 nodes at world 2, two of one at
    world 4; every loss of every rank within 1e-5 of the JAX
    ``Trainer``'s, the global norm too."""
    _, train, got = runs
    want = train[name]
    for r in got[world]:
        hist = r["train"][name]["history"]
        assert r["train"][name]["n_blocks"] == world // 2
        assert len(hist) == len(want) == cases.TRAIN[name]
        for a, b in zip(hist, want):
            for key in ("loss", "ce_loss", "grad_norm"):
                assert a[key] == pytest.approx(b[key], rel=LOSS_RTOL), \
                    (key, a, b)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", list(cases.TRAIN))
def test_dump_restores_a_ranks_blocks(runs, world, name):
    """Each rank dumps into its own directory; the restored dump is ``==``
    the rank's parameters and optimizer state at its step, its leaves
    ``Shard``s where the state's are; the optimizer state is AdamW's m,
    v and f32 master of the rank's blocks and nothing more."""
    _, _, got = runs
    for r in got[world]:
        t = r["train"][name]
        assert t["restored_equal"]
        assert "Shard" in t["restored_kinds"]
        assert t["dump_dir"] == f"rank{r['rank']:05d}"
        assert t["pipeline_step"] == cases.DUMP_INTERVAL
        assert t["opt_trees"] == 3
        assert t["opt_bytes"] == 3 * 4 * t["block_elems"]


@pytest.mark.parametrize("world", WORLDS)
def test_refusals_name_their_roadmap_items(runs, world):
    """On every rank: a fail-stop under variant ``none`` raises the WB
    data-loss ``RuntimeError``; a ``proactive`` ``Trainer`` on the (2 x
    2) mesh builds and steps (its replication is A4(d2b2), done), and so
    does an Adafactor one (A4(d2b3), done)."""
    _, _, got = runs
    for r in got[world]:
        ref = r["refusals"]
        assert ref["replicating"] == "none"
        assert ref["adafactor"] == "none"
        assert ref["fail_stop"].startswith("RuntimeError")
        assert "WB data-loss" in ref["fail_stop"]
        assert not r["jax_imported"]


def _ada_errors(rec, want):
    """Each stacked leaf's block, ``vr`` and ``vc`` (or ``v``) against
    the JAX update's global leaf at the block's rows and columns, over
    the global leaf's max |value|: the worst of each leaf."""
    params, vs = want
    assert len(rec["leaves"]) == len(params) == len(vs)
    errs = {}
    for leaf, p, v in zip(rec["leaves"], params, vs):
        at = (tuple(slice(None) if x is None else slice(*x)
                    for x in leaf["slices"]) if leaf["slices"] is not None
              else (slice(None),) * p.ndim)
        pairs = [(leaf["param"], p, at)]
        if "vr" in v:
            pairs += [(leaf["vs"]["vr"], v["vr"], at[:-1]),
                      (leaf["vs"]["vc"], v["vc"], at[:-2] + at[-1:])]
        else:
            pairs += [(leaf["vs"]["v"], v["v"], at)]
        worst = 0.0
        for got, glob, sl in pairs:
            w = glob[sl]
            if got.shape != w.shape:
                worst = np.inf
                break
            worst = max(worst, float(np.abs(got - w).max())
                        / max(float(np.abs(glob).max()), 1e-30))
        errs[leaf["path"]] = worst
    return errs


@pytest.mark.parametrize("world,case", [
    (w, c) for w in WORLDS for c in cases.ADAFACTOR
    if w in cases.ADAFACTOR[c][2]])
def test_adafactor_updates_match_jax_on_the_global_leaves(runs, world,
                                                          case):
    """Five Adafactor updates of each rank's blocks from seeded global
    gradients: every block, and the ``vr`` / ``vc`` at its rows and
    columns, within ``test_torch_optim.py``'s RTOL (1e-6 of the leaf's
    max |value|) of the JAX ``adafactor_update`` on the global stacked
    leaves; ``parts`` has two node blocks holding each FSDP part. The
    three sums across blocks are one ``all_reduce`` each a step, and the
    ``vs`` bytes follow the blocks (fewer than the global leaves')."""
    _, train, got = runs
    want = train["adafactor_updates"][case]
    for r in got[world]:
        rec = r["adafactor"][case]
        errs = _ada_errors(rec, want)
        assert max(errs.values()) <= ADA_RTOL, sorted(
            errs.items(), key=lambda kv: -kv[1])[:5]
        assert rec["count"] == cases.ADA_STEPS
        for k in ("adafactor_factors", "adafactor_denom", "adafactor_rms"):
            assert rec["counts"][k] == cases.ADA_STEPS, k
        assert any(leaf["slices"] is not None for leaf in rec["leaves"])
    glob = sum(a.nbytes for v in want[1] for a in v.values())
    assert all(r["adafactor"][case]["vs_bytes"] < glob for r in got[world])


@pytest.mark.parametrize("world,fault", [
    (w, f) for w in WORLDS for f in cases.ADA_FAULTS
    if w in cases.ADAFACTOR[cases.ADA_FAULTS[f]][2]])
def test_adafactor_planted_fault_fails_the_check(runs, world, fault):
    """Each planted fault of the split Adafactor breaks the check above:
    ``vr`` not summed over the column blocks, the RMS's sum without the
    holders' weight, a repeated FSDP part counted twice."""
    _, train, got = runs
    case = cases.ADA_FAULTS[fault]
    want = train["adafactor_updates"][case]
    worst = max(max(_ada_errors(r["adafactor_faults"][fault],
                                want).values()) for r in got[world])
    assert worst > ADA_RTOL, worst


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", list(cases.TRAIN_ADAFACTOR))
def test_adafactor_trainer_matches_the_jax_trainer(runs, world, name):
    """The split ``Trainer`` with Adafactor on the (2 x 2) mesh: every
    loss, ``ce_loss`` and global norm of every rank within 1e-5 of the
    JAX ``Trainer``'s; the dump restores the rank's blocks and ``vs``
    ``==``, and the ``vs`` bytes are the reckoning of its blocks' rows
    and columns."""
    _, train, got = runs
    want = train[f"{name}_adafactor"]
    for r in got[world]:
        t = r["train_adafactor"][name]
        hist = t["history"]
        assert len(hist) == len(want) == cases.TRAIN_ADAFACTOR[name]
        for a, b in zip(hist, want):
            for key in ("loss", "ce_loss", "grad_norm"):
                assert a[key] == pytest.approx(b[key], rel=LOSS_RTOL), \
                    (key, a, b)
        assert t["restored_equal"]
        assert t["dump_dir"] == f"rank{r['rank']:05d}"
        assert t["opt_trees"] == 0
        assert t["opt_bytes"] == t["vs_reckoned"] > 0


def test_activation_policy_names_values_and_refusal():
    """The port's policy takes the reference's names and values, and
    both refuse another with ``ValueError``; ``"batch"`` is the
    default."""
    from repro.distributed import sharding as jshard
    from repro_torch.distributed import sharding as tshard
    assert tshard.get_activation_policy() == "batch"
    try:
        for mod in (jshard, tshard):
            for policy in ("seq_model", "batch"):
                mod.set_activation_policy(policy)
                assert mod.get_activation_policy() == policy
            with pytest.raises(ValueError):
                mod.set_activation_policy("seq")
            assert mod.get_activation_policy() == "batch"
    finally:
        jshard.set_activation_policy("batch")
        tshard.set_activation_policy("batch")


def test_fsdp_gather_backward_sums_repeated_parts(runs):
    """World 4 as 4 node blocks of a (pod 2, data 2, model 1) mesh, a
    dimension only ``pod`` divides: the gather gives the whole tensor,
    and each block's gradient is the group's sum over its part, 1 + 2 +
    3 + 4 = 10 times the pattern, on both blocks that hold it (a
    reduce-scatter would give each a share)."""
    _, _, got = runs
    for r in got[4]:
        rec = r["repeated_parts"]
        p = rec["part"]
        assert np.array_equal(rec["gathered"], rec["base"])
        assert np.array_equal(rec["grad"], 10 * rec["base"][3 * p:3 * p + 3])
    assert [r["repeated_parts"]["part"] for r in got[4]] == [0, 0, 1, 1]


def _losses(text, prefix=""):
    return {int(s): float(v) for s, v in re.findall(
        prefix + r"step +(\d+) loss (\S+)", text)}


def test_split_launcher_under_torchrun(tmp_path, capsys):
    """``launch/train.py --split-model --mesh 2x2 --variant none`` under
    ``torch.distributed.run`` on 4 CPU ranks, 2 steps in f32: every rank
    prints the same losses, within 1e-5 of a one-process run's (logical
    nodes on one device)."""
    from repro_torch.launch import train as train_mod
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(src),
               OMP_NUM_THREADS="1")
    args = ["--arch", "qwen3-0.6b", "--reduced", "--steps", "2",
            "--mesh", "2x2", "--seq-len", "16", "--global-batch", "4",
            "--variant", "none", "--dtype", "float32", "--log-every", "1",
            "--device", "cpu"]
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", "-m", "repro_torch.launch.train",
         "--split-model", "--workdir", str(tmp_path / "split"), *args],
        capture_output=True, text=True, env=env, timeout=240,
        cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-3000:]
    ranks = [_losses(proc.stdout, rf"rank {r}/4: ") for r in range(4)]
    assert all(r == ranks[0] for r in ranks) and set(ranks[0]) == {0, 1}
    assert "the model axis split (block 1, model position 1)" in proc.stdout
    train_mod.main(["--workdir", str(tmp_path / "one"), *args])
    one = _losses(capsys.readouterr().out)
    assert set(one) == {0, 1}
    for s in one:
        assert ranks[0][s] == pytest.approx(one[s], rel=LOSS_RTOL)
    assert sorted(os.listdir(tmp_path / "split")) == [
        f"rank{r:05d}" for r in range(4)]

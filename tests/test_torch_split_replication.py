"""The port's REPL / VAL, recovery and the recovered shard's install
across ``torch.distributed`` ranks that split the ``model`` axis, on the
CPU (``gloo``), against the JAX package on host meshes of the same shape.

Two worlds are spawned once for the module (``torch_split_rep_cases.py``):
2 ranks on ``mesh8`` (4 data x 2 model: one block of 4 nodes, two
``model`` positions) and 4 ranks on ``mesh8`` (two blocks of 2 nodes)
and on ``pod_mesh8`` (2 pod x 2 data x 2 model: one pod a block). Each
rank holds ``torch_dist_cases.state()`` as ``sharding.Shard`` blocks and
replicates them with log dtype f32:

* every rank's ring is ``==`` the JAX engine's global ring at its block
  and position, for every variant with coalescing on and off, for parity,
  and on the pod mesh for the per-pod ring and the joined cross-pod ring;
* every ring node recovers on every rank: stats and message log ``==``
  the one-card port's, the rank's row ``==`` the one-card row of its
  position and the true block; the positions' rows together ``==`` the
  one-card values; parity recovery the same;
* ``install_recovered_shard`` writes into blocks whose failed node's
  parts (and replicated leaves) were NaN: every ``Shard.local`` ``==`` the
  block ``sharding.block_slices`` cuts from the unfailed state;
* the split ``Trainer`` (reduced qwen3 in f32 on the (2 x 2) mesh,
  proactive, N_r 1, a fail-stop of node 1 at step 2) at both worlds: 3
  losses within 1e-5 relative of the JAX ``Trainer``'s under the same
  replication, the failed run's blocks ``==`` the unfailed run's, the
  ring's timestamps and valid bits ``==`` the JAX ``Trainer``'s at the
  rank's block and position and its values within ``RING_RTOL``;
* the counted permute bytes per (node, position) per step ``==`` the JAX
  ``collective_bytes(hlo)["replication_bytes"]`` of the replicate step
  jitted on ``mesh8``, and the dry run's split cell reports the
  ``per_kind_bytes`` the ``gloo`` world 4 counts for the same step;
* planted faults each fail their check: a REPL sent to the rank of the
  wrong ``model`` position, recovery's table summed over the world, one
  position's VAL dropped, the install writing another position's rows.
"""

import os
import shutil
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as JP

import torch_dist_cases as dc
import torch_split_rep_cases as cases
import torch_tp_train_cases as tc
from repro import config as JC
from repro.config import ReplicationConfig as JRC
from repro.core.replication import ReplicationEngine as JEngine
from repro.distributed.context import make_context as jax_make_context
from repro.distributed.context import make_mesh, mesh_context
from repro.launch.costing import collective_bytes
from repro.models import build_model as jax_build_model
from repro.training import steps as jsteps
from repro.training.trainer import Trainer as JTrainer
from repro_torch.distributed.context import make_context

WORLDS = (2, 4)
LOSS_RTOL = 1e-5
#: the Trainer's ring values against the JAX Trainer's: the parameters
#: the ring logs differ from the reference's by the f32 sums' order (the
#: losses agree within 1e-5), relative to the ring's max |value|
RING_RTOL = 1e-5


def _jax_ring(mesh, pod, update, st, **rep):
    """The JAX engine's global ring after ``N_STEPS`` of ``update``, and
    its step's per-device ``replication_bytes``."""
    sp = {k: JP(*dc.specs(pod)[k]) for k in st}
    params = {k: jax.device_put(jnp.asarray(v), NamedSharding(mesh, sp[k]))
              for k, v in st.items()}
    eng = JEngine(JRC(**rep), jax_make_context(mesh), sp, params)

    @jax.jit
    def step(p, logs, i):
        new = jax.tree.map(update, p)
        logs, committed = eng.replicate(new, logs, i, new)
        return committed, logs

    logs = eng.init_logs()
    with mesh_context(eng.ctx):
        hlo = step.lower(params, logs, jnp.int32(0)).compile().as_text()
        for i in range(dc.N_STEPS):
            params, logs = step(params, logs, jnp.int32(i))
    per_device = collective_bytes(hlo, mesh.devices.size)
    return ({k: np.asarray(v) for k, v in logs.items()},
            per_device["replication_bytes"])


def _one_card():
    """The one-card port's recoveries (no group)."""
    from repro_torch.core import recovery as R
    from repro_torch.distributed.context import P
    ctx = make_context(*dc.MESH8, device="cpu")
    pctx = make_context(*dc.POD_MESH8, device="cpu")
    out = {}
    for v in dc.VARIANTS:
        for c in (True, False):
            eng, _, logs = dc.ring_run(ctx, False, dc.copy_update, variant=v,
                                       coalescing=c, **dc.COPY)
            out[("recover", v, c)] = dc.recover_all(eng, logs)
    for v, c, x in dc.POD_CASES:
        if x:
            eng, _, logs = dc.ring_run(pctx, True, dc.copy_update, variant=v,
                                       coalescing=c, cross_pod_replicas=True,
                                       **dc.COPY)
            out[("pod_recover", v, c)] = dc.recover_all(eng, logs)
    st = {k: v for k, v in dc.state().items() if k != "scale"}
    eng, params, logs = dc.ring_run(ctx, False, dc.parity_update, st=st,
                                    **dc.PARITY)
    sp = {k: P(*dc.specs(False)[k]) for k in st}
    out["parity_recover"] = {
        f: dc.result_data(R.recover_node_parity(eng, logs, params, sp,
                                                failed_coord=(f,)))
        for f in (0, 3)}
    return out


def _jax_trainer(tree, workdir):
    """The JAX ``Trainer`` on ``tc.TRAIN_MESH`` with the same replication,
    jitted without donation; its history and global ring."""
    jrun = cases.train_run(JC)
    mesh = make_mesh(tc.TRAIN_MESH, ("data", "model"),
                     devices=jax.devices()[:4])
    jtr = JTrainer(jrun, mesh, workdir)
    with mesh_context(jtr.ctx):
        jtr._step_fn = jax.jit(jsteps.make_train_step(jrun, jtr.model,
                                                      jtr.engine))
    assert all(np.array_equal(np.asarray(a, np.float32), b) for a, b in
               zip(jax.tree.leaves(jtr.state.params), jax.tree.leaves(tree)))
    hist = jtr.train(cases.TRAIN_STEPS)
    jtr.ckpt.wait()
    ring = {k: np.asarray(v) for k, v in jtr.state.logs.items()}
    eng, cfg = jtr.engine, jrun.model
    vals = ring["values"]
    ring["leaves"] = {
        (d, m, r, slot): _layer_named(eng.unflatten(
            eng.unpack(vals[d, m, r, slot])), cfg)
        for d in range(vals.shape[0]) for m in range(vals.shape[1])
        for r in range(vals.shape[2]) for slot in range(vals.shape[3])}
    return hist, ring


def _layer_named(tree, cfg):
    """A JAX tree's leaves by the port's paths: the stacked layer axis
    as a list index (``layers/0/attn/wq``), f32 numpy."""
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                if k == "layers" and path == "":
                    for i in range(cfg.n_layers):
                        walk(jax.tree.map(lambda a, i=i: a[i], node[k]),
                             f"{k}/{i}/")
                else:
                    walk(node[k], f"{path}{k}/")
            return
        out[path[:-1]] = np.asarray(node, np.float32)

    walk(tree, "")
    return out


def _dry_run_cell(cell="adamw"):
    """The dry run's split cell of :func:`cases.step_run`'s step (``cell``
    of ``cases.STEP_CELLS``: its train overrides and activation policy),
    costed on ``meta`` through a fake group of the mesh's world."""
    from repro_torch.launch import dryrun
    run = cases.step_run()
    overrides, policy = cases.STEP_CELLS[cell]
    return dryrun.run_cell("qwen3-0.6b", run.shape, False, save=False,
                           model_cfg=run.model, split_model=True,
                           mesh=cases.STEP_MESH,
                           replication=run.replication,
                           train_overrides=overrides or None,
                           act_policy=policy)


@pytest.fixture(scope="module")
def runs(mesh8, pod_mesh8):
    """Both worlds, spawned together; the JAX and one-card references
    are computed while they run."""
    if jax.device_count() < 8:
        pytest.skip("needs 8 host devices")
    tree = jax.tree.map(lambda x: np.asarray(x, np.float32),
                        jax_build_model(tc.config("qwen3", JC)).init(
                            jax.random.PRNGKey(tc.SEED)))
    root = tempfile.mkdtemp()
    try:
        handles = {}
        for w in WORLDS:
            os.makedirs(os.path.join(root, f"w{w}"))
            handles[w] = cases.start(w, os.path.join(root, f"w{w}"),
                                     {"qwen3": tree})
        ref = {}
        st = dc.state()
        for v in dc.VARIANTS:
            for c in (True, False):
                ref[("ring", v, c)] = _jax_ring(
                    mesh8, False, dc.copy_update, st, variant=v,
                    coalescing=c, **dc.COPY)
        ref["parity_ring"] = _jax_ring(
            mesh8, False, dc.parity_update,
            {k: v for k, v in st.items() if k != "scale"}, **dc.PARITY)
        for v, c, x in dc.POD_CASES:
            ref[("pod_ring", v, c, x)] = _jax_ring(
                pod_mesh8, True, dc.copy_update, st, variant=v,
                coalescing=c, cross_pod_replicas=x,
                **dict(dc.COPY, n_replicas=2 if x else 1))
        ref["one_card"] = _one_card()
        ref["trainer"] = _jax_trainer(tree, os.path.join(root, "jax"))
        ref["dry_run"] = _dry_run_cell()
        ref["dry_cells"] = {cell: _dry_run_cell(cell)
                            for cell in cases.STEP_CELLS if cell != "adamw"}
        got = {w: cases.finish(h, w, os.path.join(root, f"w{w}"))
               for w, h in handles.items()}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return ref, got


def _block(arr, starts, sizes):
    return arr[tuple(slice(s, s + n) for s, n in zip(starts, sizes))]


def _rings_equal(got, want, starts, sizes):
    return all(np.array_equal(got[k], _block(want[k], starts, sizes))
               for k in ("values", "ts", "valid"))


def _final_state():
    st = dc.state()
    for _ in range(dc.N_STEPS):
        st = {k: dc.copy_update(v) for k, v in st.items()}
    return st


def _truth(st, ring, m):
    """Ring node ``ring``'s true blocks at model position ``m`` (mesh8)."""
    return {"w1": st["w1"][2 * ring:2 * ring + 2, 3 * m:3 * m + 3],
            "w2": st["w2"][2 * m:2 * m + 2, 2 * ring:2 * ring + 2],
            "scale": st["scale"]}


def _same_meta(got, want):
    """Stats, message log and each shard's (bucket, ts, source) ``==``."""
    return (got["failed"] == want["failed"]
            and got["stats"] == want["stats"]
            and got["messages"] == want["messages"]
            and set(got["shards"]) == set(want["shards"])
            and all(got["shards"][b][:3] == want["shards"][b][:3]
                    for b in want["shards"]))


def _same_rows(got, want, pos):
    """The rank's one row ``==`` the one-card row of its position."""
    return all(g[3].shape[0] == 1 and np.array_equal(g[3][0],
                                                     want["shards"][b][3][pos])
               for b, g in got["shards"].items())


@pytest.mark.parametrize("world", WORLDS)
def test_ranks_hold_one_position_of_a_block(runs, world):
    _, got = runs
    k = 4 // (world // 2)
    for r, out in enumerate(got[world]):
        starts, sizes, block, pos = out["ctx"]
        assert (block, pos) == (r // 2, r % 2) and not out["jax_imported"]
        assert starts == (block * k, pos) and sizes == (k, 1)
        assert out[("ring", "proactive", True)]["values"].shape[:2] == (k, 1)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("variant", dc.VARIANTS)
@pytest.mark.parametrize("coalescing", [True, False])
def test_split_ring_matches_jax(runs, world, variant, coalescing):
    ref, got = runs
    want = ref[("ring", variant, coalescing)][0]
    for out in got[world]:
        starts, sizes, _, _ = out["ctx"]
        assert _rings_equal(out[("ring", variant, coalescing)], want,
                            starts, sizes)


@pytest.mark.parametrize("world", WORLDS)
def test_split_parity_ring_matches_jax(runs, world):
    ref, got = runs
    for out in got[world]:
        starts, sizes, _, _ = out["ctx"]
        assert _rings_equal(out["parity_ring"], ref["parity_ring"][0],
                            starts, sizes)


@pytest.mark.parametrize("variant,coalescing,cross", dc.POD_CASES)
def test_split_pod_ring_matches_jax(runs, variant, coalescing, cross):
    """World 4 on the pod mesh: one pod a block, each rank one position;
    the joined (pod, data) ring and each pod's own ring."""
    ref, got = runs
    key = ("pod_ring", variant, coalescing, cross)
    for r, out in enumerate(got[4]):
        starts, sizes = out["pod_ctx"]
        assert (starts, sizes) == ((r // 2, 0, r % 2), (1, 2, 1))
        assert _rings_equal(out[key], ref[key][0], starts, sizes)


@pytest.mark.parametrize("world,pod", [(2, False), (4, False), (4, True)])
@pytest.mark.parametrize("variant", dc.VARIANTS)
@pytest.mark.parametrize("coalescing", [True, False])
def test_every_node_recovers_on_every_rank(runs, world, pod, variant,
                                           coalescing):
    """Stats and messages ``==`` the one-card port's; the rank's row
    ``==`` the one-card row of its position (and, on mesh8, the true
    block); the positions' rows, stacked, ``==`` the one-card values.
    The pod mesh runs at world 4 (one pod a block)."""
    ref, got = runs
    key = ("pod_recover" if pod else "recover", variant, coalescing)
    truth = _final_state()
    ctx_key = "pod_ctx" if pod else "ctx"
    for ring, want in enumerate(ref["one_card"][key]):
        rows = {}
        for out in got[world]:
            res = out[key][ring]
            pos = out[ctx_key][0][-1]
            assert _same_meta(res, want), (ring, res["stats"])
            assert res["stats"][-1] == 0 and res["model_pos"] == {pos}
            assert _same_rows(res, want, pos)
            if not pod:
                for name, arr in _truth(truth, ring, pos).items():
                    assert np.array_equal(res["tree"][0][name], arr)
            rows.setdefault(pos, res["shards"])
        for b, (_, _, _, vals) in want["shards"].items():
            stacked = np.concatenate([rows[p][b][3] for p in sorted(rows)])
            assert np.array_equal(stacked, vals)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("failed", [0, 3])
def test_split_parity_recovery_matches_one_card(runs, world, failed):
    ref, got = runs
    want = ref["one_card"]["parity_recover"][failed]
    assert want["stats"][-1] == 0
    for out in got[world]:
        res = out["parity_recover"][failed]
        pos = out["ctx"][3]
        assert _same_meta(res, want) and res["model_pos"] == {pos}
        assert _same_rows(res, want, pos)


def _installed_equal(installed, blocks):
    return all(np.array_equal(installed[k], blocks[k]) for k in blocks)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("coalescing", [True, False])
def test_install_writes_the_unfailed_blocks(runs, world, coalescing):
    """The failed node's parts of every ``Shard.local`` (and every
    replicated leaf) NaN, then the install: every block ``==`` the one
    ``sharding.block_slices`` cuts from the unfailed state."""
    from repro_torch.distributed import sharding
    from repro_torch.distributed.context import P
    _, got = runs
    truth = _final_state()
    for out in got[world]:
        blocks = out[("blocks", coalescing)]
        starts, sizes, block, pos = out["ctx"]
        for k, arr in truth.items():
            sp = P(*dc.specs(False)[k])
            if any(sp):
                ctx = _stand_in(world, block, pos)
                arr = arr[sharding.block_slices(sp, arr.shape, ctx)]
            assert np.array_equal(blocks[k], arr)
        for node, installed in out[("install", coalescing)].items():
            assert not any(np.isnan(v).any() for v in installed.values())
            assert _installed_equal(installed, blocks), node


def _stand_in(world, block, pos):
    """A context of ``mesh8`` split over ``world`` ranks at (block,
    position), without a process group (``block_slices`` reads only its
    layout)."""
    from repro_torch.distributed.context import MeshContext
    k = 4 // (world // 2)
    return MeshContext(axis_names=("data", "model"), axis_sizes=(4, 2),
                       batch_axes=("data",), model_axis="model",
                       device=None, group=object(), world=world,
                       rank=block * 2 + pos, local_sizes=(k, 1),
                       local_starts=(block * k, pos), split_model=True)


@pytest.mark.parametrize("world", WORLDS)
def test_trainer_recovers_a_fail_stop(runs, world):
    """The split ``Trainer`` with proactive, N_r 1 and a fail-stop of node
    1 at step 2 (the install handed blocks holed where the node's parts
    were): 3 losses within 1e-5 of the JAX ``Trainer``'s, the failed
    run's blocks ``==`` the unfailed run's on every rank, still autograd
    leaves; the ring's ts / valid ``==`` the JAX ``Trainer``'s at the
    rank's block and position, its values within ``RING_RTOL``."""
    ref, got = runs
    jhist, jring = ref["trainer"]
    for r, out in enumerate(got[world]):
        t = out["train"]
        for name in ("unfailed", "failed"):
            hist = t[name]["history"]
            assert len(hist) == len(jhist) == cases.TRAIN_STEPS
            for a, b in zip(hist, jhist):
                assert a["loss"] == pytest.approx(b["loss"], rel=LOSS_RTOL)
            assert t[name]["requires_grad"]
        assert all(np.array_equal(a, b) for a, b in
                   zip(t["failed"]["blocks"], t["unfailed"]["blocks"]))
        assert t["failed"]["nan_left"] == [0]
        rec = [e for e in t["failed"]["events"] if e["event"] == "recovery"]
        assert len(rec) == 1 and rec[0]["recovered"] == cases.TRAIN_FAIL[1]
        assert rec[0]["stats"]["unrecoverable"] == 0
        assert rec[0]["cm"] == 0 and rec[0]["cm_rank"] == 0
        starts, sizes = t["unfailed"]["ctx"]
        ring = t["unfailed"]["ring"]
        for k in ("ts", "valid"):
            assert np.array_equal(ring[k], _block(jring[k], starts, sizes))
        assert np.array_equal(t["failed"]["ring"]["ts"], ring["ts"])
        for (j, rep, slot), leaves in t["unfailed"]["ring_leaves"].items():
            want = jring["leaves"][(starts[0] + j, starts[1], rep, slot)]
            assert set(leaves) == set(want)
            for path, arr in leaves.items():
                w = want[path]
                assert arr.shape == w.shape, path
                assert np.abs(arr - w).max() <= \
                    RING_RTOL * max(np.abs(w).max(), 1e-30), path


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("coalescing", [True, False])
def test_permute_bytes_match_the_reference(runs, world, coalescing):
    """``BYTES["ppermute"]`` over the rank's nodes and the steps: the JAX
    replicate step's ``replication_bytes`` per device (REPL and VAL)."""
    ref, got = runs
    want = ref[("ring", "proactive", coalescing)][1]
    assert want > 0
    for out in got[world]:
        c = out[("counts", "proactive", coalescing)]
        k = out["ctx"][1][0]
        assert c["bytes"]["ppermute"] / (dc.N_STEPS * k) == want
        assert c["counts"]["ppermute"] > 0


def test_dry_run_split_cell_counts_the_step(runs):
    """The dry run's split cell of reduced qwen3 at (2 x 2), costed on
    ``meta`` in a fake group of 4: its ``collectives`` ``per_kind_bytes``
    and ``n_ops`` are rank 0's of the same step on the ``gloo`` world of
    4 (REPL / VAL from the engine's layout there, counted here)."""
    ref, got = runs
    rec = ref["dry_run"]
    assert rec["status"] == "ok", rec.get("error")
    coll = rec["collectives"]
    step = got[4][0]["step_bytes"]
    counted = {k: v for k, v in step["bytes"].items() if v}
    assert coll["per_kind_bytes"] == counted
    assert coll["n_ops"] == {k: v for k, v in step["counts"].items() if v}
    assert coll["replication_bytes"] == counted["ppermute"]
    assert coll["total_bytes"] == sum(counted.values())
    assert all(out["step_bytes"]["bytes"]["ppermute"] == counted["ppermute"]
               for out in got[4])


@pytest.mark.parametrize("cell", ["adafactor", "seq_model"])
def test_dry_run_split_cells_count_their_step(runs, cell):
    """The dry run's split cell with Adafactor (``train_overrides``) and
    under the ``seq_model`` policy (``act_policy``), reduced qwen3 at
    (2 x 2) on ``meta``: ``per_kind_bytes`` and ``n_ops`` are rank 0's
    of the same step on the ``gloo`` world of 4, Adafactor's three sums
    and the sequence collectives among them; ``opt_state_bytes_per_rank``
    is the counted step's optimizer state (Adafactor's ``vs`` blocks);
    the record keeps its policy and optimizer."""
    ref, got = runs
    rec = ref["dry_cells"][cell]
    assert rec["status"] == "ok", rec.get("error")
    assert rec["act_policy"] == cases.STEP_CELLS[cell][1]
    step = got[4][0]["step_cells"][cell]
    counted = {k: v for k, v in step["bytes"].items() if v}
    coll = rec["collectives"]
    assert coll["per_kind_bytes"] == counted
    assert coll["n_ops"] == {k: v for k, v in step["counts"].items() if v}
    assert rec["memory"]["opt_state_bytes_per_rank"] == step["opt_bytes"]
    if cell == "adafactor":
        assert rec["optimizer"] == "adafactor"
        assert all(counted[k] > 0 for k in (
            "adafactor_factors", "adafactor_denom", "adafactor_rms"))
        adamw = ref["dry_run"]["memory"]["opt_state_bytes_per_rank"]
        assert step["opt_bytes"] < adamw / 10
    else:
        assert counted["seq_gather"] > 0 and counted["seq_scatter"] > 0
        assert "model_sum" not in counted
        batch = ref["dry_run"]["collectives"]["per_kind_bytes"]
        assert counted["seq_scatter"] < batch["model_sum"]


@pytest.mark.parametrize("world,fault", [
    (4, "repl_wrong_position"), (2, "val_dropped"), (4, "val_dropped"),
    (2, "table_over_world"), (4, "table_over_world")])
def test_planted_faults_fail_their_check(runs, world, fault):
    """A REPL to the wrong position's rank (world 4: at world 2 one block
    holds every REPL pair) fails the ring check; recovery's table over
    the world fails the message log (``n_versions`` counted ``m``
    times); one position's VAL dropped makes the version invalid at both
    positions (the AND over ``model``), so the message log differs from
    the one-card port's while the ranks still agree."""
    ref, got = runs
    want_ring = ref[("ring", "proactive", False)][0]
    want = ref["one_card"][("recover", "proactive", False)]
    outs = [out["planted"][fault] for out in got[world]]
    if fault == "repl_wrong_position":
        assert any(not _rings_equal(o["ring"], want_ring, out["ctx"][0],
                                    out["ctx"][1])
                   for o, out in zip(outs, got[world]))
        return
    bad = [isinstance(o["recover"], str) or not all(
        _same_meta(res, w) for res, w in zip(o["recover"], want))
        for o in outs]
    assert all(bad)
    if fault == "val_dropped":
        first = [res["messages"] for res in outs[0]["recover"]]
        assert all([res["messages"] for res in o["recover"]] == first
                   for o in outs)


@pytest.mark.parametrize("world", WORLDS)
def test_planted_install_of_another_position_fails(runs, world):
    _, got = runs
    for out in got[world]:
        blocks = out[("blocks", False)]
        assert any(not _installed_equal(inst, blocks) for inst in
                   out[("install_other_rows", False)].values())

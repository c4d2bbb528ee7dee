"""The port's replication engine and Algorithms 1-2 against the JAX package's.

Twins of the engine tests in ``tests/test_replication.py`` on a
``("data", "model") = (4, 2)`` node context: the same numpy state goes
through the JAX engine on the 8-device host mesh and through the port
on CPU tensors. The log ring after three steps must be ``==`` the JAX
ring for every variant with coalescing on and off (the state is not
symmetric across nodes, so a wrong ``ppermute`` direction shows), every
node must recover ``==`` its truth, and the port's recovery on the very
logs the JAX engine wrote (``logs_from_host_arrays``) must return the
JAX package's ``RecoveryResult``. Parity mode sums in another order, so
it is held at the JAX test's ``atol=1e-4``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as JP

from repro.config import ReplicationConfig as JRC
from repro.core import recovery as JR
from repro.core.directory import ShardDirectory as JDir
from repro.core.replication import ReplicationEngine as JEngine
from repro.distributed import elastic as JEl
from repro.distributed.context import make_context as jax_make_context
from repro.distributed.context import mesh_context
from repro_torch.config import ReplicationConfig
from repro_torch.core import recovery as R
from repro_torch.core.directory import ShardDirectory
from repro_torch.core.replication import ReplicationEngine
from repro_torch.distributed import elastic as El
from repro_torch.distributed.context import P, make_context

VARIANTS = ["baseline", "parallel", "proactive"]
N_STEPS = 3


def _state():
    return {
        "w1": np.arange(48, dtype=np.float32).reshape(8, 6),
        "w2": np.arange(32, dtype=np.float32).reshape(4, 8) * 0.5,
        "scale": np.linspace(0.25, 2.0, 6).astype(np.float32),
    }


JSPECS = {"w1": JP("data", "model"), "w2": JP("model", "data"),
          "scale": JP(None)}
TSPECS = {"w1": P("data", "model"), "w2": P("model", "data"),
          "scale": P(None)}


#: the same state on the (pod 2, data 2, model 2) mesh: the node
#: dimensions are sharded over the joined (pod, data) axes, pod-major,
#: so ring node s holds the blocks node s holds on the (4, 2) mesh.
POD_JSPECS = {"w1": JP(("pod", "data"), "model"),
              "w2": JP("model", ("pod", "data")), "scale": JP(None)}
POD_TSPECS = {"w1": P(("pod", "data"), "model"),
              "w2": P("model", ("pod", "data")), "scale": P(None)}
POD_AXES = ("pod", "data", "model")


def _engines(mesh, state, pod=False, **rep):
    rep.setdefault("log_dtype", "float32")
    jspecs, tspecs = (POD_JSPECS, POD_TSPECS) if pod else (JSPECS, TSPECS)
    jparams = {k: jax.device_put(jnp.asarray(v),
                                 NamedSharding(mesh, jspecs[k]))
               for k, v in state.items()}
    jeng = JEngine(JRC(**rep), jax_make_context(mesh),
                   {k: jspecs[k] for k in state}, jparams)
    ctx = (make_context((2, 2, 2), POD_AXES, device="cpu") if pod else
           make_context((4, 2), ("data", "model"), device="cpu"))
    tparams = {k: torch.from_numpy(v.copy()) for k, v in state.items()}
    teng = ReplicationEngine(ReplicationConfig(**rep), ctx,
                             {k: tspecs[k] for k in state}, tparams)
    return jeng, jparams, teng, tparams


def _run(mesh, update, n_steps=N_STEPS, state=None, pod=False, **rep):
    """Both engines after ``n_steps`` of ``x -> update(x)``; returns
    (jax engine, jax params, jax logs, port engine, port params, port
    logs)."""
    state = _state() if state is None else state
    jeng, jp, teng, tp = _engines(mesh, state, pod=pod, **rep)

    @jax.jit
    def step(params, logs, step_no):
        new = jax.tree.map(update, params)
        logs, committed = jeng.replicate(new, logs, step_no, new)
        return committed, logs

    jl = jeng.init_logs()
    tl = teng.init_logs()
    with mesh_context(jeng.ctx):
        for i in range(n_steps):
            jp, jl = step(jp, jl, jnp.int32(i))
            new = {k: update(x) for k, x in tp.items()}
            tl, tp = teng.replicate(new, tl, i, new)
            for k in tp:
                assert np.array_equal(tp[k].numpy(), np.asarray(jp[k])), k
    return jeng, jp, jl, teng, tp, tl


@pytest.fixture(scope="module")
def copy_runs(mesh8):
    return {(v, c): _run(mesh8, lambda x: x * 1.5 + 1.0, variant=v,
                         coalescing=c, n_replicas=2, n_buckets=2,
                         log_capacity=3)
            for v in VARIANTS for c in (True, False)}


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("coalescing", [True, False])
def test_log_ring_matches_jax(copy_runs, variant, coalescing):
    _, _, jl, teng, _, tl = copy_runs[(variant, coalescing)]
    for k in ("values", "ts", "valid"):
        want = np.asarray(jl[k])
        assert tuple(tl[k].shape) == want.shape == teng.log_struct()[k].shape
        assert np.array_equal(tl[k].numpy(), want), k


def test_variants_write_the_same_ring(copy_runs):
    for c in (True, False):
        rings = [copy_runs[(v, c)][5]["values"] for v in VARIANTS]
        assert all(torch.equal(rings[0], r) for r in rings[1:])


def _truth(p, failed, m):
    out = {"w1": np.asarray(p["w1"])[2 * failed:2 * failed + 2,
                                     3 * m:3 * m + 3],
           "w2": np.asarray(p["w2"])[2 * m:2 * m + 2,
                                     2 * failed:2 * failed + 2]}
    if "scale" in p:
        out["scale"] = np.asarray(p["scale"])
    return out


def _messages(result):
    """The message log with each package's own classes (``MsgType``,
    ``FetchLatestVers``) replaced by their values."""
    return [(t.value, {k: getattr(v, "addrs", v) for k, v in m.items()})
            for t, m in result.message_log]


def _same_result(port, ref):
    assert port.failed == ref.failed
    assert dataclasses.astuple(port.stats) == dataclasses.astuple(ref.stats)
    assert _messages(port) == _messages(ref)
    assert set(port.shards) == set(ref.shards)
    for b, s in ref.shards.items():
        p = port.shards[b]
        assert (p.bucket, p.ts, p.source) == (s.bucket, s.ts, s.source)
        assert np.array_equal(p.values.numpy(), np.asarray(s.values))


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("coalescing", [True, False])
def test_recover_exact_all_variants(copy_runs, variant, coalescing):
    jeng, jp, jl, teng, tp, tl = copy_runs[(variant, coalescing)]
    for failed in range(4):
        res = R.recover_node(teng, tl,
                             ShardDirectory(4, teng.layout.n_buckets, 2),
                             failed_coord=(failed,))
        ref = JR.recover_node(jeng, jl, JDir(4, jeng.layout.n_buckets, 2),
                              failed_coord=(failed,))
        _same_result(res, ref)
        assert res.stats.unrecoverable == 0
        per_model = R.reassemble_shard(teng, res)
        for m in range(2):
            tree = teng.unflatten(per_model[m])
            for k, want in _truth(tp, failed, m).items():
                assert np.array_equal(tree[k].numpy(), want), (k, m)


def test_recover_from_jax_written_logs(copy_runs):
    jeng, _, jl, teng, tp, _ = copy_runs[("proactive", False)]
    logs = teng.logs_from_host_arrays(*(np.asarray(jl[k])
                                        for k in ("values", "ts", "valid")))
    for failed in range(4):
        res = R.recover_node(teng, logs,
                             ShardDirectory(4, teng.layout.n_buckets, 2),
                             failed_coord=(failed,))
        ref = JR.recover_node(jeng, jl, JDir(4, jeng.layout.n_buckets, 2),
                              failed_coord=(failed,))
        _same_result(res, ref)
    with pytest.raises(ValueError):
        teng.logs_from_host_arrays(np.asarray(jl["values"])[:1],
                                   np.asarray(jl["ts"]),
                                   np.asarray(jl["valid"]))


def test_bf16_ring_and_recovery_from_jax_logs(mesh8):
    """The JAX engine's default log dtype: the port's bf16 ring is ``==``
    the JAX ring, and the port recovers from the JAX-written bf16 logs."""
    jeng, _, jl, teng, _, tl = _run(mesh8, lambda x: x * 1.5 + 1.0,
                                    variant="proactive", coalescing=False,
                                    n_replicas=2, n_buckets=2, log_capacity=3,
                                    log_dtype="bfloat16")
    assert tl["values"].dtype == torch.bfloat16
    assert np.array_equal(tl["values"].float().numpy(),
                          np.asarray(jl["values"], np.float32))
    logs = teng.logs_from_host_arrays(*(np.asarray(jl[k])
                                        for k in ("values", "ts", "valid")))
    assert torch.equal(logs["values"], tl["values"])
    for failed in range(4):
        res = R.recover_node(teng, logs,
                             ShardDirectory(4, teng.layout.n_buckets, 2),
                             failed_coord=(failed,))
        ref = JR.recover_node(jeng, jl, JDir(4, jeng.layout.n_buckets, 2),
                              failed_coord=(failed,))
        assert set(res.shards) == set(ref.shards)
        for b, s in ref.shards.items():
            assert res.shards[b].ts == s.ts
            assert np.array_equal(res.shards[b].values.float().numpy(),
                                  np.asarray(s.values, np.float32))


def test_params_from_host_arrays(copy_runs):
    _, jp, _, teng, tp, _ = copy_runs[("baseline", True)]
    got = teng.params_from_host_arrays(jax.tree.map(np.asarray, jp))
    assert all(torch.equal(got[k], tp[k]) for k in tp)
    with pytest.raises(ValueError):
        teng.params_from_host_arrays({"w1": np.zeros((2, 2))})


def test_algorithm2_versions_match_jax(copy_runs):
    jeng, _, jl, teng, _, tl = copy_runs[("parallel", False)]
    host = R.host_index(tl)
    jnp_logs = {k: np.asarray(v) for k, v in jl.items()}
    for node in range(4):
        for rank in range(2):
            for b in range(teng.layout.n_buckets):
                port = R.algorithm2_versions(teng, host, (node,), rank, b)
                ref = JR.algorithm2_versions(jeng, jnp_logs, (node,), rank,
                                             b)
                assert [t for t, _ in port] == [t for t, _ in ref]
                for (_, slot), (_, vals) in zip(port, ref):
                    got = R.fetch_version(teng, tl, (node,), rank, slot, b)
                    assert np.array_equal(got.numpy(), vals)


def test_latest_version_wins(mesh8):
    """Recovery must return the newest validated step after the
    capacity-2 ring wrapped twice."""
    jeng, _, jl, teng, _, tl = _run(mesh8, lambda x: x + 1.0, n_steps=5,
                                    variant="proactive", coalescing=False,
                                    n_replicas=2, n_buckets=2,
                                    log_capacity=2)
    assert np.array_equal(tl["values"].numpy(), np.asarray(jl["values"]))
    res = R.recover_node(teng, tl, ShardDirectory(4, teng.layout.n_buckets,
                                                  2), failed_coord=(1,))
    assert res.shards and all(s.ts == 4 for s in res.shards.values())


def test_log_memory_layout(copy_runs):
    jeng, _, _, teng, _, _ = copy_runs[("proactive", True)]
    st_ = teng.log_struct()
    # (data, model, N_r, capacity, n_buckets, bucket_len)
    assert st_["values"].shape[:2] == (4, 2)
    assert st_["values"].shape[2] == 2       # N_r
    assert st_["ts"].shape == st_["valid"].shape
    for k, s in jeng.log_struct().items():
        assert tuple(s.shape) == st_[k].shape
    assert st_["values"].dtype == torch.float32
    assert st_["ts"].dtype == torch.int32 and st_["valid"].dtype == torch.bool


def test_layout_matches_jax_with_uneven_dims(mesh8):
    """Local shapes, bin packing and bucket length, GSPMD padding of
    uneven dimensions included (the layout only: the JAX package's
    ``shard_map`` takes no uneven blocks)."""
    shapes = {"a": (7, 5), "b": (10,), "c": (3, 9, 2), "d": (4, 4),
              "e": (6,)}
    jspecs = {"a": JP("data", "model"), "b": JP(("data", "model")),
              "c": JP(None, "data"), "d": JP("model"), "e": JP(None)}
    tspecs = {"a": P("data", "model"), "b": P(("data", "model")),
              "c": P(None, "data"), "d": P("model"), "e": P(None)}
    for nb in (1, 2, 3, 8):
        rep = dict(n_buckets=nb, log_dtype="float32")
        jeng = JEngine(JRC(**rep), jax_make_context(mesh8), jspecs,
                       {k: jnp.zeros(s) for k, s in shapes.items()})
        teng = ReplicationEngine(
            ReplicationConfig(**rep),
            make_context((4, 2), ("data", "model"), device="cpu"), tspecs,
            {k: torch.zeros(s) for k, s in shapes.items()})
        for f in ("local_sizes", "local_shapes", "bucket_of_leaf",
                  "leaves_in_bucket", "bucket_len", "n_buckets"):
            assert getattr(teng.layout, f) == getattr(jeng.layout, f), f


def test_local_blocks_follow_the_specs():
    ctx = make_context((4, 2), ("data", "model"), device="cpu")
    state = {k: torch.from_numpy(v) for k, v in _state().items()}
    eng = ReplicationEngine(ReplicationConfig(log_dtype="float32"), ctx,
                            TSPECS, state)
    for k, spec in TSPECS.items():
        blocks = eng.local_blocks(state[k], spec)
        for d in range(4):
            for m in range(2):
                sl = El._block_slices(tuple(state[k].shape), spec, ctx,
                                      {"data": d, "model": m})
                assert torch.equal(blocks[d, m], state[k][sl]), (k, d, m)


def test_writethrough_and_none_noop():
    ctx = make_context((4,), ("data",), device="cpu")
    for variant in ("none", "writethrough"):
        rep = ReplicationConfig(variant=variant)
        assert not rep.is_replicating
        eng = ReplicationEngine(rep, ctx, {"w": P("data")},
                                {"w": torch.zeros(8)})
        logs = eng.init_logs()
        before = {k: v.clone() for k, v in logs.items()}
        out, committed = eng.replicate({"w": torch.ones(8)}, logs, 0, "c")
        assert committed == "c"
        assert all(torch.equal(out[k], before[k]) for k in before)


# ---------------------------------------------------------------------------
# The cross-pod ring: (pod, data) joined into one ring of 4 nodes
# ---------------------------------------------------------------------------

POD_CASES = [(v, c, True) for v in VARIANTS for c in (True, False)] \
    + [("proactive", c, False) for c in (True, False)]


@pytest.fixture(scope="module")
def pod_runs(pod_mesh8):
    return {(v, c, x): _run(pod_mesh8, lambda t: t * 1.5 + 1.0, pod=True,
                            variant=v, coalescing=c, cross_pod_replicas=x,
                            n_replicas=2 if x else 1, n_buckets=2,
                            log_capacity=3)
            for v, c, x in POD_CASES}


@pytest.mark.parametrize("variant,coalescing,cross", POD_CASES)
def test_pod_mesh_log_ring_matches_jax(pod_runs, variant, coalescing,
                                       cross):
    """The port's ring on the (2, 2, 2) pod mesh is ``==`` the JAX
    engine's after three steps: with ``cross_pod_replicas`` over the
    joined (pod, data) ring of 4, numbered pod-major; without it each
    pod's own ring of 2 (N_r 1)."""
    jeng, _, jl, teng, _, tl = pod_runs[(variant, coalescing, cross)]
    assert teng.repl_axes == jeng.repl_axes
    assert teng.n_nodes == jeng.n_nodes == (4 if cross else 2)
    for k in ("values", "ts", "valid"):
        want = np.asarray(jl[k])
        assert tuple(tl[k].shape) == want.shape == teng.log_struct()[k].shape
        assert np.array_equal(tl[k].numpy(), want), k


def _recover_ring_node(teng, tl, coord):
    return R.recover_node(teng, tl, teng.shard_directory(),
                          failed_coord=coord)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("coalescing", [True, False])
def test_cross_pod_recover_each_ring_node(pod_runs, variant, coalescing):
    """Every ring node (pod, data) recovers ``==`` its true block of the
    state: the oracle of ``test_recover_exact_all_variants``, since the
    JAX package cannot recover over this ring (ROADMAP C5)."""
    _, _, _, teng, tp, tl = pod_runs[(variant, coalescing, True)]
    for ring in range(4):
        coord = teng.node_coord(ring)
        assert coord == divmod(ring, 2) and teng.ring_index(coord) == ring
        res = _recover_ring_node(teng, tl, coord)
        assert res.stats.unrecoverable == 0 and res.stats.failed_node == ring
        for s in res.shards.values():
            r = int(s.source.split(":")[1].split("@")[0])
            target = (ring + teng._offsets(s.bucket)[r]) % 4
            assert s.source == f"replica:{r}@node{target}"
        per_model = R.reassemble_shard(teng, res)
        for m in range(2):
            tree = teng.unflatten(per_model[m])
            for k, want in _truth(tp, ring, m).items():
                assert np.array_equal(tree[k].numpy(), want), (ring, k, m)


def test_pod_mesh_without_cross_pod_recovers_like_jax(pod_runs):
    """Without ``cross_pod_replicas`` each pod keeps its own ring, and
    the port's recovery on a pod mesh is the JAX package's: the same
    ``RecoveryResult`` for every (pod, data), and the true block."""
    for c in (True, False):
        jeng, _, jl, teng, tp, tl = pod_runs[("proactive", c, False)]
        for pod in range(2):
            for data in range(2):
                res = R.recover_node(teng, tl, teng.shard_directory(),
                                     failed_coord=(pod, data))
                ref = JR.recover_node(jeng, jl, JDir(2, jeng.layout.n_buckets,
                                                     1),
                                      failed_coord=(pod, data))
                _same_result(res, ref)
                assert res.stats.unrecoverable == 0
                tree = teng.unflatten(R.reassemble_shard(teng, res)[1])
                for k, want in _truth(tp, 2 * pod + data, 1).items():
                    assert np.array_equal(tree[k].numpy(), want), k


def test_reference_cannot_recover_over_joined_ring_contract(pod_runs):
    """ROADMAP C5, pinned: the JAX package replicates over the joined
    ring but its ``recover_node`` takes the data coordinate as the ring
    index and indexes the data axis (size 2) with a ring index, so it
    raises ``IndexError`` for every node. If this test fails, the
    reference has been fixed, and the port's recovery can be held
    ``==`` to it."""
    jeng, _, jl, _, _, _ = pod_runs[("proactive", False, True)]
    for pod in range(2):
        for data in range(2):
            with pytest.raises(IndexError):
                JR.recover_node(jeng, jl, JDir(4, jeng.layout.n_buckets, 2),
                                failed_coord=(pod, data))


def test_planted_data_index_fault_fails_the_shard_check(pod_runs,
                                                        monkeypatch):
    """Recovery that takes the data coordinate as the ring index, as the
    JAX package does, recovers pod 1's nodes from pod 0's logs: the
    shard check must see it."""
    _, _, _, teng, tp, tl = pod_runs[("proactive", False, True)]
    monkeypatch.setattr(teng, "ring_index", lambda coord: coord[-1])
    for data in range(2):
        res = _recover_ring_node(teng, tl, (1, data))
        tree = teng.unflatten(R.reassemble_shard(teng, res)[0])
        assert not np.array_equal(tree["w1"].numpy(),
                                  _truth(tp, 2 + data, 0)["w1"])


def test_ring_coordinates():
    """Ring index <-> (pod?, data): pod-major on the joined ring, the
    data coordinate otherwise; the joined ring needs pod and data
    adjacent, pod first."""
    w = {"w": torch.zeros(8, 4)}
    rep = ReplicationConfig(cross_pod_replicas=True, n_replicas=1)
    eng = ReplicationEngine(rep, make_context((2, 3, 2), POD_AXES,
                                              device="cpu"),
                            {"w": P(("pod", "data"))},
                            {"w": torch.zeros(12, 4)})
    assert eng.repl_axes == ("pod", "data") and eng.n_nodes == 6
    assert [eng.node_coord(r) for r in range(6)] == \
        [(0, 0), (0, 1), (0, 2), (1, 0), (1, 1), (1, 2)]
    assert [eng.ring_index(eng.node_coord(r)) for r in range(6)] == \
        list(range(6))
    with pytest.raises(ValueError):
        eng.node_coord(6)
    with pytest.raises(ValueError):
        eng.ring_index((1,))
    own = ReplicationEngine(dataclasses.replace(rep,
                                                cross_pod_replicas=False),
                            make_context((2, 4, 2), POD_AXES, device="cpu"),
                            {"w": P("data")}, w)
    assert own.repl_axes == ("data",) and own.n_nodes == 4
    assert own.node_coord(3, pod=1) == (1, 3) and own.ring_index((1, 3)) == 3
    flat = ReplicationEngine(rep, make_context((4, 2), ("data", "model"),
                                               device="cpu"),
                             {"w": P("data")}, w)
    assert flat.repl_axes == ("data",) and flat.node_coord(2) == (2,)
    with pytest.raises(ValueError, match="adjacent"):
        ReplicationEngine(rep, make_context((2, 2, 2),
                                            ("pod", "model", "data"),
                                            device="cpu"),
                          {"w": P("data")}, w)


def test_cross_pod_parity_ring_and_recovery(pod_mesh8):
    """Parity mode over the joined ring (``parity_group`` 2: groups of
    ring nodes {0, 1} and {2, 3}, holders outside the group): the ring
    is ``==`` the JAX engine's, and every ring node recovers its true
    block at the parity test's atol=1e-4."""
    state = {k: v for k, v in _state().items() if k != "scale"}
    jeng, jp, jl, teng, tp, tl = _run(
        pod_mesh8, lambda x: x * 1.25 + 0.5, state=state, pod=True,
        variant="proactive", n_replicas=1, n_buckets=2, log_capacity=2,
        mode="parity", parity_group=2, cross_pod_replicas=True)
    assert teng.parity_groups() == jeng.parity_groups() == [[0, 1], [2, 3]]
    for k in ("values", "ts", "valid"):
        assert np.array_equal(tl[k].numpy(), np.asarray(jl[k])), k
    specs = {k: POD_TSPECS[k] for k in tp}
    for ring in range(4):
        res = R.recover_node_parity(teng, tl, tp, specs,
                                    failed_coord=teng.node_coord(ring))
        assert res.stats.unrecoverable == 0 and res.stats.failed_node == ring
        per_model = R.reassemble_shard(teng, res)
        for m in range(2):
            tree = teng.unflatten(per_model[m])
            for k in ("w1", "w2"):
                np.testing.assert_allclose(tree[k].numpy(),
                                           _truth(tp, ring, m)[k], atol=1e-4)


@pytest.fixture(scope="module")
def parity_run(mesh8):
    state = {k: v for k, v in _state().items() if k != "scale"}
    return _run(mesh8, lambda x: x * 1.25 + 0.5, state=state,
                variant="proactive", n_replicas=1, n_buckets=2,
                log_capacity=2, mode="parity", parity_group=2)


@pytest.mark.parametrize("failed", [0, 2, 3])
def test_parity_mode_recovery(parity_run, failed):
    """Erasure-coded logs: lost shard = parity - survivors, held at the
    JAX test's atol=1e-4 (the group sum may run in another order)."""
    jeng, jp, jl, teng, tp, tl = parity_run
    assert teng.log_struct()["values"].shape[2] == 1   # one parity shard
    for k in ("ts", "valid"):
        assert np.array_equal(tl[k].numpy(), np.asarray(jl[k])), k
    np.testing.assert_allclose(tl["values"].numpy(), np.asarray(jl["values"]),
                               atol=1e-4)
    specs = {k: TSPECS[k] for k in tp}
    res = R.recover_node_parity(teng, tl, tp, specs, failed_coord=(failed,))
    ref = JR.recover_node_parity(jeng, jl, jp, {k: JSPECS[k] for k in jp},
                                 failed_coord=(failed,))
    assert res.stats.unrecoverable == 0
    assert dataclasses.astuple(res.stats) == dataclasses.astuple(ref.stats)
    for b, s in ref.shards.items():
        assert (res.shards[b].ts, res.shards[b].source) == (s.ts, s.source)
        np.testing.assert_allclose(res.shards[b].values.numpy(), s.values,
                                   atol=1e-4)
    per_model = R.reassemble_shard(teng, res)
    for m in range(2):
        tree = teng.unflatten(per_model[m])
        for k in ("w1", "w2"):
            np.testing.assert_allclose(tree[k].numpy(),
                                       _truth(tp, failed, m)[k], atol=1e-4)


def test_parity_holder_matches_jax(mesh8):
    jeng = JEngine(JRC(variant="proactive", n_replicas=1, mode="parity",
                       parity_group=2, n_buckets=4),
                   jax_make_context(mesh8), {"w": JP("data", "model")},
                   {"w": jnp.zeros((8, 8), jnp.float32)})
    teng = ReplicationEngine(
        ReplicationConfig(variant="proactive", n_replicas=1, mode="parity",
                          parity_group=2, n_buckets=4),
        make_context((4, 2), ("data", "model"), device="cpu"),
        {"w": P("data", "model")}, {"w": torch.zeros(8, 8)})
    assert teng.parity_groups() == jeng.parity_groups()
    for g in range(2):
        for b in range(teng.layout.n_buckets):
            h = teng.parity_holder(g, b)
            assert h == jeng.parity_holder(g, b)
            assert h // 2 != g            # never inside its own group


def test_bucket_pack_unpack_roundtrip():
    ctx = make_context((4, 2), ("data", "model"), device="cpu")
    state = {k: torch.from_numpy(v) for k, v in _state().items()}
    eng = ReplicationEngine(ReplicationConfig(n_buckets=3,
                                              log_dtype="float32"),
                            ctx, TSPECS, state)
    lay = eng.layout
    rng = np.random.default_rng(0)
    leaves = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
              for s in lay.local_shapes]
    buckets = torch.stack([eng.pack_bucket(leaves, b)
                           for b in range(lay.n_buckets)])
    assert buckets.shape == (lay.n_buckets, lay.bucket_len)
    for a, b in zip(leaves, eng.unpack(buckets)):
        assert torch.equal(a, b)


def test_install_recovered_shard_matches_jax(copy_runs):
    jeng, jp, jl, teng, tp, tl = copy_runs[("proactive", True)]
    res = R.recover_node(teng, tl, ShardDirectory(4, teng.layout.n_buckets,
                                                  2), failed_coord=(2,))
    ref = JR.recover_node(jeng, jl, JDir(4, jeng.layout.n_buckets, 2),
                          failed_coord=(2,))
    # install into a state whose failed node's blocks were wiped
    wiped = {k: v.clone() for k, v in tp.items()}
    wiped["w1"][4:6] = 0.0
    wiped["w2"][:, 4:6] = 0.0
    got = El.install_recovered_shard(wiped, TSPECS, teng, res, (2,))
    jwiped = {k: jax.device_put(jnp.asarray(v.numpy()),
                                NamedSharding(jeng.ctx.mesh, JSPECS[k]))
              for k, v in wiped.items()}
    want = JEl.install_recovered_shard(jwiped, JSPECS, jeng, ref, (2,))
    for k in tp:
        assert torch.equal(got[k], tp[k]), k
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k


def test_shard_directory_follows_the_engine_targets():
    """With coalescing the engine sends every bucket to bucket 0's
    targets; the plain ``ShardDirectory`` names per-bucket targets, so
    recovery over it loses buckets (as in the JAX package), while
    ``engine.shard_directory()`` recovers every one. Without coalescing
    the two directories are equal."""
    ctx = make_context((16,), ("data",), device="cpu")
    state = {f"f{i}": torch.arange(160 * 5, dtype=torch.float32)
             .reshape(160, 5) + i for i in range(10)}
    specs = {k: P("data", None) for k in state}
    for coalescing, lost in ((True, 4), (False, 0)):
        eng = ReplicationEngine(ReplicationConfig(log_dtype="float32",
                                                  coalescing=coalescing),
                                ctx, specs, state)
        logs, _ = eng.replicate(state, eng.init_logs(), 0, state)
        plain = ShardDirectory(16, 8, 3)
        res = R.recover_node(eng, logs, plain, failed_coord=(5,))
        assert res.stats.unrecoverable == lost
        d = eng.shard_directory()
        assert (d.to_json() == ShardDirectory(16, 8, 3).to_json()) \
            == (not coalescing)
        res = R.recover_node(eng, logs, d, failed_coord=(5,))
        assert res.stats.unrecoverable == 0
        got = eng.unflatten(R.reassemble_shard(eng, res)[0])
        assert all(torch.equal(got[k], v[50:60]) for k, v in state.items())

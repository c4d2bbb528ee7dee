"""The port's ReCXL mechanism and ``Trainer`` across ``torch.distributed``
ranks, on the CPU (``gloo``), against the JAX package.

Two worlds are spawned once for the module (``torch_dist_cases.py``):
2 and 4 ranks, each rank holding whole nodes of the (4 data x 2 model)
and (2 pod x 2 data x 2 model) contexts. Every rank returns its part of
each log ring, which must be ``==`` the JAX engine's ring on ``mesh8`` /
``pod_mesh8`` at that rank's nodes, for every variant with coalescing on
and off, for parity, and for the joined cross-pod ring. Every ring node
recovers ``==`` its true block and ``==`` the one-card port's
``RecoveryResult``. The data-parallel ``Trainer`` (the reduced run of
``test_torch_trainer.py``, from the JAX Trainer's initial parameters)
keeps its losses within 5e-4 of the JAX ``Trainer``'s and 1e-4
(relative; 1e-5 for an f32 copy) of the one-card port's, recovers a
failed node to the unfailed run's parameters bit for bit, and keeps
every rank's copy ``==``. Planted faults -- a cross-rank REPL sent backwards, one VAL
dropped, one rank keeping its own gradient -- each fail their check.
"""

import dataclasses
import os
import shutil
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as JP

import torch_dist_cases as cases
from repro.config import ReplicationConfig as JRC
from repro.core.replication import ReplicationEngine as JEngine
from repro.distributed.context import make_context as jax_make_context
from repro.distributed.context import mesh_context
from repro import config as JC
from repro.training.trainer import Trainer as JTrainer
from repro_torch.distributed.context import make_context, node_group

WORLDS = (2, 4)


def _jax_ring(mesh, pod, update, st, **rep):
    """The JAX engine's global ring after ``N_STEPS`` of ``update``."""
    sp = {k: JP(*cases.specs(pod)[k]) for k in st}
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
        for i in range(cases.N_STEPS):
            params, logs = step(params, logs, jnp.int32(i))
    return {k: np.asarray(v) for k, v in logs.items()}


def _jax_trainer(mesh8, workdir):
    """The JAX Trainer on ``cases.train_run()``'s configuration."""
    jrun = JC.RunConfig(
        model=JC.get_reduced_config("qwen3-0.6b"),
        shape=JC.ShapeConfig("smoke", seq_len=32, global_batch=8,
                             kind="train"),
        mesh=JC.MeshConfig(*cases.MESH8),
        replication=JC.ReplicationConfig(
            variant="proactive", n_replicas=2, n_buckets=4, log_capacity=2,
            dump_interval=6),
        train=JC.TrainConfig(total_steps=30, warmup_steps=2,
                             learning_rate=1e-3))
    run = cases.train_run()
    for f in ("shape", "replication", "train"):
        assert dataclasses.asdict(getattr(jrun, f)) == \
            dataclasses.asdict(getattr(run, f)), f
    return JTrainer(jrun, mesh8, workdir)


def _one_card(params0):
    """The one-card port's rings, recoveries and Trainer runs."""
    ctx = make_context(*cases.MESH8, device="cpu")
    pctx = make_context(*cases.POD_MESH8, device="cpu")
    out = {}
    for v in cases.VARIANTS:
        for c in (True, False):
            eng, _, logs = cases.ring_run(ctx, False, cases.copy_update,
                                          variant=v, coalescing=c,
                                          **cases.COPY)
            out[("recover", v, c)] = cases.recover_all(eng, logs)
    for v, c, x in cases.POD_CASES:
        if x:
            eng, _, logs = cases.ring_run(
                pctx, True, cases.copy_update, variant=v, coalescing=c,
                cross_pod_replicas=True, **cases.COPY)
            out[("pod_recover", v, c)] = cases.recover_all(eng, logs)
    from repro_torch.core import recovery as R
    from repro_torch.distributed.context import P
    st = {k: v for k, v in cases.state().items() if k != "scale"}
    eng, params, logs = cases.ring_run(ctx, False, cases.parity_update,
                                       st=st, **cases.PARITY)
    sp = {k: P(*cases.specs(False)[k]) for k in st}
    out["parity_recover"] = {
        f: cases.result_data(R.recover_node_parity(eng, logs, params, sp,
                                                   failed_coord=(f,)))
        for f in (0, 3)}
    out["parity_ring"] = cases.logs_data(logs)
    root = tempfile.mkdtemp()
    try:
        for name, fail, dtype in cases.TRAIN_RUNS:
            tr = cases.trainer(None, os.path.join(root, name), params0, fail,
                               dtype)
            hist = tr.train(cases.TRAIN_STEPS)
            tr.ckpt.wait()
            out[name] = {"losses": [h["loss"] for h in hist],
                         "params": cases.params_data(tr)}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


@pytest.fixture(scope="module")
def runs(mesh8, pod_mesh8):
    """Both worlds, spawned together; the JAX and one-card references
    are computed while they run."""
    root = tempfile.mkdtemp()
    try:
        jtr = _jax_trainer(mesh8, os.path.join(root, "jax"))
        # bf16 values, exact in f32 (the workers import no JAX dtypes)
        params0 = jax.tree.map(lambda x: np.asarray(x, np.float32),
                               jtr.state.params)
        handles = {}
        for w in WORLDS:
            os.makedirs(os.path.join(root, f"w{w}"))
            handles[w] = cases.start(w, os.path.join(root, f"w{w}"), params0)
        ref = {"jax_losses": [h["loss"] for h in
                              jtr.train(cases.TRAIN_STEPS)]}
        jtr.ckpt.wait()
        st = cases.state()
        for v in cases.VARIANTS:
            for c in (True, False):
                ref[("ring", v, c)] = _jax_ring(
                    mesh8, False, cases.copy_update, st, variant=v,
                    coalescing=c, **cases.COPY)
        ref["parity_ring"] = _jax_ring(
            mesh8, False, cases.parity_update,
            {k: v for k, v in st.items() if k != "scale"}, **cases.PARITY)
        for v, c, x in cases.POD_CASES:
            ref[("pod_ring", v, c, x)] = _jax_ring(
                pod_mesh8, True, cases.copy_update, st, variant=v,
                coalescing=c, cross_pod_replicas=x,
                **dict(cases.COPY, n_replicas=2 if x else 1))
        ref["one_card"] = _one_card(params0)
        got = {w: cases.finish(h, w, os.path.join(root, f"w{w}"))
               for w, h in handles.items()}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return ref, got


def _block(arr, starts, sizes):
    """A global ring's part at one rank's nodes."""
    return arr[tuple(slice(s, s + n) for s, n in zip(starts, sizes))]


def _rings_equal(got, want, starts, sizes):
    return all(np.array_equal(got[k], _block(want[k], starts, sizes))
               for k in ("values", "ts", "valid"))


def _same_result(got, want):
    assert got["failed"] == want["failed"]
    assert got["stats"] == want["stats"]
    assert got["messages"] == want["messages"]
    assert set(got["shards"]) == set(want["shards"])
    for b, (bucket, ts, src, vals) in want["shards"].items():
        g = got["shards"][b]
        assert (g[0], g[1], g[2]) == (bucket, ts, src)
        assert np.array_equal(g[3], vals)


def _truth(st, ring, m):
    """Ring node ``ring``'s true blocks at model coordinate ``m``."""
    return {"w1": st["w1"][2 * ring:2 * ring + 2, 3 * m:3 * m + 3],
            "w2": st["w2"][2 * m:2 * m + 2, 2 * ring:2 * ring + 2],
            "scale": st["scale"]}


def _final_state():
    st = cases.state()
    for _ in range(cases.N_STEPS):
        st = {k: cases.copy_update(v) for k, v in st.items()}
    return st


@pytest.mark.parametrize("world", WORLDS)
def test_ranks_hold_blocks_of_whole_nodes(runs, world):
    _, got = runs
    k = 4 // world
    for r, out in enumerate(got[world]):
        assert out["rank"] == r and not out["jax_imported"]
        assert out["local_starts"] == (r * k, 0)
        assert out["local_sizes"] == (k, 2)
        want = ((r, 0, 0), (1, 2, 2)) if world == 2 else \
            ((r // 2, r % 2, 0), (1, 1, 2))
        assert (out["pod_local_starts"], out["pod_local_sizes"]) == want


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("variant", cases.VARIANTS)
@pytest.mark.parametrize("coalescing", [True, False])
def test_ring_matches_jax(runs, world, variant, coalescing):
    ref, got = runs
    for out in got[world]:
        assert _rings_equal(out[("ring", variant, coalescing)],
                            ref[("ring", variant, coalescing)],
                            out["local_starts"], out["local_sizes"])


@pytest.mark.parametrize("world", WORLDS)
def test_parity_ring_matches_jax(runs, world):
    """The grouped psum and the forward to the holder: ``==`` the JAX
    ring (groups of 2: one f32 add, in either order)."""
    ref, got = runs
    for out in got[world]:
        assert _rings_equal(out["parity_ring"], ref["parity_ring"],
                            out["local_starts"], out["local_sizes"])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("failed", [0, 3])
def test_parity_recovery_matches_one_card(runs, world, failed):
    ref, got = runs
    want = ref["one_card"]["parity_recover"][failed]
    assert want["stats"][-1] == 0          # nothing unrecoverable
    for out in got[world]:
        _same_result(out["parity_recover"][failed], want)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("variant,coalescing,cross", cases.POD_CASES)
def test_pod_ring_matches_jax(runs, world, variant, coalescing, cross):
    """The joined (pod, data) ring across ranks, numbered pod-major, and
    each pod's own ring: ``==`` the JAX engine's on ``pod_mesh8``."""
    ref, got = runs
    key = ("pod_ring", variant, coalescing, cross)
    for out in got[world]:
        assert _rings_equal(out[key], ref[key], out["pod_local_starts"],
                            out["pod_local_sizes"])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("variant", cases.VARIANTS)
@pytest.mark.parametrize("coalescing", [True, False])
@pytest.mark.parametrize("pod", [False, True])
def test_every_node_recovers_exactly(runs, world, variant, coalescing, pod):
    """Every ring node, recovered on every rank: ``==`` the one-card
    port's ``RecoveryResult`` and its true blocks."""
    ref, got = runs
    key = ("pod_recover" if pod else "recover", variant, coalescing)
    truth = _final_state()
    for out in got[world]:
        for ring, (res, want) in enumerate(zip(out[key],
                                               ref["one_card"][key])):
            _same_result(res, want)
            assert res["stats"][-1] == 0 and res["stats"][0] == ring
            for m in range(2):
                for name, arr in _truth(truth, ring, m).items():
                    assert np.array_equal(res["tree"][m][name], arr)


#: the data-parallel losses against the one-card port's, relative: in
#: f32 the sums over ranks differ only in the order of f32 adds; in bf16
#: each rank's gradient is rounded to bf16 before the sum (the one-card
#: run rounds the whole batch's once), which moves AdamW's update by
#: about what separates the one-card port from the JAX Trainer (3e-5).
#: Measured on the CPU (gloo): bf16 3.26e-5 at W = 2 and 2.16e-5 at
#: W = 4; f32 7.77e-8 at W = 2 and 7.65e-8 at W = 4.
ONE_CARD_RTOL = {"float32": 1e-5, "bfloat16": 1e-4}


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_data_parallel_losses(runs, world, dtype):
    """bf16 (the reduced config) within 5e-4 of the JAX Trainer's losses
    on ``mesh8``, and both dtypes within ``ONE_CARD_RTOL`` of the
    one-card port's; the same on every rank."""
    ref, got = runs
    run = "unfailed" if dtype == "bfloat16" else "f32"
    one = ref["one_card"][run]["losses"]
    if dtype == "bfloat16":
        np.testing.assert_allclose(one, ref["jax_losses"], atol=5e-4,
                                   rtol=0)
    for out in got[world]:
        losses = out["train"][run]["losses"]
        assert losses == got[world][0]["train"][run]["losses"]
        if dtype == "bfloat16":
            np.testing.assert_allclose(losses, ref["jax_losses"],
                                       atol=5e-4, rtol=0)
        np.testing.assert_allclose(losses, one, rtol=ONE_CARD_RTOL[dtype],
                                   atol=0)


@pytest.mark.parametrize("world", WORLDS)
def test_rank_weight_is_the_token_share(runs, world):
    """Masked, a rank's loss weighs its share of the loss tokens (rank r
    holds r + 1 of them), so the sum over ranks is the global token
    mean, not the mean of the ranks' means; unmasked, 1 / world."""
    _, got = runs
    total = world * (world + 1) // 2
    for r, out in enumerate(got[world]):
        masked, plain = out["train"]["rank_weight"]
        assert masked == (r + 1) / total and plain == 1.0 / world


def _params_equal(a, b):
    return len(a) == len(b) and all(np.array_equal(x, y)
                                    for x, y in zip(a, b))


@pytest.mark.parametrize("world", WORLDS)
def test_ranks_keep_equal_parameters(runs, world):
    _, got = runs
    first = got[world][0]["train"]
    for out in got[world][1:]:
        for run in ("unfailed", "failed", "f32"):
            assert _params_equal(out["train"][run]["params"],
                                 first[run]["params"])


@pytest.mark.parametrize("world", WORLDS)
def test_failed_run_equals_unfailed(runs, world):
    """Node 2 fails at step 3; the Configuration Manager (node 0, rank
    0) recovers it from the replica logs, and the final parameters are
    the unfailed run's bit for bit."""
    _, got = runs
    step, node = cases.TRAIN_FAIL
    for out in got[world]:
        t = out["train"]
        assert _params_equal(t["failed"]["params"], t["unfailed"]["params"])
        rec = [e for e in t["failed"]["events"] if e["event"] == "recovery"]
        assert len(rec) == 1 and rec[0]["recovered"] == node
        assert rec[0]["step"] == step and rec[0]["cm"] == 0
        assert rec[0]["cm_rank"] == 0
        assert rec[0]["stats"]["unrecoverable"] == 0
        assert rec[0]["stats"]["recovered_from_replicas"] == 4


@pytest.mark.parametrize("world", WORLDS)
def test_each_rank_dumps_to_its_own_directory(runs, world):
    _, got = runs
    for r, out in enumerate(got[world]):
        t = out["train"]["unfailed"]
        assert t["dump_dirs"] == [f"rank{r:05d}"]
        assert [e["step"] for e in t["events"]
                if e["event"] == "mn_dump"] == [5]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("fault", ["repl_backwards", "val_dropped"])
def test_planted_collective_faults_fail_the_ring_check(runs, world, fault):
    ref, got = runs
    want = ref[("ring", "proactive", False)]
    bad = [not _rings_equal(out["planted"][fault], want,
                            out["local_starts"], out["local_sizes"])
           for out in got[world]]
    assert any(bad)
    if fault == "val_dropped":
        assert any(not out["planted"][fault]["valid"].all()
                   for out in got[world])


@pytest.mark.parametrize("world", WORLDS)
def test_planted_skipped_all_reduce_fails_the_parameter_check(runs, world):
    _, got = runs
    params = [out["train"]["skip_all_reduce"]["params"]
              for out in got[world]]
    assert not _params_equal(params[0], params[-1])
    assert all(_params_equal(params[0], p) for p in params[:-1])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("refusal", ["cuda_on_gloo", "world_not_dividing"])
def test_context_refusals(runs, world, refusal):
    _, got = runs
    for out in got[world]:
        assert out["refusals"][refusal].startswith("ValueError")


def test_no_group_context_is_the_one_card_context():
    ctx = make_context(*cases.MESH8, device="cpu")
    assert ctx.group is None and ctx.world == 1 and ctx.rank == 0
    assert ctx.local_sizes == (4, 2) and ctx.local_starts == (0, 0)
    assert ctx.nodes_per_rank == ctx.n_nodes == 4
    if not torch.cuda.is_available():      # no fallback to the CPU
        with pytest.raises(RuntimeError):
            make_context(*cases.MESH8, device="cuda")
        with pytest.raises(RuntimeError):
            node_group()

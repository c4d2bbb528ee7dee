"""Fault injection, detection and recovery of the port against the JAX
package -- the twin of ``tests/test_chaos.py``.

Any single injected fault -- shard loss, corrupted bank row, failed
host->device upload, worker-thread death -- detected mid-grid or
mid-query-stream is recovered in place, and the recovered results are
``==`` (every ``SimResult`` field but ``meta``) to the JAX package's
fault-free results on the same specs. The spare path re-places the
rebuilt rows at the same shapes, so it builds ZERO new tile programs;
the two rebuild sources (surviving replica block, Logging-Unit journal)
give byte-identical rows, equal to the JAX package's. With chaos off,
``k_replicas`` resolves to 1 and placement keys, bytes and program
counts are untouched. The port runs its logical shards on one card
(``device="cpu"`` here); the JAX side runs as its own tests run it.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import chaos as JC
from repro.core import retry as JR
from repro.core import simulator as JS
from repro_torch.core import chaos
from repro_torch.core import engine as E
from repro_torch.core import simulator as S
from repro_torch.core.chaos import ChaosConfig, IntegrityError
from repro_torch.core.retry import (
    PLACEMENT_RETRY,
    RetryExhausted,
    RetryPolicy,
    backoff_delays,
    retry_call,
)
from repro_torch.core.scenarios import chaos_grid, sweep_grid
from repro_torch.core.serving import ScenarioServer

N = 700
CPU = "cpu"
WORKLOAD_POOL = ("ycsb", "canneal", "barnes", "raytrace", "ocean_ncp")
SHARD_COUNTS = (1, 8)
FAULT_KINDS = ("shard-loss", "corrupt-row", "upload-failure",
               "kill-prefetch", "kill-warm")


def fields(r):
    return tuple(getattr(r, f.name) for f in dataclasses.fields(r)
                 if f.name != "meta")


def jax_specs(specs):
    return [JS.ScenarioSpec(**dataclasses.asdict(s)) for s in specs]


def assert_same(port, ref, ctx):
    assert len(port) == len(ref)
    for i, (a, b) in enumerate(zip(port, ref)):
        assert fields(a) == fields(b), (ctx, i, a.meta)


def fault_cfg(kind, n_shards, **kw):
    """One-fault ChaosConfig per differential axis value."""
    if kind == "shard-loss":
        return ChaosConfig(lose_shard=n_shards - 1, lose_at_dispatch=2, **kw)
    if kind == "corrupt-row":
        return ChaosConfig(corrupt_wv_row=0, **kw)
    if kind == "upload-failure":
        return ChaosConfig(upload_failures=2, **kw)
    if kind == "kill-prefetch":
        return ChaosConfig(kill_thread="prefetch", **kw)
    if kind == "kill-warm":
        return ChaosConfig(kill_thread="warm", **kw)
    raise AssertionError(kind)


def ragged_grid(seed: int, n: int = 8):
    """A small ragged mixed-SB grid (several tile signatures, so a
    mid-grid fault lands between differently-shaped tiles), drawn from
    a numpy seed."""
    rng = np.random.default_rng(seed)

    def pick(xs):
        return xs[int(rng.integers(len(xs)))]

    return [S.ScenarioSpec(
        pick(WORKLOAD_POOL), pick(S.CONFIGS), seed=int(rng.integers(2)),
        n_replicas=pick((None, 2, 3)), link_bw_gbps=pick((None, 40.0)),
        sb_size=pick((None, 48))) for _ in range(n)]


GRID = ragged_grid(1) + ragged_grid(2)


@pytest.fixture(scope="module")
def grid_ref():
    return JS.simulate_batch(jax_specs(GRID), n_stores=N)


# ---------------------------------------------------------------------------
# Engine: every fault x both data planes x 1 and 8 shards
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("plane", ("bank", "stacked"))
@pytest.mark.parametrize("n_shards", SHARD_COUNTS)
@pytest.mark.parametrize("kind", FAULT_KINDS)
def test_engine_faults_recover_equal_to_jax(kind, n_shards, plane,
                                            grid_ref):
    """A fault injected mid-grid recovers to results ``==`` the JAX
    package's fault-free results on every plane and shard count."""
    with chaos.inject(fault_cfg(kind, n_shards)) as cs:
        got = E.run_grid(GRID, n_stores=N, tile_cells=16,
                         n_shards=n_shards, data_plane=plane, device=CPU)
    assert_same(got, grid_ref, (kind, n_shards, plane))
    rep = cs.report()
    if kind == "shard-loss":
        assert rep["recoveries"], (kind, n_shards, plane)
        assert rep["recoveries"][0]["shard"] == n_shards - 1
        if plane == "bank" and n_shards > 1:
            assert rep["recoveries"][0]["source"] == "replica"
    if kind == "corrupt-row" and plane == "bank":
        assert rep["detection_dispatches"] is not None
    if kind == "upload-failure":
        assert rep["upload_retries"] == 2
    if kind.startswith("kill"):
        assert rep["threads_killed"]


def test_engine_shard_loss_zero_new_programs_on_spare_path():
    """Spare replacement re-places the SAME shapes: the recovery builds
    no tile program, and a steady-state re-run after it builds none
    either."""
    grid = chaos_grid()
    S.clear_sim_caches()
    ref = JS.simulate_batch(jax_specs(grid), n_stores=N)
    with chaos.inject(ChaosConfig(lose_shard=2, lose_at_dispatch=2)) as cs:
        warm = E.run_grid(grid, n_stores=N, tile_cells=16, n_shards=8,
                          device=CPU)
        assert_same(warm, ref, "warmup-with-loss")
        assert cs.report()["recoveries"][0]["source"] == "replica"
        assert E.bank_stats()["k_replicas"] == 2
        tc0 = E.trace_count()
        again = E.run_grid(grid, n_stores=N, tile_cells=16, n_shards=8,
                           device=CPU)
        assert_same(again, ref, "steady-after-recovery")
        assert E.trace_count() == tc0
    rec = cs.report()["recoveries"]
    assert len(rec) == 1 and rec[0]["mode"] == "spare"


def test_engine_recovery_builds_no_program():
    """The recovery itself, not only the re-run: with the k=2 programs
    built by a fault-free run, a run that loses a shard mid-grid builds
    zero programs."""
    grid = chaos_grid()
    E.run_grid(grid, n_stores=N, tile_cells=16, n_shards=8, k_replicas=2,
               device=CPU)
    tc0 = E.trace_count()
    with chaos.inject(ChaosConfig(lose_shard=5, lose_at_dispatch=2)) as cs:
        E.run_grid(grid, n_stores=N, tile_cells=16, n_shards=8, device=CPU)
    assert cs.report()["recoveries"][0]["shard"] == 5
    assert E.trace_count() == tc0


def test_engine_degraded_recovery():
    """No spare: the unfinished cells re-run on one shard fewer with the
    bank replicated -- exactly one new program per SB group, results
    ``==`` the JAX package's, and ``bank_stats()`` reports it."""
    grid = sweep_grid(workloads=("ycsb", "barnes"),
                      configs=("wb", "proactive"), n_replicas=(None, 2),
                      sb_sizes=(None, 48))
    ref = JS.simulate_batch(jax_specs(grid), n_stores=N)
    S.clear_sim_caches()
    E.run_grid(grid, n_stores=N, tile_cells=16, n_shards=8, k_replicas=2,
               device=CPU)
    tc0 = E.trace_count()
    with chaos.inject(ChaosConfig(lose_shard=0, lose_at_dispatch=1,
                                  recovery="degraded")) as cs:
        got = E.run_grid(grid, n_stores=N, tile_cells=16, n_shards=8,
                         device=CPU)
    assert_same(got, ref, "degraded")
    assert E.bank_stats()["degraded"] is True
    assert E.trace_count() - tc0 == 2          # SB 72 and SB 48
    assert all(r.meta["n_shards"] == 7 for r in got)
    rec = cs.report()["recoveries"]
    assert rec and rec[0]["mode"] == "degraded" \
        and rec[0]["source"] == "degraded-mesh"


def test_poisoned_tile_surfaces_with_context(monkeypatch):
    """A genuine (non-injected) prefetch failure surfaces promptly as
    :class:`EngineWorkerError` naming the stage and tile, and the engine
    serves the same grid fine right afterwards."""
    grid = [S.ScenarioSpec(w, c) for w in ("ycsb", "barnes")
            for c in ("wb", "proactive")]
    S.clear_sim_caches()
    real = E._prepare_cell

    def poisoned(spec, *a, **kw):
        if spec.workload == "barnes":
            raise ValueError("poisoned tile input")
        return real(spec, *a, **kw)

    monkeypatch.setattr(E, "_prepare_cell", poisoned)
    with pytest.raises(E.EngineWorkerError) as ei:
        E.run_grid(grid, n_stores=N, tile_cells=16, n_shards=1, device=CPU)
    assert ei.value.stage == "prefetch"
    assert ei.value.tile_no is not None
    assert "poisoned tile input" in str(ei.value)
    monkeypatch.setattr(E, "_prepare_cell", real)
    S.clear_sim_caches()
    assert_same(E.run_grid(grid, n_stores=N, tile_cells=16, n_shards=1,
                           device=CPU),
                JS.simulate_batch(jax_specs(grid), n_stores=N),
                "after-poison")


def test_worker_timeout_attributes_a_stalled_prefetch(monkeypatch):
    """``worker_timeout_s`` turns a wedged prefetch worker into a prompt
    :class:`EngineWorkerError` naming it."""
    import time
    grid = [S.ScenarioSpec("ycsb", "wb")]
    real = E._prepare_cell

    def slow(*a, **kw):
        time.sleep(1.0)
        return real(*a, **kw)

    monkeypatch.setattr(E, "_prepare_cell", slow)
    with pytest.raises(E.EngineWorkerError, match="worker_timeout_s"):
        E.run_grid(grid, n_stores=N, worker_timeout_s=0.05, device=CPU)
    assert "prefetch" in E.worker_heartbeats()


# ---------------------------------------------------------------------------
# Rebuild sources: replica block vs Logging-Unit journal
# ---------------------------------------------------------------------------


def journaled_bank(n_shards):
    base = sweep_grid(workloads=("ycsb", "canneal"), configs=S.CONFIGS)
    delta = sweep_grid(workloads=("barnes",), configs=("wb", "proactive"),
                       n_replicas=(2, 3))
    S.clear_sim_caches()
    bank = S.get_trace_bank(base, N, S.PAPER_CLUSTER)
    bank.enable_journal()
    bank.extend(delta)                    # journaled, un-acked diffs
    jbank = JS.get_trace_bank(jax_specs(base), N, JS.PAPER_CLUSTER)
    jbank.enable_journal()
    jbank.extend(jax_specs(delta))
    return bank, jbank


def test_journal_replay_equals_replica_rebuild_and_jax():
    """For every shard, the rows read back from the surviving replica
    block are byte-identical to the journal rebuild and to the JAX
    package's journal rebuild, and all pass the digests."""
    n_shards = 8
    bank, jbank = journaled_bank(n_shards)
    assert bank.journal_entries > 0
    _, dev = bank.sub_device_args(n_shards, device=CPU, k_replicas=2)
    local_cap = S.sub_bank_rows(bank.wv_rows, n_shards)
    for lost in range(n_shards):
        via_replica = chaos.replica_rebuild(
            dev, lost, n_shards=n_shards, k_replicas=2,
            local_cap=local_cap, wv_rows=bank.wv_rows)
        via_journal = chaos.journal_rebuild(bank, lost, n_shards)
        via_jax = JC.journal_rebuild(jbank, lost, n_shards)
        for name in ("w", "v", "pr_nc"):
            assert np.array_equal(via_replica[name], via_journal[name])
            assert via_journal[name].tobytes() == via_jax[name].tobytes()
        chaos.verify_rebuild(bank, via_replica, lost, n_shards)
        chaos.verify_rebuild(bank, via_journal, lost, n_shards)
    bad = {k: v.copy() for k, v in via_journal.items()}
    bad["w"][0, 0] += 1.0
    with pytest.raises(IntegrityError):
        chaos.verify_rebuild(bank, bad, n_shards - 1, n_shards)


def test_replica_rebuild_reads_only_the_survivor():
    """The port's own pin: with the lost shard's every block overwritten
    with NaN first, the replica rebuild still passes the digests -- it
    read the surviving shard's replica block and nothing of the lost
    shard's."""
    n_shards = 4
    bank, _ = journaled_bank(n_shards)
    _, dev = bank.sub_device_args(n_shards, device=CPU, k_replicas=2)
    local_cap = S.sub_bank_rows(bank.wv_rows, n_shards)
    for lost in range(n_shards):
        a, w, v, p = (t.clone() for t in dev)
        w[lost] = float("nan")
        v[lost] = float("nan")
        p[lost] = True
        rebuilt = chaos.replica_rebuild(
            (a, w, v, p), lost, n_shards=n_shards, k_replicas=2,
            local_cap=local_cap, wv_rows=bank.wv_rows)
        assert len(rebuilt["w"]) == len(chaos.owned_rows(
            lost, n_shards, bank.wv_rows))
        chaos.verify_rebuild(bank, rebuilt, lost, n_shards)
    # and the memoized placement was never touched
    assert not torch.isnan(dev[1]).any()


def test_replica_layout_digests_and_integrity_detection():
    """Replica-block geometry (block ``j`` of shard ``s`` holds the rows
    owned by ``(s - j) % n``), digests ``==`` the JAX package's,
    ``fetch_wv_row`` reads identical bytes off either block, and
    ``verify_rows`` catches a tampered row -- on a clone, never the
    memoized placement."""
    n_shards = 8
    grid = sweep_grid(workloads=("ycsb", "raytrace"), configs=S.CONFIGS)
    S.clear_sim_caches()
    bank = S.get_trace_bank(grid, N, S.PAPER_CLUSTER)
    k = 2
    a, w, v, p = bank.sub_bank_host(n_shards, k)
    p_loc = S.sub_bank_rows(bank.wv_rows, n_shards)
    assert w.shape == (n_shards, k * p_loc, N)
    for r in range(bank.wv_rows):
        owner, loc = r % n_shards, r // n_shards
        for j in range(k):
            s = (owner + j) % n_shards
            assert np.array_equal(w[s, j * p_loc + loc], bank.w[r]), (r, j)
        assert chaos.row_digest(bank.w[r]) == JC.row_digest(bank.w[r])
        assert chaos.row_digest(bank.pr_nc[r]) == \
            JC.row_digest(bank.pr_nc[r])
    assert w.nbytes == k * bank.sub_bank_host(n_shards, 1)[1].nbytes
    _, dev = bank.sub_device_args(n_shards, device=CPU, k_replicas=k)
    for r in (0, bank.wv_rows - 1):
        for j in range(k):
            got = chaos.fetch_wv_row(dev, r, n_shards=n_shards,
                                     local_cap=p_loc, block=j)
            for g, h in zip(got, (bank.w[r], bank.v[r], bank.pr_nc[r])):
                assert chaos.row_digest(g) == chaos.row_digest(h)
    chaos.verify_rows(bank, dev, range(bank.wv_rows),
                      n_shards=n_shards, local_cap=p_loc)
    with chaos.inject(ChaosConfig(corrupt_wv_row=1)) as cs:
        tampered = cs.tamper_bank(dev, n_shards=n_shards, k_replicas=k,
                                  local_cap=p_loc, wv_rows=bank.wv_rows)
        with pytest.raises(IntegrityError) as ei:
            chaos.verify_rows(bank, tampered, range(bank.wv_rows),
                              n_shards=n_shards, local_cap=p_loc)
        assert ei.value.rows == (1,)
        assert cs.report()["detection_dispatches"] == 0
    chaos.verify_rows(bank, dev, range(bank.wv_rows),
                      n_shards=n_shards, local_cap=p_loc)


# ---------------------------------------------------------------------------
# Chaos off: zero churn
# ---------------------------------------------------------------------------


def test_chaos_off_zero_churn():
    """With no chaos scope, ``k_replicas`` resolves to 1 and the
    placement key, resident bytes and program counts are the plain
    layout's -- resilience costs nothing until requested."""
    assert chaos.active() is None
    n_shards = 8
    for k in (None, 3):
        assert chaos.resolve_k_replicas(k, n_shards) == \
            JC.resolve_k_replicas(k, n_shards)
    assert chaos.resolve_k_replicas(None, n_shards) == 1
    with chaos.inject(ChaosConfig()):
        assert chaos.resolve_k_replicas(None, n_shards) == 2
        assert chaos.resolve_k_replicas(None, 1) == 1     # clamped
    grid = sweep_grid(workloads=("ycsb", "canneal"), configs=S.CONFIGS)
    S.clear_sim_caches()
    E.run_grid(grid, n_stores=N, tile_cells=16, n_shards=n_shards,
               device=CPU)
    stats = E.bank_stats()
    assert stats["k_replicas"] == 1
    assert stats["chaos"] is None
    assert stats["degraded"] is False
    bank = S.get_trace_bank(grid, N)
    dev = torch.device(CPU)
    assert S.sub_key(n_shards, 1, dev) in bank._device
    assert S.sub_key(n_shards, 2, dev) not in bank._device
    a, w, v, p = bank.sub_bank_host(n_shards, 1)
    assert stats["bank_dev_bytes"] == \
        a.nbytes + w.nbytes + v.nbytes + p.nbytes
    assert bank.journal_entries == 0


# ---------------------------------------------------------------------------
# Bounded retry (core.retry)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("describe", ["x", "tile 3 placement"])
def test_retry_backoff_equals_jax_and_capped(describe):
    pol = RetryPolicy(max_attempts=5, base_delay_s=0.010,
                      max_delay_s=0.025, jitter=0.5, seed=0)
    jpol = JR.RetryPolicy(max_attempts=5, base_delay_s=0.010,
                          max_delay_s=0.025, jitter=0.5, seed=0)
    d1 = list(backoff_delays(pol, describe))
    assert d1 == list(JR.backoff_delays(jpol, describe))
    assert d1 == list(backoff_delays(pol, describe))
    assert d1 != list(backoff_delays(pol, describe + "y"))
    assert len(d1) == pol.max_attempts - 1
    assert all(0 < d <= pol.max_delay_s * (1 + pol.jitter) for d in d1)
    assert dataclasses.asdict(PLACEMENT_RETRY) == \
        dataclasses.asdict(JR.PLACEMENT_RETRY)


def test_retry_call_recovers_and_exhausts():
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise chaos.UploadError("transient")
        return "ok"

    retries = []
    assert retry_call(flaky, policy=PLACEMENT_RETRY,
                      retryable=(chaos.UploadError,), describe="flaky",
                      on_retry=lambda n, e, d: retries.append(e)) == "ok"
    assert calls["n"] == 3 and len(retries) == 2

    def dead():
        raise chaos.UploadError("always")

    with pytest.raises(RetryExhausted) as ei:
        retry_call(dead, policy=PLACEMENT_RETRY,
                   retryable=(chaos.UploadError,), describe="dead-path")
    assert ei.value.attempts == PLACEMENT_RETRY.max_attempts
    assert "dead-path" in str(ei.value)
    assert isinstance(ei.value.last, chaos.UploadError)

    def bug():
        raise ValueError("logic bug")

    with pytest.raises(ValueError):
        retry_call(bug, policy=PLACEMENT_RETRY,
                   retryable=(chaos.UploadError,), describe="bug")


# ---------------------------------------------------------------------------
# Serving daemon: faults mid-query-stream
# ---------------------------------------------------------------------------


SERVE_WARM = sweep_grid(workloads=("ycsb", "raytrace"), configs=S.CONFIGS)
SERVE_NOVEL = sweep_grid(workloads=("barnes",),
                         configs=("baseline", "proactive"),
                         n_replicas=(2, 3))


@pytest.fixture(scope="module")
def novel_ref():
    return JS.simulate_batch(jax_specs(SERVE_NOVEL), n_stores=N)


@pytest.mark.parametrize("kind", ("shard-loss", "corrupt-row",
                                  "upload-failure", "kill-daemon"))
def test_server_faults_recover_equal_to_jax(kind, novel_ref):
    """Mid-query-stream faults: the server detects, recovers in place
    (keeping its padded capacity, so ZERO new programs), and every answer
    stays ``==`` the JAX package's oracle."""
    n_shards = 8
    S.clear_sim_caches()
    cfg = (ChaosConfig(kill_thread="daemon") if kind == "kill-daemon"
           else ChaosConfig(lose_shard=n_shards - 1, lose_at_dispatch=2)
           if kind == "shard-loss" else fault_cfg(kind, n_shards))
    with chaos.inject(cfg) as cs:
        with ScenarioServer(n_stores=N, n_shards=n_shards, batch_cells=16,
                            submit_timeout_ms=60_000, device=CPU) as srv:
            assert srv.k_replicas == 2
            srv.warm(SERVE_WARM)
            srv.reset_stats()
            if kind == "kill-daemon":
                futs = [srv.submit(s) for s in SERVE_NOVEL]
                got = [f.result(timeout=120) for f in futs]
            else:
                got = srv.query_batch(SERVE_NOVEL)
            assert_same(got, novel_ref, kind)
            stats = srv.stats()
            assert stats["compiled_programs"] == 0, kind
            if kind == "shard-loss":
                rec = cs.report()["recoveries"]
                assert rec and rec[0]["source"] == "replica"
                assert rec[0]["shard"] == n_shards - 1
                again = srv.query_batch(SERVE_NOVEL)
                assert_same(again, novel_ref, "steady")
                assert srv.stats()["compiled_programs"] == 0
            if kind == "corrupt-row":
                assert cs.report()["detection_dispatches"] is not None
            if kind == "kill-daemon":
                assert stats["worker_restarts"] >= 1


def test_server_shard_loss_in_stream_recovers_in_place(novel_ref):
    """Loss armed after the warm phase (``arm_after``, as the launcher
    does): one recovery from the replica block during the stream, the
    server's counters show it, zero new programs, answers ``==``."""
    with chaos.inject(ChaosConfig(lose_shard=3,
                                  lose_at_dispatch=1 << 30)) as cs:
        with ScenarioServer(n_stores=N, n_shards=4, batch_cells=16,
                            device=CPU) as srv:
            srv.warm(SERVE_WARM)
            srv.reset_stats()
            cs.arm_after(1)
            got = srv.query_batch(SERVE_NOVEL)
            stats = srv.stats()
    assert_same(got, novel_ref, "armed")
    assert stats["recoveries"] == 1 and stats["compiled_programs"] == 0
    assert cs.report()["recoveries"][0]["source"] == "replica"


def test_server_journal_acked_after_flush():
    """The Logging Unit retains un-dumped diffs only until the device
    dump is acknowledged at the end of a successful flush."""
    with chaos.inject(ChaosConfig()):
        S.clear_sim_caches()
        with ScenarioServer(n_stores=N, n_shards=2, batch_cells=16,
                            device=CPU) as srv:
            srv.warm(SERVE_WARM)
            assert srv.stats()["journal_entries"] == 0
            srv.query_batch(SERVE_NOVEL)
            assert srv.stats()["journal_entries"] == 0
            assert srv._bank.journal_enabled

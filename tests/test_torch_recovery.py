"""The port's SS VII-E recovery-time model against the JAX package's.

Twins of ``tests/test_recovery_time.py``. The scalar model is plain
Python floats in both packages and must be ``==`` field for field; the
batched model runs in f32 in both (the JAX package without x64) and is
held at the JAX test's ``rtol=1e-5``, on CPU tensors. ``recovery_sweep``
arrays and ``downtime_query`` estimates are held against the JAX
package's at the same comparisons.
"""

import dataclasses

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from repro.core import recovery as JR
from repro.core import scenarios as JSc
from repro_torch.configs.recxl_paper import PAPER_CLUSTER, WORKLOADS
from repro_torch.core import recovery as R
from repro_torch.core import scenarios as Sc
from repro_torch.core.contention import resolve_contention

owned_st = st.floats(min_value=1.0, max_value=1e7)
bytes_st = st.floats(min_value=0.0, max_value=1e9)
bw_st = st.floats(min_value=1.0, max_value=512.0)
factor_st = st.floats(min_value=1.1, max_value=16.0)


def _fields(est):
    return dataclasses.astuple(est) + (est.total_ns, est.total_ms)


# ---------------------------------------------------------------------------
# Scalar model: == the JAX package, and its properties
# ---------------------------------------------------------------------------

def test_scalar_model_equals_jax():
    rng = np.random.default_rng(0)
    for owned, undumped, bw, dscale in zip(rng.uniform(0, 1e7, 40),
                                           rng.uniform(0, 1e9, 40),
                                           rng.uniform(1, 512, 40),
                                           rng.uniform(1, 4, 40)):
        port = R.estimate_recovery_time(owned, undumped, link_bw_gbps=bw,
                                        dir_service_scale=dscale)
        ref = JR.estimate_recovery_time(owned, undumped, link_bw_gbps=bw,
                                        dir_service_scale=dscale)
        assert _fields(port) == _fields(ref)
    assert _fields(R.estimate_recovery_time(1000.0, 1e6)) == \
        _fields(JR.estimate_recovery_time(1000.0, 1e6))


@pytest.mark.parametrize("workload", sorted(WORKLOADS))
def test_workload_inputs_equal_jax(workload):
    from repro.core.contention import resolve_contention as jax_contention
    for t in (0.1, 1.0, 1.7, 5.3):
        for ncn in (4, 8, 16):
            for axes in ((None, None, None), (0.6, 0.2, "epoch"),
                         (None, 0.5, "eager")):
                port = R.workload_recovery_inputs(
                    workload, t, n_cns=ncn,
                    contention=resolve_contention(*axes))
                ref = JR.workload_recovery_inputs(
                    workload, t, n_cns=ncn, contention=jax_contention(*axes))
                assert port == ref


@given(owned_st, bytes_st, bw_st, factor_st)
@settings(max_examples=20, deadline=None)
def test_downtime_monotone_in_replay_volume(owned, undumped, bw, factor):
    base = R.estimate_recovery_time(owned, undumped, link_bw_gbps=bw)
    more_log = R.estimate_recovery_time(owned, undumped * factor + 1.0,
                                        link_bw_gbps=bw)
    more_owned = R.estimate_recovery_time(owned * factor, undumped,
                                          link_bw_gbps=bw)
    assert more_log.total_ns > base.total_ns
    assert more_log.replay_bytes > base.replay_bytes
    assert more_owned.total_ns > base.total_ns
    assert more_owned.replay_bytes > base.replay_bytes


@given(owned_st, bytes_st, bw_st, factor_st)
@settings(max_examples=20, deadline=None)
def test_downtime_inverse_monotone_in_bandwidth(owned, undumped, bw, factor):
    slow = R.estimate_recovery_time(owned, undumped, link_bw_gbps=bw)
    fast = R.estimate_recovery_time(owned, undumped,
                                    link_bw_gbps=bw * factor)
    assert fast.total_ns < slow.total_ns
    assert fast.log_scan_ns == slow.log_scan_ns
    assert fast.directory_ns == slow.directory_ns
    assert fast.replay_bytes == slow.replay_bytes


def test_estimate_phases_sum_and_validation():
    est = R.estimate_recovery_time(1000.0, 1e6)
    total = (est.detect_ns + est.quiesce_ns + est.directory_ns +
             est.log_scan_ns + est.fetch_ns + est.writeback_ns +
             est.resume_ns)
    assert est.total_ns == total
    assert est.total_ms == est.total_ns / 1e6
    for bad in (dict(link_bw_gbps=0.0), dict(dir_service_scale=0.5)):
        with pytest.raises(ValueError):
            R.estimate_recovery_time(1000.0, 1e6, **bad)
    with pytest.raises(ValueError):
        R.estimate_recovery_time(-1.0, 1e6)


def test_workload_inputs_periodic_and_weak_scaling():
    period = PAPER_CLUSTER.dump_period_ms
    o_early, u_early = R.workload_recovery_inputs("ycsb", 0.1 * period)
    o_late, u_late = R.workload_recovery_inputs("ycsb", 0.9 * period)
    o_wrap, u_wrap = R.workload_recovery_inputs("ycsb", 2.1 * period)
    assert o_early == o_late == o_wrap
    assert u_late > u_early
    np.testing.assert_allclose(u_wrap, u_early, rtol=1e-9)
    o16, u16 = R.workload_recovery_inputs("barnes", 1.0, n_cns=16)
    o4, u4 = R.workload_recovery_inputs("barnes", 1.0, n_cns=4)
    np.testing.assert_allclose(o4, 4.0 * o16, rtol=1e-9)
    np.testing.assert_allclose(u4, 4.0 * u16, rtol=1e-9)
    with pytest.raises(ValueError):
        R.workload_recovery_inputs("barnes", 1.0, n_cns=0)


# ---------------------------------------------------------------------------
# Batched model (f32) vs the JAX package and vs the scalar model
# ---------------------------------------------------------------------------

def _grid():
    rng = np.random.default_rng(0)
    return (rng.uniform(1.0, 1e6, (4, 3)), rng.uniform(0.0, 1e8, (4, 3)),
            rng.uniform(10.0, 160.0, (4, 3)), rng.uniform(1.0, 3.0, (3,)))


def test_batched_matches_jax():
    owned, undumped, bw, dscale = _grid()
    port = R.recovery_time_batch(owned, undumped, bw, dscale, device="cpu")
    ref = JR.recovery_time_batch(owned, undumped, bw, dscale)
    assert set(port) == set(ref)
    for k, v in ref.items():
        got = port[k].numpy()
        assert got.dtype == np.float32 and got.shape == (4, 3), k
        np.testing.assert_allclose(got, np.asarray(v), rtol=1e-5)


def test_batched_matches_scalar():
    owned, undumped, bw, _ = _grid()
    out = R.recovery_time_batch(owned, undumped, bw, device="cpu")
    for i in range(4):
        for j in range(3):
            est = R.estimate_recovery_time(owned[i, j], undumped[i, j],
                                           link_bw_gbps=bw[i, j])
            np.testing.assert_allclose(float(out["total_ns"][i, j]),
                                       est.total_ns, rtol=1e-5)
            np.testing.assert_allclose(float(out["replay_bytes"][i, j]),
                                       est.replay_bytes, rtol=1e-5)


# ---------------------------------------------------------------------------
# Recovery sweeps and single-cell queries vs the JAX package
# ---------------------------------------------------------------------------

SWEEP_AXES = [dict(), dict(conflict_rate=0.5, consistency_schedule="epoch"),
              dict(read_share=0.6, directory_load=0.4),
              dict(link_bw_gbps=PAPER_CLUSTER.cxl_link_bw_gbps / 4)]


@pytest.mark.parametrize("axes", SWEEP_AXES,
                         ids=["plain", "contention", "directory", "slow-link"])
def test_recovery_sweep_matches_jax(axes):
    kw = dict(workloads=("ycsb", "canneal", "streamcluster"),
              cn_counts=(4, 8, 16), **axes)
    port = Sc.recovery_sweep(device="cpu", **kw)
    ref = JSc.recovery_sweep(**kw)
    assert (port.workloads, port.fail_times_ms, port.cn_counts) == \
        (ref.workloads, ref.fail_times_ms, ref.cn_counts)
    assert port.total_ns.shape == (3, len(Sc.DEFAULT_FAIL_FRACS), 3)
    np.testing.assert_allclose(port.total_ns, ref.total_ns, rtol=1e-5)
    assert set(port.components) == set(ref.components)
    for k, v in ref.components.items():
        np.testing.assert_allclose(port.components[k], v, rtol=1e-5)
    mid = port.fail_times_ms[1]
    np.testing.assert_allclose(port.total_ms("ycsb", mid, 4),
                               ref.total_ms("ycsb", mid, 4), rtol=1e-5)


def test_sweep_monotone_axes():
    sweep = Sc.recovery_sweep(workloads=("ycsb", "canneal"), device="cpu")
    t = sweep.total_ns
    assert (np.diff(t, axis=1) > 0).all()       # later failure -> worse
    assert (np.diff(t, axis=2) < 0).all()       # more CNs -> better
    with pytest.raises(ValueError):
        Sc.recovery_sweep(workloads=("ycsb",), link_bw_gbps=0.0,
                          device="cpu")


@pytest.mark.parametrize("kw", [
    dict(), dict(n_cns=4), dict(n_replicas=2, link_bw_gbps=40.0),
    dict(conflict_rate=0.6), dict(consistency_schedule="eager"),
    dict(read_share=0.6, directory_load=0.7)])
def test_downtime_query_equals_jax(kw):
    for w in ("ycsb", "barnes"):
        for t in (0.25, 1.2):
            port = Sc.downtime_query(w, t, **kw)
            ref = JSc.downtime_query(w, t, **kw)
            assert _fields(port) == _fields(ref)

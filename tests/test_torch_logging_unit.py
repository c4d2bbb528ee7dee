"""The port's Logging Unit against the JAX package's.

Twins of ``tests/test_logging_unit.py`` on CPU tensors, and a seeded
random REPL / VAL / drain schedule with out-of-order VALs (and a small
SRAM, so REPLs are dropped too) run through both packages: every field
of the port's state must be ``==`` the JAX state after each operation.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import logging_unit as jlu
from repro_torch.core import logging_unit as lu


def _mk(sram=16, dram=64, sources=4, width=1):
    return lu.init_state(sram, dram, sources, width, device="cpu")


def _val(x):
    return torch.tensor([x], dtype=torch.float32)


def test_repl_allocates_entry():
    s = lu.receive_repl(_mk(), 1, 42, _val(7.0))
    assert int((s.sram_src != lu.EMPTY).sum()) == 1
    assert int(s.dropped) == 0


def test_val_before_drain_required():
    s = lu.receive_repl(_mk(), 1, 42, _val(7.0))
    s = lu.drain(s, 4)
    assert int(s.dram_ptr) == 0          # unvalidated entries never drain
    s = lu.drain(lu.receive_val(s, 1, 42, 0), 4)
    assert int(s.dram_ptr) == 1
    assert int(s.dram_addr[0]) == 42 and float(s.dram_val[0, 0]) == 7.0


def test_out_of_order_vals_commit_in_ts_order():
    s = _mk()
    s = lu.receive_repl(s, 2, 10, _val(1.0))   # will get ts=0
    s = lu.receive_repl(s, 2, 11, _val(2.0))   # will get ts=1
    s = lu.drain(lu.receive_val(s, 2, 11, 1), 4)
    assert int(s.dram_ptr) == 0          # ts=1 must wait for ts=0
    s = lu.drain(lu.receive_val(s, 2, 10, 0), 4)
    assert int(s.dram_ptr) == 2
    assert int(s.dram_ts[0]) == 0 and int(s.dram_ts[1]) == 1


def test_same_address_two_inflight_stores():
    s = _mk()
    s = lu.receive_repl(s, 0, 5, _val(1.0))
    s = lu.receive_repl(s, 0, 5, _val(2.0))
    s = lu.receive_val(s, 0, 5, 0)       # validates the OLDER entry
    s = lu.drain(lu.receive_val(s, 0, 5, 1), 4)
    assert int(s.dram_ptr) == 2
    assert float(s.dram_val[0, 0]) == 1.0 and float(s.dram_val[1, 0]) == 2.0


def test_sram_full_drops_counted():
    s = _mk(sram=2)
    for i in range(3):
        s = lu.receive_repl(s, 0, i, _val(float(i)))
    assert int(s.dropped) == 1


def test_latest_version_query_and_clear():
    s = _mk()
    for ts, val in [(0, 1.0), (1, 2.0), (2, 3.0)]:
        s = lu.receive_val(lu.receive_repl(s, 1, 99, _val(val)), 1, 99, ts)
    s = lu.drain(s, 8)
    found, ts, val = lu.latest_version(s, 1, 99)
    assert bool(found) and int(ts) == 2 and float(val[0]) == 3.0
    assert [int(x) for x in lu.occupancy(s)] == [0, 3]
    found, _, _ = lu.latest_version(lu.clear_dram(s), 1, 99)
    assert not bool(found)


def test_operations_leave_their_input_unchanged():
    s = _mk()
    before = [t.clone() for t in s]
    lu.drain(lu.receive_val(lu.receive_repl(s, 0, 1, _val(1.0)), 0, 1, 0), 2)
    assert all(torch.equal(a, b) for a, b in zip(before, s))


def test_first_index_wins_on_ties():
    """``argmax`` / ``argmin`` pick the first index on ties, as in JAX:
    the first free SRAM slot is allocated, the oldest same-(src, addr)
    entry is validated, the first eligible entry drains first."""
    s = _mk(sram=4)
    for addr in (7, 7, 8):
        s = lu.receive_repl(s, 1, addr, _val(float(addr)))
    s = s._replace(sram_src=torch.tensor([-1, 1, 1, 1], dtype=torch.int32),
                   sram_seq=torch.tensor([0, 5, 5, 5], dtype=torch.int32))
    s = lu.receive_repl(s, 3, 9, _val(9.0))
    assert int(s.sram_src[0]) == 3               # slot 0: first free
    s = lu.receive_val(s, 1, 7, 0)               # seq tie 5 / 5: slot 1
    assert s.sram_valid.tolist() == [False, True, False, False]
    found, ts, _ = lu.latest_version(_mk(), 0, 0)
    assert not bool(found) and int(ts) == -1


def test_no_host_sync_in_operations():
    """Branches are device selects: each operation returns tensors on
    the state's device, with no Python bool taken from them."""
    s = lu.receive_repl(_mk(sram=1), 0, 1, _val(1.0))
    s = lu.receive_repl(s, 0, 2, _val(2.0))      # full: dropped
    assert isinstance(s.dropped, torch.Tensor) and int(s.dropped) == 1


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("torch sees a CUDA device here")
    with pytest.raises(RuntimeError, match="CUDA"):
        lu.init_state(4, 4, 2)


# ---------------------------------------------------------------------------
# The port == the JAX package, field by field, after every operation
# ---------------------------------------------------------------------------

J_REPL = jax.jit(jlu.receive_repl)
J_VAL = jax.jit(jlu.receive_val)
J_DRAIN = jax.jit(jlu.drain, static_argnums=1)


def _schedule(seed, n_src=3, per_src=6, n_addr=3):
    """A random interleaving of REPLs and VALs, with drains between.

    Each source's stores get timestamps 0, 1, ... and random addresses.
    The interleaving keeps what the protocol guarantees -- a VAL comes
    after its REPL, and the REPLs (and the VALs) of one (src, addr) keep
    their order -- and reorders everything else, so one source's VALs
    for different addresses arrive out of timestamp order."""
    rng = np.random.default_rng(seed)
    tss = {}
    for src in range(n_src):
        for ts in range(per_src):
            tss.setdefault((src, int(rng.integers(n_addr))), []).append(ts)
    kinds = [(kind, key) for key, t in tss.items() for _ in t
             for kind in ("repl", "val")]
    kinds = [kinds[i] for i in rng.permutation(len(kinds))]
    n_repl = {key: 0 for key in tss}
    n_val = {key: 0 for key in tss}
    out, deferred = [], []

    def emit(kind, key, count):
        out.append((kind,) + key + (tss[key][count[key]],))
        count[key] += 1
        if rng.random() < 0.4:
            out.append(("drain", int(rng.integers(1, 4)), 0, 0))

    for kind, key in kinds:
        if kind == "repl":
            emit("repl", key, n_repl)
            if key in deferred:
                deferred.remove(key)
                emit("val", key, n_val)
        elif n_val[key] < n_repl[key]:
            emit("val", key, n_val)
        else:
            deferred.append(key)
    assert not deferred
    return out + [("drain", 64, 0, 0)]


def _assert_same(port, ref, ctx):
    for name, p, r in zip(lu.LogUnitState._fields, port, ref):
        r = np.asarray(r)
        assert p.shape == r.shape and np.array_equal(p.numpy(), r), \
            (ctx, name, p, r)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("sram", [64, 6])
def test_random_schedule_state_equals_jax(seed, sram):
    ts = lu.init_state(sram, 48, 3, 2, device="cpu")
    js = jlu.init_state(sram, 48, 3, 2)
    _assert_same(ts, js, "init")
    for i, (kind, src, addr, t) in enumerate(_schedule(seed)):
        if kind == "repl":
            value = np.asarray([src * 100.0 + t, addr + 0.5], np.float32)
            ts = lu.receive_repl(ts, src, addr, torch.from_numpy(value))
            js = J_REPL(js, src, addr, jnp.asarray(value))
        elif kind == "val":
            ts = lu.receive_val(ts, src, addr, t)
            js = J_VAL(js, src, addr, t)
        else:
            ts = lu.drain(ts, src)
            js = J_DRAIN(js, src)
        _assert_same(ts, js, (i, kind))
    for src in range(3):
        for addr in range(3):
            got = lu.latest_version(ts, src, addr)
            want = jlu.latest_version(js, src, addr)
            for g, w in zip(got, want):
                assert np.array_equal(g.numpy(), np.asarray(w))
    assert [int(x) for x in lu.occupancy(ts)] == \
        [int(x) for x in jlu.occupancy(js)]
    _assert_same(lu.clear_dram(ts), jlu.clear_dram(js), "clear")


@given(st.integers(0, 10_000))
@settings(max_examples=10, deadline=None)
def test_property_commit_order_and_no_loss(seed):
    sched = _schedule(seed)
    n_stores = sum(1 for e in sched if e[0] == "repl")
    s = lu.init_state(64, 128, 3, 2, device="cpu")
    for kind, src, addr, t in sched:
        if kind == "repl":
            s = lu.receive_repl(s, src, addr,
                                torch.tensor([src * 100.0 + t, 0.0]))
        elif kind == "val":
            s = lu.receive_val(s, src, addr, t)
        else:
            s = lu.drain(s, src)
    assert int(s.dropped) == 0
    n = int(s.dram_ptr)
    assert n == n_stores
    srcs, tss = s.dram_src[:n].numpy(), s.dram_ts[:n].numpy()
    for src in range(3):
        assert list(tss[srcs == src]) == list(range(int((srcs == src).sum())))

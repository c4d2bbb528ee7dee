"""The port's fault scenarios (Fig. 9: fail -> replay -> resume) against
the JAX package's.

``run_fault_scenario`` runs in both packages on a handful of scenarios
-- one per variant, the double failure, the ring-wrap case of
``tests/test_scenarios.py``, contention, directory load and a
straggler -- and every ``RecoveryCheck`` field, every field of its
downtime estimate and ``directory.to_json()`` must be ``==``. The state
after each step is ``==`` the JAX package's too: the port builds it the
way ``jnp`` does (see ``scenarios._scenario_params`` and
``_step_update``). The port's run of all 51 enumerated scenarios must
give the constants ``chip_smoke.py`` holds the card to.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import scenarios as JSc
from repro.core.failures import FailureEvent as JEvent
from repro.distributed.context import make_mesh
from repro_torch.core import scenarios as Sc
from repro_torch.core.failures import FailureEvent

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke  # noqa: E402

CASES = {
    "baseline": dict(events=((2, 1),), variant="baseline"),
    "parallel": dict(events=((4, 3),), variant="parallel"),
    "proactive": dict(events=((1, 0),), variant="proactive"),
    "double": dict(events=((1, 0), (4, 3))),
    "wrap": dict(events=((5, 2),), n_steps=7, coalescing=True,
                 log_capacity=2),
    "hot": dict(events=((2, 1),), conflict_rate=0.6),
    "eager": dict(events=((2, 1),), consistency_schedule="eager"),
    "dirload": dict(events=((3, 2),), directory_load=0.4, read_share=0.6),
    "straggler": dict(events=((1, 3, "straggler", 0.5), (3, 1)),
                      n_steps=5),
}


def _scenario(mod, event_cls, name, kw):
    kw = dict(kw)
    events = tuple(event_cls(*e[:2], *e[2:]) if len(e) > 2
                   else event_cls(step=e[0], node=e[1])
                   for e in kw.pop("events"))
    return mod.FaultScenario(name=name, events=events, **kw)


@pytest.fixture(scope="module")
def outcomes():
    out = {}
    for name, kw in CASES.items():
        port = Sc.run_fault_scenario(_scenario(Sc, FailureEvent, name, kw),
                                     device="cpu")
        ref = JSc.run_fault_scenario(_scenario(JSc, JEvent, name, kw))
        out[name] = (port, ref)
    return out


CHECK_FIELDS = ("node", "step", "exact", "newest_ts", "replay_idempotent",
                "directory_consistent", "unrecoverable")


@pytest.mark.parametrize("name", list(CASES))
def test_outcome_equals_jax(outcomes, name):
    port, ref = outcomes[name]
    assert port.all_invariants_hold and ref.all_invariants_hold
    assert (port.steps_run, port.failed_nodes, port.stragglers,
            port.resumed) == (ref.steps_run, ref.failed_nodes,
                              ref.stragglers, ref.resumed)
    assert len(port.checks) == len(ref.checks) >= 1
    for p, r in zip(port.checks, ref.checks):
        assert [getattr(p, f) for f in CHECK_FIELDS] == \
            [getattr(r, f) for f in CHECK_FIELDS]
        assert dataclasses.astuple(p.downtime) == \
            dataclasses.astuple(r.downtime)
        assert p.downtime_ns == r.downtime_ns > 0
        assert p.newest_ts == p.step
    assert port.total_downtime_ns == ref.total_downtime_ns
    assert port.directory.to_json() == ref.directory.to_json()


def test_contention_scales_downtime(outcomes):
    base = outcomes["proactive"][0].total_downtime_ns
    assert outcomes["hot"][0].checks[0].downtime_ns > \
        outcomes["eager"][0].checks[0].downtime_ns
    assert base > 0


def test_state_after_each_step_equals_jax():
    """The scenario's state bits: ``scale`` as ``jnp.linspace`` builds
    it, and ``x * 1.125 + 0.5`` as XLA contracts it into one FMA."""
    scn = Sc.FaultScenario(name="s", events=())
    mesh = make_mesh((4,), ("data",), devices=jax.devices()[:4])
    jp, _ = JSc._scenario_params(JSc.FaultScenario(name="s", events=()),
                                 mesh)
    tp, _ = Sc._scenario_params(scn, torch.device("cpu"))
    step = jax.jit(lambda p: jax.tree.map(lambda x: x * 1.125 + 0.5, p))
    for i in range(8):
        for k in tp:
            assert np.array_equal(tp[k].numpy(), np.asarray(jp[k])), (i, k)
        jp = step(jp)
        tp = {k: Sc._step_update(x) for k, x in tp.items()}
    assert not np.array_equal(
        torch.linspace(0.5, 1.5, 6).numpy(),
        np.asarray(jnp.linspace(0.5, 1.5, 6, dtype=jnp.float32)))


def test_enumerate_matches_jax():
    port = Sc.enumerate_fault_scenarios()
    ref = JSc.enumerate_fault_scenarios()
    assert len(port) == len(ref) == 3 * (4 * 4 + 1)
    for p, r in zip(port, ref):
        pd = dataclasses.asdict(p)
        rd = dataclasses.asdict(r)
        assert pd == rd


def test_all_51_scenarios_give_the_chip_constants():
    """The port on CPU tensors gives, for every enumerated scenario, the
    (newest_ts, downtime) constants recorded from the JAX package that
    ``chip_smoke.py`` checks on the card; a handful are re-derived from
    the JAX package here."""
    for scn in Sc.enumerate_fault_scenarios():
        out = Sc.run_fault_scenario(scn, device="cpu")
        assert out.all_invariants_hold, scn.name
        got = tuple((c.newest_ts, c.downtime_ns) for c in out.checks)
        assert got == chip_smoke.jax_fault_checks(scn.name), scn.name
    for scn in JSc.enumerate_fault_scenarios()[::12]:
        out = JSc.run_fault_scenario(scn)
        got = tuple((c.newest_ts, c.downtime_ns) for c in out.checks)
        assert got == chip_smoke.jax_fault_checks(scn.name), scn.name


def test_fault_scenario_validation():
    with pytest.raises(ValueError):
        Sc.FaultScenario(name="bad", events=(), variant="nosuch").validate()
    with pytest.raises(ValueError):
        Sc.FaultScenario(name="bad", events=(FailureEvent(step=1, node=9),)
                         ).validate()
    with pytest.raises(ValueError):
        Sc.FaultScenario(name="bad", events=(), n_replicas=4,
                         n_nodes=4).validate()
    with pytest.raises(ValueError):
        Sc.FaultScenario(name="bad", events=(), conflict_rate=3.0).validate()


def test_directory_references():
    out = Sc.run_fault_scenario(Sc.FaultScenario(
        name="d", events=(FailureEvent(step=2, node=1),)), device="cpu")
    assert not Sc.directory_references(out.directory, {1})
    fresh = type(out.directory)(4, 2, 2)
    assert Sc.directory_references(fresh, {1})

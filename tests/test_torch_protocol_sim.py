"""``python -m repro_torch.examples.protocol_sim``, the port's twin of
``examples/protocol_sim.py``, run on the CPU at a small size: its
slowdown table, geomeans and downtimes must be the JAX package's."""

import numpy as np

from repro.core import scenarios as JSc
from repro.core import simulator as JS
from repro_torch.examples import protocol_sim

N = 400


def test_protocol_sim_main_on_cpu(capsys):
    out = protocol_sim.main(["--n-stores", str(N), "--device", "cpu"])
    printed = capsys.readouterr().out
    assert out["table"] == JS.slowdowns_from_results(JS.simulate_batch(
        [JS.ScenarioSpec(w, c) for w in JS.WORKLOADS for c in JS.CONFIGS],
        n_stores=N))
    assert out["geomeans"] == JS.geomean_slowdowns(out["table"])
    sweep = JSc.recovery_sweep(cn_counts=(16,))
    for w, cells in out["downtime_ms"].items():
        want = [sweep.total_ms(w, t, 16) for t in sweep.fail_times_ms]
        np.testing.assert_allclose(cells, want, rtol=1e-5)
    assert "every field == the blocked scan's" in printed
    assert "ReCXL-proactive" in printed and "ycsb" in printed

"""The port stands alone and runs on the card unless asked otherwise.

* Importing every module of ``repro_torch`` (and ``chip_smoke.py``) in a
  fresh interpreter loads neither ``jax`` nor any ``repro`` module.
* Without a CUDA device, every public entry point called without
  ``device=`` raises instead of running on the CPU, and
  ``chip_smoke.py`` exits non-zero without printing its result line.
  These skip where torch sees a CUDA device.
* The kernel ops take their device from their tensors: a CPU tensor
  runs the plain version, and the CUDA route launches the kernel or
  raises -- it never gives way to the plain version.
"""

import os
import shutil
import subprocess
import sys

import pytest
import torch

from repro_torch.config import ReplicationConfig
from repro_torch.core import engine as TE
from repro_torch.core import logging_unit as TLU
from repro_torch.core import recovery as TR
from repro_torch.core import scenarios as TSc
from repro_torch.core import simulator as TS
from repro_torch.core.failures import FailureEvent
from repro_torch.core.replication import ReplicationEngine
from repro_torch.distributed.context import P, make_context
from repro_torch.kernels import log_compress as TLC
from repro_torch.kernels.log_compress import kernel as TLC_kernel
from repro_torch.kernels.log_compress import ops as TLC_ops

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SRC = os.path.join(ROOT, "src")
MODULES = [
    "repro_torch", "repro_torch.device", "repro_torch.configs",
    "repro_torch.configs.recxl_paper", "repro_torch.core",
    "repro_torch.core.hostcache", "repro_torch.core.telemetry",
    "repro_torch.core.replica_groups", "repro_torch.core.directory",
    "repro_torch.core.contention", "repro_torch.core.simulator",
    "repro_torch.core.engine", "repro_torch.core.scenarios",
    "repro_torch.kernels", "repro_torch.kernels.bank_scan",
    "repro_torch.kernels.bank_scan.ref", "repro_torch.kernels.bank_scan.kernel",
    "repro_torch.kernels.bank_scan.ops", "repro_torch.kernels.nvcc",
    "repro_torch.config", "repro_torch.core.protocol",
    "repro_torch.core.failures", "repro_torch.core.replication",
    "repro_torch.core.recovery", "repro_torch.core.logging_unit",
    "repro_torch.distributed", "repro_torch.distributed.context",
    "repro_torch.distributed.elastic", "repro_torch.kernels.log_compress",
    "repro_torch.kernels.log_compress.ref",
    "repro_torch.kernels.log_compress.kernel",
    "repro_torch.kernels.log_compress.ops", "chip_smoke",
]
SPECS = TSc.sweep_grid(workloads=("ycsb",), configs=("wb", "proactive"))


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([SRC, ROOT])
    return env


def test_imports_pull_in_no_jax_and_no_repro():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith(('jax.', 'jaxlib'))\n"
        "             or m == 'repro' or m.startswith('repro.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_sources_name_no_jax_or_repro_import():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for base, _, names in os.walk(os.path.join(SRC, "repro_torch")):
        files += [os.path.join(base, n) for n in names if n.endswith(".py")]
    for path in files:
        with open(path, encoding="utf-8") as fh:
            for line in fh:
                s = line.strip()
                assert not s.startswith(("import jax", "from jax",
                                         "import repro.", "from repro.",
                                         "from repro import")), (path, s)


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("torch sees a CUDA device here")


@pytest.mark.parametrize("entry", [
    lambda: TS.simulate_batch(SPECS, n_stores=50),
    lambda: TS.slowdown_table(n_stores=50),
    lambda: TE.run_grid(SPECS, n_stores=50),
    lambda: TE.simulate_grid(SPECS, n_stores=50),
    lambda: TSc.run_sweep(SPECS, n_stores=50),
    lambda: TS.get_trace_bank(SPECS, 50).device_args(),
    lambda: TS.get_trace_bank(SPECS, 50).sub_device_args(1),
    lambda: TSc.run_fault_scenario(TSc.FaultScenario(
        name="f", events=(FailureEvent(step=1, node=0),))),
    lambda: ReplicationEngine(ReplicationConfig(), make_context(
        (4,), ("data",)), {"w": P("data")}, {"w": torch.zeros(8)}),
    lambda: TSc.recovery_sweep(workloads=("ycsb",)),
    lambda: TR.recovery_time_batch(1.0, 1.0, 1.0),
    lambda: TLU.init_state(4, 4, 2),
], ids=["simulate_batch", "slowdown_table", "run_grid", "simulate_grid",
        "run_sweep", "device_args", "sub_device_args", "run_fault_scenario",
        "ReplicationEngine", "recovery_sweep", "recovery_time_batch",
        "logging_unit.init_state"])
def test_entry_points_default_to_cuda_and_raise(no_cuda, entry):
    with pytest.raises(RuntimeError, match="CUDA"):
        entry()


def test_kernel_ops_take_the_tensors_device(monkeypatch):
    """On tensors of torch's default device (the CPU here) compress and
    decompress run the plain version and count no launch; on a device
    other than CPU or CUDA they raise; and on the CUDA route a kernel
    that cannot be built or launched raises instead of giving way to the
    plain version."""
    v = torch.linspace(-1.0, 1.0, 600)
    before = (TLC.compress.launches, TLC.decompress.launches)
    codes, scales = TLC.compress(v, torch.zeros_like(v))
    out = TLC.decompress(codes, scales, torch.zeros_like(v), 600)
    assert out.device == v.device == codes.device
    assert (TLC.compress.launches, TLC.decompress.launches) == before
    with pytest.raises(ValueError):
        TLC.compress(v.to("meta"), v.to("meta"))

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(TLC_ops, "_route", lambda t, name: "cuda")
    monkeypatch.setattr(TLC_kernel, "load", no_nvcc)
    with pytest.raises(RuntimeError, match="nvcc"):
        TLC.compress(v, torch.zeros_like(v))
    with pytest.raises(RuntimeError, match="nvcc"):
        TLC.decompress(codes, scales, torch.zeros_like(v), 600)
    assert (TLC.compress.launches, TLC.decompress.launches) == before


def _run_chip_smoke(script, cwd):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, str(script)], env=env, cwd=cwd,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_fails_without_a_card(no_cuda, tmp_path):
    out = _run_chip_smoke(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_fails_alone(tmp_path):
    script = shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    out = _run_chip_smoke(script, tmp_path)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout

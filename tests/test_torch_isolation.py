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
from repro_torch.config import ShapeConfig, get_reduced_config
from repro_torch.kernels.flash_attn import kernel as FA_kernel
from repro_torch.kernels.flash_attn import ops as FA_ops
from repro_torch.kernels.ssd_scan import kernel as SSD_kernel
from repro_torch.kernels.ssd_scan import ops as SSD_ops
from repro_torch.core.serving import ScenarioServer
from repro_torch.examples import ycsb_kv as TYcsb
from repro_torch.launch import serve as TServe
from repro_torch.launch import serve_scenarios as TServeScenarios
from repro_torch.models import attention as TA
from repro_torch.models import build_model
from repro_torch.models import model_zoo as TMZ
from repro_torch.models import ssm as TSSM

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
    "repro_torch.kernels._tensor",
    "repro_torch.config", "repro_torch.core.protocol",
    "repro_torch.core.failures", "repro_torch.core.replication",
    "repro_torch.core.recovery", "repro_torch.core.logging_unit",
    "repro_torch.distributed", "repro_torch.distributed.context",
    "repro_torch.distributed.elastic", "repro_torch.kernels.log_compress",
    "repro_torch.kernels.log_compress.ref",
    "repro_torch.kernels.log_compress.kernel",
    "repro_torch.kernels.log_compress.ops", "repro_torch.configs.hymba_1_5b",
    "repro_torch.configs.qwen3_0_6b", "repro_torch.configs.mamba2_2_7b",
    "repro_torch.models", "repro_torch.models.layers",
    "repro_torch.models.attention", "repro_torch.models.ssm",
    "repro_torch.models.transformer", "repro_torch.models.model_zoo",
    "repro_torch.kernels.flash_attn", "repro_torch.kernels.flash_attn.ref",
    "repro_torch.kernels.flash_attn.kernel",
    "repro_torch.kernels.flash_attn.ops", "repro_torch.kernels.ssd_scan",
    "repro_torch.kernels.ssd_scan.ref", "repro_torch.kernels.ssd_scan.kernel",
    "repro_torch.kernels.ssd_scan.ops", "repro_torch.training",
    "repro_torch.training.steps", "repro_torch.launch",
    "repro_torch.launch.serve", "repro_torch.core.retry",
    "repro_torch.core.chaos", "repro_torch.core.serving",
    "repro_torch.launch.serve_scenarios", "repro_torch.models.moe",
    "repro_torch.configs.moonshot_v1_16b_a3b",
    "repro_torch.configs.grok1_314b", "repro_torch.configs.deepseek_67b",
    "repro_torch.configs.stablelm_12b", "repro_torch.configs.starcoder2_15b",
    "repro_torch.examples", "repro_torch.examples.ycsb_kv",
    "repro_torch.examples.protocol_sim", "chip_smoke",
]
SPECS = TSc.sweep_grid(workloads=("ycsb",), configs=("wb", "proactive"))
HYMBA = get_reduced_config("hymba-1.5b")
MOONSHOT = get_reduced_config("moonshot-v1-16b-a3b")


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
    lambda: build_model(HYMBA).init(0),
    lambda: build_model(HYMBA).init_cache(2, 8),
    lambda: TMZ.make_batch(HYMBA, ShapeConfig("s", 8, 2, "prefill")),
    lambda: TMZ.params_from_jax(HYMBA, {}),
    lambda: TServe.serve("hymba-1.5b", reduced=True, prompt_len=8, gen=2),
    lambda: ScenarioServer(n_stores=50),
    lambda: TE.run_grid(SPECS, n_stores=50, n_shards=2),
    lambda: TServeScenarios.main(["--stores", "50", "--queries", "2"]),
    lambda: build_model(MOONSHOT).init(0),
    lambda: TServe.serve("moonshot-v1-16b-a3b", reduced=True, prompt_len=8,
                         gen=2),
    lambda: TYcsb.main([]),
], ids=["simulate_batch", "slowdown_table", "run_grid", "simulate_grid",
        "run_sweep", "device_args", "sub_device_args", "run_fault_scenario",
        "ReplicationEngine", "recovery_sweep", "recovery_time_batch",
        "logging_unit.init_state", "build_model.init", "init_cache",
        "make_batch", "params_from_jax", "serve", "ScenarioServer",
        "run_grid_sharded", "serve_scenarios", "moe_build_model.init",
        "moe_serve", "ycsb_kv"])
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


def test_model_kernel_ops_never_fall_back(monkeypatch):
    """``flash_attention`` and ``ssd_scan`` on the CUDA route launch the
    kernel or raise: with the build failing they raise, count no launch,
    and never call their plain versions. On CPU tensors they run the
    plain version and count nothing."""
    q = torch.randn(1, 16, 2, 32)
    x, dt = torch.randn(1, 16, 2, 32), torch.rand(1, 16, 2) * 0.1
    A, B = -torch.ones(2), torch.randn(1, 16, 8)
    before = (FA_ops.flash_attention.launches, SSD_ops.ssd_scan.launches)
    FA_ops.flash_attention(q, q, q)
    SSD_ops.ssd_scan(x, dt, A, B, B, chunk=8)
    assert (FA_ops.flash_attention.launches,
            SSD_ops.ssd_scan.launches) == before

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    def plain_called(*args, **kwargs):
        raise AssertionError("the CUDA route called the plain version")

    monkeypatch.setattr(FA_ops, "_route", lambda t: "cuda")
    monkeypatch.setattr(SSD_ops, "_route", lambda t: "cuda")
    monkeypatch.setattr(FA_kernel, "load", no_nvcc)
    monkeypatch.setattr(SSD_kernel, "load", no_nvcc)
    monkeypatch.setattr(TA, "_blockwise_attention", plain_called)
    monkeypatch.setattr(TA, "_full_attention", plain_called)
    monkeypatch.setattr(TSSM, "ssd_chunked", plain_called)
    with pytest.raises(RuntimeError, match="nvcc"):
        FA_ops.flash_attention(q, q, q)
    with pytest.raises(RuntimeError, match="nvcc"):
        SSD_ops.ssd_scan(x, dt, A, B, B, chunk=8)
    assert (FA_ops.flash_attention.launches,
            SSD_ops.ssd_scan.launches) == before


def test_models_take_the_plain_paths_on_the_cpu(monkeypatch):
    """On CPU tensors the model's causal self-attention takes the JAX
    package's threshold path and never the kernel op (on the card,
    ``chip_smoke.py`` counts the kernel's launches per prefill)."""
    calls = []
    monkeypatch.setattr(FA_ops, "flash_attention",
                        lambda *a, **k: calls.append("flash") or a[0])
    q = torch.randn(1, 8, 2, 16)
    for blockwise in (False, True):
        out = TA._causal_self_attention(q, q, q, use_blockwise=blockwise)
        assert out.shape == q.shape
    assert calls == []


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

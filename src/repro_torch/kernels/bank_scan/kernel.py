"""Build and ctypes binding of the CUDA bank-scan kernel.

The kernel (``src/repro_torch/csrc/bank_scan.cu``) is compiled by hand
with ``nvcc`` for ``sm_90a`` into a shared library with a plain C
interface, at first use, into ``build/repro_torch/`` at the root of the
checkout (listed in ``.gitignore``). The file name carries a hash of the
source and the flags, so an edit rebuilds and an unchanged source loads
the library already built. Nothing here runs at import time: the CPU
tests import this module on machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional, Tuple

import torch

SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "bank_scan.cu"
BUILD_DIR = Path(__file__).resolve().parents[4] / "build" / "repro_torch"

#: No fast-math: ``--use_fast_math`` implies ``-ftz=true``, and the scan
#: must keep IEEE add and max to stay bit-identical.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
#: ``(library path, build seconds, compiler output)`` of the last
#: :func:`build`; seconds are 0.0 when the library was already built.
LAST_BUILD: Optional[Tuple[Path, float, str]] = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the bank_scan kernel")


def build() -> Path:
    """Compile the kernel library unless it is already built; returns
    its path and records :data:`LAST_BUILD`. Raises ``RuntimeError``
    with the compiler's output when ``nvcc`` fails."""
    global LAST_BUILD
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + repr(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"libbank_scan-{digest}.so"
    if out.exists():
        LAST_BUILD = (out, 0.0, "")
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    secs = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}) on {SOURCE}:\n"
                           f"{log}")
    os.replace(tmp, out)        # atomic: a concurrent loader sees all or nothing
    LAST_BUILD = (out, secs, log)
    return out


def load() -> ctypes.CDLL:
    """The loaded kernel library (built on the first call)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            lib.bank_scan_launch.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
            lib.bank_scan_launch.restype = ctypes.c_int
            lib.bank_scan_max_shared_sb.argtypes = []
            lib.bank_scan_max_shared_sb.restype = ctypes.c_int
            lib.bank_scan_error_string.argtypes = [ctypes.c_int]
            lib.bank_scan_error_string.restype = ctypes.c_char_p
            _LIB = lib
        return _LIB


def launch(a_bank: torch.Tensor, w_bank: torch.Tensor, v_bank: torch.Tensor,
           p_bank: torch.Tensor, trace_idx: torch.Tensor,
           wv_idx: torch.Tensor, sb: int
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the kernel on the current stream of the tensors' card.

    The caller (``ops.bank_scan``) has checked devices, dtypes, shapes
    and contiguity. Allocates the outputs and, for rings deeper than
    shared memory holds, the scratch ring. Raises ``RuntimeError`` on a
    non-zero launch status; does not synchronise."""
    lib = load()
    dev = a_bank.device
    n_lanes = int(trace_idx.shape[0])
    with torch.cuda.device(dev):
        out_c = torch.empty(n_lanes, dtype=torch.float32, device=dev)
        out_ah = torch.empty(n_lanes, dtype=torch.int32, device=dev)
        out_sf = torch.empty(n_lanes, dtype=torch.int32, device=dev)
        scratch = None
        if sb > lib.bank_scan_max_shared_sb():
            scratch = torch.empty(sb * n_lanes, dtype=torch.float32,
                                  device=dev)
        status = lib.bank_scan_launch(
            a_bank.data_ptr(), w_bank.data_ptr(), v_bank.data_ptr(),
            p_bank.data_ptr(), trace_idx.data_ptr(), wv_idx.data_ptr(),
            n_lanes, int(a_bank.shape[1]), int(a_bank.shape[0]),
            int(w_bank.shape[0]), int(sb),
            scratch.data_ptr() if scratch is not None else None,
            out_c.data_ptr(), out_ah.data_ptr(), out_sf.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if status != 0:
        msg = lib.bank_scan_error_string(status).decode()
        raise RuntimeError(f"bank_scan launch failed: CUDA error {status} "
                           f"({msg}) at lanes={n_lanes} sb={sb}")
    return out_c, out_ah, out_sf

"""Build-and-load of the port's CUDA libraries, shared by every kernel.

Each kernel's source under ``src/repro_torch/csrc`` is compiled by hand
with ``nvcc`` for ``sm_90a`` into a shared library with a plain C
interface, at first use, into ``build/repro_torch/`` at the root of the
checkout (listed in ``.gitignore``), and loaded with ``ctypes``. A
library's file name is ``lib<name>-<hash>.so``, the hash taken over its
own source and flags, so an edit rebuilds it and an unchanged source
loads the library already built. Nothing here runs at import time: the
CPU tests import the kernel modules on machines without ``nvcc``.
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
from typing import Callable, Optional, Tuple

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
CSRC = Path(__file__).resolve().parents[1] / "csrc"

#: No fast-math: ``--use_fast_math`` implies ``-ftz=true`` and approximate
#: division, and every kernel here must keep IEEE arithmetic (and
#: subnormals) to stay bit-identical to its plain version.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


def nvcc() -> str:
    """Path of the CUDA compiler: ``$CUDA_HOME``, ``PATH``, then
    ``/usr/local/cuda``."""
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
                       "to build the port's CUDA kernels")


class CudaLibrary:
    """One ``.cu`` source built into one shared library and loaded once.

    ``bind(lib)`` declares the ``argtypes`` / ``restype`` of the
    library's C functions right after it is loaded. ``last_build`` is
    ``(library path, build seconds, compiler output)`` of the last
    :meth:`build`; seconds are 0.0 when the library was already built.
    """

    def __init__(self, name: str, bind: Callable[[ctypes.CDLL], None]):
        self.name = name
        self.source = CSRC / f"{name}.cu"
        self._bind = bind
        self._lock = threading.Lock()
        self._lib: Optional[ctypes.CDLL] = None
        self.last_build: Optional[Tuple[Path, float, str]] = None

    def path(self) -> Path:
        digest = hashlib.sha256(self.source.read_bytes()
                                + repr(NVCC_FLAGS).encode()).hexdigest()[:16]
        return BUILD_DIR / f"lib{self.name}-{digest}.so"

    def build(self) -> Path:
        """Compile the library unless it is already built; returns its
        path. Raises ``RuntimeError`` with the compiler's output when
        ``nvcc`` fails."""
        out = self.path()
        if out.exists():
            self.last_build = (out, 0.0, "")
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}."
                            f"{threading.get_ident()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                               str(self.source)],
                              capture_output=True, text=True)
        secs = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed ({proc.returncode}) on "
                               f"{self.source}:\n{log}")
        os.replace(tmp, out)    # atomic: a concurrent loader sees all or nothing
        self.last_build = (out, secs, log)
        return out

    def load(self) -> ctypes.CDLL:
        """The loaded library (built on the first call)."""
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(self.build()))
                self._bind(lib)
                self._lib = lib
            return self._lib


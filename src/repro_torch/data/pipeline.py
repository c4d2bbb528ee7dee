"""Deterministic, host-sharded synthetic token pipeline.

A copy of the JAX package's ``data/pipeline.py`` (numpy throughout),
with the port's ``batch_struct``. Production shape without production
data: the pipeline is seeded per (seed, step), supports exact resume
from a step index (a fault-tolerance requirement: after recovery the
pipeline must replay from the restored step), and can build batches on
a prefetch thread, off the critical path.

Synthetic sequences are Zipf-ish token draws with a repeated-ngram
structure so losses actually decrease in the examples (pure uniform
tokens give a flat loss).

Batches are numpy arrays, ``==`` the JAX package's for the same
``(seed, step)``; the trainer moves them to its device. numpy has no
bfloat16, so a bf16 stub input (``frames``, ``patch_embeds``) comes as
an f32 array holding the bf16 values the JAX package's cast gives
(round to nearest even), which the move to the device casts exactly.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.config import ModelConfig, ShapeConfig
from repro_torch.models.model_zoo import batch_struct


@dataclasses.dataclass
class PipelineState:
    step: int
    seed: int


def _as_numpy_dtype(x: np.ndarray, dtype: torch.dtype) -> np.ndarray:
    """``x`` in ``dtype``; bf16 as f32 holding the rounded values."""
    t = torch.from_numpy(x).to(dtype)
    return (t.float() if dtype == torch.bfloat16 else t).numpy()


class SyntheticTokenPipeline:
    def __init__(self, model_cfg: ModelConfig, shape: ShapeConfig,
                 seed: int = 0, prefetch: int = 2):
        self.cfg = model_cfg
        self.shape = shape
        self.seed = seed
        self.state = PipelineState(step=0, seed=seed)
        self._structs = batch_struct(model_cfg, shape)
        self._q: "queue.Queue[Dict[str, np.ndarray]]" = queue.Queue(prefetch)
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # ------------------------------------------------------------------
    def _make(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, step))
        out: Dict[str, np.ndarray] = {}
        v = self.cfg.vocab_size
        for name, spec in self._structs.items():
            if name == "labels":
                continue
            if not spec.dtype.is_floating_point:
                b, s = spec.shape
                # zipf-flavored draws + embedded repeats for learnability
                base = rng.zipf(1.3, size=(b, s)).astype(np.int64) % v
                ngram = rng.integers(0, v, (b, 8))
                pos = rng.integers(0, max(s - 8, 1), (b,))
                for i in range(b):
                    base[i, pos[i]:pos[i] + 8] = ngram[i, : min(8, s - pos[i])]
                out[name] = base.astype(np.int32)
            else:
                out[name] = _as_numpy_dtype(
                    rng.standard_normal(spec.shape) * 0.02, spec.dtype)
        if "labels" in self._structs:
            toks = out["tokens"]
            out["labels"] = np.concatenate(
                [toks[:, 1:], toks[:, :1]], axis=1).astype(np.int32)
        return out

    # ------------------------------------------------------------------
    def start(self) -> None:
        if self._thread is not None:
            return

        def worker():
            step = self.state.step
            while not self._stop.is_set():
                batch = self._make(step)
                while not self._stop.is_set():
                    try:
                        self._q.put(batch, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                step += 1

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        self._stop.clear()
        while not self._q.empty():
            self._q.get_nowait()

    # ------------------------------------------------------------------
    def next(self) -> Dict[str, np.ndarray]:
        if self._thread is not None:
            batch = self._q.get()
        else:
            batch = self._make(self.state.step)
        self.state.step += 1
        return batch

    def seek(self, step: int) -> None:
        """Exact resume: replay the pipeline from ``step`` (post-recovery)."""
        running = self._thread is not None
        if running:
            self.stop()
        self.state.step = step
        if running:
            self.start()

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.next()


def make_pipeline(model_cfg: ModelConfig, shape: ShapeConfig,
                  seed: int = 0) -> SyntheticTokenPipeline:
    return SyntheticTokenPipeline(model_cfg, shape, seed)

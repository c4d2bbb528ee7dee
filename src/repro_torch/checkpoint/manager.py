"""The Memory-Node (MN) tier: durable checkpoints + periodic log dumps.

The JAX package's ``checkpoint/manager.py`` over the port's trees (dicts,
lists under ``layers``; tensors, numpy arrays or Python scalars as
leaves). Paper mapping: the MNs are the fault-safe tier the Logging
Units dump compressed logs into every 2.5 ms; here the MN tier is a
directory of npz files written by a background thread (async, off the
step's critical path), plus the dumped log entries recovery reads when
the replica logs do not cover a bucket.

Layout (one manifest per committed checkpoint, written last -- a torn
dump is detected by a missing manifest):

    <dir>/step_000000123/
        manifest.json            # step, leaf names/shapes/dtypes, extra
        state.npz                # flat state leaves
        logdump_b<k>.npz         # per-bucket log dump (optional)

Leaf names are the tree paths, e.g. ``params/layers/3/attn/wq``. The
state is copied to host memory before the write goes async, so the
next step may overwrite it in place. numpy has no bfloat16: a bf16 leaf
is stored bit-exactly as its ``uint16`` view, with its true dtype in the
manifest, and ``restore`` views it back. A ``sharding.Shard`` leaf (a
rank's block, across ranks that split the ``model`` axis) is stored as
its ``local`` block, the manifest keeping its spec and the global shape;
``restore`` into a template ``Shard`` checks both and gives the template
with the stored block.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.distributed.context import P
from repro_torch.distributed.sharding import Shard
from repro_torch.optim.optimizers import tree_rebuild

#: torch dtypes numpy cannot hold, stored as an unsigned view of their bits
_VIEWS = {torch.bfloat16: (torch.int16, np.uint16)}


def _named_leaves(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """``(path, leaf)`` pairs in ``jax.tree.flatten`` order: dicts by
    sorted key, lists and tuples in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _named_leaves(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [x for i, t in enumerate(tree)
                for x in _named_leaves(t, f"{prefix}{i}/")]
    return [(prefix[:-1], tree)]


def _spec_json(spec: P) -> list:
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def _shard_info(leaf: Any) -> Optional[Dict[str, Any]]:
    """What the manifest keeps of a ``Shard`` leaf besides its block."""
    if not isinstance(leaf, Shard):
        return None
    return {"spec": _spec_json(leaf.spec), "global_shape": list(leaf.shape)}


def _to_host(leaf: Any) -> Tuple[np.ndarray, str]:
    """A leaf as a host numpy array to store, and its true dtype's name
    (a ``Shard``: its block's)."""
    if isinstance(leaf, Shard):
        return _to_host(leaf.local)
    if isinstance(leaf, torch.Tensor):
        # a copy: a host tensor's .cpu() would share the caller's storage
        t = leaf.detach().cpu() if leaf.is_cuda else leaf.detach().clone()
        if t.dtype in _VIEWS:
            signed, unsigned = _VIEWS[t.dtype]
            arr = t.view(signed).numpy().view(unsigned)
        else:
            arr = t.numpy()
        return arr, str(t.dtype).replace("torch.", "")
    arr = np.array(leaf)
    return arr, arr.dtype.name


def _from_host(arr: np.ndarray, template: Any,
               info: Optional[Dict[str, Any]] = None) -> Any:
    """``arr`` back in the type, dtype, shape and device of ``template``;
    a ``Shard`` template gets the block, after its spec and global shape
    are checked against the manifest's ``info``."""
    if isinstance(template, Shard):
        if info != _shard_info(template):
            raise ValueError(f"the stored block is of {info}, the template "
                             f"of {_shard_info(template)}")
        return dataclasses.replace(template,
                                   local=_from_host(arr, template.local))
    if isinstance(template, torch.Tensor):
        if template.dtype in _VIEWS:
            signed, _ = _VIEWS[template.dtype]
            t = torch.from_numpy(np.ascontiguousarray(arr)).view(signed)
            t = t.view(template.dtype)
        else:
            t = torch.from_numpy(np.array(arr)).to(template.dtype)
        return t.reshape(template.shape).to(template.device)
    if isinstance(template, np.ndarray):
        return np.asarray(arr, dtype=template.dtype).reshape(template.shape)
    return type(template)(arr.item())


class CheckpointManager:
    """The MN tier under ``directory``; with ``rank`` (a data-parallel
    run), this rank's own part, ``<directory>/rank<rank>``: each rank
    dumps what it holds and restores from its own directory."""

    def __init__(self, directory: str, keep: int = 3,
                 rank: Optional[int] = None):
        if rank is not None:
            directory = os.path.join(directory, f"rank{int(rank):05d}")
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._last_saved_step = -1
        self._lock = threading.Lock()
        #: seconds the last write to disk took (async: off the step)
        self.last_write_s: Optional[float] = None

    # ------------------------------------------------------------------
    # Save (async by default -- the MN dump is off the critical path)
    # ------------------------------------------------------------------

    def save(self, step: int, state: Any, *,
             extra: Optional[Dict[str, Any]] = None,
             log_dump: Optional[Dict[int, np.ndarray]] = None,
             blocking: bool = False) -> None:
        # snapshot to host BEFORE going async (the next step updates the
        # state in place)
        leaves = [(n,) + _to_host(x) + (_shard_info(x),)
                  for n, x in _named_leaves(state)]
        extra = dict(extra or {})

        def write():
            t0 = time.perf_counter()
            path = os.path.join(self.dir, f"step_{step:09d}")
            tmp = tempfile.mkdtemp(dir=self.dir, prefix=".tmp_")
            try:
                np.savez(os.path.join(tmp, "state.npz"),
                         **{n: a for n, a, _, _ in leaves})
                if log_dump:
                    for b, arr in log_dump.items():
                        np.savez(os.path.join(tmp, f"logdump_b{b}.npz"),
                                 values=arr)
                manifest = {
                    "step": step,
                    "leaves": [dict({"name": n, "shape": list(a.shape),
                                     "dtype": dt},
                                    **({"shard": sh} if sh else {}))
                               for n, a, dt, sh in leaves],
                    "extra": extra,
                    "wall_time": time.time(),
                }
                with open(os.path.join(tmp, "manifest.json"), "w") as f:
                    json.dump(manifest, f)
                if os.path.exists(path):
                    shutil.rmtree(path, ignore_errors=True)
                os.rename(tmp, path)
            finally:
                if os.path.exists(tmp):
                    shutil.rmtree(tmp, ignore_errors=True)
            with self._lock:
                self._last_saved_step = max(self._last_saved_step, step)
            self._gc()
            self.last_write_s = time.perf_counter() - t0

        if blocking:
            write()
        else:
            self.wait()
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    # ------------------------------------------------------------------
    # Restore
    # ------------------------------------------------------------------

    def steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and os.path.exists(
                    os.path.join(self.dir, name, "manifest.json")):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, template: Any, step: Optional[int] = None
                ) -> Tuple[Any, Dict[str, Any]]:
        """Restore into the structure of ``template`` (shapes must match):
        each leaf in the template leaf's type, dtype and device."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError("no checkpoints found")
        path = os.path.join(self.dir, f"step_{step:09d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        info = {e["name"]: e.get("shard") for e in manifest["leaves"]}
        with np.load(os.path.join(path, "state.npz")) as data:
            leaves = [_from_host(data[n], t, info.get(n))
                      for n, t in _named_leaves(template)]
        return tree_rebuild(template, leaves), manifest.get("extra", {})

    def load_log_dump(self, step: int, bucket: int) -> Optional[np.ndarray]:
        p = os.path.join(self.dir, f"step_{step:09d}",
                         f"logdump_b{bucket}.npz")
        if not os.path.exists(p):
            return None
        with np.load(p) as data:
            return data["values"]

    # ------------------------------------------------------------------
    def _gc(self) -> None:
        steps = self.steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:09d}"),
                          ignore_errors=True)

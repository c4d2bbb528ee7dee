"""Bounded, hash-keyed host-side memo (shared cache primitive).

One tiny LRU used by every host-side memo layer (``repro.core.
simulator`` and ``repro.core.contention``). Lives in its own module so
``contention`` -- which ``simulator`` imports -- can use the same
implementation without an import cycle.

Thread-safe: the streaming engine mutates these memos from its prefetch
and compile-warm worker threads concurrently with the caller's thread,
so every cache carries its own ``threading.RLock``. The lock is held
across ``make()`` inside :meth:`get_or_put` -- two threads racing on
the same key must not build the (potentially device-resident) value
twice, and an OrderedDict mutated mid-``move_to_end`` can corrupt.
``make()`` for one cache may populate *another* cache (cell arrays pull
trace rows), which is fine: each cache has its own lock and the nesting
order is acyclic; the RLock additionally tolerates same-cache
re-entrancy.
"""

from __future__ import annotations

import collections
import threading
from typing import Callable


class BoundedCache:
    """Hash-keyed LRU memo with a hard entry bound.

    Unlike ``functools.lru_cache`` over the raw arguments, callers pass
    a small *key* (a digest tuple for batches, a scalar-knob tuple for
    cell arrays), so a 10^4-spec batch key costs bytes instead of
    pinning a copy of the spec tuple; ``maxsize`` bounds how many
    values (which may hold large host/device arrays) stay alive.

    All public methods are thread-safe; ``get_or_put`` guarantees a
    single ``make()`` call per key even under concurrent lookups."""

    def __init__(self, maxsize: int):
        self.maxsize = maxsize
        self._data: "collections.OrderedDict" = collections.OrderedDict()
        self._lock = threading.RLock()
        self.hits = 0
        self.misses = 0

    def get_or_put(self, key, make: Callable[[], object]):
        with self._lock:
            try:
                val = self._data[key]
                self._data.move_to_end(key)
                self.hits += 1
                return val
            except KeyError:
                self.misses += 1
            val = make()
            self._data[key] = val
            while len(self._data) > self.maxsize:
                self._data.popitem(last=False)
            return val

    def __len__(self) -> int:
        with self._lock:
            return len(self._data)

    def clear(self) -> None:
        with self._lock:
            self._data.clear()
            self.hits = self.misses = 0

"""Thread safety of the port's shared host-side memo
(``repro_torch.core.hostcache.BoundedCache``): the twin of
``tests/test_hostcache.py``.

The port's module is a copy of the JAX package's, and the port's
engine tiers share their memos with worker threads as the JAX engine
does. Every contract of the reference file runs here on the port's
class, unchanged:

* ``get_or_put`` builds each key's value EXACTLY once, however many
  threads race on it;
* the LRU bound holds under concurrent inserts;
* ``clear()`` racing ``get_or_put`` never corrupts the dict;
* nested get_or_put across two caches and same-cache re-entrancy
  (RLock) both work from worker threads;
* the port's simulator and contention memos are this class.

One parity case drives the port's cache and the JAX package's through
the same seeded sequence of lookups and clears: the same values, hit
and miss counts and LRU contents at every step.
"""

import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from repro.core.hostcache import BoundedCache as JBoundedCache
from repro_torch.core.hostcache import BoundedCache


def test_single_make_per_key_under_contention():
    cache = BoundedCache(maxsize=256)
    calls = []
    barrier = threading.Barrier(8)

    def worker(tid):
        barrier.wait()
        out = []
        for rep in range(200):
            key = rep % 32
            val = cache.get_or_put(key, lambda k=key: calls.append(k)
                                   or ("value", k))
            out.append((key, val))
        return out

    with ThreadPoolExecutor(max_workers=8) as ex:
        results = [f.result() for f in
                   [ex.submit(worker, t) for t in range(8)]]

    assert len(calls) == 32, "make() ran more than once for some key"
    assert sorted(calls) == list(range(32))
    for out in results:
        for key, val in out:
            assert val == ("value", key), "corrupted value under races"
    assert len(cache) == 32
    assert cache.misses == 32
    assert cache.hits == 8 * 200 - 32


def test_lru_bound_holds_under_concurrent_inserts():
    cache = BoundedCache(maxsize=16)

    def worker(tid):
        for i in range(500):
            cache.get_or_put((tid, i), lambda: i)

    with ThreadPoolExecutor(max_workers=8) as ex:
        for f in [ex.submit(worker, t) for t in range(8)]:
            f.result()
    assert len(cache) <= 16


def test_clear_races_get_or_put():
    cache = BoundedCache(maxsize=64)
    stop = threading.Event()
    errors = []

    def churn():
        i = 0
        try:
            while not stop.is_set():
                v = cache.get_or_put(i % 40, lambda k=i % 40: ("v", k))
                assert v == ("v", i % 40)
                i += 1
        except Exception as e:        # pragma: no cover - failure path
            errors.append(e)

    def clearer():
        try:
            while not stop.is_set():
                cache.clear()
        except Exception as e:        # pragma: no cover - failure path
            errors.append(e)

    threads = [threading.Thread(target=churn) for _ in range(4)]
    threads.append(threading.Thread(target=clearer))
    for t in threads:
        t.start()
    stop_timer = threading.Timer(0.5, stop.set)
    stop_timer.start()
    for t in threads:
        t.join()
    stop_timer.cancel()
    assert not errors, errors
    assert len(cache) <= 64


def test_nested_and_reentrant_get_or_put():
    outer = BoundedCache(maxsize=8)
    inner = BoundedCache(maxsize=8)

    def make_outer(key):
        # cross-cache nesting: cell arrays pull trace rows
        row = inner.get_or_put(("trace", key), lambda: key * 2)
        # same-cache re-entrancy: RLock must not deadlock
        base = outer.get_or_put(("base",), lambda: 100)
        return row + base

    with ThreadPoolExecutor(max_workers=4) as ex:
        vals = [f.result() for f in
                [ex.submit(lambda k=k: outer.get_or_put(
                    k, lambda: make_outer(k))) for k in range(4)]]
    assert vals == [100, 102, 104, 106]
    assert len(inner) == 4


def test_sim_caches_are_bounded_caches():
    """The simulator / contention memos actually use this primitive
    (the engine's worker threads rely on it)."""
    from repro_torch.core import contention as C
    from repro_torch.core import simulator as S
    for cache in (S._CELL_ARRAY_CACHE, S._WV_ROW_CACHE, S._BANK_CACHE,
                  S._BATCH_INPUT_CACHE, S._BANKED_INPUT_CACHE,
                  C._DRAW_CACHE, C._DELAY_CACHE):
        assert isinstance(cache, BoundedCache)
        assert cache._lock is not None


def test_same_sequence_same_state_as_jax():
    """A seeded stream of 2 000 lookups over 24 keys into caches of 8,
    with a clear every ~300: the port's cache and the JAX package's
    return the same values and hold the same keys in the same LRU
    order, with the same hit and miss counts, after every operation."""
    rng = np.random.default_rng(0)
    port, ref = BoundedCache(maxsize=8), JBoundedCache(maxsize=8)
    built = {"port": [], "ref": []}
    for i in range(2000):
        if rng.random() < 1 / 300:
            port.clear()
            ref.clear()
        else:
            k = int(rng.integers(24))
            a = port.get_or_put(k, lambda k=k: built["port"].append(k)
                                or ("v", k))
            b = ref.get_or_put(k, lambda k=k: built["ref"].append(k)
                               or ("v", k))
            assert a == b == ("v", k)
        assert (port.hits, port.misses, len(port)) == \
            (ref.hits, ref.misses, len(ref)), i
        assert list(port._data) == list(ref._data), i
    assert built["port"] == built["ref"]

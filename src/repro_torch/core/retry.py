"""Bounded retry-with-backoff for transient device/transport faults.

The resilience subsystem (:mod:`repro_torch.core.chaos`)
treats host->device placement and tile dispatch as fallible: a real
multi-host deployment sees transient DMA / RPC failures that a single
retry fixes, and the chaos harness injects exactly those
(``ChaosConfig.upload_failures``).  :func:`retry_call` is the one retry
primitive both the streaming engine and the serving daemon wrap those
call sites with:

* **bounded** -- at most ``max_attempts`` tries, then the last error is
  re-raised wrapped in :class:`RetryExhausted` (callers must never spin
  forever against a genuinely dead device; shard loss is the recovery
  path's job, not the retry loop's);
* **exponential backoff, capped** -- ``base_delay_s * 2**attempt``
  clamped to ``max_delay_s``;
* **jittered, deterministically** -- the delay is stretched by up to
  ``jitter`` drawn from a ``random.Random`` seeded on ``(policy.seed,
  describe)``, so concurrent retriers decorrelate without making test
  runs irreproducible.

A policy with ``max_attempts=1`` never sleeps and adds one ``try`` to
the call -- the inert fast path when no fault is injected.
"""

from __future__ import annotations

import dataclasses
import random
import time
from typing import Callable, Optional, Tuple, Type, TypeVar

from repro_torch.core import telemetry as _tm

T = TypeVar("T")


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Retry envelope: attempts, backoff shape, jitter seed."""
    max_attempts: int = 3
    base_delay_s: float = 0.001
    max_delay_s: float = 0.050
    jitter: float = 0.5          # max fractional stretch of each delay
    seed: int = 0

    def __post_init__(self) -> None:
        if self.max_attempts < 1:
            raise ValueError(
                f"max_attempts must be >= 1, got {self.max_attempts}")
        if self.base_delay_s < 0 or self.max_delay_s < 0:
            raise ValueError("delays must be >= 0")
        if not 0 <= self.jitter <= 1:
            raise ValueError(f"jitter must be in [0, 1], got {self.jitter}")


#: Default envelope around device placement / tile dispatch: three
#: attempts a few ms apart -- enough to absorb an injected transient
#: upload fault, cheap enough to be always-on.
PLACEMENT_RETRY = RetryPolicy(max_attempts=3, base_delay_s=0.001,
                              max_delay_s=0.020)


class RetryExhausted(RuntimeError):
    """All attempts failed; ``last`` is the final underlying error."""

    def __init__(self, describe: str, attempts: int, last: BaseException):
        super().__init__(
            f"{describe or 'retried call'} failed after {attempts} "
            f"attempt(s): {last!r}")
        self.describe = describe
        self.attempts = attempts
        self.last = last


def backoff_delays(policy: RetryPolicy, describe: str = ""):
    """The (jittered, capped) sleep schedule a ``policy`` would use --
    ``max_attempts - 1`` delays, deterministic for a given
    ``(policy.seed, describe)``. Exposed for tests and for callers that
    drive their own loop."""
    rng = random.Random(f"{policy.seed}|{describe}")
    for attempt in range(policy.max_attempts - 1):
        delay = min(policy.max_delay_s, policy.base_delay_s * (2 ** attempt))
        yield delay * (1.0 + policy.jitter * rng.random())


def retry_call(fn: Callable[[], T], *,
               policy: RetryPolicy = PLACEMENT_RETRY,
               retryable: Tuple[Type[BaseException], ...] = (Exception,),
               describe: str = "",
               on_retry: Optional[Callable[[int, BaseException, float],
                                           None]] = None) -> T:
    """Call ``fn`` with bounded jittered-backoff retries.

    Only exceptions matching ``retryable`` are retried; anything else
    propagates immediately (a shard-loss or integrity fault must reach
    the recovery path, not burn retry attempts).  ``on_retry(attempt,
    error, delay)`` is invoked before each sleep -- the engines use it
    to count retries in their stats."""
    delays = backoff_delays(policy, describe)
    attempt = 0
    while True:
        attempt += 1
        try:
            return fn()
        except retryable as e:
            try:
                delay = next(delays)
            except StopIteration:
                _tm.count("retry/exhausted")
                raise RetryExhausted(describe, attempt, e) from e
            _tm.count("retry/attempts")
            _tm.observe("retry/backoff_ms", delay * 1e3)
            if on_retry is not None:
                on_retry(attempt, e, delay)
            if delay > 0:
                time.sleep(delay)

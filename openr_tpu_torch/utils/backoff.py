"""Exponential backoff tracker.

Semantics match openr/common/ExponentialBackoff.h: reportError doubles the
current backoff (starting at initial, capped at max), reportSuccess clears it,
canTryNow/time_remaining are measured from the last error time. Durations are
float seconds.

Opt-in decorrelated jitter (`jitter=True`): each error draws the next
backoff uniformly from [initial, 3 * previous] (capped at max) instead of
deterministic doubling — the AWS "decorrelated jitter" scheme. Fleets of
agents that fail together (power event, agent push) then spread their
retries instead of re-converging on the same instants and producing
synchronized resync storms. The RNG is injectable for deterministic tests;
the default (`jitter=False`) keeps the reference's exact doubling so
existing callers are bit-compatible.
"""

from __future__ import annotations

import random
import time
from typing import Optional


class ExponentialBackoff:
    def __init__(
        self,
        initial_backoff: float,
        max_backoff: float,
        clock=time.monotonic,
        jitter: bool = False,
        rng: Optional[random.Random] = None,
    ) -> None:
        assert initial_backoff > 0 and max_backoff >= initial_backoff
        self._initial = initial_backoff
        self._max = max_backoff
        self._current = 0.0
        self._last_error_time = 0.0
        self._clock = clock
        self._jitter = jitter
        self._rng = rng if rng is not None else random.Random()

    def can_try_now(self) -> bool:
        return self.get_time_remaining_until_retry() <= 0

    def report_success(self) -> None:
        self._current = 0.0
        self._last_error_time = 0.0

    def report_error(self) -> None:
        self._last_error_time = self._clock()
        if not self._jitter:
            if self._current == 0.0:
                self._current = self._initial
            else:
                self._current = min(self._max, self._current * 2)
            return
        # decorrelated jitter: uniform in [initial, 3 * previous], where
        # the first error uses previous = initial; always within
        # [initial, max] so retry latency stays bounded both ways
        prev = self._current if self._current > 0.0 else self._initial
        self._current = min(
            self._max, self._rng.uniform(self._initial, prev * 3)
        )

    def report_status(self, ok: bool) -> None:
        if ok:
            self.report_success()
        else:
            self.report_error()

    def at_max_backoff(self) -> bool:
        return self._current >= self._max

    def get_time_remaining_until_retry(self) -> float:
        if self._current == 0.0:
            return 0.0
        remaining = self._last_error_time + self._current - self._clock()
        return max(0.0, remaining)

    def get_current_backoff(self) -> float:
        return self._current

    def get_last_error_time(self) -> float:
        return self._last_error_time

    def get_initial_backoff(self) -> float:
        return self._initial

    def get_max_backoff(self) -> float:
        return self._max

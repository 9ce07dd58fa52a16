"""Asyncio-based rate limiters.

Equivalents of openr/common/AsyncDebounce.h and AsyncThrottle.h. The reference
builds these on folly::AsyncTimeout scheduled on a module's EventBase; here the
module runtime is an asyncio event loop, so they schedule loop timers instead.

AsyncDebounce: every invocation doubles the wait (min..max backoff) and
(re)schedules the callback; the callback fires once the invocations quiesce or
the max backoff elapses. Used by Decision to batch SPF runs (Decision.cpp:1406).

AsyncThrottle: invocations within the window collapse into one callback at the
window boundary. Used by LinkMonitor/PrefixManager advertisement paths.
"""

from __future__ import annotations

import asyncio
from typing import Callable, Optional

from openr_tpu_torch.utils.backoff import ExponentialBackoff


class AsyncDebounce:
    def __init__(
        self,
        min_backoff: float,
        max_backoff: float,
        callback: Callable[[], None],
        loop: Optional[asyncio.AbstractEventLoop] = None,
    ) -> None:
        self._backoff = ExponentialBackoff(min_backoff, max_backoff)
        self._callback = callback
        self._loop = loop
        self._handle: Optional[asyncio.TimerHandle] = None

    def __call__(self) -> None:
        loop = self._loop or asyncio.get_running_loop()
        if not self._backoff.at_max_backoff():
            self._backoff.report_error()
            if self._handle is not None:
                self._handle.cancel()
            self._handle = loop.call_later(
                self._backoff.get_current_backoff(), self._fire
            )
        assert self._handle is not None

    def _fire(self) -> None:
        self._handle = None
        self._backoff.report_success()
        self._callback()

    def is_scheduled(self) -> bool:
        return self._handle is not None

    def cancel(self) -> None:
        if self._handle is not None:
            self._handle.cancel()
            self._handle = None
            self._backoff.report_success()


class AsyncThrottle:
    def __init__(
        self,
        timeout: float,
        callback: Callable[[], None],
        loop: Optional[asyncio.AbstractEventLoop] = None,
    ) -> None:
        self._timeout = timeout
        self._callback = callback
        self._loop = loop
        self._handle: Optional[asyncio.TimerHandle] = None

    def __call__(self) -> None:
        if self._handle is not None:
            return  # already scheduled; coalesce
        loop = self._loop or asyncio.get_running_loop()
        if self._timeout <= 0:
            # immediate execution, mirrors AsyncThrottle.cpp zero-timeout path
            self._callback()
            return
        self._handle = loop.call_later(self._timeout, self._fire)

    def _fire(self) -> None:
        self._handle = None
        self._callback()

    def is_active(self) -> bool:
        return self._handle is not None

    def cancel(self) -> None:
        if self._handle is not None:
            self._handle.cancel()
            self._handle = None

"""Liveness watchdog.

Behavioral port of openr/watchdog/Watchdog.{h,cpp}: every module's event
loop stamps a heartbeat; a periodic checker fires a crash action when any
module stalls past thread_timeout_s or process RSS exceeds max_memory_mb
(OpenrConfig.thrift:65-69). The reference aborts the process (fireCrash,
Watchdog.h:42); here the action is injectable so tests (and supervisors
that prefer restart-on-unhealthy) can observe it.
"""

from __future__ import annotations

import asyncio
import logging
import os
import resource
import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional

log = logging.getLogger(__name__)


@dataclass
class WatchdogConfig:
    """OpenrConfig.thrift WatchdogConfig:65."""

    interval_s: float = 20.0
    thread_timeout_s: float = 300.0
    max_memory_mb: int = 800


def _default_fire(reason: str) -> None:
    log.critical("watchdog firing: %s", reason)
    os.abort()


class Watchdog:
    def __init__(
        self,
        config: Optional[WatchdogConfig] = None,
        fire: Callable[[str], None] = _default_fire,
        loop: Optional[asyncio.AbstractEventLoop] = None,
    ) -> None:
        self.config = config or WatchdogConfig()
        self.fire = fire
        self._loop = loop
        self._heartbeats: Dict[str, float] = {}
        self._tasks: Dict[str, asyncio.Task] = {}
        self._checker: Optional[asyncio.Task] = None
        self.monitored_modules: list = []
        # module -> count of budget-overrun sections (note_slow)
        self.slow_sections: Dict[str, int] = {}

    def loop(self) -> asyncio.AbstractEventLoop:
        return self._loop or asyncio.get_event_loop()

    # ------------------------------------------------------------------

    def add_module(self, name: str) -> None:
        """addEvb equivalent: spawn a heartbeat task on the (shared) loop.

        The reference stamps per-thread event loops; the rebuild runs all
        modules on one asyncio loop, so one heartbeat task per registered
        module detects loop starvation (a stuck module blocks them all) and
        keeps per-module attribution for the report."""
        self.monitored_modules.append(name)
        self._heartbeats[name] = time.monotonic()
        self._tasks[name] = self.loop().create_task(self._beat(name))

    def touch(self, name: str) -> None:
        """Modules doing long cooperative work can stamp explicitly."""
        self._heartbeats[name] = time.monotonic()

    def note_slow(self, name: str, elapsed_s: float, budget_s: float) -> None:
        """Attributed slow-section report (SolverSupervisor's per-solve
        deadline enforcement lands here): a section finished but blew its
        budget — below the fire threshold, above normal. Recorded per
        module so a watchdog fire that follows can name the culprit."""
        self.slow_sections[name] = self.slow_sections.get(name, 0) + 1
        log.warning(
            "module %s section ran %.3fs (budget %.3fs)",
            name,
            elapsed_s,
            budget_s,
        )

    def start(self) -> None:
        self._checker = self.loop().create_task(self._check_loop())

    def stop(self) -> None:
        if self._checker is not None:
            self._checker.cancel()
            self._checker = None
        for task in self._tasks.values():
            task.cancel()
        self._tasks.clear()

    # ------------------------------------------------------------------

    async def _beat(self, name: str) -> None:
        try:
            while True:
                self._heartbeats[name] = time.monotonic()
                await asyncio.sleep(min(1.0, self.config.interval_s / 4))
        except asyncio.CancelledError:
            pass

    async def _check_loop(self) -> None:
        try:
            while True:
                await asyncio.sleep(self.config.interval_s)
                self.check_once()
        except asyncio.CancelledError:
            pass

    def check_once(self) -> None:
        now = time.monotonic()
        for name, stamp in self._heartbeats.items():
            stalled = now - stamp
            if stalled > self.config.thread_timeout_s:
                self.fire(
                    f"module {name} stalled for {stalled:.1f}s "
                    f"(> {self.config.thread_timeout_s}s)"
                )
                return
        rss_mb = self.get_rss_mb()
        if rss_mb > self.config.max_memory_mb:
            self.fire(
                f"RSS {rss_mb}MB exceeds limit {self.config.max_memory_mb}MB"
            )

    @staticmethod
    def get_rss_mb() -> int:
        # ru_maxrss is KB on Linux
        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss // 1024

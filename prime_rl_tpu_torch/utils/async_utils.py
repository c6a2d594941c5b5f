"""Asyncio guard rails (reference: utils/async_utils.py:1-73):
``EventLoopLagMonitor`` measures scheduling latency of the orchestrator's
event loop (p50/p90/p99 over a window) — the canary for a blocked hot loop —
and ``safe_cancel`` tears tasks down without leaking exceptions."""

from __future__ import annotations

import asyncio
import time

import numpy as np


class EventLoopLagMonitor:
    def __init__(self, tick: float = 0.1, window: int = 600):
        self.tick = tick
        self.window = window
        self.samples: list[float] = []
        self._task: asyncio.Task | None = None

    def start(self) -> "EventLoopLagMonitor":
        self._task = asyncio.create_task(self._run())
        return self

    async def _run(self) -> None:
        while True:
            t0 = time.monotonic()
            await asyncio.sleep(self.tick)
            lag = max(0.0, time.monotonic() - t0 - self.tick)
            self.samples.append(lag)
            if len(self.samples) > self.window:
                self.samples.pop(0)

    def view(self) -> dict[str, float]:
        if not self.samples:
            return {}
        a = np.asarray(self.samples)
        return {
            "event_loop_lag_p50": float(np.percentile(a, 50)),
            "event_loop_lag_p90": float(np.percentile(a, 90)),
            "event_loop_lag_p99": float(np.percentile(a, 99)),
        }

    def stop(self) -> None:
        if self._task:
            self._task.cancel()


async def safe_cancel(task: asyncio.Task, timeout: float = 5.0) -> None:
    task.cancel()
    try:
        await asyncio.wait_for(task, timeout)
    except (asyncio.CancelledError, asyncio.TimeoutError):
        pass


class RateLimiter:
    """Rolling-window task-start throttle (reference: dispatcher.py
    AsyncLimiter(tasks_per_minute)): ``acquire()`` admits at most ``rate``
    starts per ``period`` seconds, sleeping until the oldest start in the
    window expires. ``rate <= 0`` disables (acquire returns immediately)."""

    def __init__(self, rate: int, period: float = 60.0):
        self.rate = rate
        self.period = period
        self._starts: list[float] = []
        self._lock = asyncio.Lock()

    async def acquire(self) -> None:
        if self.rate <= 0:
            return
        async with self._lock:  # FIFO fairness: one waiter computes at a time
            while True:
                now = time.monotonic()
                self._starts = [t for t in self._starts if now - t < self.period]
                if len(self._starts) < self.rate:
                    self._starts.append(now)
                    return
                await asyncio.sleep(self._starts[0] + self.period - now)

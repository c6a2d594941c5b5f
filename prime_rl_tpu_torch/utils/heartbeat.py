"""Uptime heartbeats (reference: utils/heartbeat.py:8-30 — Better Stack
pings): a daemon thread GETs a URL on an interval; failures are logged, never
fatal."""

from __future__ import annotations

import threading
import time

import httpx

from prime_rl_tpu_torch.utils.logger import get_logger


class Heartbeat:
    def __init__(self, url: str, interval: float = 30.0):
        self.url = url
        self.interval = interval
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def start(self) -> "Heartbeat":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()

    def _run(self) -> None:
        logger = get_logger()
        while not self._stop.wait(self.interval):
            try:
                httpx.get(self.url, timeout=10)
            except Exception as e:  # pragma: no cover
                logger.debug(f"heartbeat to {self.url} failed: {e}")

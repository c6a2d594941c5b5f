"""Process-wide logging (reference: utils/logger.py, loguru-based).

Uses stdlib logging with the same surface as the JAX package's logger:
``setup_logger(level, json_logs, log_file)`` once per process, then
``get_logger()`` anywhere.
"""

from __future__ import annotations

import json
import logging
import sys
import time
from pathlib import Path

_LOGGER_NAME = "prime_rl_tpu_torch"
_configured = False


class _JsonFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        payload = {
            "ts": time.time(),
            "level": record.levelname.lower(),
            "name": record.name,
            "msg": record.getMessage(),
        }
        if record.exc_info:
            payload["exc"] = self.formatException(record.exc_info)
        return json.dumps(payload)


class _ConsoleFormatter(logging.Formatter):
    COLORS = {"DEBUG": "\033[36m", "INFO": "\033[32m", "WARNING": "\033[33m", "ERROR": "\033[31m"}
    RESET = "\033[0m"

    def __init__(self, color: bool):
        super().__init__()
        self.color = color

    def format(self, record: logging.LogRecord) -> str:
        ts = time.strftime("%H:%M:%S", time.localtime(record.created))
        level = record.levelname
        if self.color and level in self.COLORS:
            level = f"{self.COLORS[level]}{level:<7}{self.RESET}"
        else:
            level = f"{level:<7}"
        msg = record.getMessage()
        if record.exc_info:
            msg += "\n" + self.formatException(record.exc_info)
        return f"{ts} | {level} | {msg}"


def setup_logger(
    level: str = "info",
    json_logs: bool = False,
    log_file: str | Path | None = None,
    name: str | None = None,
) -> logging.Logger:
    global _configured
    logger = logging.getLogger(_LOGGER_NAME if name is None else f"{_LOGGER_NAME}.{name}")
    logger.setLevel(getattr(logging, level.upper()))
    logger.handlers.clear()
    logger.propagate = False
    console = logging.StreamHandler(sys.stderr)
    console.setFormatter(_JsonFormatter() if json_logs else _ConsoleFormatter(color=sys.stderr.isatty()))
    logger.addHandler(console)
    if log_file is not None:
        Path(log_file).parent.mkdir(parents=True, exist_ok=True)
        fh = logging.FileHandler(log_file)
        fh.setFormatter(_JsonFormatter() if json_logs else _ConsoleFormatter(color=False))
        logger.addHandler(fh)
    _configured = True
    return logger


def get_logger() -> logging.Logger:
    logger = logging.getLogger(_LOGGER_NAME)
    if not _configured:
        setup_logger()
    return logger


def reset_logger() -> None:
    """Test helper: drop handlers so the next setup starts clean."""
    global _configured
    logging.getLogger(_LOGGER_NAME).handlers.clear()
    _configured = False


def format_time(seconds: float) -> str:
    if seconds < 60:
        return f"{seconds:.1f}s"
    if seconds < 3600:
        return f"{int(seconds // 60)}m{int(seconds % 60):02d}s"
    return f"{int(seconds // 3600)}h{int((seconds % 3600) // 60):02d}m"

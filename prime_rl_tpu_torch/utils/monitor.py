"""Metric monitors (the port of the JAX package's ``utils/monitor.py``):
``FileMonitor`` writes JSONL, ``MultiMonitor`` fans out. The W&B monitor is
not ported: asking for it raises.
"""

from __future__ import annotations

import json
import time
from abc import ABC, abstractmethod
from pathlib import Path
from typing import Any

from prime_rl_tpu_torch.configs.shared import FileMonitorConfig, WandbMonitorConfig


class Monitor(ABC):
    @abstractmethod
    def log(self, metrics: dict[str, Any], step: int | None = None) -> None: ...

    def log_samples(self, samples: list[dict], step: int | None = None) -> None:
        pass

    def log_distributions(self, dists: dict[str, list[float]], step: int | None = None) -> None:
        pass

    def finalize(self) -> None:
        pass


class NullMonitor(Monitor):
    def log(self, metrics: dict[str, Any], step: int | None = None) -> None:
        pass


class FileMonitor(Monitor):
    def __init__(self, path: str | Path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._fh = open(self.path, "a")

    def log(self, metrics: dict[str, Any], step: int | None = None) -> None:
        record = {"ts": time.time(), **({"step": step} if step is not None else {}), **metrics}
        self._fh.write(json.dumps(record, default=_json_default) + "\n")
        self._fh.flush()

    def log_samples(self, samples: list[dict], step: int | None = None) -> None:
        self.log({"samples": samples}, step)

    def log_distributions(self, dists: dict[str, list[float]], step: int | None = None) -> None:
        import numpy as np

        summary = {}
        for name, vals in dists.items():
            if not len(vals):
                continue
            arr = np.asarray(vals, np.float64)
            summary[f"{name}/p05"], summary[f"{name}/p50"], summary[f"{name}/p95"] = (
                float(np.percentile(arr, 5)), float(np.percentile(arr, 50)),
                float(np.percentile(arr, 95)))
            summary[f"{name}/mean"] = float(arr.mean())
        if summary:
            self.log(summary, step)

    def finalize(self) -> None:
        self._fh.close()


class MultiMonitor(Monitor):
    def __init__(self, monitors: list[Monitor]):
        self.monitors = monitors

    def log(self, metrics: dict[str, Any], step: int | None = None) -> None:
        for m in self.monitors:
            m.log(metrics, step)

    def log_samples(self, samples: list[dict], step: int | None = None) -> None:
        for m in self.monitors:
            m.log_samples(samples, step)

    def log_distributions(self, dists: dict[str, list[float]], step: int | None = None) -> None:
        for m in self.monitors:
            m.log_distributions(dists, step)

    def finalize(self) -> None:
        for m in self.monitors:
            m.finalize()


def _json_default(obj: Any) -> Any:
    try:
        return float(obj)
    except (TypeError, ValueError):
        return str(obj)


def setup_monitor(config: Any, output_dir: str | Path, name: str = "metrics") -> Monitor:
    if isinstance(config, FileMonitorConfig):
        path = config.path or (Path(output_dir) / f"{name}.jsonl")
        return FileMonitor(path)
    if isinstance(config, WandbMonitorConfig):
        raise NotImplementedError("the wandb monitor is not ported yet; use monitor.type = 'file'")
    return NullMonitor()

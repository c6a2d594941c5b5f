"""Rollout metric containers (reference: orchestrator/metrics.py:1-468 and
utils.py:141 compute_pass_metrics): ``Stat`` mean/max/min/p10/p90 views,
train/eval rollup dicts in the ``{prefix}/{subset}/<metric>/<stat>`` scheme,
and pass@k / pass^k estimators."""

from __future__ import annotations

import math
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Iterable

import numpy as np


@dataclass
class Stat:
    values: list[float] = field(default_factory=list)

    def add(self, v: float) -> None:
        self.values.append(float(v))

    def view(self) -> dict[str, float]:
        if not self.values:
            return {}
        a = np.asarray(self.values, np.float64)
        return {
            "mean": float(a.mean()),
            "max": float(a.max()),
            "min": float(a.min()),
            "p10": float(np.percentile(a, 10)),
            "p90": float(np.percentile(a, 90)),
        }


def pass_at_k(num_correct: int, num_samples: int, k: int) -> float:
    """Unbiased pass@k (Codex estimator): 1 - C(n-c, k)/C(n, k)."""
    if num_samples - num_correct < k:
        return 1.0
    return 1.0 - math.comb(num_samples - num_correct, k) / math.comb(num_samples, k)


def pass_hat_k(num_correct: int, num_samples: int, k: int) -> float:
    """pass^k: probability all k independent samples are correct —
    C(c, k)/C(n, k) (reference: utils.py compute_pass_metrics)."""
    if num_correct < k:
        return 0.0
    return math.comb(num_correct, k) / math.comb(num_samples, k)


def compute_pass_metrics(per_group_correct: list[tuple[int, int]], ks: Iterable[int]) -> dict[str, float]:
    """per_group_correct: [(num_correct, group_size)]. Returns pass@k and
    pass^k averaged over groups, for each k that fits the group size."""
    out: dict[str, float] = {}
    for k in ks:
        at, hat, n = [], [], 0
        for c, g in per_group_correct:
            if g >= k:
                at.append(pass_at_k(c, g, k))
                hat.append(pass_hat_k(c, g, k))
                n += 1
        if n:
            out[f"pass@{k}"] = float(np.mean(at))
            out[f"pass^{k}"] = float(np.mean(hat))
    return out


class RolloutMetrics:
    """Accumulates per-rollout metrics into the W&B-style nested dict:
    ``{prefix}/{agg|env=<name>}/{all|effective}/<metric>/<stat>``."""

    def __init__(self, prefix: str = "train"):
        self.prefix = prefix
        self._stats: dict[tuple[str, str, str], Stat] = defaultdict(Stat)
        self._groups: dict[str, list[tuple[int, int]]] = defaultdict(list)

    def add_rollout(self, env: str, metrics: dict[str, float], effective: bool = True) -> None:
        for name, value in metrics.items():
            for scope in ("agg", f"env={env}"):
                self._stats[(scope, "all", name)].add(value)
                if effective:
                    self._stats[(scope, "effective", name)].add(value)

    def add_group(self, env: str, num_correct: int, group_size: int) -> None:
        self._groups["agg"].append((num_correct, group_size))
        self._groups[f"env={env}"].append((num_correct, group_size))

    def view(self, ks: Iterable[int] = (1, 2, 4, 8)) -> dict[str, float]:
        out: dict[str, float] = {}
        for (scope, subset, name), stat in self._stats.items():
            for stat_name, v in stat.view().items():
                out[f"{self.prefix}/{scope}/{subset}/{name}/{stat_name}"] = v
        for scope, groups in self._groups.items():
            for name, v in compute_pass_metrics(groups, ks).items():
                out[f"{self.prefix}/{scope}/all/{name}"] = v
        return out

    def reset(self) -> None:
        self._stats.clear()
        self._groups.clear()

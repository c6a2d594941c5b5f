"""Environment ABC + registry.

An environment owns a taskset and produces Episodes by driving the policy
through the token-level InferenceClient (reference contract:
verifiers v1 ``Task``/``EnvClient.run`` — orchestrator/envs.py:29-31).
Envs are pure asyncio; they run inside env-server worker pools, NOT in the
orchestrator process.
"""

from __future__ import annotations

import importlib
from abc import ABC, abstractmethod
from typing import Any

from prime_rl_tpu_torch.envs.client import InferenceClient
from prime_rl_tpu_torch.envs.types import Episode, SamplingConfig


class Environment(ABC):
    """Subclass and register (or expose ``load_env`` in a module)."""

    name: str = "env"

    def __init__(self, **kwargs: Any):
        self.config = kwargs

    @abstractmethod
    def load_taskset(self) -> list[dict]:
        """Return the list of task_data dicts (the orchestrator samples and
        ships one per episode)."""

    @abstractmethod
    async def rollout(
        self, client: InferenceClient, task_data: dict, sampling: SamplingConfig
    ) -> Episode:
        """Run one episode for one task against the live policy."""


_REGISTRY: dict[str, type[Environment]] = {}


def register_env(cls: type[Environment]) -> type[Environment]:
    _REGISTRY[cls.name] = cls
    return cls


def load_env(name_or_path: str, **kwargs: Any) -> Environment:
    """Builtin name (envs/builtin), registered name, or ``module:Class``."""
    import prime_rl_tpu_torch.envs.builtin  # noqa: F401 — populate the registry

    if name_or_path in _REGISTRY:
        return _REGISTRY[name_or_path](**kwargs)
    if ":" in name_or_path:
        module, _, attr = name_or_path.partition(":")
        cls = getattr(importlib.import_module(module), attr)
        return cls(**kwargs)
    raise ValueError(
        f"unknown env {name_or_path!r}; registered: {sorted(_REGISTRY)}"
    )

"""Env runtime wire types: Trace / Episode / Task.

First-party analogue of the verifiers v1 contract the reference depends on
(reference: orchestrator/envs.py:108-154, SURVEY.md §2.6): an episode holds
one or more trainable *traces* — flat token streams with per-token
``sampled_mask``/``logprobs``/``temperatures`` — plus rewards and metrics.
Multi-turn conversations are already flattened by the env; branch dedup
(shared sampled prefixes) is the orchestrator's job.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, field
from typing import Any

import numpy as np


@dataclass
class Trace:
    """One trainable branch: the full token stream fed to/produced by the
    policy. ``sampled_mask[i]`` is True iff token i was sampled from the
    policy (trainable); context/tool/user tokens are False."""

    token_ids: list[int]
    sampled_mask: list[bool]
    logprobs: list[float]
    temperatures: list[float]
    reward: float | None = None
    metrics: dict[str, float] = field(default_factory=dict)
    messages: list[dict] | None = None  # optional chat view for logging
    # MoE router replay: per-token [NL, K] expert-id rows (None entries =
    # context tokens / not recorded)
    routed_experts: list | None = None
    # VLM inputs: {"pixel_values": [P, patch_dim] f32, "image_grid_thw":
    # [N, 3] i64} (HF-processor layout; reference trajectories.py:35-66
    # mm_kwargs contract) — rides the wire to TrainingSample.mm_kwargs
    mm_kwargs: dict | None = None

    def __post_init__(self):
        n = len(self.token_ids)
        assert len(self.sampled_mask) == n and len(self.logprobs) == n and len(self.temperatures) == n, \
            f"stream lengths disagree: {n}, {len(self.sampled_mask)}, {len(self.logprobs)}, {len(self.temperatures)}"

    @property
    def num_sampled(self) -> int:
        return int(sum(self.sampled_mask))


@dataclass
class Episode:
    """Result of one env rollout."""

    traces: list[Trace]
    reward: float = 0.0
    metrics: dict[str, float] = field(default_factory=dict)
    error: str | None = None
    info: dict[str, Any] = field(default_factory=dict)

    @property
    def is_error(self) -> bool:
        return self.error is not None


@dataclass
class SamplingConfig:
    """Sampling surface shipped env-ward by the orchestrator."""

    max_tokens: int = 256
    temperature: float = 1.0
    top_p: float = 1.0
    top_k: int = -1
    seed: int | None = None
    # multi-tenant serving: decode through this loaded LoRA adapter
    adapter: str | None = None


def episode_to_wire(ep: Episode) -> dict:
    return asdict(ep)


def episode_from_wire(d: dict) -> Episode:
    traces = [Trace(**t) for t in d.pop("traces")]
    return Episode(traces=traces, **d)

"""Algorithm base: pluggable per-env credit assignment + loss routing
(reference: orchestrator/algo/base.py:81-165, routing.py:23-60).

Flow: each completed Episode becomes a ``Rollout`` (episode + its
TrainingSamples). ``finalize_rollout`` runs per-episode (async — e.g. OPD
teacher scoring); ``finalize_group`` runs when the group completes and calls
``score_group`` to produce one scalar advantage per rollout, then stamps
per-token ``advantages`` and component weight streams onto the samples.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Sequence

import numpy as np

from prime_rl_tpu_torch.envs.types import Episode
from prime_rl_tpu_torch.transport.types import TrainingSample


@dataclass
class Rollout:
    """One episode + its flattened training samples + orchestrator metadata."""

    episode: Episode
    samples: list[TrainingSample]
    env_name: str
    task_data: dict
    policy_version: int = -1
    off_policy_steps: int = 0

    @property
    def reward(self) -> float:
        return self.episode.reward

    @property
    def is_error(self) -> bool:
        return self.episode.is_error

    @property
    def num_output_tokens(self) -> int:
        return sum(int(np.sum(s.mask)) for s in self.samples)

    @property
    def num_input_tokens(self) -> int:
        return sum(len(s) - int(np.sum(s.mask)) for s in self.samples)


def stamp_advantages(rollout: Rollout, advantage: float) -> None:
    """Broadcast a scalar advantage over each sample's sampled tokens
    (reference: algo/base.py stamp_advantages + types.py:109-125)."""
    for s in rollout.samples:
        adv = np.zeros(len(s), np.float32)
        adv[np.asarray(s.mask, bool)] = advantage
        s.advantages = adv


def stamp_loss_routing(rollout: Rollout, component: str = "rl", weight: float = 1.0) -> None:
    """Route each sample's sampled tokens to a loss component
    (reference: algo/routing.py:23-60)."""
    for s in rollout.samples:
        w = np.zeros(len(s), np.float32)
        w[np.asarray(s.mask, bool)] = weight
        if component == "rl":
            s.rl_weights = w
        elif component == "ce":
            s.ce_weights = w
        elif component == "ref_kl":
            s.ref_kl_weights = w
        else:
            raise ValueError(component)


class Algorithm:
    """Base class; subclasses implement ``score_group`` and may override the
    finalize hooks."""

    needs_group: bool = True

    def __init__(self, config: Any, tokenizer: Any | None = None):
        self.config = config
        # the live policy's tokenizer (resolved by the orchestrator from
        # tokenizer/model config) — algorithms that build token prefixes
        # (OPSD demos) must use this, never a hardcoded fallback
        # (reference: algo/opsd.py renders demos with the policy tokenizer)
        self.tokenizer = tokenizer

    def sample_pool_urls(self) -> list[str] | None:
        """Frozen-pool routing (reference: orchestrator/sampler.py:1-59):
        return engine URLs for this env's rollouts to be SAMPLED from instead
        of the live policy pool. None = live policy."""
        return None

    async def finalize_rollout(self, rollout: Rollout) -> None:
        """Per-episode hook (async: may call external models)."""

    def score_group(self, rollouts: Sequence[Rollout]) -> list[float]:
        """One scalar advantage per rollout."""
        raise NotImplementedError

    def finalize_group(self, rollouts: Sequence[Rollout]) -> None:
        advantages = self.score_group(rollouts)
        for r, a in zip(rollouts, advantages):
            stamp_advantages(r, a)
            stamp_loss_routing(r, "rl")

    def shaped_reward(self, rollout: Rollout) -> float:
        """Reward after optional length shaping
        (reference: algo/grpo.py:24-43)."""
        r = rollout.reward
        lp = getattr(self.config, "length_penalty", None)
        if lp is not None:
            r -= lp.num_output_tokens_weight * rollout.num_output_tokens
            r -= lp.num_input_tokens_weight * rollout.num_input_tokens
        return r

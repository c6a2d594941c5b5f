"""Concrete algorithms (reference: orchestrator/algo/{grpo,max_rl,rae,
hierarchical,echo,opd,opsd,sft}.py — behavior parity, original code)."""

from __future__ import annotations

from collections import defaultdict
from typing import Sequence

import numpy as np

from prime_rl_tpu_torch.orchestrator.algo.base import (
    Algorithm,
    Rollout,
    stamp_advantages,
    stamp_loss_routing,
)


class GRPO(Algorithm):
    """Group-mean baseline: a_i = r_i - mean(r) (reference: algo/grpo.py:15-43)."""

    def score_group(self, rollouts: Sequence[Rollout]) -> list[float]:
        rewards = [self.shaped_reward(r) for r in rollouts]
        mean = float(np.mean(rewards)) if rewards else 0.0
        return [r - mean for r in rewards]


class MaxRL(Algorithm):
    """Mean-normalized: a_i = (r_i - mean) / max|r - mean|
    (reference: algo/max_rl.py)."""

    def score_group(self, rollouts: Sequence[Rollout]) -> list[float]:
        rewards = np.asarray([self.shaped_reward(r) for r in rollouts], np.float64)
        centered = rewards - rewards.mean() if len(rewards) else rewards
        denom = float(np.max(np.abs(centered))) if len(centered) else 0.0
        if denom == 0.0:
            return [0.0] * len(rollouts)
        return [float(c / denom) for c in centered]


class RAE(Algorithm):
    """Per-agent EMA baseline (SPIRAL; reference: algo/rae.py): the baseline
    persists across groups per (env, agent) key instead of the group mean."""

    def __init__(self, config, tokenizer=None):
        super().__init__(config, tokenizer=tokenizer)
        self._baselines: dict[str, float] = {}

    def _key(self, rollout: Rollout) -> str:
        return str(rollout.episode.info.get("agent", rollout.env_name))

    def score_group(self, rollouts: Sequence[Rollout]) -> list[float]:
        decay = self.config.ema_decay
        out = []
        for r in rollouts:
            key = self._key(r)
            reward = self.shaped_reward(r)
            baseline = self._baselines.get(key, reward)
            out.append(reward - baseline)
            self._baselines[key] = decay * baseline + (1 - decay) * reward
        return out


class HierarchicalGRPO(Algorithm):
    """Scoped group baselines: rollouts are grouped by a key in episode.info
    (e.g. proposer vs solver) and each scope gets its own mean baseline
    (reference: algo/hierarchical.py)."""

    def score_group(self, rollouts: Sequence[Rollout]) -> list[float]:
        key = self.config.scope_key
        scopes: dict[str, list[int]] = defaultdict(list)
        rewards = [self.shaped_reward(r) for r in rollouts]
        for i, r in enumerate(rollouts):
            scopes[str(r.episode.info.get(key, ""))].append(i)
        out = [0.0] * len(rollouts)
        for idxs in scopes.values():
            mean = float(np.mean([rewards[i] for i in idxs]))
            for i in idxs:
                out[i] = rewards[i] - mean
        return out


class Echo(Algorithm):
    """GRPO on sampled tokens + weighted CE on env-observation (context)
    tokens (reference: algo/echo.py): the policy learns to predict what the
    environment will say back."""

    def score_group(self, rollouts: Sequence[Rollout]) -> list[float]:
        rewards = [self.shaped_reward(r) for r in rollouts]
        mean = float(np.mean(rewards)) if rewards else 0.0
        return [r - mean for r in rewards]

    def finalize_group(self, rollouts: Sequence[Rollout]) -> None:
        super().finalize_group(rollouts)
        w = self.config.observation_ce_weight
        for r in rollouts:
            for s in r.samples:
                mask = np.asarray(s.mask, bool)
                obs = ~mask
                # observation tokens after the first sampled token (true env
                # feedback, not the initial prompt)
                first_sampled = int(np.argmax(mask)) if mask.any() else len(mask)
                obs[:first_sampled] = False
                ce = np.zeros(len(s), np.float32)
                ce[obs] = w
                s.ce_weights = ce


class OPD(Algorithm):
    """On-policy distillation: a frozen teacher prefill-scores the rollout's
    tokens into ``ref_logprobs``; tokens route to the ref_kl loss, no scalar
    advantages (reference: algo/opd.py:16-47)."""

    needs_group = False

    def __init__(self, config, tokenizer=None):
        super().__init__(config, tokenizer=tokenizer)
        self._teacher = None

    def _teacher_client(self):
        if self._teacher is None:
            from prime_rl_tpu_torch.envs.client import InferenceClient

            if self.config.teacher is None or not self.config.teacher.base_url:
                raise ValueError("opd requires algo.teacher.base_url")
            self._teacher = InferenceClient(self.config.teacher.base_url[0])
        return self._teacher

    async def finalize_rollout(self, rollout: Rollout) -> None:
        client = self._teacher_client()
        for s in rollout.samples:
            lps = await client.prefill_logprobs([int(t) for t in s.token_ids])
            s.ref_logprobs = np.asarray(lps, np.float32)

    def finalize_group(self, rollouts: Sequence[Rollout]) -> None:
        for r in rollouts:
            stamp_advantages(r, 0.0)
            stamp_loss_routing(r, "ref_kl")


class OPSD(Algorithm):
    """On-policy self-distillation: the teacher is the live policy prefixed
    with a demonstration from task_data (reference: algo/opsd.py). The env
    ships the demo under ``task_data[demo_key]``."""

    needs_group = False

    def __init__(self, config, tokenizer=None):
        super().__init__(config, tokenizer=tokenizer)
        self._clients: dict[str, object] = {}

    def _client(self, base_url: str):
        if base_url not in self._clients:
            from prime_rl_tpu_torch.envs.client import InferenceClient

            self._clients[base_url] = InferenceClient(base_url)
        return self._clients[base_url]

    async def finalize_rollout(self, rollout: Rollout) -> None:
        demo = rollout.task_data.get(self.config.demo_key)
        if demo is None:
            raise ValueError(f"opsd: task_data lacks {self.config.demo_key!r}")
        base_url = rollout.episode.info.get("base_url")
        client = self._client(base_url)
        if self.tokenizer is None:
            raise ValueError(
                "opsd needs the policy tokenizer to encode the demonstration "
                "prefix (orchestrator passes it via make_algorithm)"
            )
        demo_ids = _encode_text(self.tokenizer, str(demo))
        for s in rollout.samples:
            full = demo_ids + [int(t) for t in s.token_ids]
            lps = await client.prefill_logprobs(full)
            s.ref_logprobs = np.asarray(lps[len(demo_ids):], np.float32)

    def finalize_group(self, rollouts: Sequence[Rollout]) -> None:
        for r in rollouts:
            stamp_advantages(r, 0.0)
            stamp_loss_routing(r, "ref_kl")


class SFTAlgo(Algorithm):
    """Distill-by-generation: rollouts are SAMPLED from the connected frozen
    teacher pool (sample_pool_urls routes the dispatcher there —
    reference: orchestrator/sampler.py:1-59 + algo/sft.py); plain CE on the
    teacher's sampled tokens trains the student toward them."""

    needs_group = False

    def sample_pool_urls(self) -> list[str] | None:
        t = getattr(self.config, "teacher", None)
        if t is None or not t.base_url:
            raise ValueError(
                "sft distillation requires algo.teacher.base_url (the frozen "
                "teacher pool rollouts are sampled from)")
        return list(t.base_url)

    def finalize_group(self, rollouts: Sequence[Rollout]) -> None:
        for r in rollouts:
            stamp_advantages(r, 0.0)
            stamp_loss_routing(r, "ce")


ALGORITHM_CLASSES = {
    "grpo": GRPO,
    "max_rl": MaxRL,
    "rae": RAE,
    "hierarchical_grpo": HierarchicalGRPO,
    "echo": Echo,
    "opd": OPD,
    "opsd": OPSD,
    "sft": SFTAlgo,
}


def _encode_text(tokenizer, text: str) -> list[int]:
    """Encode a plain-text span with the policy tokenizer (HF or byte),
    never adding special tokens — the demo is a prefix inside a running
    token stream."""
    try:
        return list(tokenizer.encode(text, add_special_tokens=False))
    except TypeError:
        return list(tokenizer.encode(text))


def make_algorithm(config, tokenizer=None) -> Algorithm:
    return ALGORITHM_CLASSES[config.type](config, tokenizer=tokenizer)

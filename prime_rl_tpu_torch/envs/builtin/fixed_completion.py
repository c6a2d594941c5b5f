"""fixed_completion: the fastest-learning smoke env — reward is similarity
to one constant target string, so GRPO must simply concentrate probability
mass on a fixed byte sequence + eos. Validates the full credit-assignment /
importance-ratio / weight-sync mechanics within ~20 steps from random init
(the role of the reference's reward-goes-up integration gate,
tests/integration/test_reverse_text.py:88-100, for an offline tiny model)."""

from __future__ import annotations

import difflib
import random

from prime_rl_tpu_torch.envs.base import Environment, register_env
from prime_rl_tpu_torch.envs.client import InferenceClient
from prime_rl_tpu_torch.envs.types import Episode, SamplingConfig, Trace
from prime_rl_tpu_torch.renderers.tokenizer import ByteTokenizer


@register_env
class FixedCompletionEnv(Environment):
    name = "fixed_completion"

    def __init__(self, target: str = "ok", num_examples: int = 64, seed: int = 0, **kw):
        super().__init__(**kw)
        self.target = target
        self.tokenizer = ByteTokenizer()
        rng = random.Random(seed)
        # "demonstration" feeds OPSD's demo-conditioned self-teacher prefix
        self.tasks = [{"prompt": f"Say {target}", "demonstration": target,
                       "task_id": i} for i in range(num_examples)]

    def load_taskset(self) -> list[dict]:
        return self.tasks

    async def rollout(
        self, client: InferenceClient, task_data: dict, sampling: SamplingConfig
    ) -> Episode:
        tok = self.tokenizer
        prompt_ids = tok.apply_chat_template(
            [{"role": "user", "content": task_data["prompt"]}], add_generation_prompt=True
        )
        result = await client.generate(prompt_ids, sampling)
        completion = tok.decode(result.token_ids)
        sim = difflib.SequenceMatcher(None, completion.strip()[: 2 * len(self.target)], self.target).ratio()
        # bonus for clean stop right after the target
        stopped = result.token_ids and result.token_ids[-1] == tok.eos_token_id
        reward = 0.8 * sim + 0.2 * float(stopped and completion.strip() == self.target)
        n_p, n_c = len(prompt_ids), len(result.token_ids)
        trace = Trace(
            token_ids=list(prompt_ids) + list(result.token_ids),
            sampled_mask=[False] * n_p + [True] * n_c,
            logprobs=[0.0] * n_p + list(result.logprobs),
            temperatures=[1.0] * n_p + [sampling.temperature] * n_c,
            reward=reward,
            routed_experts=([None] * n_p + list(result.routed_experts)
                            if result.routed_experts is not None else None),
        )
        return Episode(traces=[trace], reward=reward,
                       metrics={"reward": reward}, info={"completion": completion})

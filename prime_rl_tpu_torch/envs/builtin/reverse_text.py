"""reverse_text: the canonical smoke env (reference: the reverse-text
integration scenario, tests/integration/test_reverse_text.py role).

Task: given a short string, produce it reversed. Reward is the normalized
edit-similarity between the completion and the reversed string — dense
enough that GRPO visibly learns within ~20 steps on a tiny model.
Uses the ByteTokenizer ChatML template, so it runs fully offline.
"""

from __future__ import annotations

import difflib
import random

from prime_rl_tpu_torch.envs.base import Environment, register_env
from prime_rl_tpu_torch.envs.client import InferenceClient
from prime_rl_tpu_torch.envs.types import Episode, SamplingConfig, Trace
from prime_rl_tpu_torch.renderers.tokenizer import ByteTokenizer

_WORDS = [
    "cat", "dog", "sun", "moon", "tree", "fish", "bird", "star", "rain", "snow",
    "book", "lamp", "door", "wind", "leaf", "rock", "wave", "fire", "sand", "cloud",
]


@register_env
class ReverseTextEnv(Environment):
    name = "reverse_text"

    def __init__(self, num_examples: int = 256, min_len: int = 3, max_len: int = 8, seed: int = 0, **kw):
        super().__init__(**kw)
        self.tokenizer = ByteTokenizer()
        rng = random.Random(seed)
        self.tasks = []
        for i in range(num_examples):
            word = rng.choice(_WORDS)[: rng.randint(min_len, max_len)]
            self.tasks.append({"text": word, "target": word[::-1], "task_id": i})

    def load_taskset(self) -> list[dict]:
        return self.tasks

    async def rollout(
        self, client: InferenceClient, task_data: dict, sampling: SamplingConfig
    ) -> Episode:
        tok = self.tokenizer
        prompt_ids = tok.apply_chat_template(
            [{"role": "user", "content": f"Reverse: {task_data['text']}"}],
            add_generation_prompt=True,
        )
        result = await client.generate(prompt_ids, sampling)
        completion = tok.decode(result.token_ids)
        reward = score(completion, task_data["target"])
        n_p, n_c = len(prompt_ids), len(result.token_ids)
        trace = Trace(
            token_ids=list(prompt_ids) + list(result.token_ids),
            sampled_mask=[False] * n_p + [True] * n_c,
            logprobs=[0.0] * n_p + list(result.logprobs),
            temperatures=[1.0] * n_p + [sampling.temperature] * n_c,
            reward=reward,
            routed_experts=([None] * n_p + list(result.routed_experts)
                            if result.routed_experts is not None else None),
            metrics={"completion_len": float(n_c)},
        )
        return Episode(
            traces=[trace],
            reward=reward,
            metrics={"reward": reward, "exact": float(completion.strip() == task_data["target"])},
            info={"completion": completion, "target": task_data["target"]},
        )


def score(completion: str, target: str) -> float:
    completion = completion.strip()
    if not completion:
        return 0.0
    return difflib.SequenceMatcher(None, completion[: 2 * len(target)], target).ratio()

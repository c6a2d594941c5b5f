"""Two-turn builtin env exercising the multi-turn trace machinery: the
assistant answers, the user says "again", the assistant must repeat its own
first answer verbatim. Rewards consistency; the per-token masks interleave
context and sampled spans (reference role: multi-turn verifiers envs)."""

from __future__ import annotations

import difflib
import random

from prime_rl_tpu_torch.envs.base import Environment, register_env
from prime_rl_tpu_torch.envs.client import InferenceClient
from prime_rl_tpu_torch.envs.types import Episode, SamplingConfig
from prime_rl_tpu_torch.renderers.renderer import ChatMLRenderer, TraceBuilder
from prime_rl_tpu_torch.renderers.tokenizer import ByteTokenizer

_WORDS = ["sun", "map", "key", "jar", "owl", "fig", "ice", "bat"]


@register_env
class RepeatAfterMeEnv(Environment):
    name = "repeat_after_me"

    def __init__(self, num_examples: int = 64, seed: int = 0, **kw):
        super().__init__(**kw)
        rng = random.Random(seed)
        self.tasks = [{"word": rng.choice(_WORDS), "task_id": i} for i in range(num_examples)]
        self.renderer = ChatMLRenderer(ByteTokenizer())

    def load_taskset(self) -> list[dict]:
        return self.tasks

    async def rollout(
        self, client: InferenceClient, task_data: dict, sampling: SamplingConfig
    ) -> Episode:
        builder = TraceBuilder(self.renderer)
        prompt = builder.add_context(
            [{"role": "user", "content": f"Say {task_data['word']}"}]
        )
        first = await client.generate(prompt, sampling)
        msg1 = builder.add_completion(first.token_ids, first.logprobs, sampling.temperature,
                                      routed_experts=first.routed_experts)

        prompt2 = builder.add_context([{"role": "user", "content": "again"}])
        second = await client.generate(prompt2, sampling)
        msg2 = builder.add_completion(second.token_ids, second.logprobs, sampling.temperature,
                                      routed_experts=second.routed_experts)

        a, b = msg1["content"].strip(), msg2["content"].strip()
        consistency = difflib.SequenceMatcher(None, a[:16], b[:16]).ratio() if a else 0.0
        accuracy = difflib.SequenceMatcher(None, a[:16], task_data["word"]).ratio()
        reward = 0.5 * consistency + 0.5 * accuracy
        trace = builder.to_trace(reward=reward, metrics={"consistency": consistency})
        return Episode(traces=[trace], reward=reward,
                       metrics={"reward": reward, "consistency": consistency},
                       info={"first": a, "second": b})

"""dominant_color: the VLM smoke env — fully offline image RL.

Task: a synthetic image whose pixel energy concentrates in one RGB channel;
the policy must name the color. The env exercises the whole multimodal RL
data plane end to end: pixel_values ride the generate wire to the serving
engine (vision-tower prefill + mRoPE), come back attached to the Trace, and
flow through TrainingSample.mm_kwargs into the packed VLM train step
(reference role: the qwen3_5 VLM families' rollout path —
trajectories.py:35-66 mm_kwargs contract; there is no reference builtin
image env, vision rollouts come from external verifiers envs).

Works against the ``debug_vlm`` spec (ByteTokenizer + tiny vision tower);
grid/patch geometry is configurable to match any qwen3_vl-family spec.
"""

from __future__ import annotations

import difflib
import random

import numpy as np

from prime_rl_tpu_torch.envs.base import Environment, register_env
from prime_rl_tpu_torch.envs.client import InferenceClient
from prime_rl_tpu_torch.envs.types import Episode, SamplingConfig, Trace
from prime_rl_tpu_torch.renderers.tokenizer import ByteTokenizer

_COLORS = ["red", "green", "blue"]


@register_env
class DominantColorEnv(Environment):
    name = "dominant_color"

    def __init__(
        self,
        num_examples: int = 256,
        grid: tuple[int, int, int] = (1, 4, 4),  # (t, h, w) in patches
        patch_size: int = 4,
        temporal_patch_size: int = 2,
        in_channels: int = 3,
        spatial_merge_size: int = 2,
        vision_start_token_id: int = 300,
        image_token_id: int = 301,
        noise: float = 0.25,
        seed: int = 0,
        **kw,
    ):
        super().__init__(**kw)
        self.tokenizer = ByteTokenizer()
        self.grid = tuple(int(g) for g in grid)
        self.patch_dim = in_channels * temporal_patch_size * patch_size**2
        self.in_channels = in_channels
        self.merge = spatial_merge_size
        self.vstart, self.img_tok = vision_start_token_id, image_token_id
        self.noise = noise
        rng = random.Random(seed)
        self.tasks = [
            {"task_id": i, "color": rng.choice(_COLORS), "seed": i}
            for i in range(num_examples)
        ]

    def load_taskset(self) -> list[dict]:
        return self.tasks

    def _make_image(self, color: str, seed: int) -> np.ndarray:
        """[P, patch_dim] f32: per-channel blocks (HF processor flattens each
        patch channels-major); the dominant channel carries ~1.0 energy."""
        t, h, w = self.grid
        rng = np.random.default_rng(seed)
        pv = rng.standard_normal((t * h * w, self.patch_dim)).astype(np.float32) * self.noise
        per_ch = self.patch_dim // self.in_channels
        ch = _COLORS.index(color)
        pv[:, ch * per_ch:(ch + 1) * per_ch] += 1.0
        return pv

    async def rollout(
        self, client: InferenceClient, task_data: dict, sampling: SamplingConfig
    ) -> Episode:
        tok = self.tokenizer
        t, h, w = self.grid
        n_merged = t * (h // self.merge) * (w // self.merge)
        color = task_data["color"]
        pv = self._make_image(color, int(task_data["seed"]))
        mm = {"pixel_values": pv,
              "image_grid_thw": np.asarray([[t, h, w]], np.int64)}

        prompt_ids = (
            tok.encode("What color? ")
            + [self.vstart] + [self.img_tok] * n_merged
            + tok.encode("\nAnswer: ")
        )
        result = await client.generate(prompt_ids, sampling, mm=mm)
        completion = tok.decode(result.token_ids)
        reward = score(completion, color)
        n_p, n_c = len(prompt_ids), len(result.token_ids)
        trace = Trace(
            token_ids=list(prompt_ids) + list(result.token_ids),
            sampled_mask=[False] * n_p + [True] * n_c,
            logprobs=[0.0] * n_p + list(result.logprobs),
            temperatures=[1.0] * n_p + [sampling.temperature] * n_c,
            reward=reward,
            mm_kwargs=mm,
            metrics={"completion_len": float(n_c)},
        )
        return Episode(
            traces=[trace],
            reward=reward,
            metrics={"reward": reward,
                     "exact": float(completion.strip().lower().startswith(color))},
            info={"completion": completion, "target": color},
        )


def score(completion: str, target: str) -> float:
    completion = completion.strip().lower()
    if not completion:
        return 0.0
    if completion.startswith(target):
        return 1.0
    return 0.5 * difflib.SequenceMatcher(
        None, completion[: 2 * len(target)], target).ratio()

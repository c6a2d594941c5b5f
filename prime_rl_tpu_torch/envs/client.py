"""Token-level async inference client used inside env rollouts
(reference role: the verifiers agent harness calling
``/inference/v1/generate`` — SURVEY.md §3.2)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import httpx

from prime_rl_tpu_torch.envs.types import SamplingConfig


@dataclass
class TokenCompletion:
    token_ids: list[int]
    logprobs: list[float]
    finish_reason: str
    prompt_len: int
    policy_version: int = -1
    prompt_logprobs: list[float] | None = None
    # MoE router replay: [n_gen, NL_moe, K] expert ids (engine
    # collect_routed_experts), None otherwise
    routed_experts: list | None = None


class InferenceClient:
    """Async client for the sampler's token route."""

    def __init__(self, base_url: str, timeout: float = 1200.0):
        self.base_url = base_url.rstrip("/")
        self._client = httpx.AsyncClient(timeout=timeout)

    async def generate(
        self,
        token_ids: list[int],
        sampling: SamplingConfig,
        *,
        prompt_logprobs: bool = False,
        cache_salt: str | None = None,
        mm: dict | None = None,
    ) -> TokenCompletion:
        payload: dict[str, Any] = {
            "token_ids": token_ids,
            "sampling_params": {
                "max_tokens": sampling.max_tokens,
                "temperature": sampling.temperature,
                "top_p": sampling.top_p,
                "top_k": sampling.top_k,
                "logprobs": True,
                "prompt_logprobs": int(prompt_logprobs),
                **({"seed": sampling.seed} if sampling.seed is not None else {}),
                **({"adapter": sampling.adapter}
                   if getattr(sampling, "adapter", None) else {}),
            },
        }
        if cache_salt is not None:
            payload["cache_salt"] = cache_salt
        if mm is not None:
            # VLM inputs on the generate wire (server _mm_from_body contract):
            # pixel_values as base64 f32 LE + shape, grid as nested lists
            import base64

            import numpy as np

            pv = np.ascontiguousarray(np.asarray(mm["pixel_values"], np.float32))
            payload["mm"] = {
                "pixel_values": {"b64": base64.b64encode(pv.tobytes()).decode(),
                                 "shape": list(pv.shape)},
                "image_grid_thw": np.asarray(mm["image_grid_thw"]).tolist(),
            }
        r = await self._client.post(f"{self.base_url}/inference/v1/generate", json=payload)
        r.raise_for_status()
        body = r.json()
        choice = body["choices"][0]
        plp = None
        if body.get("prompt_logprobs") is not None:
            plp = [
                0.0 if e is None else float(next(iter(e.values()))["logprob"])
                for e in body["prompt_logprobs"]
            ]
        return TokenCompletion(
            token_ids=choice["token_ids"],
            logprobs=choice["logprobs"] or [],
            finish_reason=choice["finish_reason"],
            prompt_len=body["usage"]["prompt_tokens"],
            policy_version=body.get("policy_version", -1),
            prompt_logprobs=plp,
            routed_experts=choice.get("routed_experts"),
        )

    async def prefill_logprobs(self, token_ids: list[int]) -> list[float]:
        """Score a token stream: one logprob per token (0.0 leading)
        (reference: utils/client.py:599)."""
        result = await self.generate(
            token_ids, SamplingConfig(max_tokens=1, temperature=1.0), prompt_logprobs=True
        )
        return result.prompt_logprobs or []

    async def abort(self, request_id: str) -> bool:
        """Cancel an in-flight request (off-policy cancel path;
        reference: dispatcher.py:272-303 → vLLM abort)."""
        r = await self._client.post(
            f"{self.base_url}/abort", json={"request_id": request_id}, timeout=10
        )
        r.raise_for_status()
        return r.json().get("status") == "ok"

    async def update_weights(self, weight_dir: str, version: int) -> None:
        r = await self._client.post(
            f"{self.base_url}/update_weights",
            json={"weight_dir": weight_dir, "version": version},
            timeout=600,
        )
        r.raise_for_status()

    async def load_lora_adapter(self, name: str, path: str) -> None:
        """Install a PEFT adapter into the engine's serving bank
        (reference: inference/vllm/server.py:98-147)."""
        r = await self._client.post(
            f"{self.base_url}/load_lora_adapter",
            json={"lora_name": name, "lora_path": path},
        )
        r.raise_for_status()

    async def unload_lora_adapter(self, name: str) -> None:
        r = await self._client.post(
            f"{self.base_url}/unload_lora_adapter", json={"lora_name": name}
        )
        r.raise_for_status()

    async def pause(self) -> None:
        (await self._client.post(f"{self.base_url}/pause")).raise_for_status()

    async def resume(self) -> None:
        (await self._client.post(f"{self.base_url}/resume")).raise_for_status()

    async def liveness(self) -> dict:
        r = await self._client.get(f"{self.base_url}/liveness", timeout=10)
        r.raise_for_status()
        return r.json()

    async def close(self) -> None:
        await self._client.aclose()

"""The port's serving slice on the CPU: its ``Engine`` generates greedily the
same tokens as the JAX ``Engine`` from the same weights and prompts
(continuous batching, batched and single prefill, a prefix-cache hit that
takes the chunked path, multi-token decode blocks), and its HTTP server
(built by the port's entry point with ``device="cpu"``) answers the routes
``tests/unit/sampler/test_server.py`` checks on the JAX server.

Greedy tokens must be equal: both engines compute in float32 and the
weights are scaled so that argmax margins dwarf summation-order noise.
"""

import asyncio
import json
import socket

import aiohttp
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prime_rl_tpu.models import qwen3 as jqwen3
from prime_rl_tpu.models.base import debug_spec as j_debug_spec
from prime_rl_tpu.sampler.cache import CacheConfig as JCacheConfig
from prime_rl_tpu.sampler.engine import Engine as JEngine
from prime_rl_tpu.sampler.engine import SamplingParams as JSamplingParams
from prime_rl_tpu_torch.models import qwen3 as tqwen3
from prime_rl_tpu_torch.models.base import debug_spec
from prime_rl_tpu_torch.sampler.cache import CacheConfig
from prime_rl_tpu_torch.sampler.engine import Engine, SamplingParams
from prime_rl_tpu_torch.trainer.weights import save_hf_weights

torch.set_num_threads(1)


def test_engine_greedy_matches_jax_engine():
    kw = dict(vocab_size=128, num_layers=2)
    jspec, tspec = j_debug_spec(**kw), debug_spec(**kw)
    jparams = jax.tree.map(lambda x: x * 3.0, jqwen3.init_params(jspec, jax.random.key(0)))
    tparams = tqwen3.params_from_jax(jax.device_get(jparams), tspec)
    cache = dict(num_pages=64, page_size=16, max_slots=4, max_seq_len=256)
    jeng = JEngine(jparams, jspec, JCacheConfig(**cache), compute_dtype=jnp.float32,
                   decode_block=2)
    teng = Engine(tparams, tspec, CacheConfig(**cache), device="cpu",
                  compute_dtype=torch.float32, decode_block=2)

    rng = np.random.default_rng(3)
    # a burst (batched prefill for the same-bucket prompts, more requests
    # than slots), then a prompt sharing two full pages with the burst
    # (prefix-cache hit -> chunked prefill) and a stop id
    prompts = [[int(x) for x in rng.integers(1, 100, n)] for n in (5, 17, 33, 9, 40, 70)]
    greedy = dict(max_tokens=10, temperature=0.0)
    want = jeng.generate(prompts, JSamplingParams(**greedy))
    got = teng.generate(prompts, SamplingParams(**greedy))
    assert [r.token_ids for r in got] == [r.token_ids for r in want]
    assert [r.finish_reason for r in got] == [r.finish_reason for r in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.logprobs, w.logprobs, atol=1e-4, rtol=1e-4)

    follow = prompts[5][:32] + [3, 4, 5]
    stop = want[0].token_ids[3]
    sp = dict(max_tokens=12, temperature=0.0, stop_token_ids=[stop])
    want2 = jeng.generate([follow, prompts[0]], JSamplingParams(**sp))
    got2 = teng.generate([follow, prompts[0]], SamplingParams(**sp))
    assert [r.token_ids for r in got2] == [r.token_ids for r in want2]
    assert got2[1].finish_reason == want2[1].finish_reason == "stop"
    assert teng.stats["prefill_tokens_cached"] == jeng.stats["prefill_tokens_cached"] > 0


def test_engine_raises_for_unported_features():
    spec = debug_spec(num_layers=1)
    params = tqwen3.init_params(spec, torch.Generator().manual_seed(0))
    eng = Engine(params, spec, CacheConfig(num_pages=8, page_size=16, max_slots=2,
                                           max_seq_len=64), device="cpu")
    with pytest.raises(NotImplementedError, match="P/D"):
        eng.submit([1, 2], SamplingParams(extract_kv=True))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            Engine(params, spec, CacheConfig(num_pages=8, page_size=16, max_slots=2,
                                             max_seq_len=64), device="cuda")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_http_server_routes(tmp_path):
    from prime_rl_tpu_torch.configs import InferenceConfig
    from prime_rl_tpu_torch.entrypoints.inference import build_server

    config = InferenceConfig(
        device="cpu", output_dir=str(tmp_path), max_model_len=256,
        model={"name": "debug", "debug": {"random_init": True, "num_layers": 2}},
        tokenizer={"name": "byte"}, kv={"num_pages": 64, "page_size": 16},
        scheduler={"max_batch_size": 4, "decode_block": 2},
    )
    server = build_server(config)
    port = _free_port()
    base = f"http://127.0.0.1:{port}"

    async def run():
        runner = await server.start_async("127.0.0.1", port)
        try:
            async with aiohttp.ClientSession(timeout=aiohttp.ClientTimeout(total=120)) as http:
                r = await http.post(f"{base}/inference/v1/generate", json={
                    "token_ids": [1, 2, 3, 4, 5],
                    "sampling_params": {"max_tokens": 8, "temperature": 0.7, "seed": 1}})
                assert r.status == 200, await r.text()
                body = await r.json()
                choice = body["choices"][0]
                assert 1 <= len(choice["token_ids"]) <= 8
                assert len(choice["logprobs"]) == len(choice["token_ids"])
                assert all(np.isfinite(choice["logprobs"]))
                assert choice["finish_reason"] in ("stop", "length")
                assert body["usage"]["prompt_tokens"] == 5

                r = await http.post(f"{base}/inference/v1/generate", json={
                    "token_ids": [7, 8, 9, 10],
                    "sampling_params": {"max_tokens": 1, "prompt_logprobs": 1}})
                plp = (await r.json())["prompt_logprobs"]
                assert plp is not None and len(plp) == 4 and plp[0] is None
                assert "logprob" in next(iter(plp[1].values()))

                r = await http.post(f"{base}/v1/chat/completions", json={
                    "model": "debug", "messages": [{"role": "user", "content": "hi"}],
                    "max_tokens": 8, "temperature": 0.5})
                assert r.status == 200, await r.text()
                body = await r.json()
                assert body["object"] == "chat.completion"
                assert isinstance(body["choices"][0]["message"]["content"], str)

                async with http.post(f"{base}/v1/chat/completions", json={
                        "model": "m", "messages": [{"role": "user", "content": "hi"}],
                        "max_tokens": 6, "temperature": 0.8, "stream": True}) as r:
                    assert r.status == 200
                    assert r.headers["content-type"].startswith("text/event-stream")
                    events = [line[6:] for line in (await r.text()).splitlines()
                              if line.startswith("data: ")]
                assert events[-1] == "[DONE]"
                chunks = [json.loads(e) for e in events[:-1]]
                assert chunks[0]["choices"][0]["delta"].get("role") == "assistant"
                assert chunks[-1]["choices"][0]["finish_reason"] in ("stop", "length")

                r = await http.post(f"{base}/v1/completions",
                                    json={"prompt": "abc", "max_tokens": 4})
                assert (await r.json())["choices"][0]["finish_reason"] in ("stop", "length")
                assert (await (await http.get(f"{base}/v1/models")).json())["data"][0]["id"]
                assert (await (await http.post(f"{base}/pause")).json())["status"] == "paused"
                assert (await (await http.get(f"{base}/liveness")).json())["paused"] is True
                assert (await (await http.post(f"{base}/resume")).json())["status"] == "running"
                assert "prime_rl_engine_requests_total" in await (
                    await http.get(f"{base}/metrics")).text()
                # /update_weights applies an HF snapshot and bumps the version:
                # afterwards the engine serves the snapshot's weights
                assert (await (await http.get(f"{base}/liveness")).json())["policy_version"] == -1
                spec = server.engine.spec
                gen = torch.Generator().manual_seed(7)
                snap = save_hf_weights(tqwen3.init_params(spec, gen), spec, tmp_path / "snap")
                r = await http.post(f"{base}/update_weights",
                                    json={"weight_dir": str(snap), "version": 3})
                assert r.status == 200, await r.text()
                assert (await r.json()) == {"status": "ok", "version": 3}
                assert (await (await http.get(f"{base}/liveness")).json())["policy_version"] == 3
                want = tqwen3.load_hf_weights(snap, spec, dtype=torch.bfloat16)
                assert torch.equal(server.engine.params["embed"], want["embed"])
                assert torch.equal(server.engine.params["layers"][1]["q"], want["layers"]["q"][1])
                r = await http.post(f"{base}/inference/v1/generate", json={
                    "token_ids": [1, 2, 3], "sampling_params": {"max_tokens": 2}})
                assert (await r.json())["policy_version"] == 3
                r = await http.post(f"{base}/update_weights", json={"version": 4})
                assert r.status == 400  # no weight_dir
        finally:
            await server.stop_async(runner)

    asyncio.run(run())

"""Multi-LoRA serving in the port against the JAX package on the CPU: the
sampler's prefill, batched prefill, chunk and decode with two adapters and
base rows in one batch, the engine's greedy tokens with the same adapters
loaded, the bank's full / unknown / unload cases, K3's rule with a bank,
and the two endpoints over HTTP.

Tolerances: 1e-4 absolute and relative on hidden states and logits (float32,
two layers; the bank's delta sums over every bank row where the JAX
function gathers one, exact zeros added); greedy tokens equal (the weights
are scaled so that argmax margins dwarf summation-order noise)."""

from __future__ import annotations

import asyncio
import socket

import aiohttp
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prime_rl_tpu.configs.inference import ServingLoRAConfig as JServingLoRAConfig
from prime_rl_tpu.models import lora as jlora
from prime_rl_tpu.models import qwen3 as jqwen3
from prime_rl_tpu.models.base import debug_spec as j_debug_spec
from prime_rl_tpu.sampler import model as jmodel
from prime_rl_tpu.sampler.cache import CacheConfig as JCacheConfig
from prime_rl_tpu.sampler.engine import Engine as JEngine
from prime_rl_tpu.sampler.engine import SamplingParams as JSamplingParams
from prime_rl_tpu_torch.configs.inference import ServingLoRAConfig
from prime_rl_tpu_torch.models import lora as tlora
from prime_rl_tpu_torch.models import qwen3 as tqwen3
from prime_rl_tpu_torch.models.base import debug_spec
from prime_rl_tpu_torch.sampler import model as tmodel
from prime_rl_tpu_torch.sampler.cache import CacheConfig
from prime_rl_tpu_torch.sampler.engine import Engine, SamplingParams

torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-4)
RANK, ALPHA = 4, 8.0
TARGETS = ["q", "k", "v", "o", "gate", "up", "down"]


def _adapter(jspec, seed: int, scale: float = 1.0) -> dict:
    """Stacked numpy adapter {"q_a": [NL, in, r], ...} with B != 0."""
    cfg = JServingLoRAConfig(rank=RANK, alpha=ALPHA, target_modules=TARGETS)
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: jlora.init_lora(jspec, cfg, jax.random.key(0)))
    return {k: (rng.standard_normal(v.shape) * 0.1 * scale).astype(np.float32)
            for k, v in shapes["layers"].items()}


def _models(kw, scale: float = 1.0):
    jspec, tspec = j_debug_spec(**kw), debug_spec(**kw)
    jparams = jax.tree.map(lambda x: x * scale, jqwen3.init_params(jspec, jax.random.key(0)))
    tparams = tqwen3.params_from_jax(jax.device_get(jparams), tspec)
    return jspec, jparams, tspec, tparams


def _bank_layers(jp, tp, adapters: list[dict]):
    """Attach a bank of rows [0 (zeros), *adapters] to both packages' serving
    layouts, per layer ``{t}_a`` [NA, in, r] in JAX's and [in, NA, r] in the
    port's, ``{t}_b`` [NA, r, out] in both."""
    scale = ALPHA / RANK
    for li, (jl, tl) in enumerate(zip(jp["layers"], tp["layers"])):
        bank = {k: np.stack([np.zeros_like(adapters[0][k][li])] + [a[k][li] for a in adapters])
                for k in adapters[0]}
        jl["lora"] = {**{k: jnp.asarray(v) for k, v in bank.items()},
                      "scale": jnp.float32(scale)}
        tl["lora"] = {**{k: torch.from_numpy(np.ascontiguousarray(
            v.transpose(1, 0, 2) if k.endswith("_a") else v)) for k, v in bank.items()},
            "scale": scale}


def test_sampler_paths_with_two_adapters_and_base_rows_match_jax():
    """Prefill (adapter 1, prompt logprobs), the batched prefill (adapter 2),
    a chunk over a shared page (adapter 1) and two decode steps whose slots
    carry adapters 1, 2 and the base (row 0) in one batch, against the JAX
    sampler with the same bank, float32 at 1e-4."""
    kw = dict(vocab_size=256, hidden_size=128, num_layers=2, num_heads=4, num_kv_heads=2,
              head_dim=32, intermediate_size=256)
    jspec, jparams, tspec, tparams = _models(kw)
    jp, tp = jmodel.unstack_params(jparams, jspec), tmodel.unstack_params(tparams, tspec)
    _bank_layers(jp, tp, [_adapter(jspec, 1), _adapter(jspec, 2)])
    f32 = dict(compute_dtype=jnp.float32)
    rng = np.random.default_rng(3)
    shape = (jspec.num_kv_heads, 24, 16, jspec.head_dim)
    jk = [jnp.zeros(shape) for _ in range(2)]
    jv = [jnp.zeros(shape) for _ in range(2)]
    tk = [torch.zeros(shape) for _ in range(2)]
    tv = [torch.zeros(shape) for _ in range(2)]

    ids = rng.integers(1, 250, (2, 64)).astype(np.int32)
    lengths = np.asarray([37, 64], np.int32)
    pages = np.asarray([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
    jk, jv, j_h = jmodel.prefill_batch(jp, jspec, jk, jv, jnp.asarray(ids), jnp.asarray(lengths),
                                       jnp.asarray(pages), attn_impl="xla",
                                       adapter_idx=jnp.int32(2), **f32)
    _, _, t_h = tmodel.prefill_batch(tp, tspec, tk, tv, torch.from_numpy(ids.astype(np.int64)),
                                     torch.from_numpy(lengths), torch.from_numpy(pages),
                                     compute_dtype=torch.float32, adapter_idx=torch.tensor(2))
    np.testing.assert_allclose(t_h.numpy(), np.asarray(j_h), **TOL)

    ids1 = rng.integers(1, 250, (1, 64)).astype(np.int32)
    jk, jv, j_h1, j_plp, _ = jmodel.prefill(jp, jspec, jk, jv, jnp.asarray(ids1), jnp.int32(50),
                                            jnp.asarray([9, 10, 11, 12], jnp.int32),
                                            attn_impl="xla", want_prompt_logprobs=True,
                                            adapter_idx=jnp.int32(1), **f32)
    _, _, t_h1, t_plp = tmodel.prefill(tp, tspec, tk, tv, torch.from_numpy(ids1.astype(np.int64)),
                                       50, torch.tensor([9, 10, 11, 12]),
                                       compute_dtype=torch.float32, want_prompt_logprobs=True,
                                       adapter_idx=torch.tensor(1))
    np.testing.assert_allclose(t_h1.numpy(), np.asarray(j_h1), **TOL)
    np.testing.assert_allclose(t_plp.numpy()[:50], np.asarray(j_plp)[:50], **TOL)
    # the adapter changed the function: the base's prefill differs
    _, _, base_h1, _ = tmodel.prefill(tp, tspec, [t.clone() for t in tk],
                                      [t.clone() for t in tv],
                                      torch.from_numpy(ids1.astype(np.int64)), 50,
                                      torch.tensor([9, 10, 11, 12]), compute_dtype=torch.float32,
                                      adapter_idx=torch.tensor(0))
    assert float((base_h1 - t_h1).abs().max()) > 1e-2

    table = np.zeros((4, 8), np.int32)
    table[0, :4], table[1, :4], table[2, :4] = [1, 2, 3, 4], [5, 6, 7, 8], [9, 10, 11, 12]
    table[:3, 4] = [13, 14, 15]
    lens = np.asarray([37, 64, 50, 0], np.int32)
    toks = np.asarray([3, 7, 11, 0], np.int32)
    rows = np.asarray([2, 0, 1, 0], np.int32)  # adapter 2, the base, adapter 1, idle
    for _ in range(2):
        jk, jv, j_logits, *_ = jmodel.decode(jp, jspec, jk, jv, jnp.asarray(toks),
                                             jnp.asarray(lens), jnp.asarray(table),
                                             attn_impl="xla", adapter_idx=jnp.asarray(rows),
                                             **f32)
        _, _, t_logits = tmodel.decode(tp, tspec, tk, tv, torch.from_numpy(toks),
                                       torch.from_numpy(lens), torch.from_numpy(table),
                                       compute_dtype=torch.float32,
                                       adapter_idx=torch.from_numpy(rows))
        np.testing.assert_allclose(t_logits.numpy()[:3], np.asarray(j_logits)[:3], **TOL)
        toks = np.asarray(j_logits).argmax(-1).astype(np.int32)
        lens = lens + np.asarray([1, 1, 1, 0], np.int32)
    for jl, tl in zip(jk + jv, tk + tv):
        np.testing.assert_allclose(tl.numpy()[:, 1:], np.asarray(jl)[:, 1:], **TOL)

    prompt = np.concatenate([ids[0, :16], rng.integers(1, 250, 40)]).astype(np.int32)
    row = np.asarray([1, 16, 17, 18, 19, 0, 0, 0], np.int32)
    for off, valid in ((16, 32), (48, 8)):
        chunk = np.zeros((1, 32), np.int32)
        chunk[0, :valid] = prompt[off:off + valid]
        pch = row[off // 16: off // 16 + 2]
        jk, jv, j_last = jmodel.prefill_chunk(jp, jspec, jk, jv, jnp.asarray(chunk),
                                              jnp.int32(off), jnp.int32(valid),
                                              jnp.asarray(pch), jnp.asarray(row),
                                              adapter_idx=jnp.int32(1), **f32)
        _, _, t_last = tmodel.prefill_chunk(tp, tspec, tk, tv,
                                            torch.from_numpy(chunk.astype(np.int64)), off, valid,
                                            torch.from_numpy(pch), torch.from_numpy(row),
                                            compute_dtype=torch.float32,
                                            adapter_idx=torch.tensor(1))
        np.testing.assert_allclose(t_last.numpy(), np.asarray(j_last), **TOL)


def _engines(max_adapters: int = 4, scale: float = 3.0):
    kw = dict(vocab_size=128, num_layers=2)
    jspec, jparams, tspec, tparams = _models(kw, scale)
    cache = dict(num_pages=64, page_size=16, max_slots=4, max_seq_len=256)
    lcfg = dict(max_adapters=max_adapters, rank=RANK, alpha=ALPHA, target_modules=TARGETS)
    jeng = JEngine(jparams, jspec, JCacheConfig(**cache), compute_dtype=jnp.float32,
                   decode_block=2, lora_config=JServingLoRAConfig(**lcfg))
    teng = Engine(tparams, tspec, CacheConfig(**cache), device="cpu",
                  compute_dtype=torch.float32, decode_block=2,
                  lora_config=ServingLoRAConfig(**lcfg))
    return jspec, jeng, tspec, teng


def test_engine_greedy_with_adapters_matches_jax_engine():
    """Two adapters loaded in both engines; a burst of prompts split over the
    base and the adapters (batched prefill by (bucket, adapter), more
    requests than slots, mixed decode), then a prompt sharing pages with an
    earlier one under another adapter (no prefix reuse across adapters): the
    same greedy tokens and logprobs within 1e-4, and the adapters change the
    tokens."""
    jspec, jeng, _, teng = _engines()
    ads = {"a1": _adapter(jspec, 11), "a2": _adapter(jspec, 12)}
    for name, ad in ads.items():
        jeng.load_adapter(name, ad)
        teng.load_adapter(name, ad)
    assert teng.adapters == jeng.adapters == {"a1": 1, "a2": 2}
    rng = np.random.default_rng(5)
    prompts = [[int(x) for x in rng.integers(1, 100, n)] for n in (5, 17, 33, 9, 40, 70, 12)]
    names = [None, "a1", "a2", "a1", None, "a2", "a1"]
    greedy = dict(max_tokens=10, temperature=0.0)
    want = jeng.generate(prompts, [JSamplingParams(**greedy, adapter=n) for n in names])
    got = teng.generate(prompts, [SamplingParams(**greedy, adapter=n) for n in names])
    assert [r.token_ids for r in got] == [r.token_ids for r in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.logprobs, w.logprobs, **TOL)
    base = teng.generate(prompts[:3], SamplingParams(**greedy))
    assert base[0].token_ids == got[0].token_ids
    assert base[1].token_ids != got[1].token_ids or base[2].token_ids != got[2].token_ids

    follow = prompts[5][:32] + [3, 4, 5]
    sps = [dict(greedy, adapter="a1"), dict(greedy, adapter="a2")]
    want2 = jeng.generate([follow, follow], [JSamplingParams(**s) for s in sps])
    got2 = teng.generate([follow, follow], [SamplingParams(**s) for s in sps])
    assert [r.token_ids for r in got2] == [r.token_ids for r in want2]


def test_bank_equals_an_engine_on_the_merged_weights():
    """One adapter through the bank against an engine (no bank) on that
    adapter's merged weights, float32: the same greedy tokens, logprobs
    within 1e-4; base requests in the same mixed batch equal a bank-less
    engine's."""
    jspec, _, tspec, teng = _engines()
    ad = _adapter(jspec, 31)
    teng.load_adapter("m", ad)
    params = tqwen3.params_from_jax(jax.device_get(jax.tree.map(
        lambda x: x * 3.0, jqwen3.init_params(jspec, jax.random.key(0)))), tspec)
    merged = tlora.merge_lora(params, tlora.lora_from_jax({"layers": ad}),
                              ServingLoRAConfig(rank=RANK, alpha=ALPHA), spec=tspec)
    cache = CacheConfig(num_pages=64, page_size=16, max_slots=4, max_seq_len=256)
    on_merged = Engine(merged, tspec, cache, device="cpu", compute_dtype=torch.float32,
                       decode_block=2)
    plain = Engine(params, tspec, cache, device="cpu", compute_dtype=torch.float32,
                   decode_block=2)
    rng = np.random.default_rng(9)
    prompts = [[int(x) for x in rng.integers(1, 100, n)] for n in (7, 21, 30, 11)]
    greedy = dict(max_tokens=8, temperature=0.0)
    got = teng.generate(prompts, [SamplingParams(**greedy, adapter=n)
                                  for n in ("m", None, "m", None)])
    want_m = on_merged.generate(prompts[::2], SamplingParams(**greedy))
    want_b = plain.generate(prompts[1::2], SamplingParams(**greedy))
    for g, w in zip(got[::2] + got[1::2], want_m + want_b):
        assert g.token_ids == w.token_ids
        np.testing.assert_allclose(g.logprobs, w.logprobs, **TOL)


def test_bank_full_unknown_and_unload():
    """A bank of two: a third adapter is refused; a request naming an unknown
    adapter gets the error and the engine keeps serving; after unload the row
    is zero, a request naming the adapter gets the error, and the freed row
    takes the next load. Refreshing an adapter under its name changes its
    load generation, so no prefix page of the old load is reused."""
    jspec, _, tspec, teng = _engines(max_adapters=2)
    teng.load_adapter("a", _adapter(jspec, 1))
    teng.load_adapter("b", _adapter(jspec, 2))
    with pytest.raises(RuntimeError, match="adapter bank full"):
        teng.load_adapter("c", _adapter(jspec, 3))
    with pytest.raises(ValueError, match="rank/targets"):
        teng.load_adapter("a", {k: v[:, :, :2] if k.endswith("_a") else v
                                for k, v in _adapter(jspec, 4).items()})
    sp = SamplingParams(max_tokens=3, temperature=0.0, adapter="nope")
    fut = teng.submit([1, 2, 3], sp)
    ok = teng.submit([1, 2, 3], SamplingParams(max_tokens=3, temperature=0.0, adapter="b"))
    teng.run_until_idle()
    with pytest.raises(ValueError, match="unknown LoRA adapter 'nope'"):
        fut.result()
    assert len(ok.result().token_ids) == 3
    assert teng.unload_adapter("a") and not teng.unload_adapter("a")
    assert all(float(teng._row(k, 1).abs().max()) == 0 for k in teng._lora_bank)
    fut = teng.submit([1, 2, 3], SamplingParams(max_tokens=3, adapter="a"))
    teng.run_until_idle()
    with pytest.raises(ValueError, match="unknown LoRA adapter 'a'"):
        fut.result()
    teng.load_adapter("c", _adapter(jspec, 3))
    assert teng.adapters == {"b": 2, "c": 1}
    salt = teng._salt(SamplingParams(adapter="b"))
    teng.load_adapter("b", _adapter(jspec, 5))
    assert teng._salt(SamplingParams(adapter="b")) != salt


def test_takes_k3_is_false_with_a_bank():
    """K3 never runs with a bank attached: every layer carries ``lora`` and
    decode passes every slot's row, the base's too, as the JAX decode takes
    its kernel only for ``adapter_idx is None`` and no ``lora`` in the layer."""
    _, _, tspec, teng = _engines()
    for lp in teng.params["layers"]:
        assert "lora" in lp
        assert not tmodel.takes_k3(tspec, lp)
        assert not tmodel.takes_k3(tspec, {k: v for k, v in lp.items() if k != "lora"},
                                   teng._d_adapter)
        assert tmodel.takes_k3(tspec, {k: v for k, v in lp.items() if k != "lora"})
    from prime_rl_tpu_torch.models import get_family
    from prime_rl_tpu_torch.models.base import get_spec

    spec = get_spec("debug_moe")
    params = get_family(spec).init(spec, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="not servable"):
        Engine(params, spec, CacheConfig(num_pages=8, page_size=16, max_slots=2,
                                         max_seq_len=64),
               device="cpu", lora_config=ServingLoRAConfig(target_modules=["q", "moe_up"]))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_lora_endpoints_over_http(tmp_path):
    """The inference entry point with ``lora``: ``/load_lora_adapter`` from a
    directory and from a ``.safetensors`` file (the same adapter: the same
    greedy tokens, which differ from the base's), a missing path answered
    400, requests that pick the adapter by ``lora_name`` and by the chat
    ``model``, ``/unload_lora_adapter``, and a request naming the unloaded
    adapter gets the error."""
    from prime_rl_tpu_torch.configs import InferenceConfig
    from prime_rl_tpu_torch.entrypoints.inference import build_server

    config = InferenceConfig(
        device="cpu", output_dir=str(tmp_path), max_model_len=256,
        model={"name": "debug", "debug": {"random_init": True, "num_layers": 2}},
        tokenizer={"name": "byte"}, kv={"num_pages": 64, "page_size": 16},
        scheduler={"max_batch_size": 4, "decode_block": 2},
        lora={"max_adapters": 2, "rank": RANK, "alpha": ALPHA, "target_modules": TARGETS},
    )
    server = build_server(config)
    spec = server.engine.spec
    from prime_rl_tpu.models.base import get_spec as j_get_spec

    ad = _adapter(j_get_spec("debug", num_layers=2), 21, scale=3.0)
    lora = tlora.lora_from_jax({"layers": ad})
    tlora.save_adapter(lora, spec, tmp_path / "ad_dir")
    (tmp_path / "ad_dir" / "adapter_model.safetensors").rename(tmp_path / "ad.safetensors")
    tlora.save_adapter(lora, spec, tmp_path / "ad_dir")
    port = _free_port()
    base = f"http://127.0.0.1:{port}"
    prompt = [5, 6, 7, 8, 9, 10]

    async def run():
        runner = await server.start_async("127.0.0.1", port)
        try:
            async with aiohttp.ClientSession(timeout=aiohttp.ClientTimeout(total=120)) as http:
                async def gen(**extra):
                    r = await http.post(f"{base}/inference/v1/generate", json={
                        "token_ids": prompt, **extra,
                        "sampling_params": {"max_tokens": 6, "temperature": 0.0,
                                            "ignore_eos": True}})
                    return r.status, await r.json()

                r = await http.post(f"{base}/load_lora_adapter",
                                    json={"lora_name": "x", "lora_path": str(tmp_path / "ad_dir")})
                assert r.status == 200 and (await r.json())["adapters"] == ["x"]
                r = await http.post(f"{base}/load_lora_adapter", json={
                    "lora_name": "y", "lora_path": str(tmp_path / "ad.safetensors")})
                assert (await r.json())["adapters"] == ["x", "y"]
                r = await http.post(f"{base}/load_lora_adapter", json={
                    "lora_name": "z", "lora_path": str(tmp_path / "missing")})
                assert r.status == 400
                status, with_x = await gen(lora_name="x")
                assert status == 200
                _, with_y = await gen(lora_name="y")
                _, plain = await gen()
                x_tokens = with_x["choices"][0]["token_ids"]
                assert x_tokens == with_y["choices"][0]["token_ids"]
                assert x_tokens != plain["choices"][0]["token_ids"]
                r = await http.post(f"{base}/v1/chat/completions", json={
                    "model": "x", "messages": [{"role": "user", "content": "hi"}],
                    "max_tokens": 4, "temperature": 0.0})
                assert r.status == 200
                r = await http.post(f"{base}/unload_lora_adapter", json={"lora_name": "x"})
                assert (await r.json())["status"] == "ok"
                r = await http.post(f"{base}/unload_lora_adapter", json={"lora_name": "x"})
                assert (await r.json())["status"] == "not_found"
                status, body = await gen(lora_name="x")
                assert status != 200 and "unknown LoRA adapter 'x'" in body["error"]
        finally:
            await server.stop_async(runner)

    asyncio.run(run())

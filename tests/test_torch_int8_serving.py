"""The port's int8 weight-only serving on the CPU against the JAX package's:
``quantize_params`` gives the same int8 bits and scales on the same serving
weights for every served layout (qwen3 tied and untied, a MoE, MLA with DSA,
the GatedDeltaNet hybrid and Nemotron-H), the int8 engine's greedy tokens and
logprobs (prompt logprobs too) equal the JAX int8 engine's, the hybrid and
MLA int8 engines agree with JAX's, and a weight swap quantizes again.
Tolerances as ``tests/test_torch_engine.py``: equal tokens, logprobs within
1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prime_rl_tpu.models import get_family as j_get_family
from prime_rl_tpu.models.base import debug_spec as j_debug_spec
from prime_rl_tpu.models.base import get_spec as j_get_spec
from prime_rl_tpu.sampler import model as jmodel
from prime_rl_tpu.sampler.cache import CacheConfig as JCacheConfig
from prime_rl_tpu.sampler.engine import Engine as JEngine
from prime_rl_tpu.sampler.engine import SamplingParams as JSamplingParams
from prime_rl_tpu_torch.models import mla_moe as tmla
from prime_rl_tpu_torch.models import qwen3 as tqwen3
from prime_rl_tpu_torch.models.base import debug_spec, get_spec
from prime_rl_tpu_torch.sampler import model as tmodel
from prime_rl_tpu_torch.sampler.cache import CacheConfig
from prime_rl_tpu_torch.sampler.engine import Engine, SamplingParams
from test_torch_mla_moe import specs as mla_specs

torch.set_num_threads(1)

SPECS = {
    "qwen3": lambda: (j_debug_spec(num_layers=2, vocab_size=128),
                      debug_spec(num_layers=2, vocab_size=128)),
    "qwen3-untied": lambda: (j_debug_spec(num_layers=2, vocab_size=128, tie_embeddings=False),
                             debug_spec(num_layers=2, vocab_size=128, tie_embeddings=False)),
    "qwen3_moe": lambda: (j_get_spec("debug_moe"), get_spec("debug_moe")),
    "glm_moe_dsa": lambda: mla_specs(8),
    "qwen3_next": lambda: (j_get_spec("debug_qwen3_next"), get_spec("debug_qwen3_next")),
    "nemotron_h": lambda: (j_get_spec("debug_nemotron"), get_spec("debug_nemotron")),
}
_weights: dict = {}


def _model(name: str, scale: float = 1.0):
    """(JAX spec, port spec, the JAX init as numpy * scale, the port's params)."""
    if name not in _weights:
        jspec, spec = SPECS[name]()
        np_params = jax.tree.map(lambda x: np.asarray(x, np.float32),
                                 j_get_family(jspec).init(jspec, jax.random.key(0)))
        _weights[name] = (jspec, spec, np_params)
    jspec, spec, np_params = _weights[name]
    np_params = jax.tree.map(lambda x: x * np.float32(scale), np_params)
    conv = tmla.params_from_jax if spec.kv_lora_rank else tqwen3.params_from_jax
    return jspec, spec, np_params, conv(np_params, spec)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(SPECS))
def test_quantize_params_matches_jax(name, dtype):
    """The serving layout of each family quantized by both packages after the
    cast to the compute dtype: the same records at the same keys, equal int8
    bits and scales, and the raw leaves untouched."""
    jspec, spec, np_params, params = _model(name)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jq = jmodel.quantize_params(jmodel.unstack_params(
        jax.tree.map(lambda x: jnp.asarray(x).astype(jdt), np_params), jspec), jspec)
    tq = tmodel.quantize_params(tmodel.unstack_params(_cast(params, tdt), spec), spec)
    assert len(jq["layers"]) == len(tq["layers"]) == spec.num_layers
    records = 0
    for jl, tl in zip(jq["layers"] + [jq], tq["layers"] + [tq]):
        keys = [k for k in jl if k != "layers"]
        assert sorted(keys) == sorted(k for k in tl if k != "layers")
        for k in keys:
            if k == "vision":
                continue
            j, t = jl[k], tl[k]
            assert isinstance(j, dict) == isinstance(t, dict), k
            if isinstance(t, dict) and "q8" in t:
                assert t["q8"].dtype == torch.int8 and t["scale"].dtype == torch.float32
                np.testing.assert_array_equal(t["q8"].numpy(), np.asarray(j["q8"]))
                np.testing.assert_array_equal(t["scale"].numpy(), np.asarray(j["scale"]))
                records += 1
            elif not isinstance(t, dict):
                np.testing.assert_array_equal(t.float().numpy(),
                                              np.asarray(j.astype(jnp.float32)))
    assert records > 0
    assert isinstance(tq.get("lm_head"), dict) == (not spec.tie_embeddings and "lm_head" in tq)


def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    return tree.to(dtype)


CACHE = dict(num_pages=64, page_size=16, max_slots=2, max_seq_len=256)


def _engines(name: str, scale: float = 3.0, **cache):
    jspec, spec, np_params, params = _model(name, scale)
    cfg = {**CACHE, **cache}
    # copies: the JAX engine donates its parameter buffers
    jeng = JEngine(jax.tree.map(jnp.array, np_params), jspec, JCacheConfig(**cfg),
                   compute_dtype=jnp.float32, quantize="int8")
    teng = Engine(params, spec, CacheConfig(**cfg), device="cpu", compute_dtype=torch.float32,
                  quantize="int8")
    return jeng, teng


def _same(got, want) -> None:
    assert [r.token_ids for r in got] == [r.token_ids for r in want]
    assert [r.finish_reason for r in got] == [r.finish_reason for r in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.logprobs, w.logprobs, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("name", ["qwen3", "qwen3-untied"])
def test_int8_engine_matches_jax_int8_engine(name):
    """Greedy tokens and logprobs of the int8 engines on the same weights: a
    burst through the batched prefill, a prefix hit through the chunks, and
    prompt logprobs through the dequantized head."""
    jeng, teng = _engines(name)
    q = teng.params["layers"][0]["q"]
    assert isinstance(q, dict) and q["q8"].dtype == torch.int8
    assert not tmodel.takes_k3(teng.spec, teng.params["layers"][0])
    rng = np.random.default_rng(3)
    prompts = [[int(x) for x in rng.integers(1, 100, n)] for n in (5, 17, 33, 9)]
    greedy = dict(max_tokens=10, temperature=0.0)
    _same(teng.generate(prompts, SamplingParams(**greedy)),
          jeng.generate(prompts, JSamplingParams(**greedy)))
    follow = [prompts[2][:32] + [3, 4, 5]]
    _same(teng.generate(follow, SamplingParams(**greedy)),
          jeng.generate(follow, JSamplingParams(**greedy)))
    assert teng.stats["prefill_tokens_cached"] == jeng.stats["prefill_tokens_cached"] > 0
    plp = dict(max_tokens=1, prompt_logprobs=True, temperature=0.0)
    got = teng.generate([[5, 9, 23, 47]], SamplingParams(**plp))[0]
    want = jeng.generate([[5, 9, 23, 47]], JSamplingParams(**plp))[0]
    assert got.prompt_logprobs is not None and len(got.prompt_logprobs) == 4
    np.testing.assert_allclose(got.prompt_logprobs[1:], want.prompt_logprobs[1:], atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("name", ["qwen3_next", "glm_moe_dsa", "qwen3_moe", "nemotron_h"])
def test_int8_engines_of_other_families_match_jax(name):
    """int8 serving of the hybrid, MLA (DSA), MoE and Mamba-2 layouts: the
    mixers', latent and shared experts' projections go through the int8
    product; greedy tokens and logprobs equal the JAX int8 engine's."""
    jeng, teng = _engines(name, scale=1.0, num_pages=32, max_seq_len=128)
    quantized = {k for lp in teng.params["layers"] for k, v in lp.items()
                 if isinstance(v, dict) and "q8" in v}
    assert quantized and quantized <= set(tmodel._QUANT_TARGETS)
    rng = np.random.default_rng(3)
    prompts = [[int(x) for x in rng.integers(1, 200, n)] for n in (9, 32)]
    sp = dict(max_tokens=4, temperature=0.0, ignore_eos=True)
    for p in prompts:
        got = teng.generate([p], SamplingParams(**sp))
        _same(got, jeng.generate([p], JSamplingParams(**sp)))
        assert len(got[0].token_ids) == 4


def test_update_params_quantizes_again():
    """A weight swap goes through the same preparation: the new weights'
    int8 records, and the tokens of an int8 engine built on them."""
    _, spec, _, params = _model("qwen3", 3.0)
    _, _, _, other = _model("qwen3", -2.0)
    eng = Engine(params, spec, CacheConfig(**CACHE), device="cpu",
                 compute_dtype=torch.float32, quantize="int8")
    sp = SamplingParams(max_tokens=8, temperature=0.0, ignore_eos=True)
    before = eng.generate([[5, 9, 23, 47]], sp)[0].token_ids
    eng.update_params(other, version=1)
    want = tmodel.quantize_params(tmodel.unstack_params(other, spec), spec)
    for lp, wl in zip(eng.params["layers"], want["layers"]):
        for k in ("q", "o", "down"):
            assert torch.equal(lp[k]["q8"], wl[k]["q8"]) and torch.equal(lp[k]["scale"],
                                                                         wl[k]["scale"])
    fresh = Engine(other, spec, CacheConfig(**CACHE), device="cpu",
                   compute_dtype=torch.float32, quantize="int8")
    after = eng.generate([[5, 9, 23, 47]], sp)[0].token_ids
    assert after == fresh.generate([[5, 9, 23, 47]], sp)[0].token_ids != before
    with pytest.raises(ValueError, match="quantize"):
        Engine(params, spec, CacheConfig(**CACHE), device="cpu", quantize="int4")

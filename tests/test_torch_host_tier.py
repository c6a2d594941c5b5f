"""The port's host-offload KV tier on the CPU against the JAX package's: the
JAX engine's scenario (a prompt's cached pages evicted by another prompt
spill to host memory and come back on a later prefix hit) gives equal tokens
and equal spill and restore counts in both engines; the tier stays within
``host_cache_mb``, empties on a weight swap, and is off for MLA and the
hybrids, as in the JAX engine.
"""

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
from prime_rl_tpu_torch.models.base import debug_spec, get_spec
from prime_rl_tpu_torch.sampler.cache import CacheConfig, page_nbytes
from prime_rl_tpu_torch.sampler.engine import Engine, SamplingParams

torch.set_num_threads(1)

# 7 usable pages; each request wants 5, so the second prompt evicts the
# first's cached prefix (the JAX test's configuration; its second prompt runs
# past the vocabulary of 128, which a JAX gather clamps and a torch one
# refuses, so here it ends at 123)
CACHE = dict(num_pages=8, page_size=16, max_slots=2, max_seq_len=128, host_cache_mb=64)
P1, P2 = list(range(3, 3 + 64)), list(range(60, 60 + 64))


def _params():
    jspec, tspec = j_debug_spec(num_layers=2, vocab_size=128), debug_spec(num_layers=2,
                                                                          vocab_size=128)
    jparams = jax.tree.map(lambda x: x * 3.0, jqwen3.init_params(jspec, jax.random.key(0)))
    return jspec, jparams, tspec, tqwen3.params_from_jax(jax.device_get(jparams), tspec)


def _scenario(eng, sp):
    r1a = eng.generate([P1], [sp])[0]
    eng.generate([P2], [sp])  # evicts p1's cached pages -> host tier
    spilled = eng.stats.get("kv_pages_spilled", 0)
    r1b = eng.generate([P1], [sp])[0]  # device miss -> host restore
    return r1a, r1b, spilled, eng.stats.get("kv_pages_restored", 0)


def test_host_tier_matches_jax_engine():
    jspec, jparams, tspec, tparams = _params()
    jeng = JEngine(jparams, jspec, JCacheConfig(**CACHE), compute_dtype=jnp.float32)
    teng = Engine(tparams, tspec, CacheConfig(**CACHE), device="cpu",
                  compute_dtype=torch.float32)
    want = _scenario(jeng, JSamplingParams(max_tokens=4, temperature=0.0, ignore_eos=True))
    got = _scenario(teng, SamplingParams(max_tokens=4, temperature=0.0, ignore_eos=True))
    assert got[0].token_ids == got[1].token_ids == want[0].token_ids == want[1].token_ids
    np.testing.assert_allclose(got[1].logprobs, want[1].logprobs, atol=1e-4, rtol=1e-4)
    assert got[2:] == want[2:] and got[2] > 0 and got[3] > 0
    assert (teng.stats["prefill_tokens_cached"] == jeng.stats["prefill_tokens_cached"]
            == got[3] * CACHE["page_size"])


def test_restored_pages_hold_the_spilled_bits():
    """The third run's restored pages equal the first run's pages bit for
    bit, and its output equals that of a run on the device-cached pages."""
    *_, spec, params = _params()
    eng = Engine(params, spec, CacheConfig(**CACHE), device="cpu", compute_dtype=torch.float32)
    sp = SamplingParams(max_tokens=4, temperature=0.0, ignore_eos=True)
    eng.generate([P1], sp)
    first = eng.slots.cache.lookup(_hashes(eng, P1))
    pages = [(torch.stack([t[:, p] for t in eng.k_pool]).clone(),
              torch.stack([t[:, p] for t in eng.v_pool]).clone()) for p in first]
    hit = eng.generate([P1], sp)[0]  # a device prefix hit
    for h in _hashes(eng, P1):
        eng.slots.cache.decref(h)  # the lookup's own references
    eng.generate([P2], sp)
    restored = eng.generate([P1], sp)[0]
    assert restored.token_ids == hit.token_ids and restored.logprobs == hit.logprobs
    held = 0
    for h, (k, v) in zip(_hashes(eng, P1), pages):
        row = eng._host_tier.get(h)
        if row is not None:
            held += 1
            assert torch.equal(eng._host_rows[row][0], k) and torch.equal(eng._host_rows[row][1], v)
    assert held > 0


def _hashes(eng, prompt):
    from prime_rl_tpu_torch.sampler.cache import hash_pages

    ps = eng.config.page_size
    return hash_pages(prompt[:((len(prompt) - 1) // ps) * ps], ps,
                      salt=eng._salt(SamplingParams()))


def test_host_tier_stays_within_its_budget_and_empties_on_a_swap():
    """A budget of 1 MB at pages of 256 KB: the LRU keeps at most four pages
    however many spill, keeps the most recent, and a weight swap empties it."""
    spec = debug_spec(num_layers=2, vocab_size=128, num_kv_heads=4, head_dim=64)
    params = tqwen3.init_params(spec, torch.Generator().manual_seed(0))
    ps = 64
    page = page_nbytes(spec, ps, itemsize=4)
    assert page == 256 * 1024
    cache = dict(num_pages=9, page_size=ps, max_slots=1, max_seq_len=512, host_cache_mb=1)
    eng = Engine(params, spec, CacheConfig(**cache), device="cpu", compute_dtype=torch.float32)
    sp = SamplingParams(max_tokens=2, temperature=0.0, ignore_eos=True)
    rng = np.random.default_rng(0)
    for _ in range(4):
        eng.generate([[int(x) for x in rng.integers(1, 100, 300)]], sp)
        assert eng._host_tier_bytes <= (1 << 20)
        assert eng._host_tier_bytes == len(eng._host_tier) * page
    assert eng.stats["kv_pages_spilled"] > len(eng._host_tier) == 4
    eng.update_params(params)
    assert not eng._host_tier and eng._host_tier_bytes == 0


def test_host_pool_grows_in_slabs_with_use():
    """The pinned pool follows the tier's use: 16 rows at the first spill,
    each later slab doubling the rows, the last one cut at the budget
    (64 MB at pages of 256 KB: 256 rows), and no row allocated twice."""
    spec = debug_spec(num_layers=2, vocab_size=128, num_kv_heads=4, head_dim=64)
    params = tqwen3.init_params(spec, torch.Generator().manual_seed(0))
    cache = dict(num_pages=9, page_size=64, max_slots=1, max_seq_len=512, host_cache_mb=64)
    eng = Engine(params, spec, CacheConfig(**cache), device="cpu", compute_dtype=torch.float32)
    assert not eng._host_rows
    sizes = []
    for h in range(300):
        eng._spill_page(h, 1 + h % 8)
        sizes.append(len(eng._host_rows))
    assert sizes[0] == 16 and sizes[16] == 32 and sizes[32] == 64 and sizes[64] == 128
    assert sizes[128] == 256 and sizes[-1] == 256
    assert len(eng._host_tier) == 256 and eng._host_tier_bytes == 256 * (256 * 1024)
    assert sorted(eng._host_tier.values()) == list(range(256)) and not eng._host_free
    assert all(r.shape == eng._host_rows[0].shape for r in eng._host_rows)
    assert torch.equal(eng._host_rows[eng._host_tier[299]][0],
                       torch.stack([t[:, 1 + 299 % 8] for t in eng.k_pool]))


@pytest.mark.parametrize("name", ["debug_qwen3_next", "debug_nemotron", "mla"])
def test_host_tier_is_off_for_mla_and_hybrids(name):
    from prime_rl_tpu_torch.models import get_family

    if name == "mla":
        from test_torch_mla_moe import specs

        spec = specs(8)[1]
    else:
        spec = get_spec(name)
    params = get_family(spec).init(spec, torch.Generator().manual_seed(0))
    eng = Engine(params, spec, CacheConfig(num_pages=32, page_size=16, max_slots=2,
                                           max_seq_len=128, host_cache_mb=64), device="cpu")
    assert eng._host_tier is None and eng.slots.evict_sink is None
    dense = Engine(tqwen3.init_params(debug_spec(), torch.Generator().manual_seed(0)),
                   debug_spec(), CacheConfig(num_pages=32, page_size=16, max_slots=2,
                                             max_seq_len=128, host_cache_mb=64), device="cpu")
    assert dense._host_tier is not None and dense.slots.evict_sink == dense._spill_page

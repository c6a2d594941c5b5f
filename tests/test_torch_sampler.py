"""The port's sampler on the CPU against the JAX package: ``sample_tokens``
with the same gumbel noise, and ``prefill_batch`` / ``prefill_chunk`` /
``decode`` of ``prime_rl_tpu_torch.sampler.model`` against
``prime_rl_tpu.sampler.model`` on the same weights (``params_from_jax``)
and page tables, in float32.

Tolerance: 1e-4 absolute and relative on hidden states and logits (two
float32 transformer layers whose matmuls sum in different orders); 2e-5 on
sampled-token logprobs; pools and sampled tokens are compared for equality
where the arithmetic is the same, else within the hidden-state tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prime_rl_tpu.models import qwen3 as jqwen3
from prime_rl_tpu.models.base import debug_spec as j_debug_spec
from prime_rl_tpu.sampler import model as jmodel
from prime_rl_tpu.sampler.sampling import sample_tokens as j_sample
from prime_rl_tpu_torch.models import qwen3 as tqwen3
from prime_rl_tpu_torch.models.base import debug_spec, get_spec
from prime_rl_tpu_torch.sampler import cache as tcache
from prime_rl_tpu_torch.sampler import model as tmodel
from prime_rl_tpu_torch.sampler.sampling import sample_tokens as t_sample

torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-4)


def test_spec_matches_jax():
    from dataclasses import asdict

    from prime_rl_tpu.models.base import get_spec as j_get_spec

    for name in ("Qwen/Qwen3-0.6B", "meta-llama/Llama-3.2-1B", "debug"):
        assert asdict(get_spec(name)) == asdict(j_get_spec(name))
    assert asdict(get_spec("Qwen/Qwen3-0.6B", num_layers=2, vocab_size=512)) == asdict(
        j_get_spec("Qwen/Qwen3-0.6B", num_layers=2, vocab_size=512))


def test_sample_tokens_shared_noise_matches_jax():
    rng = np.random.default_rng(0)
    s, v = 8, 512
    logits = rng.standard_normal((s, v)).astype(np.float32) * 3
    logits[5] *= 0.01  # flat row: its 0.999 nucleus escapes the 64-token window
    temp = np.asarray([0.0, 1.0, 0.7, 1.0, 1.3, 1.0, 1.0, 0.5], np.float32)
    top_k = np.asarray([-1, -1, 5, -1, 20, -1, 100, 3], np.int32)
    top_p = np.asarray([1.0, 1.0, 1.0, 0.9, 0.8, 0.999, 1.0, 0.5], np.float32)
    key = jax.random.key(7)
    noise = np.asarray(jax.random.gumbel(key, (s, v), dtype=jnp.float32))  # what JAX draws
    j_tok, j_lp = j_sample(jnp.asarray(logits), jnp.asarray(temp), jnp.asarray(top_k),
                           jnp.asarray(top_p), key)
    t_tok, t_lp = t_sample(torch.from_numpy(logits), torch.from_numpy(temp),
                           torch.from_numpy(top_k), torch.from_numpy(top_p),
                           noise=torch.from_numpy(noise.copy()))
    np.testing.assert_array_equal(t_tok.numpy(), np.asarray(j_tok))
    np.testing.assert_allclose(t_lp.numpy(), np.asarray(j_lp), atol=2e-5, rtol=2e-5)
    assert int(t_tok[0]) == int(np.argmax(logits[0]))  # temperature 0 is greedy


def test_sample_tokens_generator_is_reproducible():
    logits = torch.randn(4, 300, generator=torch.Generator().manual_seed(1))
    args = (torch.ones(4), torch.full((4,), -1, dtype=torch.int32), torch.ones(4))
    a = t_sample(logits, *args, torch.Generator().manual_seed(3))
    b = t_sample(logits, *args, torch.Generator().manual_seed(3))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.fixture(scope="module")
def models():
    """One tiny qwen3 spec, JAX weights, and the same weights in the port."""
    kw = dict(vocab_size=256, hidden_size=128, num_layers=2, num_heads=4, num_kv_heads=2,
              head_dim=32, intermediate_size=256)
    jspec, tspec = j_debug_spec(**kw), debug_spec(**kw)
    jparams = jqwen3.init_params(jspec, jax.random.key(0))
    tparams = tqwen3.params_from_jax(jax.device_get(jparams), tspec)
    return (jspec, jmodel.unstack_params(jparams, jspec),
            tspec, tmodel.unstack_params(tparams, tspec))


def _pools(spec, num_pages=24, page_size=16):
    shape = (spec.num_kv_heads, num_pages, page_size, spec.head_dim)
    j = [jnp.zeros(shape, jnp.float32) for _ in range(spec.num_layers)]
    t = [torch.zeros(shape) for _ in range(spec.num_layers)]
    return j, t


def _pools_equal(jpool, tpool, **tol):
    for jl, tl in zip(jpool, tpool):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **(tol or TOL))


def test_prefill_decode_chunk_match_jax(models):
    jspec, jp, tspec, tp = models
    f32 = dict(compute_dtype=jnp.float32)
    rng = np.random.default_rng(1)
    ps, lpad = 16, 64
    jk, tk = _pools(jspec)
    jv, tv = _pools(jspec)

    # batched prefill: two real rows and a dummy row (length 0, null pages)
    ids = rng.integers(1, 250, (3, lpad)).astype(np.int32)
    lengths = np.asarray([37, 64, 0], np.int32)
    ids[2] = 0
    pages = np.asarray([[1, 2, 3, 4], [5, 6, 7, 8], [0, 0, 0, 0]], np.int32)
    jk, jv, j_h = jmodel.prefill_batch(jp, jspec, jk, jv, jnp.asarray(ids), jnp.asarray(lengths),
                                       jnp.asarray(pages), attn_impl="xla", **f32)
    _, _, t_h = tmodel.prefill_batch(tp, tspec, tk, tv, torch.from_numpy(ids.astype(np.int64)),
                                     torch.from_numpy(lengths), torch.from_numpy(pages),
                                     compute_dtype=torch.float32)
    np.testing.assert_allclose(t_h.numpy()[:2], np.asarray(j_h)[:2], **TOL)
    for jl, tl in zip(jk + jv, tk + tv):  # real pages (page 0 takes the dummy row)
        np.testing.assert_allclose(tl.numpy()[:, 1:9], np.asarray(jl)[:, 1:9], **TOL)

    # single-sequence prefill with prompt logprobs
    ids1 = rng.integers(1, 250, (1, lpad)).astype(np.int32)
    jk, jv, j_h1, j_plp, _ = jmodel.prefill(jp, jspec, jk, jv, jnp.asarray(ids1), jnp.int32(50),
                                            jnp.asarray([9, 10, 11, 12], jnp.int32),
                                            attn_impl="xla", want_prompt_logprobs=True, **f32)
    _, _, t_h1, t_plp = tmodel.prefill(tp, tspec, tk, tv, torch.from_numpy(ids1.astype(np.int64)),
                                       50, torch.tensor([9, 10, 11, 12]),
                                       compute_dtype=torch.float32, want_prompt_logprobs=True)
    np.testing.assert_allclose(t_h1.numpy(), np.asarray(j_h1), **TOL)
    np.testing.assert_allclose(t_plp.numpy()[:50], np.asarray(j_plp)[:50], **TOL)

    # two decode steps for all slots (slot 3 inactive on the null page)
    table = np.zeros((4, 8), np.int32)
    table[0, :4], table[1, :4], table[2, :4] = [1, 2, 3, 4], [5, 6, 7, 8], [9, 10, 11, 12]
    table[:3, 4] = [13, 14, 15]
    lens = np.asarray([37, 64, 50, 0], np.int32)
    toks = np.asarray([3, 7, 11, 0], np.int32)
    for _ in range(2):
        jk, jv, j_logits, *_ = jmodel.decode(jp, jspec, jk, jv, jnp.asarray(toks),
                                             jnp.asarray(lens), jnp.asarray(table),
                                             attn_impl="xla", **f32)
        _, _, t_logits = tmodel.decode(tp, tspec, tk, tv, torch.from_numpy(toks),
                                       torch.from_numpy(lens), torch.from_numpy(table),
                                       compute_dtype=torch.float32)
        np.testing.assert_allclose(t_logits.numpy()[:3], np.asarray(j_logits)[:3], **TOL)
        toks = np.asarray(j_logits).argmax(-1).astype(np.int32)
        lens = lens + np.asarray([1, 1, 1, 0], np.int32)
    for jl, tl in zip(jk + jv, tk + tv):
        np.testing.assert_allclose(tl.numpy()[:, 1:], np.asarray(jl)[:, 1:], **TOL)

    # chunked prefill of a slot whose first page is a shared prefix page
    # (page 1, written by the batched prefill above), in two chunks of 32
    prompt = np.concatenate([ids[0, :16], rng.integers(1, 250, 40)]).astype(np.int32)
    row = np.asarray([1, 16, 17, 18, 19, 0, 0, 0], np.int32)
    for off, valid in ((16, 32), (48, 8)):
        chunk = np.zeros((1, 32), np.int32)
        chunk[0, :valid] = prompt[off:off + valid]
        pch = row[off // ps: off // ps + 2]
        jk, jv, j_last = jmodel.prefill_chunk(jp, jspec, jk, jv, jnp.asarray(chunk),
                                              jnp.int32(off), jnp.int32(valid),
                                              jnp.asarray(pch), jnp.asarray(row), **f32)
        _, _, t_last = tmodel.prefill_chunk(tp, tspec, tk, tv,
                                            torch.from_numpy(chunk.astype(np.int64)), off, valid,
                                            torch.from_numpy(pch), torch.from_numpy(row),
                                            compute_dtype=torch.float32)
        np.testing.assert_allclose(t_last.numpy(), np.asarray(j_last), **TOL)
    for jl, tl in zip(jk + jv, tk + tv):
        np.testing.assert_allclose(tl.numpy()[:, 1:], np.asarray(jl)[:, 1:], **TOL)


def test_hf_state_dict_roundtrip_matches_jax(models):
    """HF interchange on a tiny spec: the JAX state dict loads into the
    port's params and converts back to the same arrays."""
    jspec, _, tspec, _ = models
    jparams = jqwen3.init_params(jspec, jax.random.key(1))
    state = jqwen3.params_to_hf_state_dict(jparams, jspec)
    tparams = tqwen3.params_from_hf_state_dict(state, tspec)
    want = tqwen3.params_from_jax(jax.device_get(jparams), tspec)
    for k in ("embed", "final_norm"):
        assert torch.equal(tparams[k], want[k])
    for k in want["layers"]:
        assert torch.equal(tparams["layers"][k], want["layers"][k])
    back = tqwen3.params_to_hf_state_dict(tparams, tspec)
    assert back.keys() == state.keys()
    for k in state:
        np.testing.assert_array_equal(back[k], state[k])


def test_host_cache_state_matches_jax():
    """Page accounting, prefix hashing and donation: the same sequence of
    acquire / release calls gives the same tables in both packages."""
    from prime_rl_tpu.sampler import cache as jcache

    results = []
    for mod in (jcache, tcache):
        cfg = mod.CacheConfig(num_pages=16, page_size=4, max_slots=3, max_seq_len=32)
        st = mod.SlotTable(cfg)
        prompt = list(range(1, 14))
        h = mod.hash_pages(prompt[:12], 4, salt=(None, None))
        a = st.acquire(20, h)
        st.release(a[0])
        b = st.acquire(20, h)  # reuses the donated prefix pages
        c = st.acquire(8, None)
        st.flush_cache()
        st.release(b[0])
        results.append((a, b, c, st.page_table.copy(), st.alloc.num_free, h))
    for x, y in zip(*results):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))

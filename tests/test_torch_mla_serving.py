"""Serving the MLA families on the CPU against the JAX package: the latent KV
pool, the sampler's prefill, chunked prefill and decode, and the engine, for
``glm_moe_dsa`` (MLA + DSA, top-k 8, so that the indexer restricts the
history past 8 tokens) and ``deepseek_v3`` (dense MLA), on the ``specs()``
of ``tests/test_torch_mla_moe.py`` (2 layers, the first dense, 4 heads, a
latent of 32 + 8 rope channels, 8 experts top-2). Weights are made by the
JAX package's init from a seed, every leaf moved off its init value (the
correction bias by 0.5 * N(0, 1)), and carried across as numpy; everything
runs in float32.

On the CPU the DSA prefill runs the training block's chunked-gather sparse
attention (``ops/sparse_mla.py``), as the JAX block runs its plain XLA form
there; on the card the same call launches K5a.

Tolerances: 2e-4 (atol and rtol) on hidden states, logits and the pools;
tokens and routing ids equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prime_rl_tpu.models import mla_moe as jmla
from prime_rl_tpu.sampler import model as jmodel
from prime_rl_tpu.sampler.cache import CacheConfig as JCacheConfig
from prime_rl_tpu.sampler.cache import KVPool as JKVPool
from prime_rl_tpu.sampler.engine import Engine as JEngine
from prime_rl_tpu.sampler.engine import SamplingParams as JSamplingParams
from prime_rl_tpu_torch.models import mla_moe as tmla
from prime_rl_tpu_torch.sampler import model as tmodel
from prime_rl_tpu_torch.sampler.cache import CacheConfig, KVPool, page_nbytes
from prime_rl_tpu_torch.sampler.engine import Engine, SamplingParams
from prime_rl_tpu_torch.trainer import optim as toptim
from test_torch_mla_moe import specs

torch.set_num_threads(1)

TOL = dict(atol=2e-4, rtol=2e-4)
KINDS = {"dsa": 8, "dense": 0}
NL_MOE, K = 1, 2


def _np(t):
    return t.detach().float().numpy()


_weights: dict = {}


def _make(kind: str, zero_index_queries: bool = False):
    """(JAX spec, port spec, JAX params as numpy, the port's params)."""
    key = (kind, zero_index_queries)
    if key not in _weights:
        jspec, spec = specs(KINDS[kind])
        rng = np.random.default_rng(0)

        def move(path, x):
            name = jax.tree_util.keystr(path)
            if zero_index_queries and "idx_wq_b" in name:
                return np.zeros_like(np.asarray(x))
            scale = 0.5 if "correction" in name else 0.05
            return np.asarray(x) + np.float32(scale) * rng.standard_normal(x.shape, np.float32)

        np_params = jax.tree_util.tree_map_with_path(
            move, jmla.init_params(jspec, jax.random.key(0)))
        _weights[key] = (jspec, spec, np_params, tmla.params_from_jax(np_params, spec))
    return _weights[key]


@pytest.fixture(params=list(KINDS), scope="module")
def model(request):
    return _make(request.param)


def _pools(spec, jspec, num_pages=24, page_size=16):
    cfg = dict(num_pages=num_pages, page_size=page_size, max_slots=2, max_seq_len=128)
    jpool = JKVPool(jspec, JCacheConfig(**cfg), dtype=jnp.float32)
    tpool = KVPool(spec, CacheConfig(**cfg), dtype=torch.float32)
    return jpool, tpool


def test_pool_holds_one_latent_row_a_token(model):
    """The MLA pool: one [1, NP, PS, kvl + rope] latent tensor a layer; for
    DSA a V pool of the indexer keys [1, NP, PS, Di], for dense MLA none; the
    same shapes as the JAX pool, and the bytes a page that size the pool on
    the card."""
    jspec, spec, _, _ = model
    jpool, tpool = _pools(spec, jspec)
    width = spec.kv_lora_rank + spec.qk_rope_head_dim
    assert [tuple(t.shape) for t in tpool.k] == [(1, 24, 16, width)] * spec.num_layers
    assert [tuple(t.shape) for t in tpool.k] == [tuple(a.shape) for a in jpool.k]
    if spec.index_topk:
        assert [tuple(t.shape) for t in tpool.v] == [(1, 24, 16, spec.index_head_dim)] * 2
        assert [tuple(t.shape) for t in tpool.v] == [tuple(a.shape) for a in jpool.v]
    else:
        assert tpool.v == jpool.v == [None] * spec.num_layers
    assert tpool.nbytes() == jpool.hbm_bytes() == 24 * page_nbytes(spec, 16, itemsize=4)


def _serve_both(jspec, spec, np_params, params, steps=4):
    """A prefill of 27 tokens into slot 0, a prompt of 70 in three chunks of
    32 (the second crossing a page bound) into slot 1, then ``steps`` decode
    steps of both slots with the routing collected, through both samplers.
    Yields (what, port value, JAX value) pairs to compare."""
    jp = jmodel.unstack_params(jax.tree.map(jnp.asarray, np_params), jspec)
    tp = tmodel.unstack_params(params, spec)
    jpool, tpool = _pools(spec, jspec)
    jk, jv, tk, tv = jpool.k, jpool.v, tpool.k, tpool.v
    rng = np.random.default_rng(1)
    ids = np.zeros((1, 32), np.int32)
    ids[0, :27] = rng.integers(3, 250, 27)
    pages = np.asarray([1, 2], np.int32)
    jk, jv, j_h, *_ = jmodel.prefill(jp, jspec, jk, jv, jnp.asarray(ids), jnp.int32(27),
                                     jnp.asarray(pages), compute_dtype=jnp.float32,
                                     attn_impl="xla")
    _, _, t_h, _ = tmodel.prefill(tp, spec, tk, tv, torch.from_numpy(ids.astype(np.int64)), 27,
                                  torch.from_numpy(pages), compute_dtype=torch.float32)
    yield "prefill", t_h, j_h
    prompt = rng.integers(3, 250, 70).astype(np.int32)
    row = np.zeros((8,), np.int32)
    row[:5] = [3, 4, 5, 6, 7]
    for off in (0, 32, 64):
        chunk = np.zeros((1, 32), np.int32)
        valid = min(32, 70 - off)
        chunk[0, :valid] = prompt[off:off + valid]
        pchunk = row[off // 16: off // 16 + 2]
        jk, jv, j_h = jmodel.prefill_chunk(
            jp, jspec, jk, jv, jnp.asarray(chunk), jnp.int32(off), jnp.int32(valid),
            jnp.asarray(pchunk), jnp.asarray(row), compute_dtype=jnp.float32)
        _, _, t_h = tmodel.prefill_chunk(
            tp, spec, tk, tv, torch.from_numpy(chunk.astype(np.int64)), off, valid,
            torch.from_numpy(pchunk), torch.from_numpy(row), compute_dtype=torch.float32)
        yield f"chunk at {off}", t_h, j_h
    table = np.zeros((2, 8), np.int32)
    table[0, :3] = [1, 2, 8]
    table[1] = row
    lens = np.asarray([27, 70], np.int32)
    toks = np.asarray([int(ids[0, 26]), int(prompt[-1])], np.int32)
    for i in range(steps):
        jk, jv, j_logits, j_routed, *_ = jmodel.decode(
            jp, jspec, jk, jv, jnp.asarray(toks), jnp.asarray(lens), jnp.asarray(table),
            attn_impl="xla", compute_dtype=jnp.float32, collect_routing=True)
        _, _, t_logits, t_routed = tmodel.decode(
            tp, spec, tk, tv, torch.from_numpy(toks), torch.from_numpy(lens),
            torch.from_numpy(table), compute_dtype=torch.float32, collect_routing=True)
        yield f"decode {i}", t_logits, j_logits
        assert t_routed.shape == (2, NL_MOE, K)
        np.testing.assert_array_equal(t_routed.numpy(), np.asarray(j_routed))
        toks = np.asarray(j_logits).argmax(-1).astype(np.int32)
        lens = lens + 1
    for i, (ja, ta) in enumerate(zip(jk + jv, tk + tv)):
        if ja is None:
            assert ta is None
            continue
        yield f"pool {i}", ta[:, 1:9], np.asarray(ja)[:, 1:9]


def test_sampler_prefill_chunk_and_decode_match_jax(model):
    """prefill, prefill_chunk over latent pages (chunks of 32 across page
    bounds, DSA's indexer keys paged beside) and four decode steps of two
    slots at lengths past the top-k: hidden states, logits, the routing of
    the MoE layer and the written pools against the JAX sampler."""
    for what, got, want in _serve_both(*model):
        np.testing.assert_allclose(_np(got), np.asarray(want), **TOL, err_msg=what)


def test_dsa_decode_takes_the_exact_top_k_among_tied_scores():
    """With the indexer's queries zeroed every score is relu(0) = 0: a tie
    over the whole history. The selection takes the lowest 8 positions, as
    ``jax.lax.top_k`` does (a threshold at the 8th score would take them
    all), and prefill, chunks and decode still match the JAX sampler; the
    result differs from attending every position."""
    row = torch.zeros((1, 40))
    row[0, 30:] = -1e30
    mask = tmodel._mla_topk_mask(row, 8)
    assert mask[0].nonzero().flatten().tolist() == list(range(8))
    jspec, spec, np_params, params = _make("dsa", zero_index_queries=True)
    got = {}
    for what, t, j in _serve_both(jspec, spec, np_params, params, steps=2):
        np.testing.assert_allclose(_np(t), np.asarray(j), **TOL, err_msg=what)
        got[what] = _np(t)
    every = {what: _np(t) for what, t, _ in _serve_both(*specs(64), np_params, params, steps=2)}
    assert not np.allclose(got["decode 1"], every["decode 1"], atol=1e-3)


def test_engine_greedy_and_routing_match_jax(model):
    """Greedy serving with the routing recorded: the JAX engine's tokens and
    routing ids ([n_gen, 1, 2], the last row -1) on the same weights, for a
    prompt of 90 tokens and one that shares its first 48 (three pages served
    from the prefix cache, the rest prefilled in chunks of 32); no batched
    prefill for MLA."""
    jspec, spec, np_params, params = model
    params = toptim.tree_map(lambda x: x * 2.0, params)
    np_params = jax.tree.map(lambda x: x * np.float32(2.0), np_params)
    cache = dict(num_pages=48, page_size=16, max_slots=2, max_seq_len=160, prefill_chunk=32)
    rng = np.random.default_rng(7)
    prompts = [[int(x) for x in rng.integers(3, 200, 90)]]
    prompts.append(prompts[0][:48] + [int(x) for x in rng.integers(3, 200, 5)])
    sp = dict(max_tokens=8, temperature=0.0, ignore_eos=True)
    engine = Engine(params, spec, CacheConfig(**cache), device="cpu",
                    compute_dtype=torch.float32, decode_block=4, collect_routed_experts=True)
    jengine = JEngine(jax.tree.map(jnp.asarray, np_params), jspec, JCacheConfig(**cache),
                      compute_dtype=jnp.float32, collect_routed_experts=True)
    assert not engine._admit_batch_plain()
    for prompt in prompts:
        got = engine.generate([prompt], SamplingParams(**sp))[0]
        want = jengine.generate([prompt], JSamplingParams(**sp))[0]
        assert got.token_ids == want.token_ids
        assert got.routed_experts.shape == (8, NL_MOE, K)
        np.testing.assert_array_equal(got.routed_experts, want.routed_experts)
        assert bool((got.routed_experts[-1] == -1).all())
    assert engine.stats["prefill_tokens_cached"] == jengine.stats["prefill_tokens_cached"] == 48
    # two prompts at once take the single prefill one after the other
    both = engine.generate(prompts, SamplingParams(**sp))
    assert [r.token_ids for r in both] == [r.token_ids for r in jengine.generate(
        prompts, JSamplingParams(**sp))]

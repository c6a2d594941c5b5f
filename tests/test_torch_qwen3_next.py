"""Qwen3-Next (``qwen3_next``, the GatedDeltaNet hybrid) on the CPU against
the JAX package, on the debug spec both packages name ``debug_qwen3_next``
(the LLLA pattern, 2/4 key/value GDN heads, gated attention with partial
rotary, 8 experts top-2 with a sigmoid-gated shared expert): the init
layout, the training forward (hidden states, load-balance aux, router
replay, remat), packed rows against separate ones, the HF conversion through
both packages and the config round trip, the sampler's prefill, chunked
prefill and decode with the recurrent rows, the engine's greedy tokens and
recorded routing, the hybrid prefix cache (the port of
``tests/unit/sampler/test_engine_hybrid_cache.py``'s qwen3_next cases), and
one train step. Weights are the JAX init's from a seed, every leaf moved
off its init value by 0.05 * N(0, 1), carried across as numpy; float32
throughout.

The JAX functions run under ``jax.jit`` (eagerly, each call of the chunked
rule traces and compiles its scan again).

Tolerances: 1e-4 (atol and rtol) on hidden states, logits and recurrent
rows, 1e-5 relative on the aux, 1e-4 relative on the step's loss and
metrics, and each parameter's gradient within 1e-3 of its norm; routing
ids and tokens equal.
"""

import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prime_rl_tpu.configs import TrainerConfig as JTrainerConfig
from prime_rl_tpu.configs.shared import MeshConfig as JMeshConfig
from prime_rl_tpu.models import qwen3_next as jnext
from prime_rl_tpu.models.base import get_spec as j_get_spec
from prime_rl_tpu.parallel.mesh import build_mesh
from prime_rl_tpu.sampler import model as jmodel
from prime_rl_tpu.sampler.cache import CacheConfig as JCacheConfig
from prime_rl_tpu.sampler.engine import Engine as JEngine
from prime_rl_tpu.sampler.engine import SamplingParams as JSamplingParams
from prime_rl_tpu.trainer import optim as joptim
from prime_rl_tpu.trainer import step as jstep
from prime_rl_tpu_torch.configs import TrainerConfig
from prime_rl_tpu_torch.models import get_family
from prime_rl_tpu_torch.models import qwen3_next as tnext
from prime_rl_tpu_torch.models.base import get_spec, spec_from_hf_config
from prime_rl_tpu_torch.models.qwen3 import params_from_jax
from prime_rl_tpu_torch.sampler import model as tmodel
from prime_rl_tpu_torch.sampler.cache import CacheConfig, KVPool, RecurrentPool, page_nbytes
from prime_rl_tpu_torch.sampler.engine import Engine, SamplingParams
from prime_rl_tpu_torch.trainer import optim as toptim
from prime_rl_tpu_torch.trainer import step as tstep
from prime_rl_tpu_torch.trainer.rl.data import FakeDataLoader
from prime_rl_tpu_torch.trainer.weights import save_hf_weights, spec_to_hf_config

torch.set_num_threads(1)

NAME = "debug_qwen3_next"
TOL = dict(atol=1e-4, rtol=1e-4)


def _np(t):
    return t.detach().float().numpy()


_weights: dict = {}


def _jit(fn):
    """``fn(params, spec, ...)`` under jax.jit, the spec and the keyword
    flags static."""
    static = tuple(n for n in ("compute_dtype", "attn_impl", "collect_routing", "remat",
                               "collect_aux") if n in inspect.signature(fn).parameters)
    return jax.jit(fn, static_argnums=(1,), static_argnames=static)


j_forward = _jit(jnext.forward)
j_prefill, j_chunk, j_decode = map(_jit, (jmodel.prefill, jmodel.prefill_chunk, jmodel.decode))


@pytest.fixture(scope="module")
def model():
    """(JAX spec, port spec, JAX params as numpy, the same params in the port)."""
    if not _weights:
        jspec, spec = j_get_spec(NAME), get_spec(NAME)
        rng = np.random.default_rng(0)
        np_params = jax.tree.map(
            lambda x: np.asarray(x) + np.float32(0.05) * rng.standard_normal(x.shape, np.float32),
            jax.jit(jnext.init_params, static_argnums=0)(jspec, jax.random.key(0)))
        _weights["m"] = (jspec, spec, np_params, params_from_jax(np_params, spec))
    return _weights["m"]


def _packed(L=40, rows=2, seed=1):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, 250, size=(rows, L)).astype(np.int32)
    a, b = 21, 13
    seg = np.array([[1] * a + [2] * b + [0] * (L - a - b)] * rows, np.int32)
    pos = np.array([list(range(a)) + list(range(b)) + [0] * (L - a - b)] * rows, np.int32)
    return ids, seg, pos


def _t_forward(params, spec, ids, seg, pos, **kw):
    kw.setdefault("remat", "none")
    return tnext.forward(params, spec, torch.from_numpy(ids), torch.from_numpy(seg),
                         torch.from_numpy(pos), compute_dtype=torch.float32, **kw)


def test_init_matches_the_jax_layout(model):
    """The port's init gives the JAX init's leaves at its shapes, and the
    JAX package's own dt_bias and A_log values; a depth cut by ``get_spec``
    keeps the pattern, so the forward raises there as in JAX."""
    jspec, spec, np_params, _ = model
    got = get_family(spec).init(spec, torch.Generator().manual_seed(0))
    want = dict(toptim.tree_paths(jax.tree.map(
        np.asarray, jax.jit(jnext.init_params, static_argnums=0)(jspec, jax.random.key(0)))))
    have = dict(toptim.tree_paths(got))
    assert set(have) == set(want)
    for path, t in have.items():
        assert tuple(t.shape) == want[path].shape, path
    for path in ("lin_layers/dt_bias", "lin_layers/A_log"):
        np.testing.assert_allclose(_np(have[path]), want[path], rtol=1e-6, err_msg=path)
    cut = get_spec(NAME, num_layers=2)
    assert cut.gdn_pattern == spec.gdn_pattern
    with pytest.raises(ValueError, match="gdn_pattern"):
        tnext.forward({}, cut, *(torch.zeros((1, 4), dtype=torch.int64),) * 3)


def test_forward_aux_and_router_replay_match_jax(model):
    """Hidden states (1e-4) and the load-balance aux summed over every layer
    (1e-5) on a packed batch with two segments and padding; full and
    save_attn remat give the same states; a replay of half the tokens over
    all four layers (the GDN layers' MoE too) matches JAX's; rows of -1 keep
    the own routing."""
    jspec, spec, np_params, params = model
    ids, seg, pos = _packed()
    jp = jax.tree.map(jnp.asarray, np_params)
    jkw = dict(compute_dtype=jnp.float32, remat="none", attn_impl="xla")
    want_h, want_aux = j_forward(jp, jspec, *map(jnp.asarray, (ids, seg, pos)),
                                     collect_aux=True, **jkw)
    got_h, got_aux = _t_forward(params, spec, ids, seg, pos, collect_aux=True)
    real = seg > 0
    np.testing.assert_allclose(_np(got_h)[real], np.asarray(want_h)[real], **TOL)
    np.testing.assert_allclose(float(got_aux), float(want_aux), rtol=1e-5)
    leaves = toptim.tree_map(lambda x: x.clone().requires_grad_(), params)
    for mode in ("full", "save_attn"):
        np.testing.assert_allclose(_np(_t_forward(leaves, spec, ids, seg, pos, remat=mode)),
                                   _np(got_h), atol=1e-6, rtol=1e-6, err_msg=mode)

    nl, k = spec.num_layers, spec.num_experts_per_tok
    rng = np.random.default_rng(5)
    routed = np.stack([rng.permutation(spec.num_experts)[:k] for _ in range(ids.size * nl)])
    routed = routed.astype(np.int32).reshape(*ids.shape, nl, k)
    routed[:, ::2] = -1
    want = j_forward(jp, jspec, *map(jnp.asarray, (ids, seg, pos)),
                         routed_experts=jnp.asarray(routed), **jkw)
    got = _t_forward(params, spec, ids, seg, pos, routed_experts=torch.from_numpy(routed))
    np.testing.assert_allclose(_np(got)[real], np.asarray(want)[real], **TOL)
    assert not np.allclose(_np(got)[real], _np(got_h)[real], atol=1e-3)
    none = _t_forward(params, spec, ids, seg, pos,
                      routed_experts=torch.full((*ids.shape, nl, k), -1, dtype=torch.int32))
    np.testing.assert_array_equal(_np(none), _np(got_h))


def test_packed_rows_equal_separate_rows(model):
    """Two sequences packed in one row give the states of each run alone:
    the GDN's resets and the conv's segment mask are exact."""
    _, spec, _, params = model
    ids, seg, pos = _packed(rows=1)
    packed = _np(_t_forward(params, spec, ids, seg, pos))
    for s in (1, 2):
        cols = np.nonzero(seg[0] == s)[0]
        alone = _np(_t_forward(params, spec, ids[:, cols], np.ones((1, len(cols)), np.int32),
                               pos[:, cols]))
        np.testing.assert_allclose(packed[0, cols], alone[0], atol=2e-5, rtol=2e-5)


def test_hf_round_trip(tmp_path, model):
    """to_hf names every key of the JAX package's table with equal values
    (the zero-centred norms' +1 folded out); from_hf gives the params back,
    and the JAX from_hf reads the port's state to the same values;
    spec_to_hf_config writes Qwen3NextForCausalLM with the layer types and
    linear-attention widths, and a snapshot reads back as the same spec."""
    jspec, spec, np_params, params = model
    want = jnext.params_to_hf_state_dict(jax.tree.map(jnp.asarray, np_params), jspec)
    family = get_family(spec)
    state = family.to_hf(params, spec)
    assert set(state) == set(want)
    for key, v in state.items():
        np.testing.assert_allclose(_np(torch.as_tensor(v)), np.asarray(want[key]), atol=1e-7,
                                   err_msg=key)
    back = family.from_hf(state, spec)
    for (pa, a), (pb, b) in zip(toptim.tree_paths(params), toptim.tree_paths(back)):
        assert pa == pb
        np.testing.assert_allclose(_np(b), _np(a), atol=1e-7, err_msg=str(pa))
    j_back = dict(toptim.tree_paths(jax.tree.map(np.asarray, jnext.params_from_hf_state_dict(
        {key: _np(torch.as_tensor(v)) for key, v in state.items()}, jspec))))
    for path, t in toptim.tree_paths(params):
        np.testing.assert_allclose(_np(t), j_back[path], atol=1e-7, err_msg=str(path))
    cfg = spec_to_hf_config(spec)
    assert cfg["architectures"] == ["Qwen3NextForCausalLM"]
    assert cfg["layer_types"] == ["linear_attention"] * 3 + ["full_attention"]
    assert spec_from_hf_config(cfg) == spec
    save_hf_weights(params, spec, tmp_path / "snap")
    assert get_spec(str(tmp_path / "snap")) == spec


def test_named_qwen3_next_spec_serves_head_dim_256():
    """The named Qwen3-Next spec: 16/2 heads of 256 (group 8), the LLLA
    pattern over 48 layers, 512 experts top-10; its pools give the "L"
    layers no pages."""
    spec = get_spec("Qwen/Qwen3-Next-80B-A3B-Instruct")
    assert (spec.num_heads, spec.num_kv_heads, spec.head_dim) == (16, 2, 256)
    assert spec.gdn_pattern == "LLLA" * 12 and spec.num_layers == 48
    assert (spec.num_experts, spec.num_experts_per_tok) == (512, 10)
    small = dataclasses.replace(get_spec(NAME))
    cfg = CacheConfig(num_pages=8, page_size=16, max_slots=3)
    pool = KVPool(small, cfg, dtype=torch.float32)
    assert [t is None for t in pool.k] == [c == "L" for c in small.gdn_pattern]
    assert pool.nbytes() == 8 * page_nbytes(small, 16, itemsize=4)
    rec = RecurrentPool(small, cfg, dtype=torch.float32)
    assert [t is None for t in rec.state] == [c == "A" for c in small.gdn_pattern]
    assert rec.conv[0].shape == (3, small.gdn_conv_dim, small.gdn_conv_kernel)
    assert rec.state[0].shape == (3, small.gdn_v_heads, small.gdn_k_dim, small.gdn_v_dim)


def _rows_close(got, want, msg):
    for li, (g, w) in enumerate(zip(got, want)):
        assert (g is None) == (w is None), li
        if g is not None:
            for part, a, b in zip(("conv", "state"), g, w):
                np.testing.assert_allclose(_np(a), np.asarray(b), **TOL,
                                           err_msg=f"{msg} layer {li} {part}")


def test_sampler_prefill_chunk_and_decode_match_jax(model):
    """A prefill of 70 tokens (past a GDN chunk boundary at 64), the same
    prompt in chunks of 32 from zero rows (pages 16), then three decode steps
    of both slots with the routing collected: hidden states, logits and the
    recurrent rows (1e-4), the routing ids, against the JAX sampler."""
    jspec, spec, np_params, params = model
    jp = jmodel.unstack_params(jax.tree.map(jnp.asarray, np_params), jspec)
    tp = tmodel.unstack_params(params, spec)
    kinds = list(spec.gdn_pattern)
    shape = (spec.num_kv_heads, 24, 16, spec.head_dim)
    jk = [jnp.zeros(shape, jnp.float32) if c == "A" else None for c in kinds]
    jv = list(jk)
    tk = [torch.zeros(shape) if c == "A" else None for c in kinds]
    tv = [torch.zeros(shape) if c == "A" else None for c in kinds]
    rng = np.random.default_rng(1)
    ids = np.zeros((1, 96), np.int32)
    ids[0, :70] = rng.integers(1, 250, 70)
    pages = np.arange(1, 7, dtype=np.int32)
    jk, jv, j_h, _, j_rows = j_prefill(jp, jspec, jk, jv, jnp.asarray(ids), jnp.int32(70),
                                            jnp.asarray(pages), compute_dtype=jnp.float32,
                                            attn_impl="xla")
    _, _, t_h, _, t_rows = tmodel.prefill(tp, spec, tk, tv, torch.from_numpy(ids.astype(np.int64)),
                                          70, torch.from_numpy(pages), compute_dtype=torch.float32)
    np.testing.assert_allclose(_np(t_h), np.asarray(j_h), **TOL)
    _rows_close(t_rows, j_rows, "prefill")

    row = np.zeros((8,), np.int32)
    row[:6] = np.arange(7, 13)
    dims = (spec.gdn_v_heads, spec.gdn_k_dim, spec.gdn_v_dim)
    jr = [None if c == "A" else (jnp.zeros((spec.gdn_conv_dim, 4)), jnp.zeros(dims))
          for c in kinds]
    tr = [None if c == "A" else (torch.zeros(spec.gdn_conv_dim, 4), torch.zeros(dims))
          for c in kinds]
    for off in (0, 32, 64):
        chunk = np.zeros((1, 32), np.int32)
        valid = min(32, 70 - off)
        chunk[0, :valid] = ids[0, off:off + valid]
        pch = row[off // 16: off // 16 + 2]
        jk, jv, j_h2, jr = j_chunk(
            jp, jspec, jk, jv, jnp.asarray(chunk), jnp.int32(off), jnp.int32(valid),
            jnp.asarray(pch), jnp.asarray(row), compute_dtype=jnp.float32, r_rows=jr)
        _, _, t_h2, tr = tmodel.prefill_chunk(
            tp, spec, tk, tv, torch.from_numpy(chunk.astype(np.int64)), off, valid,
            torch.from_numpy(pch), torch.from_numpy(row), compute_dtype=torch.float32, r_rows=tr)
        np.testing.assert_allclose(_np(t_h2), np.asarray(j_h2), **TOL, err_msg=f"chunk {off}")
        _rows_close(tr, jr, f"chunk {off}")
    np.testing.assert_allclose(_np(t_h2), _np(t_h), **TOL)  # chunked equals whole

    rc = [None if r is None else torch.stack([a[0], b[0]]) for a, b, r in zip(t_rows, tr, tr)]
    rs = [None if r is None else torch.stack([a[1], b[1]]) for a, b, r in zip(t_rows, tr, tr)]
    # copies: the port's decode advances rc/rs in place
    jrc = [None if r is None else jnp.array(_np(r)) for r in rc]
    jrs = [None if r is None else jnp.array(_np(r)) for r in rs]
    table = np.zeros((2, 8), np.int32)
    table[0, :6] = pages
    table[1] = row
    lens = np.asarray([70, 70], np.int32)
    toks = np.asarray([int(ids[0, 69])] * 2, np.int32)
    for _ in range(3):
        jk, jv, j_logits, j_routed, jrc, jrs = j_decode(
            jp, jspec, jk, jv, jnp.asarray(toks), jnp.asarray(lens), jnp.asarray(table),
            attn_impl="xla", compute_dtype=jnp.float32, collect_routing=True, r_conv=jrc,
            r_state=jrs)
        _, _, t_logits, t_routed = tmodel.decode(
            tp, spec, tk, tv, torch.from_numpy(toks), torch.from_numpy(lens),
            torch.from_numpy(table), compute_dtype=torch.float32, collect_routing=True,
            r_conv=rc, r_state=rs)
        np.testing.assert_allclose(_np(t_logits), np.asarray(j_logits), **TOL)
        assert t_routed.shape == (2, spec.num_layers, spec.num_experts_per_tok)
        np.testing.assert_array_equal(t_routed.numpy(), np.asarray(j_routed))
        toks = np.asarray(j_logits).argmax(-1).astype(np.int32)
        lens = lens + 1
    _rows_close([None if a is None else (a, b) for a, b in zip(rc, rs)],
                [None if a is None else (a, b) for a, b in zip(jrc, jrs)], "decode")
    assert not any(tmodel.takes_k3(spec, lp) for lp in tp["layers"] if "q" in lp)


def _cache(**kw):
    return dict(num_pages=64, page_size=16, max_slots=2, max_seq_len=256, **kw)


def _engine(params, spec, **kw):
    return Engine(params, spec, CacheConfig(**_cache(**kw)), device="cpu",
                  compute_dtype=torch.float32)


def _greedy(engine, prompt, n=6, **kw):
    return engine.generate([prompt], [SamplingParams(max_tokens=n, temperature=0.0,
                                                     ignore_eos=True, **kw)])[0]


def test_engine_greedy_and_routing_match_jax(model):
    """Greedy serving with the routing recorded, the state tier on (chunks
    of 16): the JAX engine's tokens and routing ids ([n_gen, NL, K], the last
    row -1) for a prompt and then one that shares its first two pages, whose
    admission restores the checkpoint (the same cached tokens and restores
    counted as JAX); the training forward's greedy tokens."""
    jspec, spec, np_params, params = model
    cache = _cache(state_cache_mb=64, prefill_chunk=16)
    rng = np.random.default_rng(7)
    prompts = [[int(x) for x in rng.integers(1, 200, 45)]]
    prompts.append(prompts[0][:32] + [int(x) for x in rng.integers(1, 200, 9)])
    n_gen = 6
    sp = dict(max_tokens=n_gen, temperature=0.0, ignore_eos=True)
    engine = Engine(params, spec, CacheConfig(**cache), device="cpu",
                    compute_dtype=torch.float32, decode_block=4, collect_routed_experts=True)
    # copies: the JAX engine donates its parameter buffers, which jnp.asarray
    # would share with the numpy arrays behind the port's tensors
    jengine = JEngine(jax.tree.map(jnp.array, np_params), jspec, JCacheConfig(**cache),
                      compute_dtype=jnp.float32, collect_routed_experts=True)
    for prompt in prompts:
        got = engine.generate([prompt], SamplingParams(**sp))[0]
        want = jengine.generate([prompt], JSamplingParams(**sp))[0]
        assert got.token_ids == want.token_ids
        assert got.routed_experts.shape == (n_gen, spec.num_layers, spec.num_experts_per_tok)
        np.testing.assert_array_equal(got.routed_experts, want.routed_experts)
        assert bool((got.routed_experts[-1] == -1).all())
    for key in ("prefill_tokens_cached", "state_restores", "state_snapshots"):
        assert engine.stats[key] == jengine.stats[key] > 0, key
    seq = np.asarray([prompts[1] + got.token_ids], np.int32)
    h = _t_forward(params, spec, seq, np.ones_like(seq),
                   np.arange(seq.shape[1], dtype=np.int32)[None])
    head = get_family(spec).get_lm_head(params, spec)
    assert (h[0] @ head)[len(prompts[1]) - 1:-1].argmax(-1).tolist() == got.token_ids


def test_hybrid_chunked_prefill_matches_fused(model):
    """With the state tier on, prefills run in chunks threading the rows
    from zeros (chunks of 16 here): the fused single-shot prefill's greedy
    tokens, nothing cached on a first visit; a prompt past the largest bucket
    serves chunked too."""
    _, spec, _, params = model
    rng = np.random.default_rng(0)
    prompt = [int(x) for x in rng.integers(1, 500, 45)]  # 2 full pages and a tail
    fused = _engine(params, spec, enable_prefix_cache=False)
    chunked = _engine(params, spec, state_cache_mb=64, prefill_chunk=16)
    assert _greedy(chunked, prompt).token_ids == _greedy(fused, prompt).token_ids
    assert chunked.stats["prefill_tokens_cached"] == 0
    long = [int(x) for x in rng.integers(1, 500, 150)]
    small = _engine(params, spec, state_cache_mb=64)
    small.buckets = [64, 128]  # the prompt of 150 exceeds the largest bucket
    assert _greedy(small, long).token_ids == _greedy(fused, long).token_ids


def test_hybrid_prefix_cache_hit_exact_and_counted(model):
    """A second identical prompt restores the boundary state and the shared
    pages, skips the prefix and decodes the same tokens; an extension of a
    cached prefix reuses the checkpoint and computes only its tail."""
    _, spec, _, params = model
    rng = np.random.default_rng(1)
    prompt = [int(x) for x in rng.integers(1, 500, 40)]
    eng = _engine(params, spec, state_cache_mb=64)
    r1 = _greedy(eng, prompt)
    assert eng.stats["state_snapshots"] >= 1
    r2 = _greedy(eng, prompt)
    assert r2.token_ids == r1.token_ids
    assert eng.stats["state_restores"] >= 1
    assert eng.stats["prefill_tokens_cached"] == 32  # 2 full pages of the 40-token prompt

    base = [int(x) for x in rng.integers(1, 500, 33)]
    eng = _engine(params, spec, state_cache_mb=64)
    _greedy(eng, base)
    ext = base[:32] + [int(x) for x in rng.integers(1, 500, 20)]
    ref = _engine(params, spec, enable_prefix_cache=False)
    assert _greedy(eng, ext).token_ids == _greedy(ref, ext).token_ids
    assert eng.stats["prefill_tokens_cached"] >= 32


def test_hybrid_cache_salt_isolation_and_weight_update_flush(model):
    """A different cache_salt shares neither checkpoints nor pages; a weight
    update empties the state tier, and the same prompt recomputes."""
    _, spec, _, params = model
    rng = np.random.default_rng(4)
    prompt = [int(x) for x in rng.integers(1, 500, 40)]
    eng = _engine(params, spec, state_cache_mb=64)
    _greedy(eng, prompt, n=4, cache_salt="a")
    before = eng.stats["prefill_tokens_cached"]
    _greedy(eng, prompt, n=4, cache_salt="b")
    assert eng.stats["prefill_tokens_cached"] == before
    assert eng._state_tier
    eng.update_params(toptim.tree_map(lambda x: x * 1.5, params), version=1)
    assert not eng._state_tier
    before = eng.stats["prefill_tokens_cached"]
    assert len(_greedy(eng, prompt, cache_salt="a").token_ids) == 6
    assert eng.stats["prefill_tokens_cached"] == before


def test_train_step_matches_jax_step_one(model):
    """One fake batch through ``make_train_step`` with a trained load-balance
    term and full remat: loss, grad_norm and every metric (rtol 1e-4), and
    every parameter's gradient (the update of sgd at lr 1 without weight
    decay) within 1e-3 of its norm."""
    jspec, spec, np_params, params = model
    cfg = dict(model={"attn": {"impl": "xla"}, "compute_dtype": "float32",
                      "lm_head_chunk_size": 48, "ac": {"mode": "full"}, "moe_aux_coef": 0.01},
               optimizer={"type": "sgd", "lr": 1.0, "weight_decay": 0.0})
    j_cfg, t_cfg = JTrainerConfig(**cfg), TrainerConfig(**cfg)
    batch, counts = FakeDataLoader(spec.vocab_size, 64, 2, 2, seed=0).next_batch()
    scale = float(counts["rl"])
    j_opt, _ = joptim.make_optimizer(j_cfg.optimizer, j_cfg.scheduler, 1.0)
    mesh_info = build_mesh(JMeshConfig(fsdp=-1))
    j_state = jstep.init_train_state(jspec, mesh_info, j_opt,
                                     params=jax.tree.map(jnp.asarray, np_params))
    j_step = jstep.make_train_step(jspec, j_cfg.model, j_cfg.loss, j_opt, mesh_info)
    j_batch = jstep.MicroBatchArrays(*[None if x is None else jnp.asarray(x) for x in batch])
    j_state, j_metrics = j_step(j_state, j_batch, jstep.Scales(
        jnp.float32(scale), jnp.float32(1.0), jnp.float32(1.0)))
    t_opt, _ = toptim.make_optimizer(t_cfg.optimizer, t_cfg.scheduler, 1.0)
    t_state = tstep.init_train_state(spec, "cpu", t_opt,
                                     params=toptim.tree_map(lambda x: x.clone(), params))
    t_step = tstep.make_train_step(spec, t_cfg.model, t_cfg.loss, t_opt, "cpu")
    t_state, t_metrics = t_step(t_state, batch, tstep.Scales(scale, 1.0, 1.0))
    assert set(t_metrics) == set(j_metrics) and "moe_load_balance" in t_metrics
    for name in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(t_metrics[name]), float(j_metrics[name]), rtol=1e-4)
    for name, stat in t_metrics.items():
        if name not in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(stat.total), float(j_metrics[name].total),
                                       rtol=1e-4, atol=1e-5, err_msg=name)
    before = dict(toptim.tree_paths(np_params))
    j_flat = dict(toptim.tree_paths(jax.tree.map(np.asarray, j_state.params)))
    for path, t in toptim.tree_paths(t_state.params):
        t_grad, j_grad = before[path] - _np(t), before[path] - j_flat[path]
        assert np.linalg.norm(t_grad - j_grad) <= 1e-3 * np.linalg.norm(j_grad) + 1e-7, path

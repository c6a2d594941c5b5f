"""The gated-MoE families (MiniMax-M2, AFMoE, Laguna) on the CPU against the
JAX package, on the debug specs both packages name ``debug_minimax`` (a
layer-scope qk-norm, partial rotary, every layer MoE), ``debug_afmoe`` (a
sigmoid attention-output gate, sandwich norms, 64-token windows on every
other layer, shared experts, a dense first layer, a router without a
correction bias) and ``debug_laguna`` (a per-head softplus gate, a rope base
of its own on the windowed layers, a shared expert of absolute size, a
dense first layer, routed scaling): the training forward (hidden states,
load-balance aux, router replay), the HF conversion through both packages'
key tables and the config round trip, the sampler's prefill, chunked
prefill and decode, greedy engine tokens and recorded routing, and one train
step. Weights are made by the JAX package's init from a seed, every leaf
moved off its init value (a correction bias by 0.5 * N(0, 1), so that
selection and weights differ), and carried across as numpy through
``models.qwen3.params_from_jax``; everything runs in float32.

Tolerances: 2e-4 (atol and rtol) on hidden states and logits, 1e-5 relative
on the aux, 1e-4 relative on the step's loss, grad norm and metrics, 4e-5
absolute on the parameters after the update; routing ids and tokens equal.
"""

import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prime_rl_tpu.configs import TrainerConfig as JTrainerConfig
from prime_rl_tpu.configs.shared import MeshConfig as JMeshConfig
from prime_rl_tpu.models import gated_moe as jgated
from prime_rl_tpu.models import glm4_moe as jglm
from prime_rl_tpu.models.base import get_spec as j_get_spec
from prime_rl_tpu.parallel.mesh import build_mesh
from prime_rl_tpu.sampler import model as jmodel
from prime_rl_tpu.sampler.cache import CacheConfig as JCacheConfig
from prime_rl_tpu.sampler.engine import Engine as JEngine
from prime_rl_tpu.sampler.engine import SamplingParams as JSamplingParams
from prime_rl_tpu.trainer import optim as joptim
from prime_rl_tpu.trainer import step as jstep
from prime_rl_tpu_torch.configs import TrainerConfig
from prime_rl_tpu_torch.models import gated_moe as tgated
from prime_rl_tpu_torch.models import get_family
from prime_rl_tpu_torch.models.base import get_spec, spec_from_hf_config
from prime_rl_tpu_torch.models.qwen3 import params_from_jax
from prime_rl_tpu_torch.sampler import model as tmodel
from prime_rl_tpu_torch.sampler.cache import CacheConfig
from prime_rl_tpu_torch.sampler.engine import Engine, SamplingParams
from prime_rl_tpu_torch.trainer import optim as toptim
from prime_rl_tpu_torch.trainer import step as tstep
from prime_rl_tpu_torch.trainer.rl.data import FakeDataLoader
from prime_rl_tpu_torch.trainer.weights import save_hf_weights, spec_to_hf_config

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

torch.set_num_threads(1)

NAMES = ("debug_minimax", "debug_afmoe", "debug_laguna")
TOL = dict(atol=2e-4, rtol=2e-4)


def _np(t):
    return t.detach().float().numpy()


_weights: dict = {}


@pytest.fixture(params=NAMES, scope="module")
def model(request):
    """(JAX spec, port spec, JAX params as numpy, the same params in the
    port) of the parametrized family."""
    name = request.param
    if name not in _weights:
        jspec, spec = j_get_spec(name), get_spec(name)
        rng = np.random.default_rng(0)

        def move(path, x):
            scale = 0.5 if "correction" in jax.tree_util.keystr(path) else 0.05
            return np.asarray(x) + np.float32(scale) * rng.standard_normal(x.shape, np.float32)

        np_params = jax.tree_util.tree_map_with_path(
            move, jgated.init_params(jspec, jax.random.key(0)))
        _weights[name] = (jspec, spec, np_params, params_from_jax(np_params, spec))
    return _weights[name]


def _n_moe(spec):
    return spec.num_layers - spec.first_k_dense_replace


def _packed(L=40, rows=2, seed=1):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, 250, size=(rows, L)).astype(np.int32)
    a, b = 21, 13
    seg = np.array([[1] * a + [2] * b + [0] * (L - a - b)] * rows, np.int32)
    pos = np.array([list(range(a)) + list(range(b)) + [0] * (L - a - b)] * rows, np.int32)
    return ids, seg, pos


def _t_forward(params, spec, ids, seg, pos, **kw):
    kw.setdefault("remat", "none")
    return tgated.forward(params, spec, torch.from_numpy(ids), torch.from_numpy(seg),
                          torch.from_numpy(pos), compute_dtype=torch.float32, **kw)


def test_init_matches_the_jax_layout(model):
    """The port's init gives the JAX init's leaves at its shapes: the gates,
    the layer-wide q/k norms, the sandwich norms, AFMoE without a correction
    bias."""
    jspec, spec, np_params, _ = model
    got = get_family(spec).init(spec, torch.Generator().manual_seed(0))
    want = dict(toptim.tree_paths(np_params))
    have = dict(toptim.tree_paths(got))
    assert set(have) == set(want)
    for path, t in have.items():
        assert tuple(t.shape) == want[path].shape, path
    assert ("router_correction_bias" in got["layers"]) == (spec.family != "afmoe")


def test_forward_aux_and_router_replay_match_jax(model):
    """Hidden states (2e-4) and the load-balance aux summed over the MoE
    layers (1e-5) on a packed batch with two segments and padding; full and
    save_attn remat give the same states; a replay of half the tokens over
    the MoE layers matches JAX's and moves the result; rows of -1 keep the
    own routing."""
    jspec, spec, np_params, params = model
    ids, seg, pos = _packed()
    jp = jax.tree.map(jnp.asarray, np_params)
    jkw = dict(compute_dtype=jnp.float32, remat="none", attn_impl="xla")
    want_h, want_aux = jglm.forward(jp, jspec, *map(jnp.asarray, (ids, seg, pos)),
                                    collect_aux=True, **jkw)
    got_h, got_aux = _t_forward(params, spec, ids, seg, pos, collect_aux=True)
    real = seg > 0
    np.testing.assert_allclose(_np(got_h)[real], np.asarray(want_h)[real], **TOL)
    np.testing.assert_allclose(float(got_aux), float(want_aux), rtol=1e-5)
    leaves = toptim.tree_map(lambda x: x.clone().requires_grad_(), params)
    for mode in ("full", "save_attn"):
        np.testing.assert_allclose(_np(_t_forward(leaves, spec, ids, seg, pos, remat=mode)),
                                   _np(got_h), atol=1e-6, rtol=1e-6, err_msg=mode)

    nl, k = _n_moe(spec), spec.num_experts_per_tok
    rng = np.random.default_rng(5)
    routed = np.stack([rng.permutation(spec.num_experts)[:k] for _ in range(ids.size * nl)])
    routed = routed.astype(np.int32).reshape(*ids.shape, nl, k)
    routed[:, ::2] = -1
    want = jglm.forward(jp, jspec, *map(jnp.asarray, (ids, seg, pos)),
                        routed_experts=jnp.asarray(routed), **jkw)
    got = _t_forward(params, spec, ids, seg, pos, routed_experts=torch.from_numpy(routed))
    np.testing.assert_allclose(_np(got)[real], np.asarray(want)[real], **TOL)
    assert not np.allclose(_np(got)[real], _np(got_h)[real], atol=1e-3)
    none = _t_forward(params, spec, ids, seg, pos,
                      routed_experts=torch.full((*ids.shape, nl, k), -1, dtype=torch.int32))
    np.testing.assert_array_equal(_np(none), _np(got_h))


def test_hf_round_trip(tmp_path, model):
    """to_hf names every key of the JAX package's table for the family, with
    equal values; from_hf gives the params back, and the JAX from_hf reads
    the port's state to the same values; spec_to_hf_config writes the
    family's own architecture, and a snapshot reads back as the same spec
    (MiniMax-M2's config names one MLP width, the experts': the debug spec's
    unused dense width reads back as it)."""
    jspec, spec, np_params, params = model
    want = jgated.params_to_hf_state_dict(jax.tree.map(jnp.asarray, np_params), jspec)
    family = get_family(spec)
    state = family.to_hf(params, spec)
    assert set(state) == set(want)
    for key, v in state.items():
        np.testing.assert_array_equal(_np(torch.as_tensor(v)), np.asarray(want[key]), err_msg=key)
    back = family.from_hf(state, spec)
    for (pa, a), (pb, b) in zip(toptim.tree_paths(params), toptim.tree_paths(back)):
        assert pa == pb and torch.equal(a, b), pa
    j_back = dict(toptim.tree_paths(jax.tree.map(np.asarray, jgated.params_from_hf_state_dict(
        {key: _np(torch.as_tensor(v)) for key, v in state.items()}, jspec))))
    for path, t in toptim.tree_paths(params):
        np.testing.assert_array_equal(_np(t), j_back[path], err_msg=path)

    arch = {"minimax_m2": "MiniMaxM2ForCausalLM", "afmoe": "AfmoeForCausalLM",
            "laguna": "LagunaForCausalLM"}[spec.family]
    cfg = spec_to_hf_config(spec)
    assert cfg["architectures"] == [arch]
    want_spec = spec
    if spec.family == "minimax_m2":
        want_spec = dataclasses.replace(spec, intermediate_size=spec.moe_intermediate_size)
    assert spec_from_hf_config(cfg) == want_spec
    save_hf_weights(params, spec, tmp_path / "snap")
    assert get_spec(str(tmp_path / "snap")) == want_spec


def test_named_minimax_m2_spec_has_the_published_widths():
    """The port's named ``MiniMaxAI/MiniMax-M2`` spec is what its published
    config.json (``chip_smoke.MINIMAX_M2_CONFIG``) reads as: 3072 wide, 62
    layers, 256 experts of 1536, top 8 (the JAX package's table keeps other
    widths; ROADMAP Queue 3)."""
    named = get_spec("MiniMaxAI/MiniMax-M2")
    assert named == spec_from_hf_config(dict(chip_smoke.MINIMAX_M2_CONFIG))
    assert (named.hidden_size, named.num_layers, named.moe_intermediate_size,
            named.num_experts, named.num_experts_per_tok) == (3072, 62, 1536, 256, 8)
    assert (named.num_heads, named.num_kv_heads, named.head_dim) == (48, 8, 128)
    assert named.partial_rotary_factor == 0.5 and named.qk_norm_scope == "layer"


def test_sampler_prefill_chunk_and_decode_match_jax(model):
    """A prefill of 27 tokens (the windowed layers' 64-token window not yet
    in force), a prompt in two chunks of 32 whose second crosses a page
    bound and reaches past the window, then four decode steps with the
    routing collected, for both slots: hidden states and logits (2e-4), the
    routing (equal ids) and the written pools, against the JAX sampler on the
    same weights and page tables."""
    jspec, spec, np_params, params = model
    jp = jmodel.unstack_params(jax.tree.map(jnp.asarray, np_params), jspec)
    tp = tmodel.unstack_params(params, spec)
    nl = spec.num_layers
    shape = (spec.num_kv_heads, 24, 16, spec.head_dim)
    jk = [jnp.zeros(shape, jnp.float32) for _ in range(nl)]
    jv = [jnp.zeros(shape, jnp.float32) for _ in range(nl)]
    tk = [torch.zeros(shape) for _ in range(nl)]
    tv = [torch.zeros(shape) for _ in range(nl)]
    rng = np.random.default_rng(1)
    ids = np.zeros((1, 32), np.int32)
    ids[0, :27] = rng.integers(1, 250, 27)
    pages = np.asarray([1, 2], np.int32)
    jk, jv, j_h, *_ = jmodel.prefill(jp, jspec, jk, jv, jnp.asarray(ids), jnp.int32(27),
                                     jnp.asarray(pages), compute_dtype=jnp.float32,
                                     attn_impl="xla")
    _, _, t_h, _ = tmodel.prefill(tp, spec, tk, tv, torch.from_numpy(ids.astype(np.int64)), 27,
                                  torch.from_numpy(pages), compute_dtype=torch.float32)
    np.testing.assert_allclose(_np(t_h), np.asarray(j_h), **TOL)

    prompt = rng.integers(1, 250, 70).astype(np.int32)
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
        np.testing.assert_allclose(_np(t_h), np.asarray(j_h), **TOL, err_msg=f"chunk {off}")

    table = np.zeros((2, 8), np.int32)
    table[0, :3] = [1, 2, 8]
    table[1] = row
    lens = np.asarray([27, 70], np.int32)
    toks = np.asarray([int(ids[0, 26]), int(prompt[-1])], np.int32)
    for _ in range(4):
        jk, jv, j_logits, j_routed, *_ = jmodel.decode(
            jp, jspec, jk, jv, jnp.asarray(toks), jnp.asarray(lens), jnp.asarray(table),
            attn_impl="xla", compute_dtype=jnp.float32, collect_routing=True)
        _, _, t_logits, t_routed = tmodel.decode(
            tp, spec, tk, tv, torch.from_numpy(toks), torch.from_numpy(lens),
            torch.from_numpy(table), compute_dtype=torch.float32, collect_routing=True)
        np.testing.assert_allclose(_np(t_logits), np.asarray(j_logits), **TOL)
        assert t_routed.shape == (2, _n_moe(spec), spec.num_experts_per_tok)
        np.testing.assert_array_equal(t_routed.numpy(), np.asarray(j_routed))
        toks = np.asarray(j_logits).argmax(-1).astype(np.int32)
        lens = lens + 1
    for jl, tl in zip(jk + jv, tk + tv):
        np.testing.assert_allclose(_np(tl)[:, 1:9], np.asarray(jl)[:, 1:9], **TOL)


def test_decode_takes_plain_qkv_where_jax_skips_k3(model):
    """Decode prepares q/k/v in K3 on the card only where the JAX package
    takes its kernel: never for these families (MiniMax-M2's layer-scope
    qk-norm; AFMoE's and Laguna's gates), always for the dense Qwen3 block."""
    _, spec, _, params = model
    tp = tmodel.unstack_params(params, spec)
    assert not any(tmodel.takes_k3(spec, lp) for lp in tp["layers"])
    dense = get_spec("debug")
    dp = tmodel.unstack_params(get_family(dense).init(dense, torch.Generator().manual_seed(0)),
                               dense)
    assert all(tmodel.takes_k3(dense, lp) for lp in dp["layers"])


def test_engine_greedy_and_routing_match_jax(model):
    """Greedy serving with the routing recorded gives the JAX engine's tokens
    and routing ids on the same weights ([n_gen, NL_moe, K], the last row
    -1), and the training forward's greedy tokens; a prompt longer than the
    window prefills in chunks (chunk 32) and a second request reuses the
    first's prefix pages."""
    jspec, spec, np_params, params = model
    params = toptim.tree_map(lambda x: x * 2.0, params)
    np_params = jax.tree.map(lambda x: x * np.float32(2.0), np_params)
    cache = dict(num_pages=48, page_size=16, max_slots=2, max_seq_len=160, prefill_chunk=32)
    rng = np.random.default_rng(7)
    prompts = [[int(x) for x in rng.integers(1, 200, 90)]]
    prompts.append(prompts[0][:48] + [int(x) for x in rng.integers(1, 200, 5)])
    n_gen = 8
    sp = dict(max_tokens=n_gen, temperature=0.0, ignore_eos=True)
    engine = Engine(params, spec, CacheConfig(**cache), device="cpu",
                    compute_dtype=torch.float32, decode_block=4, collect_routed_experts=True)
    jengine = JEngine(jax.tree.map(jnp.asarray, np_params), jspec, JCacheConfig(**cache),
                      compute_dtype=jnp.float32, collect_routed_experts=True)
    for prompt in prompts:
        got = engine.generate([prompt], SamplingParams(**sp))[0]
        want = jengine.generate([prompt], JSamplingParams(**sp))[0]
        assert got.token_ids == want.token_ids
        assert got.routed_experts.shape == (n_gen, _n_moe(spec), spec.num_experts_per_tok)
        np.testing.assert_array_equal(got.routed_experts, want.routed_experts)
        assert bool((got.routed_experts[-1] == -1).all())
    assert engine.stats["prefill_tokens_cached"] == jengine.stats["prefill_tokens_cached"] > 0
    seq = np.asarray([prompts[1] + got.token_ids], np.int32)
    h = _t_forward(params, spec, seq, np.ones_like(seq),
                   np.arange(seq.shape[1], dtype=np.int32)[None])
    head = get_family(spec).get_lm_head(params, spec)
    assert (h[0] @ head)[len(prompts[1]) - 1:-1].argmax(-1).tolist() == got.token_ids


def test_train_step_matches_jax_step_one(model):
    """One fake batch through ``make_train_step`` with a trained
    load-balance term: loss, grad_norm and every metric (rtol 1e-4), and
    every parameter after an sgd update with weight decay (atol 4e-5)."""
    jspec, spec, np_params, params = model
    cfg = dict(model={"attn": {"impl": "xla"}, "compute_dtype": "float32",
                      "lm_head_chunk_size": 48, "ac": {"mode": "full"}, "moe_aux_coef": 0.01},
               optimizer={"type": "sgd", "lr": 1e-2, "weight_decay": 0.1})
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
    j_flat = dict(toptim.tree_paths(jax.tree.map(np.asarray, j_state.params)))
    for path, t in toptim.tree_paths(t_state.params):
        np.testing.assert_allclose(_np(t), j_flat[path], atol=4e-5, rtol=0, err_msg=path)

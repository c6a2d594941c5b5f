"""The glm4_moe family (GLM-4.5) on the CPU against the JAX package, on the
spec of ``tests/unit/models/test_glm4_moe.py`` (4 layers, the first dense,
4/2 heads of 16 with half of each rotated, qk-norm, 8 experts top-2 in 2
groups of which 1 is kept, sigmoid scores with a selection-only correction
bias, routed scaling 1.5, one shared expert) and the same spec at 6/2 heads,
so that a GQA group above 2 runs too: the training forward (hidden states,
load-balance aux, router replay over the MoE layers only), the HF
conversion, the sampler's prefill and decode with the routing collected,
greedy engine tokens and recorded routing against the training forward and
the JAX engine, and one train step. Weights are made by the JAX package's
init from a seed, every leaf moved off its init value (the correction bias
by 0.5 * N(0, 1), so that selection and weights differ), and carried across
as numpy; everything runs in float32.

Tolerances, those of ``tests/test_torch_gpt_oss.py``: 2e-4 on hidden states
and logits, 1e-4 relative on the step's loss and metrics, 4e-5 absolute on
the parameters after the update; routing ids and tokens equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prime_rl_tpu.configs import TrainerConfig as JTrainerConfig
from prime_rl_tpu.configs.shared import MeshConfig as JMeshConfig
from prime_rl_tpu.models import glm4_moe as jglm
from prime_rl_tpu.models.base import ModelSpec as JModelSpec
from prime_rl_tpu.parallel.mesh import build_mesh
from prime_rl_tpu.sampler import model as jmodel
from prime_rl_tpu.sampler.cache import CacheConfig as JCacheConfig
from prime_rl_tpu.sampler.engine import Engine as JEngine
from prime_rl_tpu.sampler.engine import SamplingParams as JSamplingParams
from prime_rl_tpu.trainer import optim as joptim
from prime_rl_tpu.trainer import step as jstep
from prime_rl_tpu_torch.configs import TrainerConfig
from prime_rl_tpu_torch.models import get_family
from prime_rl_tpu_torch.models import glm4_moe as tglm
from prime_rl_tpu_torch.models.base import ModelSpec, get_spec
from prime_rl_tpu_torch.models.qwen3 import params_from_jax
from prime_rl_tpu_torch.sampler import model as tmodel
from prime_rl_tpu_torch.sampler.cache import CacheConfig
from prime_rl_tpu_torch.sampler.engine import Engine, SamplingParams
from prime_rl_tpu_torch.trainer import optim as toptim
from prime_rl_tpu_torch.trainer import step as tstep
from prime_rl_tpu_torch.trainer.rl.data import FakeDataLoader
from prime_rl_tpu_torch.trainer.weights import save_hf_weights

torch.set_num_threads(1)

SPEC_KW = dict(
    family="glm4_moe", vocab_size=256, hidden_size=64, num_layers=4,
    num_heads=4, num_kv_heads=2, head_dim=16, intermediate_size=96,
    rope_theta=10000.0, rms_eps=1e-5, tie_embeddings=False, qk_norm=True,
    max_position_embeddings=512, eos_token_id=255, pad_token_id=0,
    num_experts=8, num_experts_per_tok=2, moe_intermediate_size=32,
    norm_topk_prob=True, partial_rotary_factor=0.5, n_shared_experts=1,
    first_k_dense_replace=1, routed_scaling_factor=1.5, router_sigmoid=True,
    n_group=2, topk_group=1,
)
HEADS = {"4/2 heads": {}, "6/2 heads": dict(num_heads=6)}
NL_MOE, K = 3, 2
TOL = dict(atol=2e-4, rtol=2e-4)


def _np(t):
    return t.detach().float().numpy()


_weights: dict = {}


@pytest.fixture(params=list(HEADS), scope="module")
def model(request):
    """(JAX spec, port spec, JAX params as numpy, the same params in the
    port) at the parametrized heads."""
    name = request.param
    if name not in _weights:
        kw = {**SPEC_KW, **HEADS[name]}
        jspec, spec = JModelSpec(**kw), ModelSpec(**kw)
        rng = np.random.default_rng(0)

        def move(path, x):
            scale = 0.5 if "correction" in jax.tree_util.keystr(path) else 0.05
            return np.asarray(x) + np.float32(scale) * rng.standard_normal(x.shape, np.float32)

        np_params = jax.tree_util.tree_map_with_path(
            move, jglm.init_params(jspec, jax.random.key(0)))
        _weights[name] = (jspec, spec, np_params, params_from_jax(np_params, spec))
    return _weights[name]


def _packed(L=40, rows=2, seed=1):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, 250, size=(rows, L)).astype(np.int32)
    a, b = 21, 13
    seg = np.array([[1] * a + [2] * b + [0] * (L - a - b)] * rows, np.int32)
    pos = np.array([list(range(a)) + list(range(b)) + [0] * (L - a - b)] * rows, np.int32)
    return ids, seg, pos


def _t_forward(params, spec, ids, seg, pos, **kw):
    kw.setdefault("remat", "none")
    return tglm.forward(params, spec, torch.from_numpy(ids), torch.from_numpy(seg),
                        torch.from_numpy(pos), compute_dtype=torch.float32, **kw)


def test_forward_aux_and_router_replay_match_jax(model):
    """Hidden states (2e-4) and the load-balance aux summed over the MoE
    layers (1e-5); full and save_attn remat give the same states; a replay of
    half the tokens over the 3 MoE layers matches JAX's and moves the result;
    rows of -1 keep the own routing."""
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

    rng = np.random.default_rng(5)
    routed = np.stack([rng.permutation(8)[:K] for _ in range(ids.size * NL_MOE)])
    routed = routed.astype(np.int32).reshape(*ids.shape, NL_MOE, K)
    routed[:, ::2] = -1
    want = jglm.forward(jp, jspec, *map(jnp.asarray, (ids, seg, pos)),
                        routed_experts=jnp.asarray(routed), **jkw)
    got = _t_forward(params, spec, ids, seg, pos, routed_experts=torch.from_numpy(routed))
    np.testing.assert_allclose(_np(got)[real], np.asarray(want)[real], **TOL)
    assert not np.allclose(_np(got)[real], _np(got_h)[real], atol=1e-3)
    none = _t_forward(params, spec, ids, seg, pos,
                      routed_experts=torch.full((*ids.shape, NL_MOE, K), -1, dtype=torch.int32))
    np.testing.assert_array_equal(_np(none), _np(got_h))
    with pytest.raises(ValueError, match="MoE layers"):
        _t_forward(params, spec, ids, seg, pos,
                   routed_experts=torch.full((*ids.shape, 4, K), -1, dtype=torch.int32))
    with pytest.raises(ValueError, match="glm4_moe.forward"):
        _t_forward(params, dataclasses.replace(spec, family="qwen3_moe"), ids, seg, pos)


def test_hf_round_trip(tmp_path, model):
    """to_hf names every key the JAX package names with equal values (the
    dense first layer's MLP, the routers, the correction biases, the shared
    experts); from_hf gives the params back; a snapshot's config.json
    (``Glm4MoeForCausalLM``) reads back as the same spec."""
    jspec, spec, np_params, params = model
    want = jglm.params_to_hf_state_dict(jax.tree.map(jnp.asarray, np_params), jspec)
    family = get_family(spec)
    state = family.to_hf(params, spec)
    assert set(state) == set(want)
    for k, v in state.items():
        np.testing.assert_array_equal(_np(torch.as_tensor(v)), np.asarray(want[k]), err_msg=k)
    back = family.from_hf(state, spec)
    for (pa, a), (pb, b) in zip(toptim.tree_paths(params), toptim.tree_paths(back)):
        assert pa == pb and torch.equal(a, b), pa
    save_hf_weights(params, spec, tmp_path / "snap")
    assert get_spec(str(tmp_path / "snap")) == spec


def test_sampler_prefill_and_decode_match_jax(model):
    """prefill_batch (two prompts and a dummy row), then three decode steps
    with the routing collected: hidden states and logits (2e-4), the routing
    of the 3 MoE layers (equal ids) and the written pools, against the JAX
    sampler on the same weights and page tables."""
    jspec, spec, np_params, params = model
    jp = jmodel.unstack_params(jax.tree.map(jnp.asarray, np_params), jspec)
    tp = tmodel.unstack_params(params, spec)
    assert len(tp["layers"]) == 4 and "router" not in tp["layers"][0]
    j_prefill_batch = jax.jit(jmodel.prefill_batch, static_argnums=(1,),
                              static_argnames=("attn_impl", "compute_dtype"))
    j_decode = jax.jit(jmodel.decode, static_argnums=(1,),
                       static_argnames=("attn_impl", "compute_dtype", "collect_routing"))
    shape = (spec.num_kv_heads, 24, 8, spec.head_dim)
    jk = [jnp.zeros(shape, jnp.float32) for _ in range(4)]
    jv = [jnp.zeros(shape, jnp.float32) for _ in range(4)]
    tk = [torch.zeros(shape) for _ in range(4)]
    tv = [torch.zeros(shape) for _ in range(4)]
    rng = np.random.default_rng(1)
    ids = rng.integers(1, 250, (3, 16)).astype(np.int32)
    lengths = np.asarray([13, 16, 0], np.int32)
    ids[2] = 0
    pages = np.asarray([[1, 2], [3, 4], [0, 0]], np.int32)
    jk, jv, j_h = j_prefill_batch(jp, jspec, jk, jv, jnp.asarray(ids), jnp.asarray(lengths),
                                  jnp.asarray(pages), attn_impl="xla", compute_dtype=jnp.float32)
    _, _, t_h = tmodel.prefill_batch(tp, spec, tk, tv, torch.from_numpy(ids.astype(np.int64)),
                                     torch.from_numpy(lengths), torch.from_numpy(pages),
                                     compute_dtype=torch.float32)
    np.testing.assert_allclose(_np(t_h)[:2], np.asarray(j_h)[:2], **TOL)
    table = np.zeros((3, 6), np.int32)
    table[0, :3], table[1, :3] = [1, 2, 5], [3, 4, 6]
    lens = np.asarray([13, 16, 0], np.int32)
    toks = np.asarray([3, 7, 0], np.int32)
    for _ in range(3):
        jk, jv, j_logits, j_routed, *_ = j_decode(
            jp, jspec, jk, jv, jnp.asarray(toks), jnp.asarray(lens), jnp.asarray(table),
            attn_impl="xla", compute_dtype=jnp.float32, collect_routing=True)
        _, _, t_logits, t_routed = tmodel.decode(
            tp, spec, tk, tv, torch.from_numpy(toks), torch.from_numpy(lens),
            torch.from_numpy(table), compute_dtype=torch.float32, collect_routing=True)
        np.testing.assert_allclose(_np(t_logits)[:2], np.asarray(j_logits)[:2], **TOL)
        assert t_routed.shape == (3, NL_MOE, K)
        np.testing.assert_array_equal(t_routed.numpy()[:2], np.asarray(j_routed)[:2])
        toks = np.asarray(j_logits).argmax(-1).astype(np.int32)
        lens = lens + np.asarray([1, 1, 0], np.int32)
    for jl, tl in zip(jk + jv, tk + tv):
        np.testing.assert_allclose(_np(tl)[:, 1:7], np.asarray(jl)[:, 1:7], **TOL)


def test_engine_greedy_and_routing_match_the_forward_and_jax(model):
    """Greedy serving with the routing recorded gives the training forward's
    greedy tokens, and the JAX engine's tokens and routing ids on the same
    weights ([n_gen, 3, 2], the last row -1)."""
    jspec, spec, np_params, params = model
    params = toptim.tree_map(lambda x: x * 2.0, params)
    np_params = jax.tree.map(lambda x: x * np.float32(2.0), np_params)
    cache = dict(num_pages=32, page_size=16, max_slots=2, max_seq_len=128)
    engine = Engine(params, spec, CacheConfig(**cache), device="cpu",
                    compute_dtype=torch.float32, decode_block=4, collect_routed_experts=True)
    prompt = [int(x) for x in np.random.default_rng(7).integers(1, 200, 21)]
    n_gen = 8
    got = engine.generate([prompt], SamplingParams(max_tokens=n_gen, temperature=0.0,
                                                   ignore_eos=True))[0]
    want = JEngine(jax.tree.map(jnp.asarray, np_params), jspec, JCacheConfig(**cache),
                   compute_dtype=jnp.float32, collect_routed_experts=True).generate(
        [prompt], JSamplingParams(max_tokens=n_gen, temperature=0.0, ignore_eos=True))[0]
    assert got.token_ids == want.token_ids
    assert got.routed_experts.shape == (n_gen, NL_MOE, K)
    np.testing.assert_array_equal(got.routed_experts, want.routed_experts)
    assert bool((got.routed_experts[-1] == -1).all())
    seq = np.asarray([prompt + got.token_ids], np.int32)
    h = _t_forward(params, spec, seq, np.ones_like(seq),
                   np.arange(seq.shape[1], dtype=np.int32)[None])
    head = get_family(spec).get_lm_head(params, spec)
    assert (h[0] @ head)[len(prompt) - 1:-1].argmax(-1).tolist() == got.token_ids


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

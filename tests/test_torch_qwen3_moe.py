"""The qwen3_moe family on the CPU against the JAX package, on the
``debug_moe`` spec (2 layers, 4/2 heads of 32, 8 experts top-2): the training
forward (hidden states and the load-balance aux, on its own routing and
replayed), self-replay, the HF conversion, the sampler's prefill, decode and
chunked prefill, greedy engine tokens against the training forward, the
engine's recorded routing (router replay: equal to the JAX engine's, row by
row the routing of each generated token as the next step's input, the last
row -1) and one train step with half the tokens replayed. Weights are made
by the JAX package's init from a seed, every leaf moved off its init value,
and carried across as numpy; everything runs in float32.

Tolerances, those of ``tests/test_torch_gpt_oss.py``: 2e-4 on hidden states
and logits, 1e-4 relative on the step's loss and metrics, 4e-5 absolute on
the parameters after the update; routing ids and tokens equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prime_rl_tpu.configs import TrainerConfig as JTrainerConfig
from prime_rl_tpu.configs.shared import MeshConfig as JMeshConfig
from prime_rl_tpu.models import qwen3_moe as jmoe
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
from prime_rl_tpu_torch.models import qwen3_moe as tmoe
from prime_rl_tpu_torch.models.base import get_spec
from prime_rl_tpu_torch.models.qwen3 import load_hf_weights, params_from_jax
from prime_rl_tpu_torch.ops import moe as tmoe_ops
from prime_rl_tpu_torch.sampler import model as tmodel
from prime_rl_tpu_torch.sampler.cache import CacheConfig
from prime_rl_tpu_torch.sampler.engine import Engine, SamplingParams
from prime_rl_tpu_torch.trainer import optim as toptim
from prime_rl_tpu_torch.trainer import step as tstep
from prime_rl_tpu_torch.trainer.rl.data import FakeDataLoader
from prime_rl_tpu_torch.trainer.weights import save_hf_weights, spec_to_hf_config
from prime_rl_tpu_torch.utils import pathing

torch.set_num_threads(1)

JSPEC, SPEC = j_get_spec("debug_moe"), get_spec("debug_moe")
NL, K = SPEC.num_layers, SPEC.num_experts_per_tok
TOL = dict(atol=2e-4, rtol=2e-4)


def _np(t):
    return t.detach().float().numpy()


@pytest.fixture(scope="module")
def weights():
    """(JAX params as numpy, the same params in the port): the JAX init from
    a seed with every leaf moved by 0.05 * N(0, 1)."""
    rng = np.random.default_rng(0)
    np_params = jax.tree.map(
        lambda x: np.asarray(x) + np.float32(0.05) * rng.standard_normal(x.shape, np.float32),
        jmoe.init_params(JSPEC, jax.random.key(0)))
    return np_params, params_from_jax(np_params, SPEC)


def _packed(L=40, rows=2, seed=1):
    """Packed rows of two segments whose positions restart, and padding."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, 500, size=(rows, L)).astype(np.int32)
    a, b = 21, 13
    seg = np.array([[1] * a + [2] * b + [0] * (L - a - b)] * rows, np.int32)
    pos = np.array([list(range(a)) + list(range(b)) + [0] * (L - a - b)] * rows, np.int32)
    return ids, seg, pos


def _t_forward(params, ids, seg, pos, **kw):
    kw.setdefault("remat", "none")
    return tmoe.forward(params, SPEC, torch.from_numpy(ids), torch.from_numpy(seg),
                        torch.from_numpy(pos), compute_dtype=torch.float32, **kw)


class _Recorder:
    """Records every ``route_topk`` call's expert ids (the training forward's
    own routing), in call order: one [T, K] a MoE layer."""

    def __init__(self, monkeypatch):
        own = tmoe_ops.route_topk
        self.ids = []

        def wrapped(*args, **kw):
            out = own(*args, **kw)
            self.ids.append(out.expert_ids.clone())
            return out

        monkeypatch.setattr(tmoe_ops, "route_topk", wrapped)


def test_forward_hidden_aux_and_router_replay_match_jax(weights, monkeypatch):
    """Hidden states (2e-4) and the summed load-balance aux (1e-5) on a packed
    batch; full remat gives the same states; a replay of half the tokens
    matches JAX's; replaying the forward's own routing is the identity, and
    rows of -1 keep it."""
    np_params, params = weights
    ids, seg, pos = _packed()
    jp = jax.tree.map(jnp.asarray, np_params)
    jkw = dict(compute_dtype=jnp.float32, remat="none", attn_impl="xla")
    want_h, want_aux = jmoe.forward(jp, JSPEC, *map(jnp.asarray, (ids, seg, pos)),
                                    collect_aux=True, **jkw)
    rec = _Recorder(monkeypatch)
    got_h, got_aux = _t_forward(params, ids, seg, pos, collect_aux=True)
    real = seg > 0
    np.testing.assert_allclose(_np(got_h)[real], np.asarray(want_h)[real], **TOL)
    np.testing.assert_allclose(float(got_aux), float(want_aux), rtol=1e-5)
    leaves = toptim.tree_map(lambda x: x.clone().requires_grad_(), params)
    np.testing.assert_allclose(_np(_t_forward(leaves, ids, seg, pos, remat="full")),
                               _np(got_h), atol=1e-6, rtol=1e-6)

    own = torch.stack(rec.ids[:NL], dim=1).reshape(*ids.shape, NL, K)
    again = _t_forward(params, ids, seg, pos, routed_experts=own)
    np.testing.assert_array_equal(_np(again), _np(got_h))
    none = _t_forward(params, ids, seg, pos, routed_experts=torch.full_like(own, -1))
    np.testing.assert_array_equal(_np(none), _np(got_h))

    rng = np.random.default_rng(5)
    routed = np.stack([rng.permutation(8)[:K] for _ in range(ids.size * NL)]).astype(np.int32)
    routed = routed.reshape(*ids.shape, NL, K)
    routed[:, ::2] = -1
    want = jmoe.forward(jp, JSPEC, *map(jnp.asarray, (ids, seg, pos)),
                        routed_experts=jnp.asarray(routed), **jkw)
    got = _t_forward(params, ids, seg, pos, routed_experts=torch.from_numpy(routed))
    np.testing.assert_allclose(_np(got)[real], np.asarray(want)[real], **TOL)
    assert not np.allclose(_np(got)[real], _np(got_h)[real], atol=1e-3)


def test_hf_round_trip(tmp_path, weights):
    """to_hf names every key the JAX package names with equal values; from_hf
    gives the params back; a snapshot reads back through ``get_spec`` (the
    same spec, ``Qwen3MoeForCausalLM``) and ``load_hf_weights``."""
    np_params, params = weights
    want = jmoe.params_to_hf_state_dict(jax.tree.map(jnp.asarray, np_params), JSPEC)
    family = get_family(SPEC)
    state = family.to_hf(params, SPEC)
    assert set(state) == set(want)
    for k, v in state.items():
        np.testing.assert_array_equal(v, np.asarray(want[k]), err_msg=k)
    back = family.from_hf(state, SPEC)
    for (pa, a), (pb, b) in zip(toptim.tree_paths(params), toptim.tree_paths(back)):
        assert pa == pb and torch.equal(a, b), pa
    save_hf_weights(params, SPEC, tmp_path / "snap")
    assert pathing.is_stable(tmp_path / "snap")
    assert get_spec(str(tmp_path / "snap")) == SPEC
    assert spec_to_hf_config(SPEC)["architectures"] == ["Qwen3MoeForCausalLM"]
    loaded = load_hf_weights(tmp_path / "snap", SPEC, dtype=torch.float32)
    for (pa, a), (_, b) in zip(toptim.tree_paths(params), toptim.tree_paths(loaded)):
        assert torch.equal(a.bfloat16().float(), b), pa


def _pools(num_pages=24, page_size=8):
    shape = (SPEC.num_kv_heads, num_pages, page_size, SPEC.head_dim)
    return ([jnp.zeros(shape, jnp.float32) for _ in range(NL)],
            [torch.zeros(shape) for _ in range(NL)])


def test_sampler_prefill_decode_and_chunk_match_jax(weights):
    """prefill_batch (two prompts and a dummy row), three decode steps with
    the routing collected, and a two-chunk prefill over a shared prefix page:
    hidden states and logits (2e-4), the decode routing (equal ids) and the
    written pools against the JAX sampler on the same weights and tables."""
    np_params, params = weights
    jp = jmodel.unstack_params(jax.tree.map(jnp.asarray, np_params), JSPEC)
    tp = tmodel.unstack_params(params, SPEC)
    f32 = dict(compute_dtype=jnp.float32)
    static = dict(static_argnums=(1,), static_argnames=("attn_impl", "compute_dtype"))
    j_prefill_batch = jax.jit(jmodel.prefill_batch, **static)
    j_decode = jax.jit(jmodel.decode, static_argnums=(1,),
                       static_argnames=("attn_impl", "compute_dtype", "collect_routing"))
    j_prefill_chunk = jax.jit(jmodel.prefill_chunk, static_argnums=(1,),
                              static_argnames=("compute_dtype",))
    rng = np.random.default_rng(1)
    jk, tk = _pools()
    jv, tv = _pools()

    ids = rng.integers(1, 500, (3, 16)).astype(np.int32)
    lengths = np.asarray([13, 16, 0], np.int32)
    ids[2] = 0
    pages = np.asarray([[1, 2], [3, 4], [0, 0]], np.int32)
    jk, jv, j_h = j_prefill_batch(jp, JSPEC, jk, jv, jnp.asarray(ids), jnp.asarray(lengths),
                                  jnp.asarray(pages), attn_impl="xla", **f32)
    _, _, t_h = tmodel.prefill_batch(
        tp, SPEC, tk, tv, torch.from_numpy(ids.astype(np.int64)), torch.from_numpy(lengths),
        torch.from_numpy(pages), compute_dtype=torch.float32)
    np.testing.assert_allclose(_np(t_h)[:2], np.asarray(j_h)[:2], **TOL)

    table = np.zeros((3, 6), np.int32)
    table[0, :3], table[1, :3] = [1, 2, 5], [3, 4, 6]
    lens = np.asarray([13, 16, 0], np.int32)
    toks = np.asarray([3, 7, 0], np.int32)
    for _ in range(3):
        jk, jv, j_logits, j_routed, *_ = j_decode(
            jp, JSPEC, jk, jv, jnp.asarray(toks), jnp.asarray(lens), jnp.asarray(table),
            attn_impl="xla", collect_routing=True, **f32)
        _, _, t_logits, t_routed = tmodel.decode(
            tp, SPEC, tk, tv, torch.from_numpy(toks), torch.from_numpy(lens),
            torch.from_numpy(table), compute_dtype=torch.float32, collect_routing=True)
        np.testing.assert_allclose(_np(t_logits)[:2], np.asarray(j_logits)[:2], **TOL)
        assert t_routed.shape == (3, NL, K) and t_routed.dtype == torch.int32
        np.testing.assert_array_equal(t_routed.numpy()[:2], np.asarray(j_routed)[:2])
        toks = np.asarray(j_logits).argmax(-1).astype(np.int32)
        lens = lens + np.asarray([1, 1, 0], np.int32)
    for jl, tl in zip(jk + jv, tk + tv):
        np.testing.assert_allclose(_np(tl)[:, 1:7], np.asarray(jl)[:, 1:7], **TOL)

    prompt = np.concatenate([ids[0, :8], rng.integers(1, 500, 20)]).astype(np.int32)
    row = np.asarray([1, 7, 8, 9, 0, 0], np.int32)
    for off, valid in ((8, 16), (24, 4)):
        chunk = np.zeros((1, 16), np.int32)
        chunk[0, :valid] = prompt[off:off + valid]
        pch = row[off // 8: off // 8 + 2]
        jk, jv, j_last = j_prefill_chunk(jp, JSPEC, jk, jv, jnp.asarray(chunk), jnp.int32(off),
                                         jnp.int32(valid), jnp.asarray(pch), jnp.asarray(row),
                                         **f32)
        _, _, t_last = tmodel.prefill_chunk(
            tp, SPEC, tk, tv, torch.from_numpy(chunk.astype(np.int64)), off, valid,
            torch.from_numpy(pch), torch.from_numpy(row), compute_dtype=torch.float32)
        np.testing.assert_allclose(_np(t_last), np.asarray(j_last), **TOL)


def test_engine_greedy_and_routing_match_the_forward_and_jax(weights, monkeypatch):
    """Greedy serving with the routing recorded: the tokens are the training
    forward's greedy choices; each completion's ``routed_experts`` [n_gen, NL,
    K] is, row by row, the training forward's routing of that generated token
    as an input (the last row -1, its forward never ran); and the JAX engine
    on the same weights and prompts gives the same tokens and the same ids."""
    np_params, params = weights
    params = toptim.tree_map(lambda x: x * 2.0, params)
    np_params = jax.tree.map(lambda x: x * np.float32(2.0), np_params)
    cache = dict(num_pages=32, page_size=16, max_slots=2, max_seq_len=128)
    engine = Engine(params, SPEC, CacheConfig(**cache), device="cpu",
                    compute_dtype=torch.float32, decode_block=4, collect_routed_experts=True)
    rng = np.random.default_rng(7)
    prompts = [[int(x) for x in rng.integers(1, 500, n)] for n in (21, 9)]
    n_gen = 8
    got = engine.generate(prompts, SamplingParams(max_tokens=n_gen, temperature=0.0,
                                                  ignore_eos=True))
    j_engine = JEngine(jax.tree.map(jnp.asarray, np_params), JSPEC, JCacheConfig(**cache),
                       compute_dtype=jnp.float32, collect_routed_experts=True)
    want = j_engine.generate(prompts, JSamplingParams(max_tokens=n_gen, temperature=0.0,
                                                      ignore_eos=True))
    head = get_family(SPEC).get_lm_head(params, SPEC)
    for prompt, res, j_res in zip(prompts, got, want):
        assert res.token_ids == j_res.token_ids and len(res.token_ids) == n_gen
        r = res.routed_experts
        assert r.shape == (n_gen, NL, K) and r.dtype == np.int32
        np.testing.assert_array_equal(r, j_res.routed_experts)
        assert bool((r[:-1] >= 0).all() and (r[:-1] < SPEC.num_experts).all())
        assert bool((r[-1] == -1).all())
        seq = np.asarray([prompt + res.token_ids], np.int32)
        rec = _Recorder(monkeypatch)
        h = _t_forward(params, seq, np.ones_like(seq), np.arange(seq.shape[1], dtype=np.int32)[None])
        monkeypatch.undo()
        logits = h[0] @ head
        assert logits[len(prompt) - 1:-1].argmax(-1).tolist() == res.token_ids
        own = torch.stack(rec.ids, dim=1)  # [L, NL, K]
        inputs = own[len(prompt):len(prompt) + n_gen - 1].numpy()
        np.testing.assert_array_equal(np.sort(r[:-1], -1), np.sort(inputs, -1))


def _model_cfg(cls):
    return cls(model={"attn": {"impl": "xla"}, "compute_dtype": "float32",
                      "lm_head_chunk_size": 48, "ac": {"mode": "full"}, "moe_aux_coef": 0.01},
               optimizer={"type": "sgd", "lr": 1e-2, "weight_decay": 0.1})


def test_train_step_with_replay_matches_jax_step_one(weights):
    """One fake batch with half the tokens' routing replayed through
    ``make_train_step`` with a trained load-balance term: loss, grad_norm and
    every metric (rtol 1e-4), and every parameter after an sgd update with
    weight decay (atol 4e-5)."""
    np_params, params = weights
    j_cfg, t_cfg = _model_cfg(JTrainerConfig), _model_cfg(TrainerConfig)
    batch, counts = FakeDataLoader(SPEC.vocab_size, 64, 2, 2, seed=0).next_batch()
    rng = np.random.default_rng(3)
    routed = rng.integers(0, SPEC.num_experts, (*batch.input_ids.shape, NL, K)).astype(np.int32)
    routed[..., 1, :] = routed[..., 0, :][..., ::-1]  # distinct ids in a row of two
    routed[:, :, ::2] = -1
    batch = batch._replace(routed_experts=routed)
    scale = float(counts["rl"])

    j_opt, _ = joptim.make_optimizer(j_cfg.optimizer, j_cfg.scheduler, 1.0)
    mesh_info = build_mesh(JMeshConfig(fsdp=-1))
    j_state = jstep.init_train_state(JSPEC, mesh_info, j_opt,
                                     params=jax.tree.map(jnp.asarray, np_params))
    j_step = jstep.make_train_step(JSPEC, j_cfg.model, j_cfg.loss, j_opt, mesh_info)
    j_batch = jstep.MicroBatchArrays(*[None if x is None else jnp.asarray(x) for x in batch])
    j_state, j_metrics = j_step(j_state, j_batch, jstep.Scales(
        jnp.float32(scale), jnp.float32(1.0), jnp.float32(1.0)))

    t_opt, _ = toptim.make_optimizer(t_cfg.optimizer, t_cfg.scheduler, 1.0)
    t_state = tstep.init_train_state(SPEC, "cpu", t_opt,
                                     params=toptim.tree_map(lambda x: x.clone(), params))
    t_step = tstep.make_train_step(SPEC, t_cfg.model, t_cfg.loss, t_opt, "cpu")
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

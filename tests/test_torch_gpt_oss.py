"""The gpt-oss slice as a whole on the CPU against the JAX package, on the tiny
spec of ``tests/unit/models/test_gpt_oss.py`` (windows of 8 on every other
layer, sinks, q/k/v/o biases, YaRN, clamped-GLU experts with biases): the
training forward (hidden states, load-balance aux, router replay), the HF
conversion with its interleaved ``gate_up_proj``, the sampler's prefill,
chunked prefill and decode past the window, greedy engine tokens against the
training forward, and one train step. Weights are made by the JAX package's
init from a seed, every leaf moved off its init value (so biases, sinks and
norms are nonzero), and carried across as numpy; everything runs in float32.

Tolerances are stated per test: 2e-4 on hidden states and logits (the
packages sum in different orders through 4 layers), 1e-4 relative on the
step's loss and metrics, 4e-5 absolute on the parameters after the update.
"""

import dataclasses
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prime_rl_tpu.configs import TrainerConfig as JTrainerConfig
from prime_rl_tpu.configs.shared import MeshConfig as JMeshConfig
from prime_rl_tpu.models import gpt_oss as jgpt
from prime_rl_tpu.models.base import ModelSpec as JModelSpec
from prime_rl_tpu.parallel.mesh import build_mesh
from prime_rl_tpu.sampler import model as jmodel
from prime_rl_tpu.trainer import optim as joptim
from prime_rl_tpu.trainer import step as jstep
from prime_rl_tpu_torch.configs import TrainerConfig
from prime_rl_tpu_torch.models import get_family
from prime_rl_tpu_torch.models import gpt_oss as tgpt
from prime_rl_tpu_torch.models.base import ModelSpec, get_spec
from prime_rl_tpu_torch.models.qwen3 import layer_windows_list, load_hf_weights
from prime_rl_tpu_torch.sampler import model as tmodel
from prime_rl_tpu_torch.sampler.cache import CacheConfig
from prime_rl_tpu_torch.sampler.engine import Engine, SamplingParams
from prime_rl_tpu_torch.trainer import optim as toptim
from prime_rl_tpu_torch.trainer import step as tstep
from prime_rl_tpu_torch.trainer.rl.data import FakeDataLoader
from prime_rl_tpu_torch.trainer.weights import save_hf_weights, spec_to_hf_config
from prime_rl_tpu_torch.utils import pathing

torch.set_num_threads(1)

SPEC_KW = dict(
    family="gpt_oss", vocab_size=256, hidden_size=64, num_layers=4,
    num_heads=4, num_kv_heads=2, head_dim=16, intermediate_size=48,
    rope_theta=150000.0, rms_eps=1e-5, tie_embeddings=False, qk_norm=False,
    max_position_embeddings=512, eos_token_id=255, pad_token_id=0,
    num_experts=4, num_experts_per_tok=2, moe_intermediate_size=48,
    sliding_window=8, sliding_window_pattern=2, attn_sinks=True,
    attn_bias=True, swiglu_alpha=1.702, swiglu_limit=7.0,
    expert_bias=True, router_bias=True, router_softmax_topk=True,
    rope_yarn_factor=4.0, rope_yarn_orig_max=128, rope_yarn_truncate=False,
)
JSPEC, SPEC = JModelSpec(**SPEC_KW), ModelSpec(**SPEC_KW)
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
        jgpt.init_params(JSPEC, jax.random.key(0)))
    return np_params, tgpt.params_from_jax(np_params, SPEC)


def _packed(L=48, rows=2, seed=1):
    """Packed rows: two segments whose positions restart (both longer than the
    window of 8), and a padded tail."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, 250, size=(rows, L)).astype(np.int32)
    a, b = 24, 19
    seg = np.array([[1] * a + [2] * b + [0] * (L - a - b)] * rows, np.int32)
    pos = np.array([list(range(a)) + list(range(b)) + [0] * (L - a - b)] * rows, np.int32)
    return ids, seg, pos


def _t_forward(params, ids, seg, pos, spec=SPEC, **kw):
    kw.setdefault("remat", "none")
    return tgpt.forward(params, spec, torch.from_numpy(ids), torch.from_numpy(seg),
                        torch.from_numpy(pos), compute_dtype=torch.float32, **kw)


def test_forward_hidden_aux_and_router_replay_match_jax(weights):
    """Hidden states (2e-4) and the summed load-balance aux (1e-5) on a packed
    batch; the kernel route (the kernels' plain versions) and full remat give
    the same states; replayed routing (half the tokens forced) matches JAX;
    windows and sinks both change the result."""
    np_params, params = weights
    ids, seg, pos = _packed()
    jp = jax.tree.map(jnp.asarray, np_params)
    jkw = dict(compute_dtype=jnp.float32, remat="none", attn_impl="xla")
    want_h, want_aux = jgpt.forward(jp, JSPEC, *map(jnp.asarray, (ids, seg, pos)),
                                    collect_aux=True, **jkw)
    got_h, got_aux = _t_forward(params, ids, seg, pos, collect_aux=True)
    real = seg > 0  # padding rows attend nothing; their hidden states are not used
    np.testing.assert_allclose(_np(got_h)[real], np.asarray(want_h)[real], **TOL)
    np.testing.assert_allclose(float(got_aux), float(want_aux), rtol=1e-5)
    assert layer_windows_list(SPEC) == [8, 0, 8, 0]

    kernel = _t_forward(params, ids, seg, pos, attn_impl="pallas")
    np.testing.assert_allclose(_np(kernel)[real], _np(got_h)[real], atol=1e-5, rtol=1e-5)
    leaves = toptim.tree_map(lambda x: x.clone().requires_grad_(), params)
    for mode in ("full", "save_attn/2"):
        np.testing.assert_allclose(_np(_t_forward(leaves, ids, seg, pos, remat=mode)),
                                   _np(got_h), atol=1e-6, rtol=1e-6, err_msg=mode)

    rng = np.random.default_rng(5)
    routed = np.stack([rng.permutation(4)[:2] for _ in range(ids.size * 4)]).astype(np.int32)
    routed = routed.reshape(*ids.shape, 4, 2)
    routed[:, ::2] = -1
    want = jgpt.forward(jp, JSPEC, *map(jnp.asarray, (ids, seg, pos)),
                        routed_experts=jnp.asarray(routed), **jkw)
    got = _t_forward(params, ids, seg, pos, routed_experts=torch.from_numpy(routed))
    np.testing.assert_allclose(_np(got)[real], np.asarray(want)[real], **TOL)
    assert not np.allclose(_np(got)[real], _np(got_h)[real], atol=1e-3)

    for over in (dict(sliding_window=0), dict(attn_sinks=False)):
        spec = dataclasses.replace(SPEC, **over)
        p = params if spec.attn_sinks else {
            **params, "layers": {k: v for k, v in params["layers"].items() if k != "sink"}}
        other = _np(_t_forward(p, ids, seg, pos, spec=spec))[real]
        assert not np.allclose(other, _np(got_h)[real], atol=1e-3), over


def test_hf_round_trip_with_interleaved_gate_up(tmp_path, weights):
    """to_hf names every key the JAX package names with equal values (gate at
    the even and up at the odd columns of ``gate_up_proj``); from_hf gives the
    params back; a snapshot reads back through ``get_spec`` (the same spec)
    and ``load_hf_weights`` (bf16-rounded params)."""
    np_params, params = weights
    want = jgpt.params_to_hf_state_dict(jax.tree.map(jnp.asarray, np_params), JSPEC)
    family = get_family(SPEC)
    state = family.to_hf(params, SPEC)
    assert set(state) == set(want)
    for k, v in state.items():
        np.testing.assert_array_equal(v, np.asarray(want[k]), err_msg=k)
    gu = state["model.layers.1.mlp.experts.gate_up_proj"]
    assert gu.shape == (4, 64, 96)
    np.testing.assert_array_equal(gu[..., 1::2], _np(params["layers"]["expert_up"][1]))
    back = family.from_hf(state, SPEC)
    for (pa, a), (pb, b) in zip(toptim.tree_paths(params), toptim.tree_paths(back)):
        assert pa == pb and torch.equal(a, b), pa

    save_hf_weights(params, SPEC, tmp_path / "snap")
    assert pathing.is_stable(tmp_path / "snap")
    assert get_spec(str(tmp_path / "snap")) == SPEC
    assert spec_to_hf_config(SPEC)["architectures"] == ["GptOssForCausalLM"]
    loaded = load_hf_weights(tmp_path / "snap", SPEC, dtype=torch.float32)
    for (pa, a), (_, b) in zip(toptim.tree_paths(params), toptim.tree_paths(loaded)):
        assert torch.equal(a.bfloat16().float(), b), pa


def _pools(num_pages=24, page_size=8):
    shape = (SPEC.num_kv_heads, num_pages, page_size, SPEC.head_dim)
    return ([jnp.zeros(shape, jnp.float32) for _ in range(SPEC.num_layers)],
            [torch.zeros(shape) for _ in range(SPEC.num_layers)])


def test_sampler_prefill_decode_and_chunk_match_jax(weights):
    """prefill_batch (two prompts and a dummy row), three decode steps that
    carry a 13-token slot past the window, and a two-chunk prefill over a
    shared prefix page: hidden states and logits (2e-4) and the written pools
    against the JAX sampler on the same weights and page tables."""
    np_params, params = weights
    jp = jmodel.unstack_params(jax.tree.map(jnp.asarray, np_params), JSPEC)
    tp = tmodel.unstack_params(params, SPEC)
    f32 = dict(compute_dtype=jnp.float32)
    # jitted: eager JAX compiles every MoE op of every layer on its own
    static = dict(static_argnums=(1,), static_argnames=("attn_impl", "compute_dtype"))
    j_prefill_batch, j_decode = (jax.jit(f, **static) for f in (jmodel.prefill_batch,
                                                                 jmodel.decode))
    j_prefill_chunk = jax.jit(jmodel.prefill_chunk, static_argnums=(1,),
                              static_argnames=("compute_dtype",))
    rng = np.random.default_rng(1)
    jk, tk = _pools()
    jv, tv = _pools()

    ids = rng.integers(1, 250, (3, 16)).astype(np.int32)
    lengths = np.asarray([13, 16, 0], np.int32)
    ids[2] = 0
    pages = np.asarray([[1, 2], [3, 4], [0, 0]], np.int32)
    jk, jv, j_h = j_prefill_batch(jp, JSPEC, jk, jv, jnp.asarray(ids), jnp.asarray(lengths),
                                       jnp.asarray(pages), attn_impl="xla", **f32)
    _, _, t_h = tmodel.prefill_batch(tp, SPEC, tk, tv, torch.from_numpy(ids.astype(np.int64)),
                                     torch.from_numpy(lengths), torch.from_numpy(pages),
                                     compute_dtype=torch.float32)
    np.testing.assert_allclose(_np(t_h)[:2], np.asarray(j_h)[:2], **TOL)

    table = np.zeros((3, 6), np.int32)
    table[0, :3], table[1, :3] = [1, 2, 5], [3, 4, 6]
    lens = np.asarray([13, 16, 0], np.int32)
    toks = np.asarray([3, 7, 0], np.int32)
    for _ in range(3):
        jk, jv, j_logits, *_ = j_decode(jp, JSPEC, jk, jv, jnp.asarray(toks),
                                             jnp.asarray(lens), jnp.asarray(table),
                                             attn_impl="xla", **f32)
        _, _, t_logits = tmodel.decode(tp, SPEC, tk, tv, torch.from_numpy(toks),
                                       torch.from_numpy(lens), torch.from_numpy(table),
                                       compute_dtype=torch.float32)
        np.testing.assert_allclose(_np(t_logits)[:2], np.asarray(j_logits)[:2], **TOL)
        toks = np.asarray(j_logits).argmax(-1).astype(np.int32)
        lens = lens + np.asarray([1, 1, 0], np.int32)
    for jl, tl in zip(jk + jv, tk + tv):
        np.testing.assert_allclose(_np(tl)[:, 1:7], np.asarray(jl)[:, 1:7], **TOL)

    prompt = np.concatenate([ids[0, :8], rng.integers(1, 250, 20)]).astype(np.int32)
    row = np.asarray([1, 7, 8, 9, 0, 0], np.int32)
    for off, valid in ((8, 16), (24, 4)):
        chunk = np.zeros((1, 16), np.int32)
        chunk[0, :valid] = prompt[off:off + valid]
        pch = row[off // 8: off // 8 + 2]
        jk, jv, j_last = j_prefill_chunk(jp, JSPEC, jk, jv, jnp.asarray(chunk),
                                              jnp.int32(off), jnp.int32(valid),
                                              jnp.asarray(pch), jnp.asarray(row), **f32)
        _, _, t_last = tmodel.prefill_chunk(tp, SPEC, tk, tv,
                                            torch.from_numpy(chunk.astype(np.int64)), off, valid,
                                            torch.from_numpy(pch), torch.from_numpy(row),
                                            compute_dtype=torch.float32)
        np.testing.assert_allclose(_np(t_last), np.asarray(j_last), **TOL)


def test_engine_greedy_matches_training_forward(weights):
    """Paged-cache serving (windows, sinks and expert biases in decode, a
    prompt longer than the window) gives, token for token, the greedy choice
    of the training forward run on the whole sequence."""
    _, params = weights
    params = toptim.tree_map(lambda x: x * 2.0, params)
    engine = Engine(params, SPEC, CacheConfig(num_pages=32, page_size=16, max_slots=2,
                                              max_seq_len=128),
                    device="cpu", compute_dtype=torch.float32, decode_block=4)
    prompt = [int(x) for x in np.random.default_rng(7).integers(1, 200, 21)]
    ids, want = list(prompt), []
    head = get_family(SPEC).get_lm_head(params, SPEC)
    for _ in range(10):
        arr = np.asarray([ids], np.int32)
        h = _t_forward(params, arr, np.ones_like(arr), np.arange(len(ids), dtype=np.int32)[None])
        want.append(int((h[0, -1] @ head).argmax()))
        ids.append(want[-1])
    got = engine.generate([prompt], SamplingParams(max_tokens=10, temperature=0.0))[0]
    assert got.token_ids == want


def _model_cfg(cls):
    return cls(model={"attn": {"impl": "xla"}, "compute_dtype": "float32",
                      "lm_head_chunk_size": 48, "ac": {"mode": "full"}, "moe_aux_coef": 0.01},
               optimizer={"type": "sgd", "lr": 1e-2, "weight_decay": 0.1})


def test_train_step_matches_jax_step_one(weights):
    """One fake batch through ``make_train_step`` with a trained load-balance
    term: loss, grad_norm and every metric (rtol 1e-4), and every parameter
    after an sgd update with weight decay (atol 4e-5), sinks and biases
    included."""
    np_params, params = weights
    j_cfg, t_cfg = _model_cfg(JTrainerConfig), _model_cfg(TrainerConfig)
    batch, counts = FakeDataLoader(SPEC.vocab_size, 64, 2, 2, seed=0).next_batch()
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
    before = dict(toptim.tree_paths(params))
    for path, t in toptim.tree_paths(t_state.params):
        np.testing.assert_allclose(_np(t), j_flat[path], atol=4e-5, rtol=0, err_msg=path)
        assert not torch.equal(t, before[path]), path  # every leaf moved, sinks included


def test_entrypoint_trains_a_tiny_gpt_oss_directory(tmp_path, monkeypatch):
    """``entrypoints.trainer --device cpu --data.type fake --model.name <dir
    with a GptOss config.json> --model.debug.random-init`` takes two steps and
    writes a v2 snapshot that reads back through ``get_spec`` and
    ``load_hf_weights``."""
    from prime_rl_tpu_torch.entrypoints import trainer as entry

    spec = dataclasses.replace(SPEC, intermediate_size=SPEC.moe_intermediate_size)
    model = tmp_path / "tiny_gpt_oss"
    model.mkdir()
    (model / "config.json").write_text(json.dumps(spec_to_hf_config(spec)))
    assert get_spec(str(model)) == spec
    out = tmp_path / "out"
    monkeypatch.setattr(sys, "argv", [
        "trainer", "--device", "cpu", "--data.type", "fake", "--model.name", str(model),
        "--model.debug.random-init", "--max-steps", "2", "--data.seq-len", "64",
        "--batch.seq-len", "64", "--data.micro-batch-size", "2", "--data.num-micro-batches",
        "2", "--model.lm-head-chunk-size", "48", "--model.moe-aux-coef", "0.01",
        "--output-dir", str(out)])
    entry.main()
    records = [json.loads(l) for l in (out / "trainer.jsonl").read_text().splitlines()]
    assert len(records) == 2 and all(np.isfinite(r["loss"]) for r in records)
    snap = pathing.weights_dir(out, 2)
    assert pathing.is_stable(snap) and get_spec(str(snap)) == spec
    loaded = load_hf_weights(snap, spec, dtype=torch.float32)
    assert loaded["layers"]["expert_gate"].shape == (4, 4, 64, 48)
    assert loaded["layers"]["sink"].shape == (4, 4)

"""The MLA + DSA slice as a whole on the CPU against the JAX package: the
``glm_moe_dsa`` and ``deepseek_v3`` training forward (hidden states, the
load-balance aux, router replay), the gradients of every leaf, sparse against
dense at full top-k, the HF conversion, one train step, and the trainer's
entry point on a tiny ``GlmMoeDsaForCausalLM`` directory. Weights are made by
the JAX package's init from a seed and carried across as numpy; everything
runs in float32.

Tolerances are stated per test: 2e-4 for hidden states (both packages round
the attention products' inputs to bfloat16 at the same places and sum in
float32), 4e-3 of each gradient's scale (one bf16 step), 1e-4 for the step's
loss.
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
from prime_rl_tpu.models import mla_moe as jmla
from prime_rl_tpu.models.base import ModelSpec as JModelSpec
from prime_rl_tpu.parallel.mesh import build_mesh
from prime_rl_tpu.trainer import optim as joptim
from prime_rl_tpu.trainer import step as jstep
from prime_rl_tpu_torch.configs import TrainerConfig
from prime_rl_tpu_torch.models import get_family
from prime_rl_tpu_torch.models import mla_moe as tmla
from prime_rl_tpu_torch.models.base import ModelSpec, get_spec
from prime_rl_tpu_torch.models.qwen3 import load_hf_weights
from prime_rl_tpu_torch.trainer import optim as toptim
from prime_rl_tpu_torch.trainer import step as tstep
from prime_rl_tpu_torch.trainer.rl.data import FakeDataLoader
from prime_rl_tpu_torch.trainer.weights import save_hf_weights, spec_to_hf_config
from prime_rl_tpu_torch.utils import pathing

torch.set_num_threads(1)

SPEC_KW = dict(
    family="glm_moe_dsa", vocab_size=256, hidden_size=64, num_layers=2,
    num_heads=4, num_kv_heads=4, head_dim=32, intermediate_size=128,
    moe_intermediate_size=48, num_experts=8, num_experts_per_tok=2,
    n_shared_experts=1, first_k_dense_replace=1, router_sigmoid=True,
    routed_scaling_factor=1.0, q_lora_rank=48, kv_lora_rank=32,
    qk_rope_head_dim=8, qk_nope_head_dim=24, v_head_dim=16,
    index_n_heads=4, index_head_dim=16, index_topk=64,
    rope_interleave=True, tie_embeddings=False, qk_norm=False,
    eos_token_id=255, pad_token_id=0,
)


def specs(index_topk=64, **kw):
    """The ``dsa_spec`` of tests/unit/models/test_mla_moe.py in both packages;
    ``index_topk = 0`` is the deepseek_v3 (dense MLA) family."""
    over = dict(SPEC_KW, index_topk=index_topk, **kw)
    if index_topk == 0:
        over.update(family="deepseek_v3", index_n_heads=0, index_head_dim=0)
    return JModelSpec(**over), ModelSpec(**over)


def _np(t):
    return t.detach().float().numpy()


def _params(jspec, spec, seed=1, scale=1.0):
    np_params = jax.tree.map(lambda x: np.asarray(x) * np.float32(scale),
                             jmla.init_params(jspec, jax.random.key(seed)))
    return np_params, tmla.params_from_jax(np_params, spec)


def _packed(L=48, rows=2, seed=1):
    """Packed rows: two segments whose positions restart, and a padded tail."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, 250, size=(rows, L)).astype(np.int32)
    a, b = L // 2, L // 2 - 5
    seg = np.array([[1] * a + [2] * b + [0] * (L - a - b)] * rows, np.int32)
    pos = np.array([list(range(a)) + list(range(b)) + [0] * (L - a - b)] * rows, np.int32)
    return ids, seg, pos


def _j_forward(np_params, jspec, ids, seg, pos, **kw):
    return jmla.forward(jax.tree.map(jnp.asarray, np_params), jspec, jnp.asarray(ids),
                        jnp.asarray(seg), jnp.asarray(pos), compute_dtype=jnp.float32,
                        remat="none", **kw)


def _t_forward(params, spec, ids, seg, pos, **kw):
    kw.setdefault("remat", "none")
    return tmla.forward(params, spec, torch.from_numpy(ids), torch.from_numpy(seg),
                        torch.from_numpy(pos), compute_dtype=torch.float32, **kw)


@pytest.mark.parametrize("index_topk", [8, 64, 0])
def test_forward_hidden_and_aux_match_jax(index_topk):
    """Hidden states (atol = rtol = 2e-4) and the summed load-balance aux
    (1e-5) on a packed batch with two segments and padding; top-k 8 really
    restricts, 64 selects every causal row, 0 is dense MLA (deepseek_v3)."""
    jspec, spec = specs(index_topk)
    np_params, params = _params(jspec, spec)
    ids, seg, pos = _packed()
    want_h, want_aux = _j_forward(np_params, jspec, ids, seg, pos, collect_aux=True)
    got_h, got_aux = _t_forward(params, spec, ids, seg, pos, collect_aux=True)
    real = seg > 0  # padding rows attend nothing; their hidden states are not used
    np.testing.assert_allclose(_np(got_h)[real], np.asarray(want_h)[real], atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(float(got_aux), float(want_aux), rtol=1e-5)
    assert torch.equal(_t_forward(params, spec, ids, seg, pos), got_h)


def test_kernel_route_full_remat_and_router_replay():
    """``attn_impl='pallas'`` runs the kernels' plain versions, which do not
    round q and kv to bf16 (float32 here): the hidden states stay within 2e-2
    of the chunked-gather route. ``full`` remat changes nothing. Replayed
    routing (half the tokens forced) matches the JAX forward at 2e-4.
    ``selective`` (the products with no batch dims kept) runs since the remat
    slice and changes nothing either."""
    jspec, spec = specs(8)
    np_params, params = _params(jspec, spec, seed=2)
    ids, seg, pos = _packed(seed=2)
    base = _t_forward(params, spec, ids, seg, pos)
    kernel = _t_forward(params, spec, ids, seg, pos, attn_impl="pallas")
    np.testing.assert_allclose(_np(kernel), _np(base), atol=2e-2, rtol=2e-2)
    assert not torch.equal(kernel, base)
    leaves = toptim.tree_map(lambda x: x.clone().requires_grad_(), params)
    full = _t_forward(leaves, spec, ids, seg, pos, remat="full")
    np.testing.assert_allclose(_np(full), _np(base), atol=1e-6, rtol=1e-6)
    selective = _t_forward(leaves, spec, ids, seg, pos, remat="selective")
    np.testing.assert_allclose(_np(selective), _np(base), atol=1e-6, rtol=1e-6)
    # LoRA runs since its slice (held against JAX in tests/test_torch_lora.py):
    # an identity adapter (B = 0) leaves the states as they are
    from prime_rl_tpu_torch.configs.shared import LoRAConfig
    from prime_rl_tpu_torch.models.lora import init_lora

    lora = init_lora(spec, LoRAConfig(rank=2), torch.Generator().manual_seed(1))
    assert {"q_b_a", "kv_b_a", "o_a"} <= set(lora["layers"])
    np.testing.assert_array_equal(
        _np(_t_forward(params, spec, ids, seg, pos, lora=lora, lora_scale=2.0)), _np(base))

    rng = np.random.default_rng(5)
    routed = np.stack([rng.permutation(8)[:2] for _ in range(ids.size)]).astype(np.int32)
    routed = routed.reshape(*ids.shape, 1, 2)
    routed[:, ::2] = -1
    want = _j_forward(np_params, jspec, ids, seg, pos, routed_experts=jnp.asarray(routed))
    got = _t_forward(params, spec, ids, seg, pos, routed_experts=torch.from_numpy(routed))
    real = seg > 0
    np.testing.assert_allclose(_np(got)[real], np.asarray(want)[real], atol=2e-4, rtol=2e-4)
    assert not np.allclose(_np(got)[real], _np(base)[real], atol=1e-3)


def test_gradients_of_every_leaf_match_jax_and_the_indexer_gets_none():
    """d(sum h^2 over real tokens)/d(leaf) for every leaf against jax.grad,
    each within 4e-3 of the leaf's largest gradient (both packages round the
    attention's cotangents to bf16, the transpose of the bf16 cast of q and
    kv, so a last-digit difference before that rounding moves a value by one
    bf16 step of 2^-8); the indexer's leaves get exactly 0 (its selection is
    gradient-free) while attention, router and experts do get gradients. Full
    remat, so the recompute is exercised."""
    jspec, spec = specs(8)
    np_params, params = _params(jspec, spec, seed=5, scale=2.0)
    ids, seg, pos = _packed(L=40, rows=1, seed=5)
    mask = (seg > 0)[..., None].astype(np.float32)

    def j_loss(p):
        h = jmla.forward(p, jspec, jnp.asarray(ids), jnp.asarray(seg), jnp.asarray(pos),
                         compute_dtype=jnp.float32, remat="none")
        return jnp.sum((h * mask) ** 2)

    want = jax.grad(j_loss)(jax.tree.map(jnp.asarray, np_params))
    leaves = toptim.tree_map(lambda x: x.clone().requires_grad_(), params)
    h = _t_forward(leaves, spec, ids, seg, pos, remat="full")
    (h * torch.from_numpy(mask)).square().sum().backward()
    want_flat = dict(toptim.tree_paths(jax.tree.map(np.asarray, want)))
    paths = toptim.tree_paths(leaves)
    assert set(p for p, _ in paths) == set(want_flat)
    for path, leaf in paths:
        w = want_flat[path]
        if "idx_" in path:
            assert leaf.grad is None and float(np.abs(w).sum()) == 0.0, path
            continue
        if path.endswith("router_correction_bias"):
            assert leaf.grad is None or float(leaf.grad.abs().sum()) == 0.0
            continue
        scale = float(np.abs(w).max())
        assert (scale > 0) == (path != "lm_head"), path  # the loss stops at the hidden states
        if scale == 0:
            assert leaf.grad is None
            continue
        np.testing.assert_allclose(_np(leaf.grad), w, atol=4e-3 * scale, rtol=4e-3, err_msg=path)


def test_sparse_equals_dense_at_full_topk():
    """index_topk >= L selects every causal row of the segment, so the DSA
    path reproduces dense MLA attention on the same weights (2e-3, as the JAX
    test), through the chunked-gather op and through the kernels' plain
    versions alike; a small top-k really differs."""
    _, sp_sparse = specs(64)
    sp_dense = dataclasses.replace(sp_sparse, index_topk=0)
    jspec, _ = specs(64)
    _, params = _params(jspec, sp_sparse)
    ids, seg, pos = _packed()
    real = seg > 0
    dense = _np(_t_forward(params, sp_dense, ids, seg, pos))[real]
    for impl in ("xla", "pallas"):
        sparse = _np(_t_forward(params, sp_sparse, ids, seg, pos, attn_impl=impl))[real]
        np.testing.assert_allclose(sparse, dense, rtol=2e-3, atol=2e-3, err_msg=impl)
    small = _np(_t_forward(params, dataclasses.replace(sp_sparse, index_topk=4), ids, seg,
                           pos))[real]
    assert np.isfinite(small).all() and not np.allclose(small, dense, atol=1e-3)


@pytest.mark.parametrize("index_topk", [8, 0])
def test_hf_conversion_round_trip_and_snapshot(tmp_path, index_topk):
    """to_hf names every HF key the JAX package names, with equal values;
    from_hf gives the params back; a saved snapshot reads back through
    ``get_spec`` (the same spec) and ``load_hf_weights`` (bf16-rounded params)."""
    jspec, spec = specs(index_topk)
    np_params, params = _params(jspec, spec, seed=4)
    want = jmla.params_to_hf_state_dict(np_params, jspec)
    family = get_family(spec)
    state = family.to_hf(params, spec)
    assert set(state) == set(want)
    for k, v in state.items():
        np.testing.assert_array_equal(_np(v), want[k], err_msg=k)
    if index_topk:
        assert "model.layers.1.self_attn.indexer.wq_b.weight" in state
    back = family.from_hf(state, spec)
    for (pa, a), (pb, b) in zip(toptim.tree_paths(params), toptim.tree_paths(back)):
        assert pa == pb and torch.equal(a, b), pa
    assert back["layers"]["router_correction_bias"].dtype == torch.float32

    save_hf_weights(params, spec, tmp_path / "snap")
    assert pathing.is_stable(tmp_path / "snap")
    assert get_spec(str(tmp_path / "snap")) == spec
    loaded = load_hf_weights(tmp_path / "snap", spec, dtype=torch.float32)
    for (pa, a), (_, b) in zip(toptim.tree_paths(params), toptim.tree_paths(loaded)):
        assert torch.equal(a.bfloat16().float(), b), pa
    arch = spec_to_hf_config(spec)["architectures"][0]
    assert arch == ("GlmMoeDsaForCausalLM" if index_topk else "DeepseekV3ForCausalLM")


def _model_cfg(cls):
    return cls(model={"attn": {"impl": "xla"}, "compute_dtype": "float32",
                      "lm_head_chunk_size": 48, "ac": {"mode": "full"}, "moe_aux_coef": 0.01},
               optimizer={"type": "sgd", "lr": 1e-2, "weight_decay": 0.1})


def test_train_step_matches_jax_step_one():
    """One fake batch through ``make_train_step`` on the DSA spec with a
    trained load-balance term: loss, grad_norm and every metric (rtol 1e-4),
    and the parameters after an sgd update with weight decay (atol 4e-5: lr 1e-2
    times one bf16 step, 4e-3, of a gradient that the clip holds below 1; both
    packages round the attention's cotangents to bf16. Adam's first update is
    sign-like and would turn such a step on a near-zero gradient into a
    difference of lr; its parity is tested on the dense family)."""
    jspec, spec = specs(8)
    np_params, params = _params(jspec, spec, seed=0)
    j_cfg, t_cfg = _model_cfg(JTrainerConfig), _model_cfg(TrainerConfig)
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
    t_state = tstep.init_train_state(spec, "cpu", t_opt, params=params)
    t_step = tstep.make_train_step(spec, t_cfg.model, t_cfg.loss, t_opt, "cpu")
    t_state, t_metrics = t_step(t_state, batch, tstep.Scales(scale, 1.0, 1.0))

    assert set(t_metrics) == set(j_metrics) and "moe_load_balance" in t_metrics
    for name in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(t_metrics[name]), float(j_metrics[name]), rtol=1e-4)
    for name, stat in t_metrics.items():
        if name not in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(stat.total), float(j_metrics[name].total),
                                       rtol=1e-4, atol=1e-5, err_msg=name)
            assert float(stat.count) == float(j_metrics[name].count), name
    j_flat = dict(toptim.tree_paths(jax.tree.map(np.asarray, j_state.params)))
    for path, t in toptim.tree_paths(t_state.params):
        np.testing.assert_allclose(_np(t), j_flat[path], atol=4e-5, rtol=0, err_msg=path)


def test_bf16_masters_and_8bit_adam_on_the_dense_layers_tree():
    """adamw_8bit with bf16 masters on a tree that has a ``dense_layers``
    stack: two steps are deterministic, every float leaf but the indexer's and
    the selection bias changes, and a leaf's update over several runs of blocks
    equals its update in one run bit for bit."""
    _, spec = specs(8)
    cfg = TrainerConfig(model={"attn": {"impl": "xla"}, "compute_dtype": "float32",
                               "lm_head_chunk_size": 48},
                        optimizer={"type": "adamw_8bit", "lr": 1e-3, "weight_decay": 0.0,
                                   "master_dtype": "bfloat16"})
    batch, counts = FakeDataLoader(spec.vocab_size, 32, 2, 1, seed=1).next_batch()

    def run():
        opt, _ = toptim.make_optimizer(cfg.optimizer, cfg.scheduler, 1.0)
        state = tstep.init_train_state(spec, "cpu", opt, seed=3, master_dtype="bfloat16")
        step = tstep.make_train_step(spec, cfg.model, cfg.loss, opt, "cpu")
        first = state
        for _ in range(2):
            state, metrics = step(state, batch, tstep.Scales(float(counts["rl"]), 1.0, 1.0))
        return first, state, float(metrics["loss"])

    first, a, loss_a = run()
    _, b, loss_b = run()
    assert loss_a == loss_b and np.isfinite(loss_a)
    for (path, x), (_, y), (_, z) in zip(toptim.tree_paths(a.params), toptim.tree_paths(b.params),
                                         toptim.tree_paths(first.params)):
        assert torch.equal(x, y), path
        frozen = "idx_" in path or "router_correction_bias" in path
        assert torch.equal(x, z) == frozen, path

    g = torch.from_numpy(np.random.default_rng(0).standard_normal(5000).astype(np.float32))
    opt = toptim.scale_by_adam_8bit(block=16)
    state = opt.init({"w": g})
    whole, _ = opt.update({"w": g}, state)
    old = toptim._LEAF_BLOCKS
    toptim._LEAF_BLOCKS = 7
    try:
        parts, _ = opt.update({"w": g}, state)
    finally:
        toptim._LEAF_BLOCKS = old
    assert torch.equal(whole["w"], parts["w"])


def _tiny_dir(tmp_path):
    _, spec = specs(8)
    model = tmp_path / "tiny_dsa"
    model.mkdir()
    (model / "config.json").write_text(json.dumps(spec_to_hf_config(spec)))
    return model, spec


def test_entrypoint_trains_a_tiny_dsa_directory(tmp_path, monkeypatch):
    """``entrypoints.trainer --device cpu --data.type fake --model.name <dir
    with a GlmMoeDsa config.json> --model.debug.random-init`` takes two
    steps, writes its records and a v2 snapshot that reads back through
    ``get_spec`` and ``load_hf_weights``; without ``--device cpu`` it raises
    where there is no card."""
    from prime_rl_tpu_torch.entrypoints import trainer as entry

    model, spec = _tiny_dir(tmp_path)
    assert get_spec(str(model)) == spec
    out = tmp_path / "out"
    args = ["--data.type", "fake", "--model.name", str(model), "--model.debug.random-init",
            "--max-steps", "2", "--data.seq-len", "64", "--batch.seq-len", "64",
            "--data.micro-batch-size", "2", "--data.num-micro-batches", "2",
            "--model.lm-head-chunk-size", "48", "--model.moe-aux-coef", "0.01",
            "--output-dir", str(out)]
    monkeypatch.setattr(sys, "argv", ["trainer", "--device", "cpu", *args])
    entry.main()
    records = [json.loads(l) for l in (out / "trainer.jsonl").read_text().splitlines()]
    assert len(records) == 2 and all(np.isfinite(r["loss"]) for r in records)
    snap = pathing.weights_dir(out, 2)
    assert pathing.is_stable(snap) and get_spec(str(snap)) == spec
    loaded = load_hf_weights(snap, spec, dtype=torch.float32)
    assert set(loaded) == {"dense_layers", "embed", "final_norm", "layers", "lm_head"}
    assert loaded["layers"]["expert_gate"].shape == (1, 8, 64, 48)
    if not torch.cuda.is_available():
        monkeypatch.setattr(sys, "argv", ["trainer", *args])
        with pytest.raises(RuntimeError, match="cuda|CUDA|card"):
            entry.main()

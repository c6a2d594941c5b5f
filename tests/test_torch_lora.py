"""LoRA in the port against the JAX package's (``prime_rl_tpu/models/lora.py``
and its threading through the forward, the train step and the trainers) on
the CPU, at the debug specs' size: the PEFT files both ways, ``merge_lora``
on every layout, the forward and the adapter gradients, the identity at
init, merge against runtime, the train step with a frozen base, SFT and RL
with the adapter exported. Adapters used for a check have B != 0: an
untrained adapter is the identity and would prove nothing. Tolerances are
stated where they are used."""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prime_rl_tpu.configs.shared import LoRAConfig as JLoRAConfig
from prime_rl_tpu.models import get_family as j_get_family
from prime_rl_tpu.models import lora as jlora
from prime_rl_tpu.models.base import get_spec as j_get_spec
from prime_rl_tpu_torch.configs.shared import LoRAConfig
from prime_rl_tpu_torch.models import get_family
from prime_rl_tpu_torch.models import lora as tlora
from prime_rl_tpu_torch.models.base import get_spec
from prime_rl_tpu_torch.models.qwen3 import params_from_jax

torch.set_num_threads(2)

RANK, ALPHA = 4, 8.0


def _np(t):
    return t.detach().float().numpy()


def np_adapter(jspec, cfg, seed: int, b_scale: float = 0.05) -> dict:
    """A numpy adapter in the JAX layout with A and B both drawn from
    ``seed`` (B != 0)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: jlora.init_lora(jspec, cfg, jax.random.key(0)))
    return {"layers": {k: (rng.standard_normal(v.shape) * (0.05 if k.endswith("_a")
                                                            else b_scale)).astype(np.float32)
                       for k, v in shapes["layers"].items()}}


def family_case(name: str, seed: int = 0, experts: bool = False, **cfg_kw):
    """(jspec, spec, JAX params as numpy, the port's params, LoRA configs of
    both packages) of a debug spec."""
    jspec, spec = j_get_spec(name), get_spec(name)
    np_params = jax.tree.map(np.asarray, j_get_family(jspec).init(jspec, jax.random.key(seed)))
    jcfg = JLoRAConfig(rank=RANK, alpha=ALPHA, experts=experts, **cfg_kw)
    tcfg = LoRAConfig(rank=RANK, alpha=ALPHA, experts=experts, **cfg_kw)
    return jspec, spec, np_params, params_from_jax(np_params, spec), jcfg, tcfg


def model_inputs(seed: int, vocab: int, b: int = 2, l: int = 32):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, vocab, (b, l)).astype(np.int32)
    seg = np.zeros((b, l), np.int32)
    pos = np.zeros((b, l), np.int32)
    seg[0, :20], seg[0, 20:29] = 1, 2
    pos[0, :20], pos[0, 20:29] = np.arange(20), np.arange(9)
    seg[1, :] = 1
    pos[1, :] = np.arange(l)
    return ids, seg, pos


# ---------------------------------------------------------------------------
# the adapter files and merge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,experts", [("debug", False), ("debug_moe", True)])
def test_peft_files_load_in_either_package(tmp_path, name, experts):
    """A PEFT file written by either package loads in the other with equal
    arrays (the dense targets, and the per-expert ``mlp.experts.{e}`` keys)."""
    from safetensors.numpy import load_file, save_file

    jspec, spec, _, _, jcfg, tcfg = family_case(name, experts=experts)
    ad = np_adapter(jspec, jcfg, 1)
    assert tlora.resolve_targets(tcfg, spec) == jlora.resolve_targets(jcfg, jspec)
    save_file(jlora.adapter_state_dict(ad, jspec, jcfg), str(tmp_path / "j.safetensors"))
    got = tlora.load_adapter_file(tmp_path / "j.safetensors", spec)
    assert set(got) == set(ad["layers"])
    for k, v in ad["layers"].items():
        np.testing.assert_array_equal(got[k], v)
    tlora.save_adapter(tlora.lora_from_jax(ad), spec, tmp_path / "t")
    back = jlora.adapter_from_state_dict(
        load_file(str(tmp_path / "t" / "adapter_model.safetensors")), jspec)
    assert set(back) == set(ad["layers"])
    for k, v in ad["layers"].items():
        np.testing.assert_array_equal(back[k], v)


@pytest.mark.parametrize("name,experts", [
    ("debug", False),  # layers
    ("debug_moe", True),  # layers with per-expert stacks
    ("debug_qwen3_next", False),  # attn_layers + lin_layers by the pattern
    ("debug_nemotron", True),  # attn_layers + moe_layers by the pattern
])
def test_merge_lora_matches_jax_on_every_layout(name, experts):
    """``merge_lora`` of the same base and adapter in both packages, every
    merged stack within 1e-6 (float32 sums of rank 4): the plain stack, the
    per-expert stacks and the hybrids' stacks picked by their patterns."""
    jspec, spec, np_params, params, jcfg, tcfg = family_case(name, experts=experts)
    ad = np_adapter(jspec, jcfg, 2)
    want = jlora.merge_lora(jax.tree.map(jnp.asarray, np_params), jax.tree.map(jnp.asarray, ad),
                            jcfg, spec=jspec)
    got = tlora.merge_lora(params, tlora.lora_from_jax(ad), tcfg, spec=spec)
    merged_any = False
    for stack, layers in got.items():
        if not isinstance(layers, dict):
            continue
        for key, t in layers.items():
            np.testing.assert_allclose(_np(t), np.asarray(want[stack][key]), atol=1e-6, rtol=1e-6)
            merged_any |= not np.array_equal(_np(t), np_params[stack][key])
    assert merged_any


def test_merge_lora_on_split_dense_and_moe_stacks():
    """The ``dense_layers`` + ``layers`` layout (GLM-4.5's dense first layers)
    takes the matching slices of the [NL, ...] adapter stacks, as in JAX."""
    jspec, spec = spec_pair("glm4_moe")
    np_params = jax.tree.map(np.asarray, j_get_family(jspec).init(jspec, jax.random.key(3)))
    assert "dense_layers" in np_params
    jcfg = JLoRAConfig(rank=RANK, alpha=ALPHA, experts=True)
    tcfg = LoRAConfig(rank=RANK, alpha=ALPHA, experts=True)
    ad = np_adapter(jspec, jcfg, 4)
    want = jlora.merge_lora(jax.tree.map(jnp.asarray, np_params), jax.tree.map(jnp.asarray, ad),
                            jcfg, spec=jspec)
    got = tlora.merge_lora(params_from_jax(np_params, spec), tlora.lora_from_jax(ad), tcfg,
                           spec=spec)
    for stack in ("dense_layers", "layers"):
        for key, t in got[stack].items():
            np.testing.assert_allclose(_np(t), np.asarray(want[stack][key]), atol=1e-6, rtol=1e-6)


# ---------------------------------------------------------------------------
# the forward and its gradients
# ---------------------------------------------------------------------------

def _forward_and_grads(fam_t, fam_j, jspec, spec, np_params, params, ad, jcfg, tcfg, ids, seg,
                       pos, ct, remat="none", **fkw):
    tl = tlora.lora_from_jax(ad)
    for t in tl["layers"].values():
        t.requires_grad_()
    out = fam_t.forward(params, spec, *map(torch.from_numpy, (ids, seg, pos)),
                        compute_dtype=torch.float32, remat=remat, lora=tl,
                        lora_scale=tlora.lora_scale(tcfg), **fkw)
    if isinstance(out, tuple):
        out = out[0]
    (out * torch.from_numpy(ct)).sum().backward()

    def j_loss(lora):
        h = fam_j.forward(jax.tree.map(jnp.asarray, np_params), jspec, jnp.asarray(ids),
                          jnp.asarray(seg), jnp.asarray(pos), compute_dtype=jnp.float32,
                          attn_impl="xla", remat="none", lora=lora,
                          lora_scale=jlora.lora_scale(jcfg), **fkw)
        if isinstance(h, tuple):
            h = h[0]
        return jnp.sum(h * ct), h

    (_, want), jgrads = jax.jit(jax.value_and_grad(j_loss, has_aux=True))(
        jax.tree.map(jnp.asarray, ad))
    return out, want, {k: t.grad for k, t in tl["layers"].items()}, jgrads["layers"]


@pytest.mark.parametrize("name,remat", [("debug", "none"), ("debug", "save_attn")])
def test_forward_and_adapter_gradients_match_jax(name, remat):
    """The final hidden states with a two-target-family adapter on all seven
    projections and its gradients against ``jax.grad`` through the JAX
    forward, float32, atol = rtol = 1e-4 (the gradients of A sum over every
    token), on the rows that are not padding."""
    jspec, spec, np_params, params, jcfg, tcfg = family_case(name)
    ad = np_adapter(jspec, jcfg, 5)
    ids, seg, pos = model_inputs(6, spec.vocab_size)
    ct = np.random.default_rng(7).standard_normal((*ids.shape, spec.hidden_size)).astype(
        np.float32) * (seg != 0)[..., None]
    out, want, grads, jgrads = _forward_and_grads(
        get_family(spec), j_get_family(jspec), jspec, spec, np_params, params, ad, jcfg, tcfg,
        ids, seg, pos, ct, remat=remat)
    valid = seg != 0
    np.testing.assert_allclose(_np(out)[valid], np.asarray(want)[valid], atol=1e-4, rtol=1e-4)
    assert set(grads) == set(jgrads)
    for k, g in grads.items():
        np.testing.assert_allclose(_np(g), np.asarray(jgrads[k]), atol=1e-4, rtol=1e-4,
                                   err_msg=k)


GLM_KW = dict(num_layers=3, family="glm4_moe", num_experts=4, num_experts_per_tok=2,
              moe_intermediate_size=64, n_shared_experts=1, first_k_dense_replace=1,
              router_sigmoid=True, partial_rotary_factor=0.5, qk_norm=False)
GPT_OSS_KW = dict(
    family="gpt_oss", vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
    num_kv_heads=2, head_dim=16, intermediate_size=48, rope_theta=150000.0, rms_eps=1e-5,
    tie_embeddings=False, qk_norm=False, max_position_embeddings=512, eos_token_id=255,
    pad_token_id=0, num_experts=4, num_experts_per_tok=2, moe_intermediate_size=48,
    sliding_window=8, sliding_window_pattern=2, attn_sinks=True, attn_bias=True,
    swiglu_alpha=1.702, swiglu_limit=7.0, expert_bias=True, router_bias=True,
    router_softmax_topk=True)
DSA_KW = dict(
    family="glm_moe_dsa", vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
    num_kv_heads=4, head_dim=32, intermediate_size=128, moe_intermediate_size=48,
    num_experts=8, num_experts_per_tok=2, n_shared_experts=1, first_k_dense_replace=1,
    router_sigmoid=True, routed_scaling_factor=1.0, q_lora_rank=48, kv_lora_rank=32,
    qk_rope_head_dim=8, qk_nope_head_dim=24, v_head_dim=16, index_n_heads=4,
    index_head_dim=16, index_topk=16, rope_interleave=True, tie_embeddings=False,
    qk_norm=False, eos_token_id=255, pad_token_id=0)


def spec_pair(case: str):
    """Both packages' specs of a family case: a built-in debug spec by name,
    or the kwargs of the families' own test files."""
    from prime_rl_tpu.models.base import ModelSpec as JModelSpec
    from prime_rl_tpu.models.base import debug_spec as j_debug_spec
    from prime_rl_tpu_torch.models.base import ModelSpec, debug_spec

    if case == "glm4_moe":
        return j_debug_spec(**GLM_KW), debug_spec(**GLM_KW)
    if case in ("gpt_oss", "glm_moe_dsa", "deepseek_v3"):
        kw = {"gpt_oss": GPT_OSS_KW, "glm_moe_dsa": DSA_KW}.get(case) or dict(
            DSA_KW, family="deepseek_v3", index_topk=0, index_n_heads=0, index_head_dim=0)
        return JModelSpec(**kw), ModelSpec(**kw)
    return j_get_spec(case), get_spec(case)


@pytest.mark.parametrize("case", ["debug_moe", "glm4_moe", "debug_minimax", "debug_afmoe",
                                  "debug_laguna", "gpt_oss", "glm_moe_dsa", "deepseek_v3",
                                  "debug_qwen3_next", "debug_nemotron"])
def test_every_family_forward_and_adapter_gradients_match_jax(case):
    """Each family the port's LoRA reaches, with every target of the default
    config and the per-expert targets on (``experts``; MLA maps the attention
    targets onto q_b, kv_b, kv_a and o; Nemotron-H's latent experts have no
    gate): the final hidden states and the adapter gradients against the
    JAX forward and ``jax.grad``, float32: the states at atol = rtol = 2e-4
    on the rows that are not padding, each gradient at rtol 2e-4 and atol
    1e-5 of its largest magnitude (they sum over every token; routed experts
    computed in the same precision), the MLA families' at 4e-3 of it."""
    jspec, spec = spec_pair(case)
    np_params = jax.tree.map(np.asarray, j_get_family(jspec).init(jspec, jax.random.key(0)))
    if spec.kv_lora_rank:
        from prime_rl_tpu_torch.models.mla_moe import params_from_jax as mla_from_jax

        params = mla_from_jax(np_params, spec)
    else:
        params = params_from_jax(np_params, spec)
    jcfg = JLoRAConfig(rank=RANK, alpha=ALPHA, experts=True)
    tcfg = LoRAConfig(rank=RANK, alpha=ALPHA, experts=True)
    assert tlora.resolve_targets(tcfg, spec) == jlora.resolve_targets(jcfg, jspec)
    ad = np_adapter(jspec, jcfg, 9)
    ids, seg, pos = model_inputs(10, spec.vocab_size)
    ct = np.random.default_rng(11).standard_normal((*ids.shape, spec.hidden_size)).astype(
        np.float32) * (seg != 0)[..., None]
    out, want, grads, jgrads = _forward_and_grads(
        get_family(spec), j_get_family(jspec), jspec, spec, np_params, params, ad, jcfg, tcfg,
        ids, seg, pos, ct)
    valid = seg != 0
    np.testing.assert_allclose(_np(out)[valid], np.asarray(want)[valid], atol=2e-4, rtol=2e-4)
    assert set(grads) == set(jgrads)
    # the MLA families: tests/test_torch_mla_moe.py's gradient tolerance (4e-3
    # of the largest magnitude), whose DSA scores take bfloat16 operands
    rel = 4e-3 if spec.kv_lora_rank else 1e-5
    for k, g in grads.items():
        w = np.asarray(jgrads[k])
        np.testing.assert_allclose(_np(g), w, atol=rel * float(np.abs(w).max()),
                                   rtol=max(rel, 2e-4), err_msg=k)
        if k.endswith("_a") and not k.startswith("moe_"):
            assert float(g.abs().max()) > 0, k


@pytest.mark.parametrize("name", ["debug"])
def test_identity_at_init_and_merge_equals_runtime(name):
    """B = 0 at init: the forward with the adapter is the base's, bit for
    bit, and so is the merge. With B != 0 the merged weights' forward equals
    the adapter's within 1e-4 (float32)."""
    _, spec, _, params, _, tcfg = family_case(name)
    fam = get_family(spec)
    ids, seg, pos = map(torch.from_numpy, model_inputs(8, spec.vocab_size))
    kw = dict(compute_dtype=torch.float32, remat="none")
    lora0 = tlora.init_lora(spec, tcfg, torch.Generator().manual_seed(1))
    assert all(float(v.abs().max()) == 0 for k, v in lora0["layers"].items() if k.endswith("_b"))
    h0 = fam.forward(params, spec, ids, seg, pos, **kw)
    h1 = fam.forward(params, spec, ids, seg, pos, lora=lora0,
                     lora_scale=tlora.lora_scale(tcfg), **kw)
    assert torch.equal(h0, h1)
    merged0 = tlora.merge_lora(params, lora0, tcfg, spec=spec)
    for k, v in params["layers"].items():
        assert torch.equal(merged0["layers"][k], v), k
    lora = {"layers": {k: (v + 0.03 if k.endswith("_b") else v)
                       for k, v in lora0["layers"].items()}}
    h2 = fam.forward(params, spec, ids, seg, pos, lora=lora,
                     lora_scale=tlora.lora_scale(tcfg), **kw)
    assert float((h2 - h0).abs().max()) > 1e-3
    h3 = fam.forward(tlora.merge_lora(params, lora, tcfg, spec=spec), spec, ids, seg, pos, **kw)
    valid = seg != 0
    np.testing.assert_allclose(_np(h3)[valid], _np(h2)[valid], atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# the train step and the trainers
# ---------------------------------------------------------------------------

def _trainer_cfg(**lora):
    from prime_rl_tpu_torch.configs.trainer import TrainerConfig

    cfg = TrainerConfig()
    cfg.model.attn.impl = "xla"
    cfg.model.lm_head_chunk_size = 0
    cfg.model.compute_dtype = "float32"
    cfg.model.ac.mode = "none"
    cfg.model.lora = LoRAConfig(rank=RANK, alpha=ALPHA, **lora)
    return cfg


def test_train_step_updates_the_adapters_only():
    """Four steps of the LoRA train step: finite losses, the adapters' B
    moved from zero, the frozen base bit-equal, no gradient on it."""
    from prime_rl_tpu_torch.configs.shared import AdamWConfig
    from prime_rl_tpu_torch.trainer.optim import make_optimizer, tree_leaves
    from prime_rl_tpu_torch.trainer.rl.data import FakeDataLoader
    from prime_rl_tpu_torch.trainer.step import (
        Scales,
        init_base_params,
        init_lora_train_state,
        make_train_step,
    )

    spec = get_spec("debug", num_layers=2)
    cfg = _trainer_cfg()
    opt, _ = make_optimizer(AdamWConfig(lr=1e-2), cfg.scheduler, 1.0)
    base = init_base_params(spec, "cpu", seed=0, dtype=torch.float32)
    before = [t.clone() for t in tree_leaves(base)]
    state = init_lora_train_state(spec, cfg.model.lora, "cpu", opt, seed=0)
    step = make_train_step(spec, cfg.model, cfg.loss, opt, "cpu", base_params=base)
    loader = FakeDataLoader(spec.vocab_size, 64, 2, 2, seed=4)
    losses = []
    for _ in range(4):
        batch, counts = loader.next_batch()
        state, metrics = step(state, batch, Scales(float(max(counts["rl"], 1)), 1.0, 1.0))
        losses.append(float(metrics["loss"]))
    assert np.isfinite(losses).all()
    assert set(state.params) == {"layers"}
    assert float(state.params["layers"]["q_b"].abs().sum()) > 0
    for t, b in zip(tree_leaves(base), before):
        assert torch.equal(t, b) and t.grad is None and not t.requires_grad


def _jsonl(path):
    return [json.loads(line) for line in open(path)]


def test_sft_with_lora_trains_and_exports(tmp_path):
    """SFT with ``model.lora`` on fake data: four finite losses, merged
    snapshots and the standalone adapter beside them, which loads back with
    every configured target stacked per layer (the JAX ``test_sft_lora``)."""
    from prime_rl_tpu_torch.configs.trainer import SFTConfig
    from prime_rl_tpu_torch.trainer.sft.train import train

    cfg = SFTConfig(
        output_dir=str(tmp_path), max_steps=4, device="cpu",
        model={"name": "debug", "lm_head_chunk_size": 0, "attn": {"impl": "xla"},
               "debug": {"random_init": True, "num_layers": 2},
               "lora": {"rank": RANK, "alpha": ALPHA}},
        data={"type": "fake", "seq_len": 64, "batch_size": 4, "micro_batch_size": 2},
        weight_ckpt={"interval": 2}, ckpt={"interval": 1000},
    )
    result = train(cfg)
    losses = [r["loss"] for r in result.records]
    assert len(losses) == 4 and np.isfinite(losses).all()
    snaps = sorted(tmp_path.glob("weights/step_*"))
    assert snaps and snaps[-1].name == "step_4"
    spec = get_spec("debug", num_layers=2)
    ad = tlora.load_adapter_file(snaps[-1] / "adapter", spec)
    assert set(ad) == {f"{t}_{x}" for t in ("q", "k", "v", "o", "gate", "up", "down")
                       for x in "ab"}
    assert ad["q_a"].shape == (2, spec.hidden_size, RANK)
    assert float(np.abs(ad["down_b"]).sum()) > 0
    np.testing.assert_array_equal(ad["q_b"], _np(result.state.params["layers"]["q_b"]))


def test_rl_trainer_with_lora_publishes_merges_and_adapters(tmp_path):
    """The RL trainer with ``model.lora`` on fake data: the state is the
    adapter tree, every snapshot holds the merge of the frozen base and the
    adapter, and its ``adapter/`` file the adapter of that step."""
    from prime_rl_tpu_torch.configs.trainer import TrainerConfig
    from prime_rl_tpu_torch.models.qwen3 import load_hf_weights
    from prime_rl_tpu_torch.trainer.rl.train import train
    from prime_rl_tpu_torch.trainer.step import init_base_params

    cfg = TrainerConfig(
        output_dir=str(tmp_path), max_steps=2, device="cpu",
        model={"name": "debug", "lm_head_chunk_size": 0, "attn": {"impl": "xla"},
               "compute_dtype": "float32",
               "debug": {"random_init": True, "num_layers": 2},
               "lora": {"rank": RANK, "alpha": ALPHA}},
        data={"type": "fake", "seq_len": 64, "micro_batch_size": 2, "num_micro_batches": 1},
        batch={"seq_len": 64}, ckpt={"interval": 1000},
    )
    result = train(cfg)
    assert set(result.state.params) == {"layers"}
    spec = get_spec("debug", num_layers=2)
    snap = tmp_path / "weights" / "step_2"
    ad = tlora.load_adapter_file(snap / "adapter", spec)
    np.testing.assert_array_equal(ad["v_b"], _np(result.state.params["layers"]["v_b"]))
    served = load_hf_weights(snap, spec, dtype=torch.float32)
    # the trainer's frozen base: the random init of its seed
    base = init_base_params(spec, "cpu", seed=cfg.seed, dtype=torch.float32)
    lora = tlora.lora_from_jax({"layers": ad})
    want = tlora.merge_lora(base, lora, cfg.model.lora, spec=spec)
    for k in ("q", "down"):
        # the snapshot is bfloat16: the merge within its rounding (2^-8)
        np.testing.assert_allclose(_np(served["layers"][k]), _np(want["layers"][k]),
                                   atol=1e-3, rtol=8e-3)
        assert not torch.equal(want["layers"][k], base["layers"][k])

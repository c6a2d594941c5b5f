"""The training slice's ops on the CPU against the JAX package: the flash
attention backward (K2a/K2b through their plain PyTorch version, against the
JAX Pallas kernels run in interpret mode as the JAX tests run them), the
chunked LM head, the training forward under every remat mode, and every RL
loss. Inputs come from a numpy seed and go to both packages; everything runs
in float32.

Tolerances are stated per test: 2e-4 for the attention gradients (the Pallas
kernels accumulate block by block, the plain version in one sum), 2e-5 for
the element-wise ops, 1e-4 for whole-model gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prime_rl_tpu.configs.trainer import DefaultLossConfig as JDefault
from prime_rl_tpu.configs.trainer import IPOLossConfig as JIPO
from prime_rl_tpu.configs.trainer import RatioLossConfig as JRatio
from prime_rl_tpu.models import qwen3 as jqwen3
from prime_rl_tpu.models.base import debug_spec as j_debug_spec
from prime_rl_tpu.ops.flash_attention import flash_attention as j_flash
from prime_rl_tpu.ops.flash_attention import flash_attention_with_lse as j_flash_lse
from prime_rl_tpu.ops.lm_head import chunked_logprob_entropy as j_chunked
from prime_rl_tpu.ops.lm_head import lm_head_logits as j_logits
from prime_rl_tpu.trainer.rl import loss as jloss
from prime_rl_tpu_torch.configs.trainer import DefaultLossConfig, IPOLossConfig, RatioLossConfig
from prime_rl_tpu_torch.models import get_family
from prime_rl_tpu_torch.models import qwen3 as tqwen3
from prime_rl_tpu_torch.models import qwen3_next as tnext
from prime_rl_tpu_torch.models.base import debug_spec
from prime_rl_tpu_torch.ops import attention as tattn
from prime_rl_tpu_torch.ops import flash_attention as tflash
from prime_rl_tpu_torch.ops.lm_head import chunked_logprob_entropy, lm_head_logits
from prime_rl_tpu_torch.trainer.rl import loss as tloss

torch.set_num_threads(1)


def _np(t):
    return t.detach().numpy()


def _leaves(*arrays):
    return [torch.from_numpy(np.array(a)).requires_grad_() for a in arrays]


# ---------------------------------------------------------------------------
# flash attention backward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nkv,seq_lens", [
    (2, [[20, 25, 9], [37]]),  # GQA 2:1, several segments, padded tails
    (4, [[20, 25, 9], [37]]),  # 1:1
    (2, [[64], []]),  # a full row and an all-padding row
])
def test_flash_backward_matches_jax_pallas(nkv, seq_lens):
    """dq, dk, dv of the plain backward against jax.grad through the Pallas
    kernels (interpret mode, block_q = block_kv = 8), f32, rtol = atol = 2e-4.
    Padding rows carry a non-zero cotangent and must give finite, zero dq."""
    rng = np.random.default_rng(0)
    b, l, nh, hd = 2, 64, 4, 16
    q = rng.standard_normal((b, l, nh, hd)).astype(np.float32)
    k = rng.standard_normal((b, l, nkv, hd)).astype(np.float32)
    v = rng.standard_normal((b, l, nkv, hd)).astype(np.float32)
    do = rng.standard_normal((b, l, nh, hd)).astype(np.float32)
    seg = np.stack([tattn.make_segment_ids(lens, l) for lens in seq_lens])

    tq, tk, tv = _leaves(q, k, v)
    out = tflash.flash_attention(tq, tk, tv, torch.from_numpy(seg))
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))

    def j_loss(q, k, v):
        return jnp.sum(j_flash(q, k, v, jnp.asarray(seg), block_q=8, block_kv=8) * do)

    want = jax.grad(j_loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    for g, w in zip(got, want):
        assert np.isfinite(_np(g)).all()
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=2e-4, atol=2e-4)
    assert float(got[0][torch.from_numpy(seg) == 0].abs().max()) == 0.0


def test_flash_backward_matches_jax_pallas_at_head_dim_256():
    """Qwen3-Next's attention shape, head dim 256 at GQA group 8: dq, dk, dv
    of the plain backward against jax.grad through the Pallas kernels
    (interpret mode, block_q = block_kv = 8) over packed segments and a
    padded tail, f32, rtol = atol = 2e-5."""
    rng = np.random.default_rng(9)
    b, l, nh, nkv, hd = 1, 48, 8, 1, 256
    q = rng.standard_normal((b, l, nh, hd)).astype(np.float32)
    k = rng.standard_normal((b, l, nkv, hd)).astype(np.float32)
    v = rng.standard_normal((b, l, nkv, hd)).astype(np.float32)
    do = rng.standard_normal((b, l, nh, hd)).astype(np.float32)
    seg = tattn.make_segment_ids([20, 17], l)[None]

    tq, tk, tv = _leaves(q, k, v)
    out = tflash.flash_attention(tq, tk, tv, torch.from_numpy(seg))
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))

    def j_loss(q, k, v):
        return jnp.sum(j_flash(q, k, v, jnp.asarray(seg), block_q=8, block_kv=8) * do)

    want = jax.grad(j_loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=2e-5, atol=2e-5)
    assert float(got[0][torch.from_numpy(seg) == 0].abs().max()) == 0.0


def test_flash_backward_cross_block_with_lse_cotangent_matches_jax():
    """Lq != Lkv, non-causal, cotangents of both out and lse (what a ring
    merge sends back), rtol = atol = 2e-4."""
    rng = np.random.default_rng(1)
    b, lq, lk, nh, nkv, hd = 2, 16, 32, 4, 2, 16
    q = rng.standard_normal((b, lq, nh, hd)).astype(np.float32)
    k = rng.standard_normal((b, lk, nkv, hd)).astype(np.float32)
    v = rng.standard_normal((b, lk, nkv, hd)).astype(np.float32)
    do = rng.standard_normal((b, lq, nh, hd)).astype(np.float32)
    dlse = rng.standard_normal((b, nh, lq)).astype(np.float32)
    seg_q, seg_kv = np.ones((b, lq), np.int32), np.ones((b, lk), np.int32)
    seg_q[1, 12:], seg_kv[1, 20:] = 0, 0
    seg_kv[0, 24:] = 2  # keys of another segment: invisible to every query

    tq, tk, tv = _leaves(q, k, v)
    out, lse = tflash.flash_attention_with_lse(tq, tk, tv, torch.from_numpy(seg_q),
                                               torch.from_numpy(seg_kv), causal=False)
    # rows without a key have lse -1e30 in both packages: keep them out of the sum
    t_dlse = torch.from_numpy(dlse) * (lse.detach() > -1e29)
    got = torch.autograd.grad([out, lse], (tq, tk, tv), [torch.from_numpy(do), t_dlse])

    def j_loss(q, k, v):
        o, s = j_flash_lse(q, k, v, jnp.asarray(seg_q), jnp.asarray(seg_kv), causal=False,
                           block_q=8, block_kv=8)
        return jnp.sum(o * do) + jnp.sum(jnp.where(s > -1e29, s, 0.0) * dlse)

    want = jax.grad(j_loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=2e-4, atol=2e-4)


def test_flash_backward_only_lse_cotangent():
    """A graph that uses only lse still differentiates (do is absent)."""
    rng = np.random.default_rng(2)
    q, k, v = _leaves(*(rng.standard_normal((1, 16, 2, 16)).astype(np.float32)
                        for _ in range(3)))
    seg = torch.ones(1, 16, dtype=torch.int32)
    _, lse = tflash.flash_attention_with_lse(q, k, v, seg, seg, causal=True)
    got = torch.autograd.grad(lse.sum(), (q, k, v))

    def j_loss(q, k, v):
        return jnp.sum(j_flash_lse(q, k, v, jnp.ones((1, 16), jnp.int32),
                                   jnp.ones((1, 16), jnp.int32), causal=True,
                                   block_q=8, block_kv=8)[1])

    want = jax.grad(j_loss, argnums=(0, 1, 2))(*(jnp.asarray(_np(t)) for t in (q, k, v)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=2e-4, atol=2e-4)


def test_attention_dispatch_is_differentiable_on_both_routes():
    """attention() on the CPU: ``auto`` is einsum attention under PyTorch's
    autograd, ``pallas`` the flash Function with the plain backward; on rows
    that see a key both give the same gradients (atol = rtol = 2e-5)."""
    rng = np.random.default_rng(3)
    b, l, nh, nkv, hd = 1, 32, 4, 2, 16
    arrs = [rng.standard_normal((b, l, n, hd)).astype(np.float32) for n in (nh, nkv, nkv)]
    seg = torch.from_numpy(tattn.make_segment_ids([20, 12], l))[None]
    do = torch.from_numpy(rng.standard_normal((b, l, nh, hd)).astype(np.float32))
    grads = {}
    for impl in ("auto", "pallas", "xla"):
        leaves = _leaves(*arrs)
        out = tattn.attention(*leaves, seg, impl=impl)
        grads[impl] = torch.autograd.grad(out, leaves, do)
    for a, c in zip(grads["auto"], grads["pallas"]):
        np.testing.assert_allclose(_np(a), _np(c), rtol=2e-5, atol=2e-5)
    for a, c in zip(grads["auto"], grads["xla"]):
        assert torch.equal(a, c)
    with pytest.raises(ValueError):
        tattn.attention(*_leaves(*arrs), seg, impl="cudnn")


# ---------------------------------------------------------------------------
# LM head
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk,softcap,with_temps", [
    (0, 0.0, False),  # one chunk
    (16, 0.0, True),  # even chunks, temperatures (one of them 0)
    (20, 0.0, True),  # ragged last chunk
    (20, 5.0, True),  # softcap before temperature
])
def test_chunked_logprob_entropy_matches_jax(chunk, softcap, with_temps):
    """Values and d hidden, d lm_head against JAX; atol = rtol = 2e-5."""
    rng = np.random.default_rng(4)
    b, l, d, vocab = 2, 24, 32, 96
    hidden = rng.standard_normal((b, l, d)).astype(np.float32)
    w = (rng.standard_normal((d, vocab)) * 0.3).astype(np.float32)
    labels = rng.integers(0, vocab, (b, l)).astype(np.int32)
    temps = rng.uniform(0.5, 1.5, (b, l)).astype(np.float32)
    temps[0, 3] = 0.0
    ct = rng.standard_normal((b, l)).astype(np.float32)

    th, tw = _leaves(hidden, w)
    lp, ent = chunked_logprob_entropy(th, tw, torch.from_numpy(labels),
                                      torch.from_numpy(temps) if with_temps else None,
                                      chunk_size=chunk, softcap=softcap)
    assert not ent.requires_grad  # entropy is a monitoring stat
    gh, gw = torch.autograd.grad(lp, (th, tw), torch.from_numpy(ct))

    def j_fn(h, w):
        return j_chunked(h, w, jnp.asarray(labels), jnp.asarray(temps) if with_temps else None,
                         chunk_size=chunk, softcap=softcap)

    j_lp, j_ent = j_fn(jnp.asarray(hidden), jnp.asarray(w))
    j_gh, j_gw = jax.grad(lambda h, w: jnp.sum(j_fn(h, w)[0] * ct), argnums=(0, 1))(
        jnp.asarray(hidden), jnp.asarray(w))
    tol = dict(rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(_np(lp), np.asarray(j_lp), **tol)
    np.testing.assert_allclose(_np(ent), np.asarray(j_ent), **tol)
    np.testing.assert_allclose(_np(gh), np.asarray(j_gh), **tol)
    np.testing.assert_allclose(_np(gw), np.asarray(j_gw), rtol=2e-5, atol=1e-4)


def test_lm_head_logits_matches_jax():
    rng = np.random.default_rng(5)
    h = rng.standard_normal((3, 32)).astype(np.float32)
    w = rng.standard_normal((32, 50)).astype(np.float32)
    got = lm_head_logits(torch.from_numpy(h), torch.from_numpy(w))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), np.asarray(j_logits(jnp.asarray(h), jnp.asarray(w))),
                               rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# training forward
# ---------------------------------------------------------------------------

def _model_inputs(rng, spec, b=2, l=64):
    ids = rng.integers(0, spec.vocab_size, (b, l)).astype(np.int32)
    seg = np.stack([tattn.make_segment_ids([30, 20], l), tattn.make_segment_ids([64], l)])
    pos = np.stack([tattn.make_position_ids([30, 20], l), tattn.make_position_ids([64], l)])
    return ids, seg.astype(np.int32), pos.astype(np.int32)


def _jax_params(jspec, seed=0):
    params = jqwen3.init_params(jspec, jax.random.key(seed))
    return params, jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("family,kw", [("qwen3", {}), ("llama", {"qk_norm": False}),
                                       ("qwen3", {"attn_bias": True})])
def test_forward_matches_jax(family, kw):
    """Final hidden states of the 2-layer debug model, f32, atol = rtol = 2e-5
    on rows that are not padding."""
    rng = np.random.default_rng(6)
    jspec, spec = j_debug_spec(family=family, **kw), debug_spec(family=family, **kw)
    jparams, np_params = _jax_params(jspec)
    if kw.get("attn_bias"):
        for name in ("q_bias", "k_bias", "v_bias", "o_bias"):
            np_params["layers"][name] = rng.standard_normal(
                np_params["layers"][name].shape).astype(np.float32) * 0.1
        jparams = jax.tree.map(jnp.asarray, np_params)
    ids, seg, pos = _model_inputs(rng, spec)
    want = jqwen3.forward(jparams, jspec, jnp.asarray(ids), jnp.asarray(seg), jnp.asarray(pos),
                          compute_dtype=jnp.float32, attn_impl="xla", remat="none")
    params = tqwen3.params_from_jax(np_params, spec)
    got = get_family(spec).forward(params, spec, *map(torch.from_numpy, (ids, seg, pos)),
                                   compute_dtype=torch.float32, remat="none")
    valid = seg != 0
    np.testing.assert_allclose(_np(got)[valid], np.asarray(want)[valid], rtol=2e-5, atol=2e-5)


def _torch_grads(params, spec, inputs, ct, **kw):
    leaves = tqwen3.params_from_jax(params, spec)
    flat = []

    def req(tree):
        for key, val in tree.items():
            if isinstance(val, dict):
                req(val)
            else:
                tree[key] = val.requires_grad_()
                flat.append((key, tree[key]))

    req(leaves)
    out = tqwen3.forward(leaves, spec, *inputs, compute_dtype=torch.float32, **kw)
    (out * ct).sum().backward()
    return {k: t.grad for k, t in flat}


@pytest.mark.parametrize("impl", ["auto", "pallas"])
def test_forward_gradients_identical_under_every_remat_mode(impl, monkeypatch):
    """Every remat mode (none, full, save_attn, offload_attn, selective,
    offload_dots, and the stride form) gives bit-identical gradients, the
    ``none`` ones match JAX (atol = rtol = 1e-4), and on the flash route
    save_attn and offload_attn run the attention forward once per layer where
    full, selective and offload_dots (which recompute the kernel, as the JAX
    policies recompute a Pallas call) run it twice."""
    rng = np.random.default_rng(7)
    jspec, spec = j_debug_spec(), debug_spec()
    jparams, np_params = _jax_params(jspec)
    ids, seg, pos = _model_inputs(rng, spec)
    inputs = tuple(map(torch.from_numpy, (ids, seg, pos)))
    valid = torch.from_numpy(seg != 0)[..., None]
    ct = torch.from_numpy(rng.standard_normal((2, 64, spec.hidden_size)).astype(np.float32))
    ct = ct * valid  # padding rows differ between the routes by construction

    calls = {"n": 0}
    plain_fwd = tflash.flash_attention_reference

    def counting(*a, **k):
        calls["n"] += 1
        return plain_fwd(*a, **k)

    monkeypatch.setattr(tflash, "flash_attention_reference", counting)
    grads, fwd_calls = {}, {}
    modes = ("none", "full", "save_attn", "save_attn/2", "offload_attn", "offload_attn/2",
             "selective", "offload_dots/2")
    for mode in modes:
        calls["n"] = 0
        grads[mode] = _torch_grads(np_params, spec, inputs, ct, remat=mode, attn_impl=impl)
        fwd_calls[mode] = calls["n"]
    for mode in modes[1:]:
        for name, g in grads["none"].items():
            assert torch.equal(g, grads[mode][name]), (mode, name)
    if impl == "pallas":
        nl = spec.num_layers
        assert fwd_calls == {"none": nl, "full": 2 * nl, "save_attn": nl,
                             "save_attn/2": nl + nl // 2, "offload_attn": nl,
                             "offload_attn/2": nl + nl // 2, "selective": 2 * nl,
                             "offload_dots/2": 2 * nl}

    def j_loss(p):
        out = jqwen3.forward(p, jspec, jnp.asarray(ids), jnp.asarray(seg), jnp.asarray(pos),
                             compute_dtype=jnp.float32, attn_impl="xla", remat="none")
        return jnp.sum(out * _np(ct))

    want = jax.grad(j_loss)(jparams)
    flat_want = {**{k: v for k, v in want.items() if k != "layers"}, **want["layers"]}
    for name, g in grads["none"].items():
        np.testing.assert_allclose(_np(g), np.asarray(flat_want[name]), rtol=1e-4, atol=1e-4)


def test_forward_rejects_what_waits_for_later_slices():
    spec = debug_spec()
    params = tqwen3.init_params(spec, torch.Generator().manual_seed(0))
    ids = torch.zeros(1, 8, dtype=torch.int64)
    seg = torch.ones(1, 8, dtype=torch.int32)
    with pytest.raises(NotImplementedError):
        tqwen3.forward(params, spec, ids, seg, ids, mesh=object())
    # int8 compute runs since its slice (held against JAX in
    # tests/test_torch_int8_linear.py)
    assert tqwen3.forward(params, spec, ids, seg, ids,
                          quantized_compute="int8").shape == (1, 8, spec.hidden_size)
    # the offload and selective remat modes run since their slice (the
    # gradients: test_forward_gradients_identical_under_every_remat_mode);
    # a name no JAX family knows raises
    for mode in ("offload_attn", "offload_dots", "selective"):
        assert tqwen3.forward(params, spec, ids, seg, ids, remat=mode).shape == (1, 8, 64)
    with pytest.raises(ValueError, match="unknown ac.mode"):
        tqwen3.forward(params, spec, ids, seg, ids, remat="offload_everything")
    # LoRA runs since its slice (held against JAX in tests/test_torch_lora.py)
    from prime_rl_tpu_torch.configs.shared import LoRAConfig
    from prime_rl_tpu_torch.models.lora import init_lora

    lora = init_lora(spec, LoRAConfig(rank=2), torch.Generator().manual_seed(1))
    out = tqwen3.forward(params, spec, ids, seg, ids, lora=lora, lora_scale=2.0)
    assert out.shape == (1, 8, spec.hidden_size)
    # the VLM families resolve, the hybrid VLM too (held against JAX in
    # tests/test_torch_qwen3_next_vl.py)
    assert get_family(debug_spec(family="qwen3_vl")).init.__module__.endswith("qwen3_vl")
    assert get_family(debug_spec(family="qwen3_next_vl")).forward is tnext.forward


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def _loss_streams(rng, b=2, l=32):
    trainer = rng.normal(-1.5, 0.6, (b, l)).astype(np.float32)
    infer = (trainer + rng.normal(0, 0.3, (b, l))).astype(np.float32)
    ref = (trainer + rng.normal(0, 0.3, (b, l))).astype(np.float32)
    adv = rng.standard_normal((b, l)).astype(np.float32)
    adv[0, :4] = 0.0
    mask = rng.random((b, l)) < 0.7
    weights = rng.choice([0.0, 0.5, 1.0], (b, l)).astype(np.float32)
    return trainer, infer, ref, adv, mask, weights


def _check_loss(t_out, j_out, t_leaf, j_grad):
    """Value, every metric's (sum, count) and the gradient; atol = rtol = 2e-5."""
    tol = dict(rtol=2e-5, atol=2e-5)
    (t_val, t_metrics), (j_val, j_metrics) = t_out, j_out
    np.testing.assert_allclose(_np(t_val), np.asarray(j_val), **tol)
    assert set(t_metrics) == set(j_metrics)
    for name, stat in t_metrics.items():
        np.testing.assert_allclose(_np(stat.total), np.asarray(j_metrics[name].total), **tol)
        np.testing.assert_allclose(_np(stat.count), np.asarray(j_metrics[name].count), **tol)
        np.testing.assert_allclose(_np(stat.mean), np.asarray(j_metrics[name].mean), **tol)
    (grad,) = torch.autograd.grad(t_val, t_leaf)
    np.testing.assert_allclose(_np(grad), np.asarray(j_grad), **tol)


@pytest.mark.parametrize("name,tcfg,jcfg,weighted", [
    ("default", DefaultLossConfig(dppo_mask_high=0.1, dppo_mask_low=0.1),
     JDefault(dppo_mask_high=0.1, dppo_mask_low=0.1), False),
    ("default", DefaultLossConfig(adv_tau=0.5, kl_tau=2.0), JDefault(adv_tau=0.5, kl_tau=2.0),
     True),
    ("ipo", IPOLossConfig(ipo_threshold=0.1), JIPO(ipo_threshold=0.1), True),
    ("ratio", RatioLossConfig(clip_eps_low=0.1, clip_eps_high=0.15),
     JRatio(clip_eps_low=0.1, clip_eps_high=0.15), True),
])
def test_rl_losses_match_jax(name, tcfg, jcfg, weighted):
    trainer, infer, _, adv, mask, weights = _loss_streams(np.random.default_rng(8))
    t_fn, j_fn = tloss.make_rl_loss_fn(tcfg), jloss.make_rl_loss_fn(jcfg)
    assert t_fn.__name__ == f"{name}_loss"
    (leaf,) = _leaves(trainer)
    t_out = t_fn(leaf, *map(torch.from_numpy, (infer, adv, mask)),
                 torch.from_numpy(weights) if weighted else None, tcfg)
    j_w = jnp.asarray(weights) if weighted else None
    j_args = (jnp.asarray(infer), jnp.asarray(adv), jnp.asarray(mask), j_w, jcfg)
    j_out = j_fn(jnp.asarray(trainer), *j_args)
    j_grad = jax.grad(lambda t: j_fn(t, *j_args)[0])(jnp.asarray(trainer))
    _check_loss(t_out, j_out, leaf, j_grad)


def test_ref_kl_and_ce_losses_match_jax():
    trainer, infer, ref, _, mask, weights = _loss_streams(np.random.default_rng(9))
    (leaf,) = _leaves(trainer)
    t_out = tloss.ref_kl_loss(leaf, *map(torch.from_numpy, (infer, ref, mask, weights)))
    j_args = tuple(map(jnp.asarray, (infer, ref, mask, weights)))
    j_out = jloss.ref_kl_loss(jnp.asarray(trainer), *j_args)
    j_grad = jax.grad(lambda t: jloss.ref_kl_loss(t, *j_args)[0])(jnp.asarray(trainer))
    _check_loss(t_out, j_out, leaf, j_grad)

    (leaf,) = _leaves(trainer)
    t_out = tloss.ce_loss(leaf, torch.from_numpy(mask), torch.from_numpy(weights))
    j_out = jloss.ce_loss(jnp.asarray(trainer), jnp.asarray(mask), jnp.asarray(weights))
    j_grad = jax.grad(lambda t: jloss.ce_loss(t, jnp.asarray(mask), jnp.asarray(weights))[0])(
        jnp.asarray(trainer))
    _check_loss(t_out, j_out, leaf, j_grad)


@pytest.mark.parametrize("components", ["rl", "rl+ce+ref_kl"])
def test_compute_loss_and_token_counts_match_jax(components):
    rng = np.random.default_rng(10)
    trainer, infer, ref, adv, mask, weights = _loss_streams(rng)
    full = components != "rl"
    ce_w = rng.choice([0.0, 1.0], mask.shape).astype(np.float32) if full else None
    rk_w = rng.choice([0.0, 0.25], mask.shape).astype(np.float32) if full else None
    rl_w = weights if full else None

    def opt(x, conv):
        return None if x is None else conv(x)

    t_counts = tloss.component_token_counts(torch.from_numpy(mask), opt(rl_w, torch.from_numpy),
                                            opt(ce_w, torch.from_numpy),
                                            opt(rk_w, torch.from_numpy))
    j_counts = jloss.component_token_counts(jnp.asarray(mask), opt(rl_w, jnp.asarray),
                                            opt(ce_w, jnp.asarray), opt(rk_w, jnp.asarray))
    assert {k: int(v) for k, v in t_counts.items()} == {k: int(v) for k, v in j_counts.items()}

    def kwargs(conv, cfg, scalar):
        return dict(inference_logprobs=conv(infer), advantages=conv(adv), loss_mask=conv(mask),
                    ref_logprobs=opt(ref if full else None, conv), rl_weights=opt(rl_w, conv),
                    ce_weights=opt(ce_w, conv), ref_kl_weights=opt(rk_w, conv), loss_cfg=cfg,
                    rl_scale=scalar(t_counts["rl"]), ce_scale=scalar(t_counts["ce"]),
                    ref_kl_scale=scalar(t_counts["ref_kl"]))

    (leaf,) = _leaves(trainer)
    t_out = tloss.compute_loss(trainer_logprobs=leaf,
                               **kwargs(torch.from_numpy, DefaultLossConfig(), float))
    j_kw = kwargs(jnp.asarray, JDefault(), lambda c: jnp.float32(int(c)))
    j_out = jloss.compute_loss(trainer_logprobs=jnp.asarray(trainer), **j_kw)
    j_grad = jax.grad(lambda t: jloss.compute_loss(trainer_logprobs=t, **j_kw)[0])(
        jnp.asarray(trainer))
    _check_loss(t_out, j_out, leaf, j_grad)


@pytest.mark.parametrize("hd", [32, 96, 192, 320, 512])
def test_padded_flash_backward_matches_jax_pallas(hd):
    """The K2a and K2b wrappers' head-dim padding (``bwd_padded``: q, k, v and
    do zero-padded to the next built width, delta of the true width, dq, dk,
    dv sliced back) run around the plain versions, with out and lse from
    ``fwd_padded``, against jax.grad through the Pallas kernels in interpret
    mode at the true head dim, f32, rtol = atol = 2e-5."""
    rng = np.random.default_rng(hd + 1)
    b, l, nh, nkv = 1, 48, 4, 2
    q = rng.standard_normal((b, l, nh, hd)).astype(np.float32)
    k = rng.standard_normal((b, l, nkv, hd)).astype(np.float32)
    v = rng.standard_normal((b, l, nkv, hd)).astype(np.float32)
    do = rng.standard_normal((b, l, nh, hd)).astype(np.float32)
    seg = tattn.make_segment_ids([20, 17], l)[None]
    tq, tk, tv, tdo, tseg = map(torch.from_numpy, (q, k, v, do, seg))
    scale = hd ** -0.5
    out, lse = tflash.fwd_padded(tflash.flash_attention_reference, tq, tk, tv, tseg, tseg, True,
                                 scale)
    delta = tflash._delta(out, tdo, None)
    args = (tseg, tseg, lse, delta, tdo, True, scale)
    dq = tflash.bwd_padded(tflash.flash_attention_dq_reference, tq, tk, tv, *args)
    dk, dv = tflash.bwd_padded(tflash.flash_attention_dkv_reference, tq, tk, tv, *args)

    def j_loss(q, k, v):
        return jnp.sum(j_flash(q, k, v, jnp.asarray(seg), block_q=8, block_kv=8) * do)

    want = jax.grad(j_loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    for g, w in zip((dq, dk, dv), want):
        assert g.shape == w.shape
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=2e-5, atol=2e-5)
    assert float(dq[torch.from_numpy(seg) == 0].abs().max()) == 0.0

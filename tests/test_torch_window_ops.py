"""The window and sink forms of the port's kernel modules, and gpt-oss's expert
op, on the CPU against the JAX package: K1 and its backward (K2a, K2b and the
sinks' gradient) through the plain versions against the Pallas kernels run as
the JAX tests run them (interpret mode on the CPU), K4's plain version against
its Pallas kernel, and ``moe_mlp`` with per-expert biases and the clamped GLU.
Inputs come from a numpy seed and go to both packages; sinks are nonzero and
random; everything runs in float32.

Tolerance: 2e-5 absolute and relative on values (both sides compute in f32
and differ only in summation order), 1e-4 on gradients (a sum over up to 64
rows of such values) and 1e-4 on a model's hidden states; pools written by the
KV append must match exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prime_rl_tpu.models import qwen3 as jqwen3
from prime_rl_tpu.models.base import debug_spec as j_debug_spec
from prime_rl_tpu.ops import layers as jlayers
from prime_rl_tpu.ops import moe as jmoe
from prime_rl_tpu.ops.decode_attention import decode_paged_attention as j_decode_attention
from prime_rl_tpu.ops.flash_attention import _flash as j_flash
from prime_rl_tpu_torch.models import qwen3 as tqwen3
from prime_rl_tpu_torch.models.base import debug_spec
from prime_rl_tpu_torch.ops import attention as tattn
from prime_rl_tpu_torch.ops import layers as tlayers
from prime_rl_tpu_torch.ops import moe as tmoe
from prime_rl_tpu_torch.ops.decode_attention import decode_paged_attention as t_decode_attention
from prime_rl_tpu_torch.ops.flash_attention import _fwd as t_flash_fwd

torch.set_num_threads(1)

TOL = dict(atol=2e-5, rtol=2e-5)
GTOL = dict(atol=1e-4, rtol=1e-4)


def _np(t):
    return t.detach().numpy()


@pytest.mark.parametrize("window,with_sinks", [(0, True), (8, False), (8, True)])
def test_k1_k2_window_and_sinks_match_jax(window, with_sinks):
    """out and lse of K1's plain version, and dq/dk/dv/dsinks of K2's (with
    cotangents on both out and lse), against the Pallas kernels with 16-row
    blocks, so a window of 8 really bands them. Row 0 packs three sequences
    and padding, row 1 is one sequence padded at the tail: a padding row's
    lse is -1e30 without sinks and the sink itself with them. (The dense form
    without sinks is held in ``test_torch_ops`` and ``test_torch_train_ops``.)"""
    rng = np.random.default_rng(10 + window + with_sinks)
    b, l, nh, nkv, hd = 2, 64, 4, 2, 32
    q = rng.standard_normal((b, l, nh, hd)).astype(np.float32)
    k = rng.standard_normal((b, l, nkv, hd)).astype(np.float32)
    v = rng.standard_normal((b, l, nkv, hd)).astype(np.float32)
    sinks = rng.standard_normal(nh).astype(np.float32)
    seg = np.zeros((b, l), np.int32)
    seg[0] = np.concatenate([tattn.make_segment_ids([20, 25, 9], 54), np.zeros(10, np.int32)])
    seg[1, :37] = 1
    do = rng.standard_normal((b, l, nh, hd)).astype(np.float32)
    dlse = rng.standard_normal((b, nh, l)).astype(np.float32)
    scale = hd ** -0.5

    def j_fn(q_, k_, v_, s_):
        out, lse = j_flash(jnp.swapaxes(q_, 1, 2), jnp.swapaxes(k_, 1, 2),
                           jnp.swapaxes(v_, 1, 2), s_.reshape(nh, 1), jnp.asarray(seg),
                           jnp.asarray(seg), True, scale, window, with_sinks, 16, 16)
        return jnp.swapaxes(out, 1, 2), lse[:, :, 0, :]

    (j_out, j_lse), vjp = jax.vjp(j_fn, *map(jnp.asarray, (q, k, v, sinks)))
    j_grads = vjp((jnp.asarray(do), jnp.asarray(dlse)))

    leaves = [torch.from_numpy(a.copy()).requires_grad_() for a in (q, k, v, sinks)]
    t_out, t_lse = t_flash_fwd(*leaves[:3], torch.from_numpy(seg), torch.from_numpy(seg), True,
                               scale, window=window, sinks=leaves[3] if with_sinks else None)
    np.testing.assert_allclose(_np(t_out), np.asarray(j_out), **TOL)
    np.testing.assert_allclose(_np(t_lse), np.asarray(j_lse), **TOL)
    pad = np.broadcast_to((seg == 0)[:, None, :], t_lse.shape)
    want_pad = np.broadcast_to(sinks[None, :, None], t_lse.shape)[pad] if with_sinks else \
        np.float32(-1e30)
    np.testing.assert_array_equal(_np(t_lse)[pad], want_pad)
    assert float(t_out.detach()[0, 54:].abs().max()) == 0.0

    wanted = leaves if with_sinks else leaves[:3]
    t_grads = torch.autograd.grad([t_out, t_lse], wanted,
                                  [torch.from_numpy(do), torch.from_numpy(dlse)])
    for name, g, w in zip(("dq", "dk", "dv", "dsinks"), t_grads, j_grads):
        np.testing.assert_allclose(_np(g), np.asarray(w), err_msg=name, **GTOL)
    if with_sinks:
        assert float(t_grads[3].abs().min()) > 0  # every head's sink gets a gradient

    # the attention dispatch's XLA route computes the same out on every row
    # that sees a key (it spreads a padding row's softmax over the masked keys)
    x = tattn.xla_attention(*(torch.from_numpy(a) for a in (q, k, v)), torch.from_numpy(seg),
                            torch.from_numpy(seg), window=window,
                            sinks=torch.from_numpy(sinks) if with_sinks else None)
    np.testing.assert_allclose(_np(x)[seg != 0], _np(t_out)[seg != 0], **TOL)


@pytest.mark.parametrize("window,with_sinks", [(8, True), (8, False), (0, True)])
def test_k4_window_and_sinks_match_jax(window, with_sinks):
    """Slots shorter than the window (n + 1 = 4), equal to it (8), longer with
    a window start inside a page (n = 13: rows 6..12) and across a page
    boundary (n = 21: rows 14..20, pages 1 and 2), a long slot, and an
    inactive slot on the null page; the Pallas kernel runs one page a block,
    so it skips whole blocks below the window."""
    rng = np.random.default_rng(20 + window + with_sinks)
    s, nh, nkv, hd, ps, np_, p = 6, 8, 2, 32, 8, 48, 8
    q = rng.standard_normal((s, nh, hd)).astype(np.float32)
    k_new = rng.standard_normal((s, nkv, hd)).astype(np.float32)
    v_new = rng.standard_normal((s, nkv, hd)).astype(np.float32)
    k_pool = rng.standard_normal((nkv, np_, ps, hd)).astype(np.float32)
    v_pool = rng.standard_normal((nkv, np_, ps, hd)).astype(np.float32)
    sinks = rng.standard_normal(nh).astype(np.float32)
    table = np.zeros((s, p), np.int32)
    for slot in range(5):  # slot 5 inactive: an all-null row
        table[slot] = 1 + slot * p + np.arange(p)
    lengths = np.asarray([3, 7, 13, 21, 60, 2], np.int32)
    kw = dict(window=window, sinks=sinks if with_sinks else None)

    got_o, got_k, got_v = t_decode_attention(
        *(torch.from_numpy(a.copy()) for a in (q, k_new, v_new, k_pool, v_pool, lengths, table)),
        **{**kw, "sinks": torch.from_numpy(sinks) if with_sinks else None})
    want_o, want_k, want_v = j_decode_attention(
        *(jnp.asarray(a) for a in (q, k_new, v_new, k_pool, v_pool, lengths, table)),
        **{**kw, "sinks": jnp.asarray(sinks) if with_sinks else None}, block_pages=1,
        interpret=True)
    np.testing.assert_allclose(_np(got_o)[:5], np.asarray(want_o)[:5], **TOL)
    np.testing.assert_array_equal(_np(got_k)[:, 1:], np.asarray(want_k)[:, 1:])
    np.testing.assert_array_equal(_np(got_v)[:, 1:], np.asarray(want_v)[:, 1:])


def test_moe_mlp_with_biases_and_clamped_glu_matches_jax():
    """gpt-oss's expert op: softmax over the top-k logits with a router bias,
    per-expert gate/up/down biases and the clamped GLU (values pushed past the
    clamp limit). Output, routing and the gradients of the input, router,
    weights and every bias against ``jax.grad``; the activation alone too."""
    rng = np.random.default_rng(30)
    t, d, e, m, k = 24, 16, 4, 12, 2
    x = rng.standard_normal((t, d)).astype(np.float32)
    rw = (rng.standard_normal((d, e)) * 0.5).astype(np.float32)
    rb = rng.standard_normal(e).astype(np.float32)
    wg, wu = (rng.standard_normal((2, e, d, m)) * 1.5).astype(np.float32)
    wd = (rng.standard_normal((e, m, d)) * 0.3).astype(np.float32)
    bg, bu = rng.standard_normal((2, e, m)).astype(np.float32)
    bd = rng.standard_normal((e, d)).astype(np.float32)
    ct = rng.standard_normal((t, d)).astype(np.float32)
    kw = dict(softmax_topk=True, activation_alpha=1.702, activation_limit=7.0)
    arrays = (x, rw, wg, wu, wd, rb, bg, bu, bd)

    def j_loss(x_, rw_, wg_, wu_, wd_, rb_, bg_, bu_, bd_):
        out, r = jmoe.moe_mlp(x_, rw_, wg_, wu_, wd_, k, router_b=rb_, b_gate=bg_, b_up=bu_,
                              b_down=bd_, **kw)
        return jnp.sum(out * ct), (out, r)

    (_, (want, want_r)), want_g = jax.value_and_grad(
        j_loss, argnums=tuple(range(9)), has_aux=True)(*map(jnp.asarray, arrays))
    leaves = [torch.from_numpy(a.copy()).requires_grad_() for a in arrays]
    out, r = tmoe.moe_mlp(*leaves[:5], k, router_b=leaves[5], b_gate=leaves[6], b_up=leaves[7],
                          b_down=leaves[8], **kw)
    grads = torch.autograd.grad((out * torch.from_numpy(ct)).sum(), leaves)
    np.testing.assert_array_equal(r.expert_ids.numpy(), np.asarray(want_r.expert_ids))
    np.testing.assert_allclose(_np(r.weights), np.asarray(want_r.weights), **TOL)
    np.testing.assert_allclose(_np(out), np.asarray(want), **TOL)
    names = ("x", "router", "gate", "up", "down", "router_b", "b_gate", "b_up", "b_down")
    for name, g, w in zip(names, grads, want_g):
        np.testing.assert_allclose(_np(g), np.asarray(w), err_msg=name, **GTOL)

    gate, up = (rng.standard_normal((2, 50)) * 6).astype(np.float32)
    assert (np.abs(gate) > 7).any() and (np.abs(up) > 7).any()
    np.testing.assert_allclose(
        _np(tlayers.clamped_glu(torch.from_numpy(gate), torch.from_numpy(up), 1.702, 7.0)),
        np.asarray(jlayers.clamped_glu(jnp.asarray(gate), jnp.asarray(up), 1.702, 7.0)), **TOL)


def test_windowed_dense_block_with_sinks_matches_jax():
    """A qwen3 spec with a sliding window on every other layer and attention
    sinks (the mistral-style dense block; llama is the same block without
    qk-norm) runs in the port's forward, through the attention dispatch's
    window and sink forms, and matches the JAX forward (1e-4) on a packed
    batch; the kernel route (the plain versions) gives the same hidden
    states."""
    kw = dict(vocab_size=128, num_layers=2, sliding_window=8, sliding_window_pattern=2,
              attn_sinks=True)
    jspec, tspec = j_debug_spec(**kw), debug_spec(**kw)
    rng = np.random.default_rng(40)
    np_params = jax.tree.map(
        lambda x: np.asarray(x) + np.float32(0.1) * rng.standard_normal(x.shape, np.float32),
        jqwen3.init_params(jspec, jax.random.key(4)))
    params = tqwen3.params_from_jax(np_params, tspec)
    seg = np.zeros((2, 40), np.int32)
    seg[0, :30], seg[0, 30:36], seg[1, :40] = 1, 2, 1
    pos = np.where(seg > 0, np.concatenate([np.arange(30), np.arange(6), np.zeros(4)])
                   .astype(np.int32)[None], 0).astype(np.int32)
    pos[1] = np.arange(40)
    ids = rng.integers(1, 120, (2, 40)).astype(np.int32)
    want = jqwen3.forward(jax.tree.map(jnp.asarray, np_params), jspec,
                          *map(jnp.asarray, (ids, seg, pos)), compute_dtype=jnp.float32,
                          attn_impl="xla", remat="none")
    got = {impl: tqwen3.forward(params, tspec, *map(torch.from_numpy, (ids, seg, pos)),
                                compute_dtype=torch.float32, attn_impl=impl, remat="none")
           for impl in ("auto", "pallas")}
    real = seg > 0
    for impl, h in got.items():
        np.testing.assert_allclose(_np(h)[real], np.asarray(want)[real], atol=1e-4, rtol=1e-4,
                                   err_msg=impl)

"""The port's kernel modules on the CPU against the JAX package: K1 (flash
attention forward), K3 (decode QKV prep), K4 (paged decode attention with
KV append), each through its plain PyTorch version, against the JAX Pallas
kernel run as the JAX tests run it (interpret mode on the CPU), plus the
layer ops and the attention dispatch. Inputs come from a numpy seed and go
to both packages; everything runs in float32.

Tolerance: 2e-5 absolute and relative on every float comparison — both
sides compute in f32 and differ only in summation order; pools written by
the KV append must match exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prime_rl_tpu.ops import attention as jattn
from prime_rl_tpu.ops import layers as jlayers
from prime_rl_tpu.ops.decode_attention import decode_paged_attention as j_decode_attention
from prime_rl_tpu.ops.decode_qkv import decode_qkv_prep as j_decode_qkv
from prime_rl_tpu.ops.flash_attention import flash_attention as j_flash
from prime_rl_tpu.ops.flash_attention import flash_attention_with_lse as j_flash_lse
from prime_rl_tpu_torch.ops import attention as tattn
from prime_rl_tpu_torch.ops import layers as tlayers
from prime_rl_tpu_torch.ops.decode_attention import decode_paged_attention as t_decode_attention
from prime_rl_tpu_torch.ops.decode_qkv import decode_qkv_prep as t_decode_qkv
from prime_rl_tpu_torch.ops.flash_attention import flash_attention as t_flash
from prime_rl_tpu_torch.ops.flash_attention import flash_attention_with_lse as t_flash_lse

torch.set_num_threads(1)

TOL = dict(atol=2e-5, rtol=2e-5)


def _close(t, j, **kw):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **(kw or TOL))


def _packed_segments():
    """Two rows of 64: row 0 packs three sequences and padding; row 1 is a
    single sequence padded at the tail (bucketed prefill)."""
    seg = np.zeros((2, 64), np.int32)
    seg[0] = np.concatenate([tattn.make_segment_ids([20, 25, 9], 54), np.zeros(10, np.int32)])
    seg[1, :37] = 1
    return seg


def test_k1_flash_attention_matches_jax():
    rng = np.random.default_rng(0)
    b, l, nh, nkv, hd = 2, 64, 4, 2, 64
    q = rng.standard_normal((b, l, nh, hd)).astype(np.float32)
    k = rng.standard_normal((b, l, nkv, hd)).astype(np.float32)
    v = rng.standard_normal((b, l, nkv, hd)).astype(np.float32)
    seg = _packed_segments()
    tq, tk, tv, tseg = map(torch.from_numpy, (q, k, v, seg))
    jq, jk, jv, jseg = map(jnp.asarray, (q, k, v, seg))

    _close(t_flash(tq, tk, tv, tseg), j_flash(jq, jk, jv, jseg))
    t_out, t_lse = t_flash_lse(tq, tk, tv, tseg, tseg, causal=True)
    j_out, j_lse = j_flash_lse(jq, jk, jv, jseg, jseg, causal=True)
    _close(t_out, j_out)
    _close(t_lse, j_lse)
    # padding rows: output 0, lse -1e30, as the TPU kernel's finalize
    assert float(t_out[0, 54:].abs().max()) == 0.0
    assert float(t_lse[1, :, 37:].max()) == float(np.float32(-1e30))

    # the XLA path agrees with both on every row that sees a key
    t_x = tattn.xla_attention(tq, tk, tv, tseg, tseg, causal=True)
    _close(t_x, jattn.xla_attention(jq, jk, jv, jseg, jseg, causal=True))
    valid = seg != 0
    np.testing.assert_allclose(t_x.numpy()[valid], t_out.numpy()[valid], **TOL)
    # the dispatch takes the XLA path for CPU tensors
    _close(tattn.attention(tq, tk, tv, tseg), t_x)


@pytest.mark.parametrize("qk_norm,bias,partial", [
    (True, False, False),   # qwen3-style
    (False, True, False),   # biases, no qk-norm
    (True, False, True),    # partial rotary
])
def test_k3_decode_qkv_prep_matches_jax(qk_norm, bias, partial):
    rng = np.random.default_rng(1)
    s, d, nh, nkv, hd = 8, 64, 4, 2, 16
    rot = hd // 2 if partial else hd

    def arr(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    inputs = dict(
        x=arr(s, d), norm_w=arr(d), wq=arr(d, nh * hd, scale=0.1),
        wk=arr(d, nkv * hd, scale=0.1), wv=arr(d, nkv * hd, scale=0.1),
        positions=rng.integers(0, 300, s).astype(np.int32),
        inv_freq=(1.0 / (1e4 ** (np.arange(0, rot, 2) / rot))).astype(np.float32),
    )
    opt = {}
    if qk_norm:
        opt.update(q_norm_w=arr(hd), k_norm_w=arr(hd))
    if bias:
        opt.update(q_bias=arr(nh * hd), k_bias=arr(nkv * hd), v_bias=arr(nkv * hd))
    kw = dict(num_heads=nh, num_kv_heads=nkv, head_dim=hd, qk_norm=qk_norm,
              scaling=1.1, eps=1e-6)
    got = t_decode_qkv(*(torch.from_numpy(a) for a in inputs.values()), **kw,
                       **{k: torch.from_numpy(a) for k, a in opt.items()})
    want = j_decode_qkv(*(jnp.asarray(a) for a in inputs.values()), **kw,
                        **{k: jnp.asarray(a) for k, a in opt.items()}, interpret=True)
    for g, w in zip(got, want):
        _close(g, w)


def test_k4_decode_paged_attention_matches_jax():
    """Ragged lengths (one slot crosses several pages), an empty slot, and
    two inactive slots whose page-table rows are the null page 0."""
    rng = np.random.default_rng(2)
    s, nh, nkv, hd, ps, np_, p = 6, 4, 2, 128, 8, 40, 8
    q = rng.standard_normal((s, nh, hd)).astype(np.float32)
    k_new = rng.standard_normal((s, nkv, hd)).astype(np.float32)
    v_new = rng.standard_normal((s, nkv, hd)).astype(np.float32)
    k_pool = rng.standard_normal((nkv, np_, ps, hd)).astype(np.float32)
    v_pool = rng.standard_normal((nkv, np_, ps, hd)).astype(np.float32)
    table = np.zeros((s, p), np.int32)
    for slot in range(4):  # slots 4, 5 inactive: all-null rows
        table[slot] = 1 + slot * p + np.arange(p)
    lengths = np.asarray([5, 0, 13, 61, 3, 3], np.int32)

    got_o, got_k, got_v = t_decode_attention(
        *(torch.from_numpy(a.copy()) for a in (q, k_new, v_new, k_pool, v_pool, lengths, table)))
    want_o, want_k, want_v = j_decode_attention(
        *(jnp.asarray(a) for a in (q, k_new, v_new, k_pool, v_pool, lengths, table)),
        interpret=True)
    _close(got_o[:4], np.asarray(want_o)[:4])
    # every page but the shared null page is exact (inactive slots race for
    # page 0 in both packages; nothing reads it)
    np.testing.assert_array_equal(got_k.numpy()[:, 1:], np.asarray(want_k)[:, 1:])
    np.testing.assert_array_equal(got_v.numpy()[:, 1:], np.asarray(want_v)[:, 1:])


def test_k1_and_k4_match_jax_at_head_dim_256():
    """Qwen3-Next's attention shape, head dim 256 at GQA group 8: K1 (out and
    lse over packed segments) and K4 (ragged lengths over several pages, an
    inactive slot) through their plain versions against the Pallas kernels
    in interpret mode, at 2e-5."""
    rng = np.random.default_rng(5)
    b, l, nh, nkv, hd = 2, 64, 8, 1, 256
    q = rng.standard_normal((b, l, nh, hd)).astype(np.float32)
    k = rng.standard_normal((b, l, nkv, hd)).astype(np.float32)
    v = rng.standard_normal((b, l, nkv, hd)).astype(np.float32)
    seg = _packed_segments()
    t_out, t_lse = t_flash_lse(*map(torch.from_numpy, (q, k, v, seg, seg)), causal=True)
    j_out, j_lse = j_flash_lse(*map(jnp.asarray, (q, k, v, seg, seg)), causal=True)
    _close(t_out, j_out)
    _close(t_lse, j_lse)

    s, ps, np_, p = 4, 8, 40, 8
    q = rng.standard_normal((s, nh, hd)).astype(np.float32)
    k_new = rng.standard_normal((s, nkv, hd)).astype(np.float32)
    v_new = rng.standard_normal((s, nkv, hd)).astype(np.float32)
    k_pool = rng.standard_normal((nkv, np_, ps, hd)).astype(np.float32)
    v_pool = rng.standard_normal((nkv, np_, ps, hd)).astype(np.float32)
    table = np.zeros((s, p), np.int32)
    for slot in range(3):  # slot 3 inactive: the null page
        table[slot] = 1 + slot * p + np.arange(p)
    lengths = np.asarray([40, 0, 63, 5], np.int32)
    got = t_decode_attention(
        *(torch.from_numpy(a.copy()) for a in (q, k_new, v_new, k_pool, v_pool, lengths, table)))
    want = j_decode_attention(
        *(jnp.asarray(a) for a in (q, k_new, v_new, k_pool, v_pool, lengths, table)),
        interpret=True)
    _close(got[0][:3], np.asarray(want[0])[:3])
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy()[:, 1:], np.asarray(w)[:, 1:])


@pytest.mark.parametrize("hd", [384, 512])
def test_k4_matches_jax_at_head_dims_384_and_512(hd):
    """K4's widths of the range repair (Cfg<384>, Cfg<512>): its plain version
    over ragged lengths, several pages and an inactive slot at GQA groups 4
    and 1, against the Pallas kernel in interpret mode, at 2e-5; the pools
    written exactly."""
    from prime_rl_tpu_torch.ops.decode_attention import check_shape

    rng = np.random.default_rng(hd)
    s, ps, np_, p = 4, 8, 40, 8
    for nh, nkv in ((8, 2), (2, 2)):
        check_shape(nh, nkv, hd)
        q = rng.standard_normal((s, nh, hd)).astype(np.float32)
        k_new = rng.standard_normal((s, nkv, hd)).astype(np.float32)
        v_new = rng.standard_normal((s, nkv, hd)).astype(np.float32)
        k_pool = rng.standard_normal((nkv, np_, ps, hd)).astype(np.float32)
        v_pool = rng.standard_normal((nkv, np_, ps, hd)).astype(np.float32)
        table = np.zeros((s, p), np.int32)
        for slot in range(3):  # slot 3 inactive: the null page
            table[slot] = 1 + slot * p + np.arange(p)
        lengths = np.asarray([40, 0, 63, 5], np.int32)
        got = t_decode_attention(*(torch.from_numpy(a.copy())
                                   for a in (q, k_new, v_new, k_pool, v_pool, lengths, table)))
        want = j_decode_attention(
            *(jnp.asarray(a) for a in (q, k_new, v_new, k_pool, v_pool, lengths, table)),
            interpret=True)
        _close(got[0][:3], np.asarray(want[0])[:3])
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_array_equal(g.numpy()[:, 1:], np.asarray(w)[:, 1:])


def test_layer_ops_match_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    w = rng.standard_normal(16).astype(np.float32)
    pos = rng.integers(0, 1000, (2, 5)).astype(np.int32)
    _close(tlayers.rms_norm(torch.from_numpy(x), torch.from_numpy(w)),
           jlayers.rms_norm(jnp.asarray(x), jnp.asarray(w)))
    _close(tlayers.rope_frequencies(12, 1e4), jlayers.rope_frequencies(12, 1e4))
    t_inv, t_scale = tlayers.yarn_rope_parameters(16, 1.5e5, 32.0, 4096, truncate=False)
    j_inv, j_scale = jlayers.yarn_rope_parameters(16, 1.5e5, 32.0, 4096, truncate=False)
    _close(t_inv, j_inv)
    assert t_scale == pytest.approx(j_scale)
    for inv in (np.asarray(j_inv), np.asarray(jlayers.rope_frequencies(8, 1e4))):  # full, partial
        _close(tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                                  torch.from_numpy(inv.copy()), 1.2),
               jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), jnp.asarray(inv), 1.2))
    _close(tlayers.swiglu(torch.from_numpy(x), torch.from_numpy(x[::-1].copy())),
           jlayers.swiglu(jnp.asarray(x), jnp.asarray(x[::-1].copy())))
    np.testing.assert_array_equal(tattn.make_position_ids([3, 2], 6),
                                  jattn.make_position_ids([3, 2], 6))


def test_cuda_kernels_refuse_what_they_do_not_take():
    """The wrappers never fall back: the CPU path is taken for CPU tensors
    only (there a window runs the plain version), and features outside the
    ported forms raise."""
    x = torch.randn(1, 64, 2, 64, generator=torch.Generator().manual_seed(0))
    seg = torch.ones(1, 64, dtype=torch.int32)
    _close(t_flash(x, x, x, seg, window=16),
           tattn.xla_attention(x, x, x, seg, seg, causal=True, window=16).numpy())
    q, kv = torch.zeros(2, 2, 64), torch.zeros(2, 2, 64)
    pool = torch.zeros(2, 3, 8, 64)
    with pytest.raises(NotImplementedError, match="scale"):
        t_decode_attention(q, kv, kv, pool, pool.clone(), torch.zeros(2, dtype=torch.int32),
                           torch.zeros(2, 1, dtype=torch.int32), sm_scale=0.5)
    assert jax.default_backend() == "cpu"


@pytest.mark.parametrize("hd", [32, 96, 192, 320, 512])
def test_k1_padded_head_dims_match_jax_pallas(hd):
    """The K1 wrapper's head-dim padding (``fwd_padded``: q, k, v zero-padded
    to the next built width, 64, 128, 256, 384 or 512, the true head dim's
    scale, out sliced back; 512 runs as it is) run around the plain version,
    against the Pallas kernel in interpret mode at the true head dim, f32 at
    2e-5: a zero column adds 0 to every score, so out and lse do not
    change."""
    from prime_rl_tpu_torch.ops import flash_attention as tflash

    rng = np.random.default_rng(hd)
    b, l, nh, nkv = 2, 64, 4, 2
    q = rng.standard_normal((b, l, nh, hd)).astype(np.float32)
    k = rng.standard_normal((b, l, nkv, hd)).astype(np.float32)
    v = rng.standard_normal((b, l, nkv, hd)).astype(np.float32)
    seg = _packed_segments()
    tq, tk, tv, tseg = map(torch.from_numpy, (q, k, v, seg))
    assert tflash.padded_head_dim(hd) == {32: 64, 96: 128, 192: 256, 320: 384, 512: 512}[hd]
    out, lse = tflash.fwd_padded(tflash.flash_attention_reference, tq, tk, tv, tseg, tseg, True,
                                 hd ** -0.5)
    assert out.shape == q.shape
    j_out, j_lse = j_flash_lse(*map(jnp.asarray, (q, k, v, seg, seg)), causal=True)
    _close(out, j_out, rtol=2e-5, atol=2e-5)
    _close(lse, j_lse, rtol=2e-5, atol=2e-5)
    _close(out, j_flash(*map(jnp.asarray, (q, k, v, seg)), block_q=16, block_kv=16),
           rtol=2e-5, atol=2e-5)


def test_takes_k4_mirrors_the_jax_decode_choice():
    """``sampler.model.takes_k4`` against the JAX decode's choice of its
    kernel (``hd % 128 == 0``, ``sampler/model.py`` ``_decode_attn_fused_local``)
    for every built-in spec and at head dims 32 and 96. They agree everywhere
    but at 64, where the port runs K4 and the JAX package XLA (a logged
    divergence). At 32 and 96 the port's decode attention takes the plain
    paged version, and it gives the JAX decode's output and pages (f32 at
    this file's tolerance)."""
    import dataclasses

    from prime_rl_tpu.sampler import model as jsm
    from prime_rl_tpu_torch.models.base import BUILTIN_SPECS
    from prime_rl_tpu_torch.sampler import model as tsm

    for name, spec in BUILTIN_SPECS.items():
        assert tsm.takes_k4(spec) == (spec.head_dim % 128 == 0 or spec.head_dim == 64), name
    base = BUILTIN_SPECS["debug"]
    assert base.head_dim == 32
    rng = np.random.default_rng(4)
    for hd in (32, 96):
        spec = dataclasses.replace(base, head_dim=hd)
        assert not tsm.takes_k4(spec) and hd % 128 != 0
        s, nh, nkv, ps, np_, p = 4, 4, 2, 8, 20, 4
        arrs = [rng.standard_normal(sh).astype(np.float32) for sh in
                ((s, nh, hd), (s, nkv, hd), (s, nkv, hd), (nkv, np_, ps, hd), (nkv, np_, ps, hd))]
        table = (1 + np.arange(s * p, dtype=np.int32)).reshape(s, p)
        lengths = np.asarray([5, 0, 13, 30], np.int32)
        got = tsm._decode_attn_fused_local(
            *(torch.from_numpy(a.copy()) for a in (*arrs, lengths, table)), k4=tsm.takes_k4(spec))
        want = jsm._decode_attn_fused_local(*(jnp.asarray(a) for a in (*arrs, lengths, table)),
                                            None, "pallas", 0, False)
        for g, w in zip(got, want):
            _close(g, w)

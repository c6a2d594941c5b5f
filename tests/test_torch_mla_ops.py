"""The MLA/DSA slice's ops on the CPU against the JAX package: the sparse-MLA
attention (K5a/K5b through their plain PyTorch versions, against the JAX
Pallas kernels run in interpret mode as the JAX tests run them, and against
the XLA chunked-gather op), the indexer's top-k, interleaved rope, layer norm,
dense MLA attention, and the MoE routing and expert products. Inputs come from
a numpy seed and go to both packages.

Tolerances are stated per test. Against the Pallas kernels on the same
float32 inputs the plain versions differ only in summation order (2e-4);
against the XLA op, which rounds its products' inputs to bfloat16, they hold
the JAX tests' own 3e-2 (forward) and 5e-2 (gradients).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prime_rl_tpu.ops import layers as jlayers
from prime_rl_tpu.ops import moe as jmoe
from prime_rl_tpu.ops import sparse_mla as jsparse
from prime_rl_tpu.ops.sparse_mla_pallas import sparse_mla_attention as j_pallas_attn
from prime_rl_tpu_torch.ops import layers as tlayers
from prime_rl_tpu_torch.ops import moe as tmoe
from prime_rl_tpu_torch.ops import sparse_mla as tsparse
from prime_rl_tpu_torch.ops import sparse_mla_kernel as tkernel

torch.set_num_threads(1)

H, DQ, DV = 8, 160, 128


def _np(t):
    return t.detach().float().numpy()


def _case(seed, S, Sk, T, causal=True):
    """q, kv (numpy f32) and causal top-k-looking indices with the sentinel
    Sk, as tests/unit/ops/test_sparse_mla_pallas.py builds them."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((S, H, DQ)).astype(np.float32)
    kv = rng.standard_normal((Sk, DQ)).astype(np.float32)
    idx = np.full((S, T), Sk, np.int32)
    for i in range(S):
        hi = min(i + 1, Sk) if causal else Sk
        n = min(T, hi)
        if n > 0:
            idx[i, :n] = rng.choice(hi, size=n, replace=False)
    return q, kv, idx


# ---------------------------------------------------------------------------
# (a) K5a's plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(37, 37, 16), (64, 64, 64), (33, 48, 50)])
def test_sparse_mla_forward_matches_jax_pallas_and_xla(shape):
    """bf16 inputs, as the JAX test feeds its kernel: out against the Pallas
    kernel (interpret mode, chunk 16, block_t 128) and the XLA op, atol 3e-2
    (the JAX test's own: online against one-shot softmax on bf16 values)."""
    S, Sk, T = shape
    q, kv, idx = _case(0, S, Sk, T)
    scale = DQ ** -0.5
    jq, jkv = jnp.asarray(q, jnp.bfloat16), jnp.asarray(kv, jnp.bfloat16)
    want_pallas = j_pallas_attn(jq, jkv, jnp.asarray(idx), scale, DV, chunk=16, block_t=128)
    want_xla = jsparse.sparse_mla_attention(jq, jkv, jnp.asarray(idx), scale, DV, chunk=16)
    tq, tkv = torch.from_numpy(q).bfloat16(), torch.from_numpy(kv).bfloat16()
    tidx = torch.from_numpy(idx)
    out, lse = tkernel.sparse_mla_attention_reference(tq, tkv, tidx, scale, DV, chunk=16)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    np.testing.assert_allclose(_np(out), np.asarray(want_pallas, np.float32), atol=3e-2)
    np.testing.assert_allclose(_np(out), np.asarray(want_xla, np.float32), atol=3e-2)
    # the wrapper takes the plain version for CPU tensors, and the XLA port agrees
    got = tkernel.sparse_mla_attention(tq, tkv, tidx, scale, DV)
    assert torch.equal(got, tkernel.sparse_mla_attention_reference(tq, tkv, tidx, scale, DV)[0])
    np.testing.assert_allclose(_np(tsparse.sparse_mla_attention(tq, tkv, tidx, scale, DV)),
                               np.asarray(want_xla, np.float32), atol=3e-2)


def test_sparse_mla_forward_f32_is_tight_and_all_sentinel_rows_are_zero():
    """float32 inputs: out against the Pallas kernel at 2e-4 (summation order
    only); a token that selected nothing gives out 0 and lse -5e29 + log 1e-30;
    a batched call equals the rows one by one."""
    S, Sk, T = 8, 8, 4
    q, kv, idx = _case(1, S, Sk, T)
    idx[3] = Sk
    want = j_pallas_attn(jnp.asarray(q), jnp.asarray(kv), jnp.asarray(idx), 0.1, DV,
                         chunk=8, block_t=128)
    tq, tkv, tidx = torch.from_numpy(q), torch.from_numpy(kv), torch.from_numpy(idx)
    out, lse = tkernel.sparse_mla_forward(tq, tkv, tidx, 0.1, DV)
    np.testing.assert_allclose(_np(out), np.asarray(want), atol=2e-4, rtol=2e-4)
    assert float(out[3].abs().max()) == 0.0
    np.testing.assert_allclose(_np(lse[3]), -5e29 + np.log(1e-30), rtol=1e-6)
    both = tkernel.sparse_mla_attention(torch.stack([tq, tq * 2]), torch.stack([tkv, tkv]),
                                        torch.stack([tidx, tidx]), 0.1, DV)
    assert torch.equal(both[0], out)
    assert torch.equal(both[1], tkernel.sparse_mla_forward(tq * 2, tkv, tidx, 0.1, DV)[0])


# ---------------------------------------------------------------------------
# (b) K5b's plain version
# ---------------------------------------------------------------------------

def test_sparse_mla_backward_matches_jax_grads():
    """dq and dkv of the plain backward (through the autograd Function, f32)
    against jax.grad through the Pallas kernels (2e-4) and through the XLA op
    (5e-2, the JAX test's own: that op rounds to bf16); a token that selected
    nothing gets dq 0."""
    S, Sk, T = 24, 24, 12
    q, kv, idx = _case(2, S, Sk, T)
    idx[5] = Sk
    scale = DQ ** -0.5
    ct = np.random.default_rng(3).standard_normal((S, H, DV)).astype(np.float32)

    def j_grads(fn):
        def f(q_, kv_):
            return jnp.sum(fn(q_, kv_, jnp.asarray(idx), scale, DV, chunk=8) * ct)

        return jax.grad(f, argnums=(0, 1))(jnp.asarray(q), jnp.asarray(kv))

    want_dq, want_dkv = j_grads(lambda *a, **k: j_pallas_attn(*a, block_t=128, **k))
    xla_dq, xla_dkv = j_grads(jsparse.sparse_mla_attention)

    tq = torch.from_numpy(q).requires_grad_()
    tkv = torch.from_numpy(kv).requires_grad_()
    out = tkernel.sparse_mla_attention(tq, tkv, torch.from_numpy(idx), scale, DV)
    dq, dkv = torch.autograd.grad((out * torch.from_numpy(ct)).sum(), (tq, tkv))
    np.testing.assert_allclose(_np(dq), np.asarray(want_dq), atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(_np(dkv), np.asarray(want_dkv), atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(_np(dq), np.asarray(xla_dq), atol=5e-2)
    np.testing.assert_allclose(_np(dkv), np.asarray(xla_dkv), atol=5e-2)
    assert float(dq[5].abs().max()) == 0.0

    # the XLA port's autograd against the XLA op's own gradients: same roundings
    tq2 = torch.from_numpy(q).requires_grad_()
    tkv2 = torch.from_numpy(kv).requires_grad_()
    out2 = tsparse.sparse_mla_attention(tq2, tkv2, torch.from_numpy(idx), scale, DV, chunk=8)
    dq2, dkv2 = torch.autograd.grad((out2 * torch.from_numpy(ct)).sum(), (tq2, tkv2))
    np.testing.assert_allclose(_np(dq2), np.asarray(xla_dq), atol=5e-2)
    np.testing.assert_allclose(_np(dkv2), np.asarray(xla_dkv), atol=5e-2)


def test_plain_backward_keeps_the_per_slot_dkv_rows_in_float32():
    """The plain K5b (``_backward_into``) adds each slot's dkv row to dkv as
    float32, as the 576 K5b writes it since its rows went f32: on bf16
    inputs its f32 dkv is the float64 sum of the same rows (ds and p rounded
    to bf16 where the kernels round them) within 2e-6 of the largest |dkv|,
    while rounding each row to bf16 first (``round_rows``, the wide K5b's
    form) moves it by more than 1e-4 of it: one bf16 step of a large row."""
    rng = np.random.default_rng(5)
    S, H, Dq, Dv, T = 48, 16, 64, 32, 3
    bf = torch.bfloat16
    q = torch.from_numpy(rng.standard_normal((S, H, Dq)).astype(np.float32)).to(bf)
    kv = torch.from_numpy(rng.standard_normal((S, Dq)).astype(np.float32)).to(bf)
    do = torch.from_numpy(rng.standard_normal((S, H, Dv)).astype(np.float32)).to(bf)
    idx = torch.from_numpy(np.stack([rng.choice(S, T, replace=False) for _ in range(S)])
                           .astype(np.int32))
    scale = Dq ** -0.5
    out, lse = tkernel.sparse_mla_attention_reference(q, kv, idx, scale, Dv)
    delta = (out.float() * do.float()).sum(-1)
    got = {}
    for rounded in (False, True):
        dkv = torch.zeros((S, Dq), dtype=torch.float32)
        tkernel._backward_into(q, kv, idx, lse, delta, do, dkv, scale, Dv, round_rows=rounded)
        got[rounded] = dkv.double()
    # the same rows in float64: p and ds rounded as the plain version rounds them
    kvg = kv.double()[idx.long()]  # [S, T, Dq]
    s = torch.einsum("shd,std->sht", q.double(), kvg) * scale
    p = torch.exp(s - lse.double()[..., None])
    dp = torch.einsum("shd,std->sht", do.double(), kvg[..., :Dv])
    ds = (p.float() * (dp.float() - delta[..., None]) * scale).to(bf).double()
    rows = torch.einsum("sht,shd->std", ds, q.double())
    rows[..., :Dv] += torch.einsum("sht,shd->std", p.float().to(bf).double(), do.double())
    want = torch.zeros((S, Dq), dtype=torch.float64).index_add_(
        0, idx.long().reshape(-1), rows.reshape(-1, Dq))
    big = float(want.abs().max())
    assert float((got[False] - want).abs().max()) < 2e-6 * big
    assert float((got[True] - want).abs().max()) > 1e-4 * big


def test_slot_order_is_the_inverse_of_the_selection():
    """The sorted inverse that the dkv reduction walks: every kv row's slots,
    ascending, sentinels last and outside every segment."""
    _, _, idx = _case(4, 10, 10, 6)
    idx[2] = 10
    order, seg = tkernel.slot_order(torch.from_numpy(idx), 10)
    flat = idx.reshape(-1)
    assert seg.dtype == torch.int32 and seg.shape == (11,) and int(seg[0]) == 0
    assert int(seg[-1]) == int((flat < 10).sum())
    for r in range(10):
        slots = order[int(seg[r]):int(seg[r + 1])].numpy()
        assert (flat[slots] == r).all() and (np.diff(slots) > 0).all()
        assert len(slots) == int((flat == r).sum())
    # f32 dkvg rows: 16 chunks of 256 queries keep the buffer at 1.2 GB
    assert tkernel.bwd_launches(4096, 2048) == 16 and tkernel.bwd_chunk(10, 6) == 10


def test_kernel_wrappers_raise_for_what_the_kernels_do_not_take():
    """On a CUDA tensor the wrapper launches the kernels or raises: the width
    check comes before any launch, so it can run here. A width above the
    wide forms' 1152 raises; this file's narrower widths (Dq 160, v_dim 128)
    and Dq 640 (the wide forms, padded to 1152) pass it and stop at the
    device check."""
    q = torch.zeros(4, H, 1280, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="H % 8 == 0, Dq <= 1152 and v_dim <= 1024"):
        tkernel._check_args(q, torch.zeros(4, 1280, dtype=torch.bfloat16),
                            torch.zeros(4, 2, dtype=torch.int32), DV)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        tkernel._check_args(torch.zeros(4, H, 640, dtype=torch.bfloat16),
                            torch.zeros(4, 640, dtype=torch.bfloat16),
                            torch.zeros(4, 2, dtype=torch.int32), 512)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        tkernel._check_args(torch.zeros(4, H, DQ, dtype=torch.bfloat16),
                            torch.zeros(4, DQ, dtype=torch.bfloat16),
                            torch.zeros(4, 2, dtype=torch.int32), DV)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        tkernel._check_args(torch.zeros(4, 64, 576, dtype=torch.bfloat16),
                            torch.zeros(4, 576, dtype=torch.bfloat16),
                            torch.zeros(4, 2, dtype=torch.int32), 512)


@pytest.mark.parametrize("heads", [8, 32, 64, 96, 128])
def test_kernel_widths_take_every_dsa_head_count_the_jax_kernel_takes(heads):
    """The check table of K5a/K5b (``check_widths``, no launch): a
    ``GlmMoeDsaForCausalLM`` config (GLM-5's widths) at 8, 32, 64, 96 and 128
    heads gives q [S, H, 576] and v_dim 512, which the kernels take, as the JAX
    wrapper sends every ``H % 8 == 0`` to its Pallas kernel; the kernels run
    ``padded_heads(H) / 64`` groups. Narrower widths (Dq 320, v_dim 256) are
    taken, zero-padded to 576/512. Refused: ``H % 8 != 0`` (the JAX wrapper's
    XLA fall-back, a deliberate divergence), Dq above 576, v_dim above 512 or
    not a multiple of 128 (a range the JAX kernel takes and no DSA config
    has)."""
    import chip_smoke

    from prime_rl_tpu_torch.models.base import spec_from_hf_config

    spec = spec_from_hf_config({**chip_smoke.GLM5_CONFIG, "num_attention_heads": heads,
                                "num_key_value_heads": heads})
    assert spec.num_heads == heads and spec.index_topk
    dq, dv = spec.kv_lora_rank + spec.qk_rope_head_dim, spec.kv_lora_rank
    tkernel.check_widths(spec.num_heads, dq, dv)
    assert tkernel.padded_heads(heads) == {8: 64, 32: 64, 64: 64, 96: 128, 128: 128}[heads]
    assert tkernel.bwd_launches(4096, 2048, heads) == 16 * tkernel.padded_heads(heads) // 64
    tkernel.check_widths(spec.num_heads, 320, 256)
    tkernel.check_widths(spec.num_heads, dq, 256)
    # past 576/512 the wide forms take up to 1152/1024 (the built widths 1152/1024)
    tkernel.check_widths(spec.num_heads, 640, dv)
    tkernel.check_widths(spec.num_heads, 1152, 1024)
    assert tkernel.built_widths(640, dv) == (1152, 1024)
    assert tkernel.built_widths(dq, dv) == (576, 512)
    for bad in ((heads + 4, dq, dv), (heads, 1280, dv), (heads, dq, 640), (heads, 320, 384),
                (heads, dq, 200), (heads, 1152, 1152)):
        with pytest.raises(ValueError, match="H % 8 == 0, Dq <= 1152 and v_dim <= 1024"):
            tkernel.check_widths(*bad)


@pytest.mark.parametrize("heads", [32, 128])
def test_grouped_reference_matches_jax_pallas(heads):
    """``sparse_mla_grouped_reference``, the kernels' decomposition (heads
    padded with zeros to whole groups of 64, one group at a time, dkv summed
    over the groups in the kernels' order), against the Pallas kernels in
    interpret mode, values and gradients, float32 at this file's 2e-4: the
    padded heads add exactly nothing. At 32 heads one group of 32 real and 32
    padded rows; at 128 two whole groups."""
    S, Sk, T = 24, 24, 12
    rng = np.random.default_rng(heads)
    q = rng.standard_normal((S, heads, DQ)).astype(np.float32)
    _, kv, idx = _case(5, S, Sk, T)
    idx[4] = Sk
    ct = rng.standard_normal((S, heads, DV)).astype(np.float32)
    scale = DQ ** -0.5

    @jax.jit
    def j_fwd_grads(q_, kv_):
        def f(a, b):
            out = j_pallas_attn(a, b, jnp.asarray(idx), scale, DV, chunk=8, block_t=128)
            return jnp.sum(out * ct), out

        (_, out), grads = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(q_, kv_)
        return out, grads

    want, (want_dq, want_dkv) = j_fwd_grads(jnp.asarray(q), jnp.asarray(kv))
    tq, tkv, tidx = torch.from_numpy(q), torch.from_numpy(kv), torch.from_numpy(idx)
    out, lse, dq, dkv = tkernel.sparse_mla_grouped_reference(tq, tkv, tidx, scale, DV,
                                                             do=torch.from_numpy(ct))
    assert out.shape == (S, heads, DV) and lse.shape == (S, heads) and dq.shape == q.shape
    np.testing.assert_allclose(_np(out), np.asarray(want), atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(_np(dq), np.asarray(want_dq), atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(_np(dkv), np.asarray(want_dkv), atol=2e-4, rtol=2e-4)
    assert float(out[4].abs().max()) == 0.0 and float(dq[4].abs().max()) == 0.0
    # the same values as the ungrouped plain versions, up to summation order
    ref_out, ref_lse = tkernel.sparse_mla_attention_reference(tq, tkv, tidx, scale, DV)
    np.testing.assert_allclose(_np(out), _np(ref_out), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(_np(lse), _np(ref_lse), atol=1e-6, rtol=1e-6)


def test_wide_grouped_reference_matches_jax_pallas():
    """``sparse_mla_grouped_reference`` at the wide widths Dq 1152 / v_dim
    1024 follows the wide K5b's decomposition: groups of ``WIDE_HEADS`` = 16
    heads, unpadded, each group's per-slot dkv rows added in ascending order.
    At 24 heads that is one whole group and one of 8. Values and gradients
    against the Pallas kernels in interpret mode at the same widths, float32
    at 2e-4 (the tolerance of ``test_padded_widths_match_jax_pallas``), with
    a token that selected nothing (out and dq 0)."""
    S, Sk, T, heads, dq_w, dv = 24, 24, 12, 24, tkernel.DQ_WIDE, tkernel.DV_WIDE
    assert tkernel.WIDE_HEADS == 16 and heads % tkernel.WIDE_HEADS == 8
    rng = np.random.default_rng(1152)
    q = rng.standard_normal((S, heads, dq_w)).astype(np.float32)
    kv = rng.standard_normal((Sk, dq_w)).astype(np.float32)
    _, _, idx = _case(7, S, Sk, T)
    idx[5] = Sk
    ct = rng.standard_normal((S, heads, dv)).astype(np.float32)
    scale = dq_w ** -0.5

    @jax.jit
    def j_fwd_grads(q_, kv_):
        def f(a, b):
            out = j_pallas_attn(a, b, jnp.asarray(idx), scale, dv, chunk=8, block_t=128)
            return jnp.sum(out * ct), out

        (_, out), grads = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(q_, kv_)
        return out, grads

    want, (want_dq, want_dkv) = j_fwd_grads(jnp.asarray(q), jnp.asarray(kv))
    tq, tkv, tidx = torch.from_numpy(q), torch.from_numpy(kv), torch.from_numpy(idx)
    out, lse, dq, dkv = tkernel.sparse_mla_grouped_reference(tq, tkv, tidx, scale, dv,
                                                             do=torch.from_numpy(ct))
    assert out.shape == (S, heads, dv) and lse.shape == (S, heads) and dq.shape == q.shape
    assert dkv.shape == kv.shape
    np.testing.assert_allclose(_np(out), np.asarray(want), atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(_np(dq), np.asarray(want_dq), atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(_np(dkv), np.asarray(want_dkv), atol=2e-4, rtol=2e-4)
    assert float(out[5].abs().max()) == 0.0 and float(dq[5].abs().max()) == 0.0
    # the groups' dkv rows, added in order, are the plain backward's up to
    # summation order in float32
    ref_dq, ref_dkv = tkernel.sparse_mla_backward_reference(tq, tkv, tidx, out, lse,
                                                            torch.from_numpy(ct), scale, dv)
    np.testing.assert_allclose(_np(dq), _np(ref_dq), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(_np(dkv), _np(ref_dkv), atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# (c) indexer, rope, norms, dense MLA
# ---------------------------------------------------------------------------

def _indexer_case():
    rng = np.random.default_rng(3)
    S, Hi, Di = 33, 2, 8
    q = rng.standard_normal((S, Hi, Di)).astype(np.float32)
    k = rng.standard_normal((S, Di)).astype(np.float32)
    w = rng.standard_normal((S, Hi)).astype(np.float32)
    # two segments [0, 20) and [20, 32), then one padding row that selects nothing
    pos = np.concatenate([np.arange(20), np.arange(12), [0]]).astype(np.int32)
    tok = np.arange(S, dtype=np.int32)
    ks, ke = tok - pos, tok + 1
    ke[-1] = 0
    return q, k, w, ks, ke


@pytest.mark.parametrize("topk,chunk", [(16, 16), (40, 1024)])
def test_topk_indices_select_the_same_sets_as_jax(topk, chunk):
    """Each row's indices as sorted sets (the order among ties is no part of
    the contract), the sentinel count, causality within the segment."""
    q, k, w, ks, ke = _indexer_case()
    S = q.shape[0]
    want = np.asarray(jsparse.mla_topk_indices(*map(jnp.asarray, (q, k, w, ks, ke)), topk,
                                               chunk=chunk))
    got = tsparse.mla_topk_indices(*map(torch.from_numpy, (q, k, w, ks, ke)), topk, chunk=chunk)
    assert got.dtype == torch.int32 and got.shape == (S, topk)
    got = got.numpy()
    for t in range(S):
        assert sorted(got[t]) == sorted(want[t]), t
        real = got[t][got[t] < S]
        assert (real >= ks[t]).all() and (real < ke[t]).all()
        assert len(real) == min(topk, max(ke[t] - ks[t], 0)) == len(np.unique(real))
    assert (got[-1] == S).all()
    with pytest.raises(NotImplementedError, match="approx"):
        tsparse.mla_topk_indices(*map(torch.from_numpy, (q, k, w, ks, ke)), topk,
                                 method="approx")


def test_topk_thresholds_match_jax():
    """The k-th largest valid logit per token, rtol 1e-5; -1e30 where fewer
    than topk entries are valid."""
    q, k, w, ks, ke = _indexer_case()
    want = np.asarray(jsparse.mla_topk_thresholds(*map(jnp.asarray, (q, k, w, ks, ke)), 7,
                                                  chunk=8))
    got = tsparse.mla_topk_thresholds(*map(torch.from_numpy, (q, k, w, ks, ke)), 7, chunk=8)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert float(got[0]) == np.float32(-1e30) and float(got[-1]) == np.float32(-1e30)


@pytest.mark.parametrize("ndim", [2, 3])
def test_interleaved_rope_matches_jax(ndim):
    rng = np.random.default_rng(5)
    shape = (11, 3, 8) if ndim == 3 else (11, 8)
    x = rng.standard_normal(shape).astype(np.float32)
    pos = rng.integers(0, 500, 11).astype(np.int32)
    inv = np.asarray(jlayers.rope_frequencies(8, 1e4))
    want = jsparse.interleaved_rope(jnp.asarray(x), jnp.asarray(pos), jnp.asarray(inv))
    got = tsparse.interleaved_rope(torch.from_numpy(x), torch.from_numpy(pos),
                                   torch.from_numpy(inv))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("bias", [True, False])
def test_layer_norm_matches_jax(bias):
    rng = np.random.default_rng(6)
    x = rng.standard_normal((5, 7, 16)).astype(np.float32) * 3 + 1
    w = rng.standard_normal(16).astype(np.float32)
    b = rng.standard_normal(16).astype(np.float32) if bias else None
    want = jlayers.layer_norm(jnp.asarray(x), jnp.asarray(w), None if b is None else jnp.asarray(b))
    got = tlayers.layer_norm(torch.from_numpy(x), torch.from_numpy(w),
                             None if b is None else torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)


def test_dense_mla_attention_matches_jax_values_and_grads():
    """Two segments and a padded tail; out at 1e-4 and the gradients at 2e-3
    (both sides round the products' inputs to bf16 and sum in f32)."""
    rng = np.random.default_rng(7)
    S = 29
    q = rng.standard_normal((S, 4, 40)).astype(np.float32)
    kv = rng.standard_normal((S, 40)).astype(np.float32)
    seg = np.array([1] * 12 + [2] * 13 + [0] * 4, np.int32)
    ct = rng.standard_normal((S, 4, 32)).astype(np.float32)

    def f(q_, kv_):
        return jnp.sum(jsparse.dense_mla_attention(q_, kv_, jnp.asarray(seg), 0.2, 32) * ct)

    want = jsparse.dense_mla_attention(jnp.asarray(q), jnp.asarray(kv), jnp.asarray(seg), 0.2, 32)
    want_dq, want_dkv = jax.grad(f, argnums=(0, 1))(jnp.asarray(q), jnp.asarray(kv))
    tq, tkv = torch.from_numpy(q).requires_grad_(), torch.from_numpy(kv).requires_grad_()
    out = tsparse.dense_mla_attention(tq, tkv, torch.from_numpy(seg), 0.2, 32)
    dq, dkv = torch.autograd.grad((out * torch.from_numpy(ct)).sum(), (tq, tkv))
    np.testing.assert_allclose(_np(out), np.asarray(want), atol=1e-4, rtol=1e-4)
    assert float(out[-1].abs().max()) == 0.0
    np.testing.assert_allclose(_np(dq), np.asarray(want_dq), atol=2e-3, rtol=2e-3)
    np.testing.assert_allclose(_np(dkv), np.asarray(want_dkv), atol=2e-3, rtol=2e-3)


# ---------------------------------------------------------------------------
# (d) MoE routing and expert products
# ---------------------------------------------------------------------------

def _router_case(t=24, d=16, e=8, seed=8):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((t, d)).astype(np.float32)
    rw = rng.standard_normal((d, e)).astype(np.float32) * 0.5
    return rng, x, rw


ROUTINGS = {
    "softmax": dict(),
    "softmax_unnormed_bias": dict(norm_topk_prob=False, router_b=True),
    "softmax_topk": dict(softmax_topk=True, router_b=True),
    "sigmoid_noaux": dict(sigmoid_noaux=True, correction_bias=True, routed_scaling=2.5),
    "sigmoid_groups": dict(sigmoid_noaux=True, correction_bias=True, n_group=4, topk_group=2,
                           norm_topk_prob=False),
}


@pytest.mark.parametrize("name", sorted(ROUTINGS))
@pytest.mark.parametrize("forced", [False, True])
def test_route_topk_matches_jax(name, forced):
    """Expert ids exactly; weights, load-balance aux and entropy at 1e-5. With
    ``forced``, half the tokens replay a recorded selection."""
    rng, x, rw = _router_case()
    kw = dict(ROUTINGS[name])
    if kw.pop("router_b", False):
        kw["router_b"] = rng.standard_normal(8).astype(np.float32)
    if kw.pop("correction_bias", False):
        kw["correction_bias"] = rng.standard_normal(8).astype(np.float32) * 0.3
    if forced:
        f = np.stack([rng.permutation(8)[:2] for _ in range(24)]).astype(np.int32)
        f[::2] = -1
        kw["forced_experts"] = f

    def conv(fn):
        return {k: (fn(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}

    want = jmoe.route_topk(jnp.asarray(x), jnp.asarray(rw), 2, **conv(jnp.asarray))
    got = tmoe.route_topk(torch.from_numpy(x), torch.from_numpy(rw), 2, **conv(torch.from_numpy))
    assert got.expert_ids.dtype == torch.int32
    np.testing.assert_array_equal(got.expert_ids.numpy(), np.asarray(want.expert_ids))
    np.testing.assert_allclose(got.weights.numpy(), np.asarray(want.weights), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(got.load_balance_loss), float(want.load_balance_loss),
                               rtol=1e-5)
    np.testing.assert_allclose(float(got.router_entropy), float(want.router_entropy), rtol=1e-5)


@pytest.mark.parametrize("sigmoid", [False, True])
def test_moe_mlp_matches_jax_values_and_grads(sigmoid):
    """Output and the gradients of x, the router and the three expert stacks
    (rtol = atol = 2e-5, f32) with an expert that no token chooses: its router
    column is pushed far down, so its group is empty and its gradients are 0."""
    rng, x, rw = _router_case(t=20)
    e, d, m = 8, 16, 12
    wg = rng.standard_normal((e, d, m)).astype(np.float32) * 0.3
    wu = rng.standard_normal((e, d, m)).astype(np.float32) * 0.3
    wd = rng.standard_normal((e, m, d)).astype(np.float32) * 0.3
    ct = rng.standard_normal((20, d)).astype(np.float32)
    kw = dict(sigmoid_noaux=True, routed_scaling=2.5) if sigmoid else {}
    push = np.zeros(e, np.float32)
    push[5] = -100.0  # expert 5 is never chosen

    def j_loss(x_, rw_, wg_, wu_, wd_):
        extra = (dict(correction_bias=jnp.asarray(push)) if sigmoid
                 else dict(router_b=jnp.asarray(push)))
        out, r = jmoe.moe_mlp(x_, rw_, wg_, wu_, wd_, 2, **kw, **extra)
        return jnp.sum(out * ct), (out, r)

    (_, (want, want_r)), want_g = jax.value_and_grad(j_loss, argnums=(0, 1, 2, 3, 4),
                                                     has_aux=True)(
        *map(jnp.asarray, (x, rw, wg, wu, wd)))
    leaves = [torch.from_numpy(a.copy()).requires_grad_() for a in (x, rw, wg, wu, wd)]
    extra = (dict(correction_bias=torch.from_numpy(push)) if sigmoid
             else dict(router_b=torch.from_numpy(push)))
    out, r = tmoe.moe_mlp(*leaves, 2, **kw, **extra)
    grads = torch.autograd.grad((out * torch.from_numpy(ct)).sum(), leaves)
    assert 5 not in r.expert_ids.numpy()
    np.testing.assert_array_equal(r.expert_ids.numpy(), np.asarray(want_r.expert_ids))
    np.testing.assert_allclose(_np(out), np.asarray(want), rtol=2e-5, atol=2e-5)
    for name, g, w in zip(("x", "router", "gate", "up", "down"), grads, want_g):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=2e-5, atol=2e-5, err_msg=name)
    assert float(grads[2][5].abs().max()) == 0.0 == float(grads[4][5].abs().max())


def test_moe_mlp_raises_for_what_other_families_need():
    """The expert-parallel mesh still raises; per-expert LoRA runs since its
    slice (against JAX's two extra ragged products here, float32 at 2e-5;
    and through every family in tests/test_torch_lora.py); Nemotron-H's
    non-gated experts over a latent input (``w_gate=None, x_experts``) run
    since its slice (held against JAX in tests/test_torch_nemotron_h.py) and
    give the latent width."""
    x, rw = torch.zeros(4, 8), torch.zeros(8, 4)
    w, wd = torch.zeros(4, 8, 6), torch.zeros(4, 6, 8)
    rng = np.random.default_rng(12)
    arrs = [rng.standard_normal(sh).astype(np.float32) * 0.3
            for sh in ((4, 8), (8, 4), (4, 8, 6), (4, 8, 6), (4, 6, 8))]
    ad = {k: rng.standard_normal(sh).astype(np.float32) * 0.3 for k, sh in (
        ("moe_gate_a", (4, 8, 2)), ("moe_gate_b", (4, 2, 6)), ("moe_up_a", (4, 8, 2)),
        ("moe_up_b", (4, 2, 6)), ("moe_down_a", (4, 6, 2)), ("moe_down_b", (4, 2, 8)))}
    want, _ = jmoe.moe_mlp(*map(jnp.asarray, arrs), 2,
                           lora={k: jnp.asarray(v) for k, v in ad.items()}, lora_scale=1.5)
    got, _ = tmoe.moe_mlp(*map(torch.from_numpy, arrs), 2,
                          lora={k: torch.from_numpy(v) for k, v in ad.items()}, lora_scale=1.5)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=2e-5, atol=2e-5)
    plain, _ = tmoe.moe_mlp(*map(torch.from_numpy, arrs), 2)
    assert float((plain - got).abs().max()) > 1e-3
    out, _ = tmoe.moe_mlp(x, rw, None, torch.zeros(4, 3, 6), torch.zeros(4, 6, 3), 2,
                          x_experts=torch.zeros(4, 3))
    assert out.shape == (4, 3)
    with pytest.raises(NotImplementedError, match="multi-card"):
        tmoe.set_ep_mesh(None)
    assert tmoe.grouped_product_impl(x) == "loop"


@pytest.mark.parametrize("dq_w,dv", [(320, 256), (1152, 1024)])
def test_padded_widths_match_jax_pallas(dq_w, dv):
    """The wrappers' column padding (``fwd_padded``, ``bwd_padded``) run
    around the plain versions at ``Dq`` 320 and ``v_dim`` 256 (q and kv
    padded to 576 columns, do to 512, the call made at v_dim 512, out sliced
    to 256 and dq, dkv to 320), and the wide forms' widths 1152 / 1024 (run
    as they are), against the Pallas kernels in interpret mode at the
    unpadded widths, values and gradients, float32 at 2e-4: the zero columns
    add nothing to the scores, to dP or to dkv."""
    S, Sk, T, heads = 24, 24, 12, 16
    rng = np.random.default_rng(17)
    q = rng.standard_normal((S, heads, dq_w)).astype(np.float32)
    kv = rng.standard_normal((Sk, dq_w)).astype(np.float32)
    _, _, idx = _case(6, S, Sk, T)
    idx[3] = Sk
    ct = rng.standard_normal((S, heads, dv)).astype(np.float32)
    scale = dq_w ** -0.5

    @jax.jit
    def j_fwd_grads(q_, kv_):
        def f(a, b):
            out = j_pallas_attn(a, b, jnp.asarray(idx), scale, dv, chunk=8, block_t=128)
            return jnp.sum(out * ct), out

        (_, out), grads = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(q_, kv_)
        return out, grads

    want, (want_dq, want_dkv) = j_fwd_grads(jnp.asarray(q), jnp.asarray(kv))
    tq, tkv, tidx = torch.from_numpy(q), torch.from_numpy(kv), torch.from_numpy(idx)
    out, lse = tkernel.fwd_padded(tkernel.sparse_mla_attention_reference, tq, tkv, tidx, scale,
                                  dv)
    dq, dkv = tkernel.bwd_padded(tkernel.sparse_mla_backward_reference, tq, tkv, tidx, out, lse,
                                 torch.from_numpy(ct), scale, dv)
    assert out.shape == (S, heads, dv) and dq.shape == q.shape and dkv.shape == kv.shape
    np.testing.assert_allclose(_np(out), np.asarray(want), atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(_np(dq), np.asarray(want_dq), atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(_np(dkv), np.asarray(want_dkv), atol=2e-4, rtol=2e-4)
    assert float(out[3].abs().max()) == 0.0 and float(dq[3].abs().max()) == 0.0
    tkernel.check_widths(heads, dq_w, dv)

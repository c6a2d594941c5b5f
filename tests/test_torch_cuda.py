"""The port's CUDA kernels against their plain PyTorch versions on the card,
at small shapes with both supported head dims. These need an NVIDIA GPU
(the kernels have no CPU mode) and skip elsewhere; on the machine with the
card: ``python -m pytest tests/test_torch_cuda.py -q --noconftest`` (the
repo conftest sets up JAX, which these tests do not use).

Tolerance: 1e-2 absolute + 1e-2 relative against the plain version in
float32 (bf16 keeps 8 significant bits; each kernel rounds its output once,
K1 also its probabilities); the KV append must be exact.
"""

import pytest
import torch

from prime_rl_tpu_torch.ops import _build
from prime_rl_tpu_torch.ops.decode_attention import (
    decode_paged_attention,
    decode_paged_attention_reference,
)
from prime_rl_tpu_torch.ops.decode_qkv import decode_qkv_prep, decode_qkv_prep_reference
from prime_rl_tpu_torch.ops.flash_attention import flash_attention_reference, flash_attention_with_lse

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.Generator(device="cuda").manual_seed(0)


def _bf16(gen, *shape, scale=1.0):
    return (torch.randn(shape, device="cuda", generator=gen) * scale).to(torch.bfloat16)


def _assert_close(got, ref):
    torch.testing.assert_close(got.float(), ref.float(), atol=1e-2, rtol=1e-2)


@pytest.mark.parametrize("hd", [64, 128])
def test_flash_attn_fwd_matches_plain(gen, hd):
    b, l, nh, nkv = 2, 192, 4, 2
    q, k, v = _bf16(gen, b, l, nh, hd), _bf16(gen, b, l, nkv, hd), _bf16(gen, b, l, nkv, hd)
    seg = torch.zeros(b, l, dtype=torch.int32, device="cuda")
    seg[0, :70], seg[0, 70:150], seg[1, :100] = 1, 2, 1
    before = _build.launches["flash_attn_fwd"]
    out, lse = flash_attention_with_lse(q, k, v, seg, seg, causal=True)
    assert _build.launches["flash_attn_fwd"] == before + 1
    ref_out, ref_lse = flash_attention_reference(q.float(), k.float(), v.float(), seg, seg,
                                                 True, hd ** -0.5)
    _assert_close(out, ref_out)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=1e-4)


@pytest.mark.parametrize("hd,bias,partial", [(128, False, False), (64, True, True)])
def test_decode_qkv_prep_matches_plain(gen, hd, bias, partial):
    s, d, nh, nkv = 20, 256, 4, 2
    rot = hd // 2 if partial else hd
    args = (_bf16(gen, s, d), 1 + _bf16(gen, d, scale=0.1), _bf16(gen, d, nh * hd, scale=0.05),
            _bf16(gen, d, nkv * hd, scale=0.05), _bf16(gen, d, nkv * hd, scale=0.05),
            torch.randint(0, 4000, (s,), device="cuda", generator=gen, dtype=torch.int32),
            1.0 / (1e6 ** (torch.arange(0, rot, 2, device="cuda", dtype=torch.float32) / rot)))
    kw = dict(num_heads=nh, num_kv_heads=nkv, head_dim=hd, qk_norm=True,
              q_norm_w=1 + _bf16(gen, hd, scale=0.1), k_norm_w=1 + _bf16(gen, hd, scale=0.1),
              scaling=1.1)
    if bias:
        kw.update(q_bias=_bf16(gen, nh * hd), k_bias=_bf16(gen, nkv * hd),
                  v_bias=_bf16(gen, nkv * hd))
    got = decode_qkv_prep(*args, **kw)
    ref = decode_qkv_prep_reference(args[0].float(), *args[1:], **kw)
    for g, r in zip(got, ref):
        _assert_close(g, r)


@pytest.mark.parametrize("hd,group", [(128, 2), (64, 4)])
def test_decode_paged_attention_matches_plain(gen, hd, group):
    s, nkv, ps, p = 6, 2, 16, 8
    nh = nkv * group
    k_pool, v_pool = _bf16(gen, nkv, s * p + 1, ps, hd), _bf16(gen, nkv, s * p + 1, ps, hd)
    table = (1 + torch.arange(s * p, device="cuda", dtype=torch.int32)).reshape(s, p)
    table[-1] = 0  # an inactive slot on the null page
    lengths = torch.tensor([0, 1, 15, 16, 100, 3], dtype=torch.int32, device="cuda")
    q, k_new, v_new = _bf16(gen, s, nh, hd), _bf16(gen, s, nkv, hd), _bf16(gen, s, nkv, hd)
    k_ref, v_ref = k_pool.float(), v_pool.float()
    o, _, _ = decode_paged_attention(q, k_new, v_new, k_pool, v_pool, lengths, table)
    ref_o, k_ref, v_ref = decode_paged_attention_reference(
        q.float(), k_new.float(), v_new.float(), k_ref, v_ref, lengths, table)
    _assert_close(o[:-1], ref_o[:-1])
    assert torch.equal(k_pool.float(), k_ref) and torch.equal(v_pool.float(), v_ref)

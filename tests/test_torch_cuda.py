"""The port's CUDA kernels against their plain PyTorch versions on the card,
at small shapes with the supported head dims (64 to 512; K1/K2 at 320 and
512 and K4 at 384 and 512 among them) and widths (K5 at 576/512 and at the
wide 1152/1024 and 640/512). These need an NVIDIA GPU
(the kernels have no CPU mode) and skip elsewhere; on the machine with the
card: ``python -m pytest tests/test_torch_cuda.py -q --noconftest`` (the
repo conftest sets up JAX, which these tests do not use).

Tolerance: 1e-2 absolute + 1e-2 relative against the plain version in
float32 (bf16 keeps 8 significant bits; each kernel rounds its output once,
K1 also its probabilities), 1e-3 + 1e-4 relative on K1's lse (f32 sums in
another order); the KV append must be exact. K2a/K2b (also over
``chip_smoke.K1_EDGE_CASES``, with their tile counts) are held
against the plain backward on the same bf16 inputs (which rounds p and ds to
bf16 where the kernels do): 2e-2 absolute + 2e-2 relative, because a bf16
rounding of ds that flips by one step in the kernel moves a sum of up to 192
terms by more than one bf16 step of the result. K5a/K5b and the dkv reduction
are held against their plain versions on the same bf16 inputs at the same 2e-2
(K5a's lse within 1e-3), both kernels also over ``chip_smoke.K5B_EDGE_CASES``
with their tile counts and two launches bit-equal, and at 32 and 128 heads
(the wrappers' groups of 64 heads).
The window and sink forms of K1, K2a, K2b and K4 are held at the same
tolerances as their dense forms; the sinks' gradient (plain PyTorch beside the
kernels) against the plain backward's at 2e-2 relative to its norm.
"""

import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402  (its K1 edge cases and packings)
from prime_rl_tpu_torch.ops import _build
from prime_rl_tpu_torch.ops.decode_attention import (
    SPLIT_ROWS,
    decode_paged_attention,
    decode_paged_attention_reference,
    decode_rows_counts,
    decode_rows_visited,
    max_splits,
)
from prime_rl_tpu_torch.ops.decode_qkv import (
    decode_qkv_prep,
    decode_qkv_prep_reference,
    decode_qkv_tile_counts,
    decode_qkv_tiles_visited,
)
from prime_rl_tpu_torch.ops.flash_attention import dkv_tiles as dkv_tiles_of
from prime_rl_tpu_torch.ops.flash_attention import dq_tiles as dq_tiles_of
from prime_rl_tpu_torch.ops.flash_attention import (
    _delta,
    _fwd,
    flash_attention,
    flash_attention_backward,
    flash_attention_backward_reference,
    flash_attention_dkv,
    flash_attention_dkv_reference,
    flash_attention_dq,
    flash_attention_dq_reference,
    flash_attention_reference,
    flash_attention_with_lse,
    flash_bwd_dkv_tiles_visited,
    flash_bwd_tile_counts,
    flash_tile_counts,
    flash_tiles_visited,
    fwd_tiles,
    sinks_grad,
)

from prime_rl_tpu_torch.ops import sparse_mla_kernel as mla

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


@pytest.mark.parametrize("hd", [64, 128, 256])
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


@pytest.mark.parametrize("case", chip_smoke.K1_EDGE_CASES, ids=lambda c: c[0])
def test_flash_attn_fwd_cases_match_plain(gen, case):
    """K1 over ``chip_smoke.K1_EDGE_CASES``: lengths that are no multiple of
    the 128-row tile, the cross-block form, a fully padded row, many short
    segments (tiles skipped), a segment that ends mid-tile, GQA groups 1, 2
    and 8, both head dims, window 128 with and without sinks: out and lse
    against the plain version, padding rows out 0 and lse -1e30 (or the
    sink), one launch a call, two launches on the same inputs give equal bits,
    and the kv tiles the kernel counts are the skip rule's."""
    _, b, lq, lk, nh, nkv, hd, q_lens, kv_lens, causal, window, with_sinks = case
    q, k, v = _bf16(gen, b, lq, nh, hd), _bf16(gen, b, lk, nkv, hd), _bf16(gen, b, lk, nkv, hd)
    seg_q = chip_smoke.packed_segments(b, lq, q_lens, "cuda")[0]
    seg_kv = seg_q if kv_lens is None else chip_smoke.packed_segments(b, lk, kv_lens, "cuda")[0]
    sinks = torch.randn(nh, device="cuda", generator=gen) if with_sinks else None
    before = _build.launches["flash_attn_fwd"]
    out, lse = _fwd(q, k, v, seg_q, seg_kv, causal, None, window=window, sinks=sinks)
    out2, lse2 = _fwd(q, k, v, seg_q, seg_kv, causal, None, window=window, sinks=sinks)
    torch.cuda.synchronize()
    assert _build.launches["flash_attn_fwd"] == before + 2
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    ref_out, ref_lse = flash_attention_reference(q.float(), k.float(), v.float(), seg_q, seg_kv,
                                                 causal, hd ** -0.5, window, sinks)
    _assert_close(out, ref_out)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=1e-4)
    pad = (seg_q == 0)[:, None, :].expand_as(lse)
    want = sinks[None, :, None].expand_as(lse)[pad] if with_sinks else torch.full_like(
        lse[pad], -1e30)
    assert torch.equal(lse[pad], want)
    assert bool((out[seg_q == 0] == 0).all())
    counts = flash_tile_counts(q, k, v, seg_q, seg_kv, causal, window, sinks)
    visited = flash_tiles_visited(seg_q, seg_kv, causal, window,
                                  *fwd_tiles(hd)).sum(-1, dtype=torch.int32)
    assert torch.equal(counts[..., 0], visited[:, None].expand_as(counts[..., 0]))


def _packed_seg(b, l):
    seg = torch.zeros(b, l, dtype=torch.int32, device="cuda")
    seg[0, : l // 3], seg[0, l // 3: l - 40] = 1, 2  # two segments and a padded tail
    seg[1, : l // 2] = 1
    return seg


@pytest.mark.parametrize("hd,nh,nkv,l", [(64, 4, 2, 192), (128, 4, 2, 192), (128, 2, 2, 200),
                                         (256, 16, 2, 200)])
def test_flash_attn_bwd_matches_plain(gen, hd, nh, nkv, l):
    """K2a and K2b (GQA 2:1 and 1:1, a ragged last tile) against the plain
    backward; rows of padding carry a non-zero cotangent and must give dq = 0."""
    b = 2
    q, k, v = _bf16(gen, b, l, nh, hd), _bf16(gen, b, l, nkv, hd), _bf16(gen, b, l, nkv, hd)
    do = _bf16(gen, b, l, nh, hd)
    seg = _packed_seg(b, l)
    out, lse = flash_attention_with_lse(q, k, v, seg, seg, causal=True)
    before = (_build.launches["flash_attn_bwd_dq"], _build.launches["flash_attn_bwd_dkv"])
    got = flash_attention_backward(q, k, v, seg, seg, out, lse, do, None, True, hd ** -0.5)
    torch.cuda.synchronize()
    assert _build.launches["flash_attn_bwd_dq"] == before[0] + 1
    assert _build.launches["flash_attn_bwd_dkv"] == before[1] + 1
    ref = flash_attention_backward_reference(q, k, v, seg, seg, out, lse, do, None, True,
                                             hd ** -0.5)
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        assert torch.isfinite(g.float()).all(), name
        torch.testing.assert_close(g.float(), r.float(), atol=2e-2, rtol=2e-2, msg=name)
    assert (got[0][seg == 0] == 0).all()


@pytest.mark.parametrize("case", chip_smoke.K1_EDGE_CASES, ids=lambda c: c[0])
def test_flash_attn_bwd_cases_match_plain(gen, case):
    """K2a and K2b over ``chip_smoke.K1_EDGE_CASES`` (lse from K1; the
    cross-block cases, not causal, with an lse cotangent folded into delta):
    dq, dk and dv against the plain versions, padding rows dq = 0, one launch
    each a call, two launches on the same inputs give equal bits, and the
    tiles the kernels count are the skip rules'."""
    _, b, lq, lk, nh, nkv, hd, q_lens, kv_lens, causal, window, with_sinks = case
    q, k, v = _bf16(gen, b, lq, nh, hd), _bf16(gen, b, lk, nkv, hd), _bf16(gen, b, lk, nkv, hd)
    do = _bf16(gen, b, lq, nh, hd)
    seg_q = chip_smoke.packed_segments(b, lq, q_lens, "cuda")[0]
    seg_kv = seg_q if kv_lens is None else chip_smoke.packed_segments(b, lk, kv_lens, "cuda")[0]
    sinks = torch.randn(nh, device="cuda", generator=gen) if with_sinks else None
    dlse = None if causal else torch.randn(b, nh, lq, device="cuda", generator=gen)
    out, lse = _fwd(q, k, v, seg_q, seg_kv, causal, None, window=window, sinks=sinks)
    args = (q, k, v, seg_q, seg_kv, lse, _delta(out, do, dlse), do, causal, hd ** -0.5, window)
    before = dict(_build.launches)
    runs = [(flash_attention_dq(*args), *flash_attention_dkv(*args)) for _ in range(2)]
    torch.cuda.synchronize()
    for name in ("flash_attn_bwd_dq", "flash_attn_bwd_dkv"):
        assert _build.launches[name] == before.get(name, 0) + 2, name
    for a, c in zip(*runs):
        assert torch.equal(a, c)
    refs = (flash_attention_dq_reference(*args), *flash_attention_dkv_reference(*args))
    for name, g, r in zip(("dq", "dk", "dv"), runs[0], refs):
        assert torch.isfinite(g.float()).all(), name
        torch.testing.assert_close(g.float(), r.float(), atol=2e-2, rtol=2e-2, msg=name)
    assert (runs[0][0][seg_q == 0] == 0).all()
    dq_tiles, dkv_tiles = flash_bwd_tile_counts(*args[:9], window)
    for got, rule in ((dq_tiles, flash_tiles_visited(seg_q, seg_kv, causal, window,
                                                     *dq_tiles_of(hd))),
                      (dkv_tiles, flash_bwd_dkv_tiles_visited(seg_q, seg_kv, causal, window,
                                                              *dkv_tiles_of(hd)))):
        want = rule.sum(-1, dtype=torch.int32)
        assert torch.equal(got[..., 0], want[:, None].expand_as(got[..., 0]))


def test_flash_attn_bwd_cross_block_with_lse_cotangent(gen):
    """Lq != Lkv, non-causal, gradients of both out and lse through autograd."""
    b, lq, lk, nh, nkv, hd = 2, 128, 192, 4, 2, 128
    q, k, v = _bf16(gen, b, lq, nh, hd), _bf16(gen, b, lk, nkv, hd), _bf16(gen, b, lk, nkv, hd)
    seg_q = torch.ones(b, lq, dtype=torch.int32, device="cuda")
    seg_kv = torch.ones(b, lk, dtype=torch.int32, device="cuda")
    seg_q[1, 100:], seg_kv[1, 150:] = 0, 0
    do, dlse = _bf16(gen, b, lq, nh, hd), torch.randn(b, nh, lq, device="cuda", generator=gen)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out, lse = flash_attention_with_lse(*leaves, seg_q, seg_kv, causal=False)
    got = torch.autograd.grad([out, lse], leaves, [do, dlse])
    ref = flash_attention_backward_reference(q, k, v, seg_q, seg_kv, out.detach(), lse.detach(),
                                             do, dlse, False, hd ** -0.5)
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        torch.testing.assert_close(g.float(), r.float(), atol=2e-2, rtol=2e-2, msg=name)


def test_flash_attention_backward_is_deterministic(gen):
    b, l, nh, nkv, hd = 2, 256, 4, 2, 128
    q, k, v = _bf16(gen, b, l, nh, hd), _bf16(gen, b, l, nkv, hd), _bf16(gen, b, l, nkv, hd)
    seg = _packed_seg(b, l)
    grads = []
    for _ in range(2):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        flash_attention(*leaves, seg).float().square().sum().backward()
        grads.append([t.grad for t in leaves])
    for a, c in zip(*grads):
        assert torch.equal(a, c)


@pytest.mark.parametrize("window,with_sinks", [(64, True), (100, False), (0, True)])
def test_flash_attn_window_and_sinks_match_plain(gen, window, with_sinks):
    """K1, K2a and K2b with a sliding window (one a tile wide, one that cuts
    tiles) and/or sinks, through the autograd Function: out, lse (a padding
    row's lse is its sink) and every gradient against the plain versions;
    the banded kernels launch once each."""
    b, l, nh, nkv, hd = 2, 320, 8, 2, 64
    q, k, v = _bf16(gen, b, l, nh, hd), _bf16(gen, b, l, nkv, hd), _bf16(gen, b, l, nkv, hd)
    do = _bf16(gen, b, l, nh, hd)
    seg = _packed_seg(b, l)
    sinks = torch.randn(nh, device="cuda", generator=gen) if with_sinks else None
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    if with_sinks:
        leaves.append(sinks.clone().requires_grad_())
    before = dict(_build.launches)
    out, lse = _fwd(*leaves[:3], seg, seg, True, None, window=window,
                    sinks=leaves[3] if with_sinks else None)
    grads = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    for name in ("flash_attn_fwd", "flash_attn_bwd_dq", "flash_attn_bwd_dkv"):
        assert _build.launches[name] == before.get(name, 0) + 1, name
    ref_out, ref_lse = flash_attention_reference(q.float(), k.float(), v.float(), seg, seg, True,
                                                 hd ** -0.5, window, sinks)
    _assert_close(out, ref_out)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=1e-4)
    pad = (seg == 0)[:, None, :].expand_as(lse)
    if with_sinks:  # a row that sees no key: its lse is the sink
        assert torch.equal(lse[pad], sinks[None, :, None].expand_as(lse)[pad])
    else:
        assert bool((lse[pad] < -1e29).all())
    ref = flash_attention_backward_reference(q, k, v, seg, seg, out.detach(), lse.detach(), do,
                                             None, True, hd ** -0.5, window)
    for name, g, r in zip(("dq", "dk", "dv"), grads, ref):
        assert torch.isfinite(g.float()).all(), name
        torch.testing.assert_close(g.float(), r.float(), atol=2e-2, rtol=2e-2, msg=name)
    if with_sinks:
        want = sinks_grad(sinks, ref_lse, _delta(ref_out, do, None))
        assert float((grads[3] - want).norm()) <= 2e-2 * float(want.norm())


@pytest.mark.parametrize("hd,bias,partial", [(128, False, False), (64, True, True),
                                              (32, False, True)])
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


@pytest.mark.parametrize("case", chip_smoke.K3_EDGE_CASES, ids=lambda c: c[0])
def test_decode_qkv_prep_cases_match_plain(gen, case):
    """K3 over ``chip_smoke.K3_EDGE_CASES`` (S of 1 to 256, head dims 32-128,
    rot < HD, biases with and without qk-norm, positions near 131071): two
    launches with equal bits against the plain version, and the weight tiles
    each block loaded (the kernel's count) equal to the tiling's mirror."""
    name, s, d, nh, nkv, hd, qk_norm, bias, rot, positions, use_yarn = case
    rope = dict(rot=rot)
    if use_yarn:
        from prime_rl_tpu_torch.models.base import get_spec
        from prime_rl_tpu_torch.models.qwen3 import rope_setup

        inv_freq, scaling = rope_setup(get_spec(chip_smoke.GPT_OSS), device="cuda")
        rope = dict(inv_freq=inv_freq, scaling=scaling)
    args, kw = chip_smoke.k3_inputs(gen, s, d, nh, nkv, hd, qk_norm=qk_norm, bias=bias,
                                    positions=positions, **rope)
    chip_smoke.k3_check(name, args, kw)
    chip_smoke.k3_tiles(name, args, kw)


@pytest.mark.parametrize("s,hd", [(130, 64), (256, 128), (200, 128)])
def test_decode_qkv_prep_large_s_matches_plain(gen, s, hd):
    """Row groups past 128 rows (the weights loaded again for each): every
    row against the plain version, one launch counted a call."""
    args, kw = chip_smoke.k3_inputs(gen, s, 512, 4, 2, hd, qk_norm=hd == 128, bias=hd == 64)
    before = _build.launches["decode_qkv_prep"]
    got = decode_qkv_prep(*args, **kw)
    torch.cuda.synchronize()
    assert _build.launches["decode_qkv_prep"] == before + 1
    for g, r in zip(got, decode_qkv_prep_reference(args[0].float(), *args[1:], **kw)):
        _assert_close(g, r)


def test_decode_qkv_prep_never_reads_rows_past_s(gen):
    """x a view of the first S rows of a buffer whose later rows are NaN: the
    kernel's map ends at S (TMA fills the rest of a box with zeros), so no
    NaN reaches the outputs, which equal the plain version's on the clean
    rows."""
    s, d = 7, 400
    args, kw = chip_smoke.k3_inputs(gen, s, d, 8, 2, 64, qk_norm=True, bias=True, rot=32)
    buf = torch.full((64, d), float("nan"), dtype=torch.bfloat16, device="cuda")
    buf[:s] = args[0]
    got = decode_qkv_prep(buf[:s], *args[1:], **kw)
    torch.cuda.synchronize()
    for g, r in zip(got, decode_qkv_prep_reference(args[0].float(), *args[1:], **kw)):
        assert torch.isfinite(g.float()).all()
        _assert_close(g, r)


@pytest.mark.parametrize("s", [1, 64, 65])
def test_decode_qkv_prep_loads_each_weight_tile_once(gen, s):
    """Up to 128 rows every weight tile is loaded exactly once a call, by the
    block the tiling gives it to; two launches give equal bits."""
    args, kw = chip_smoke.k3_inputs(gen, s, 1024, 16, 8, 128, qk_norm=True, bias=False)
    counts = decode_qkv_tile_counts(*args, **kw)
    want = decode_qkv_tiles_visited(s, 1024, (2048, 1024, 1024), counts.shape[2])
    assert torch.equal(counts, want.to(counts.device))
    assert int(counts.sum()) == 16 * 32
    first, second = decode_qkv_prep(*args, **kw), decode_qkv_prep(*args, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("hd,group", [(128, 2), (64, 4), (256, 8), (384, 4), (512, 1),
                                      (512, 8)])
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


@pytest.mark.parametrize("window,with_sinks", [(16, True), (20, False), (0, True)])
def test_decode_paged_attention_window_and_sinks_match_plain(gen, window, with_sinks):
    """K4 at gpt-oss's group of 8 and head dim 64: slots shorter than, equal
    to and longer than the window, a window start inside a page, sinks."""
    s, nkv, group, hd, ps, p = 7, 2, 8, 64, 16, 8
    nh = nkv * group
    k_pool, v_pool = _bf16(gen, nkv, s * p + 1, ps, hd), _bf16(gen, nkv, s * p + 1, ps, hd)
    table = (1 + torch.arange(s * p, device="cuda", dtype=torch.int32)).reshape(s, p)
    lengths = torch.tensor([0, 5, 15, 16, 37, 100, 127], dtype=torch.int32, device="cuda")
    q, k_new, v_new = _bf16(gen, s, nh, hd), _bf16(gen, s, nkv, hd), _bf16(gen, s, nkv, hd)
    sinks = torch.randn(nh, device="cuda", generator=gen) if with_sinks else None
    k_ref, v_ref = k_pool.float(), v_pool.float()
    before = _build.launches["decode_paged_attention"]
    o, _, _ = decode_paged_attention(q, k_new, v_new, k_pool, v_pool, lengths, table,
                                     window=window, sinks=sinks)
    torch.cuda.synchronize()
    assert _build.launches["decode_paged_attention"] == before + 1
    ref_o, k_ref, v_ref = decode_paged_attention_reference(
        q.float(), k_new.float(), v_new.float(), k_ref, v_ref, lengths, table, window=window,
        sinks=sinks)
    _assert_close(o, ref_o)
    assert torch.equal(k_pool.float(), k_ref) and torch.equal(v_pool.float(), v_ref)


@pytest.mark.parametrize("hd,group,ps,window,with_sinks", [
    (128, 2, 16, 0, False), (128, 2, 64, 0, False), (64, 8, 64, 0, True), (64, 8, 16, 128, True),
    (128, 8, 16, 300, False), (64, 1, 64, 300, True),
    # groups padded to a chunk (3, 5, 6) or cut into chunks of 8 and 4 (12)
    (128, 3, 16, 0, False), (128, 5, 64, 0, True), (128, 6, 32, 300, False),
    (128, 12, 16, 0, False), (128, 12, 64, 300, True), (64, 12, 64, 128, True),
    # head dim 256 (Qwen3-Next's group 8)
    (256, 8, 64, 0, False), (256, 8, 16, 300, True)])
def test_decode_paged_attention_split_k_matches_plain(gen, hd, group, ps, window, with_sinks):
    """Split-K over long contexts: up to 8 splits of ``SPLIT_ROWS`` rows,
    lengths at and next to the split and page boundaries, windows of one and
    two splits, sinks: the output against the plain version, the pools exact,
    two launches with equal bits, one launch counted a call, and the rows each
    work item read (the kernel's count) equal to the split rule's mirror."""
    s, nkv, p = 7, 2, 2048 // ps
    nh = nkv * group
    lengths = [0, 1, SPLIT_ROWS - 1, SPLIT_ROWS, SPLIT_ROWS + 1, 1000, 2047]
    q, k_new, v_new, k_pool, v_pool, lengths, table = chip_smoke.k4_inputs(
        gen, s, nh, nkv, hd, ps, p, lengths)
    sinks = torch.randn(nh, device="cuda", generator=gen) if with_sinks else None
    kw = dict(window=window, sinks=sinks)
    k_ref, v_ref = k_pool.float(), v_pool.float()
    k2, v2, k3, v3 = k_pool.clone(), v_pool.clone(), k_pool.clone(), v_pool.clone()
    before = _build.launches["decode_paged_attention"]
    o, _, _ = decode_paged_attention(q, k_new, v_new, k_pool, v_pool, lengths, table, **kw)
    o2, _, _ = decode_paged_attention(q, k_new, v_new, k2, v2, lengths, table, **kw)
    torch.cuda.synchronize()
    assert _build.launches["decode_paged_attention"] == before + 2
    assert torch.equal(o, o2) and torch.equal(k_pool, k2) and torch.equal(v_pool, v2)
    ref_o, k_ref, v_ref = decode_paged_attention_reference(
        q.float(), k_new.float(), v_new.float(), k_ref, v_ref, lengths, table, **kw)
    _assert_close(o, ref_o)
    assert torch.equal(k_pool.float(), k_ref) and torch.equal(v_pool.float(), v_ref)
    rows = decode_rows_counts(q, k_new, v_new, k3, v3, lengths, table, **kw)
    want = decode_rows_visited(lengths, window, SPLIT_ROWS, max_splits(p * ps))
    assert torch.equal(rows, want[:, None, :].expand_as(rows))


@pytest.mark.parametrize("window", [0, 100])
def test_decode_paged_attention_never_reads_rows_outside_the_window(gen, window):
    """A poisoned pool: NaN in every row of the slots' pages outside [lo, n)
    (below the window, the new token's row n and everything past it). The
    kernel reads none of them: its output is finite and equals the plain
    version's on a clean copy, and the rows it attends are left as they were."""
    s, nkv, group, hd, ps, p = 5, 2, 4, 128, 16, 64
    q, k_new, v_new, k_pool, v_pool, lengths, table = chip_smoke.k4_inputs(
        gen, s, nkv * group, nkv, hd, ps, p, [0, 17, 300, 700, 1000])
    k_ref, v_ref = k_pool.float(), v_pool.float()
    pos = torch.arange(p * ps, device="cuda")[None, :]
    n = lengths.long()[:, None]
    lo = (n + 1 - window).clamp(min=0) if window else torch.zeros_like(n)
    outside = ((pos < lo) | (pos >= n)).reshape(s, p, ps)  # [slot, page of the slot, row]
    pages = table.long()
    for pool in (k_pool, v_pool):
        pool[:, pages] = torch.where(outside[None, ..., None], float("nan"), pool[:, pages].float()
                                     ).to(pool.dtype)
    attended = ~outside
    k_before = k_pool[:, pages][:, attended].clone()
    o, _, _ = decode_paged_attention(q, k_new, v_new, k_pool, v_pool, lengths, table,
                                     window=window)
    torch.cuda.synchronize()
    assert torch.isfinite(o.float()).all()
    ref_o, _, _ = decode_paged_attention_reference(
        q.float(), k_new.float(), v_new.float(), k_ref, v_ref, lengths, table, window=window)
    _assert_close(o, ref_o)
    assert torch.equal(k_pool[:, pages][:, attended], k_before)
    new_rows = k_pool.view(nkv, -1, hd)[:, (pages.gather(1, n // ps) * ps + n % ps)[:, 0]]
    assert torch.equal(new_rows, k_new.transpose(0, 1))


def _sparse_case(gen, S, T):
    """q, kv, do and causal top-k-looking indices (token i selects min(T, i + 1)
    distinct rows of [0, i]; the rest of its row is the sentinel S)."""
    q, kv = _bf16(gen, S, mla.HEADS, mla.DQ), _bf16(gen, S, mla.DQ)
    do = _bf16(gen, S, mla.HEADS, mla.DV)
    score = torch.rand(S, S, device="cuda", generator=gen)
    pos = torch.arange(S, device="cuda")
    val, idx = torch.sort(torch.where(pos[None, :] <= pos[:, None], score, -1.0), dim=-1,
                          descending=True)
    idx = torch.where(val >= 0, idx, S)[:, :T].to(torch.int32)
    if T > S:
        idx = torch.nn.functional.pad(idx, (0, T - S), value=S)
    return q, kv, do, idx.contiguous()


@pytest.mark.parametrize("S,T", [(200, 100), (320, 512)])
def test_sparse_mla_kernels_match_plain(gen, S, T):
    """K5a, K5b and the dkv reduction through the autograd Function: ragged
    tiles, sentinels in every row (T > S), one token that selected nothing."""
    q, kv, do, idx = _sparse_case(gen, S, T)
    idx[5] = S
    scale = mla.DQ ** -0.5
    before = dict(_build.launches)
    leaves = [q.clone().requires_grad_(), kv.clone().requires_grad_()]
    out = mla.sparse_mla_attention(*leaves, idx, scale, mla.DV)
    dq, dkv = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    n = mla.bwd_launches(S, T)
    assert _build.launches["sparse_mla_fwd"] == before.get("sparse_mla_fwd", 0) + 1
    assert _build.launches["sparse_mla_bwd"] == before.get("sparse_mla_bwd", 0) + n
    assert _build.launches["sparse_mla_dkv_reduce"] == before.get("sparse_mla_dkv_reduce", 0) + n
    ref_out, ref_lse = mla.sparse_mla_attention_reference(q, kv, idx, scale, mla.DV)
    ref_dq, ref_dkv = mla.sparse_mla_backward_reference(q, kv, idx, out.detach(), ref_lse, do,
                                                        scale, mla.DV)
    for name, g, r in (("out", out, ref_out), ("dq", dq, ref_dq), ("dkv", dkv, ref_dkv)):
        assert torch.isfinite(g.float()).all(), name
        torch.testing.assert_close(g.float(), r.float(), atol=2e-2, rtol=2e-2, msg=name)
    assert (out[5] == 0).all() and (dq[5] == 0).all()


@pytest.mark.parametrize("heads", [32, 128])
def test_sparse_mla_kernels_match_plain_at_other_head_counts(gen, heads, monkeypatch):
    """K5a, K5b and the dkv reduction through the autograd Function at 32 heads
    (one group, 32 rows of zeros) and 128 (two groups), over several chunks
    (the chunk cut to 64 queries): one K5a launch a group of 64 heads, one K5b
    launch and reduction a chunk and group; out, dq and dkv within 2e-2 + 2e-2
    |ref| of the plain versions (the backward's over the same groups,
    ``chip_smoke.k5b_reference``), two runs bit-equal, dq 0 for a token that
    selected nothing."""
    S, T = 256, 128
    monkeypatch.setattr(mla, "BWD_SLOTS", 64 * 128)
    _, kv, _, idx = _sparse_case(gen, S, T)
    q, do = _bf16(gen, S, heads, mla.DQ), _bf16(gen, S, heads, mla.DV)
    idx[5] = S
    scale = mla.DQ ** -0.5
    groups = mla.padded_heads(heads) // mla.HEADS
    results = []
    for _ in range(2):
        before = dict(_build.launches)
        leaves = [q.clone().requires_grad_(), kv.clone().requires_grad_()]
        out = mla.sparse_mla_attention(*leaves, idx, scale, mla.DV)
        results.append((out, *torch.autograd.grad(out, leaves, do)))
        torch.cuda.synchronize()
        n = mla.bwd_launches(S, T, heads)
        assert n == 4 * groups
        assert _build.launches["sparse_mla_fwd"] == before.get("sparse_mla_fwd", 0) + groups
        assert _build.launches["sparse_mla_bwd"] == before.get("sparse_mla_bwd", 0) + n
        assert (_build.launches["sparse_mla_dkv_reduce"]
                == before.get("sparse_mla_dkv_reduce", 0) + n)
    for a, b in zip(*results):
        assert torch.equal(a, b)
    out, dq, dkv = results[0]
    assert out.shape == (S, heads, mla.DV) and dq.shape == q.shape
    ref_out, ref_lse = mla.sparse_mla_attention_reference(q, kv, idx, scale, mla.DV)
    # the plain backward over the kernels' groups of 64 heads: each group's
    # per-slot dkv rows rounded to bf16 before the f32 sum, as K5b writes them
    ref_dq, ref_dkv = chip_smoke.k5b_reference(q, kv, idx, out.detach(), ref_lse, do, scale)
    for name, g, r in (("out", out, ref_out), ("dq", dq, ref_dq), ("dkv", dkv, ref_dkv)):
        assert torch.isfinite(g.float()).all(), name
        torch.testing.assert_close(g.float(), r.float(), atol=2e-2, rtol=2e-2, msg=name)
    assert (out[5] == 0).all() and (dq[5] == 0).all()


@pytest.mark.parametrize("case", chip_smoke.K5B_EDGE_CASES, ids=lambda c: c[0])
def test_sparse_mla_backward_cases_match_plain(gen, case):
    """K5b and the dkv reduction over ``chip_smoke.K5B_EDGE_CASES``: T of 100
    and 2047, S = 1, a token that selected nothing, sentinels scattered inside
    a row (S, -1 and S + 7), a small Sk (every kv row selected by every
    token), several chunks: dq and dkv within 2e-2 + 2e-2 |ref| of the plain
    backward, two calls bit-equal, the kernel's tile counts equal to
    ``sparse_mla_bwd_tiles_visited``, dq 0 for the token that selected
    nothing (``chip_smoke.k5b_check``)."""
    name, S, Sk, T, layout, empty, slots = case
    q, kv, do, idx = chip_smoke.k5b_inputs(gen, S, Sk, T, layout, empty)
    before = _build.launches["sparse_mla_bwd"]
    chip_smoke.k5b_check(name, q, kv, do, idx, empty, slots)
    assert _build.launches["sparse_mla_bwd"] > before


_NARROW_CASES = [c + (64,) for c in chip_smoke.K5B_EDGE_CASES] + list(chip_smoke.K5_HEAD_CASES)


@pytest.mark.parametrize("seed", range(1, 11))
@pytest.mark.parametrize("case", _NARROW_CASES, ids=lambda c: c[0])
def test_sparse_mla_backward_cases_hold_over_many_draws(gen, case, seed):
    """The 576 K5b's edge and head cases over generator seeds 1 .. 10, each
    draw through ``chip_smoke.k5b_check`` (dq and dkv within the unchanged
    K5B_TOL, two calls bit-equal): while both sides rounded each slot's dkv
    row to bf16, a large row near a rounding boundary landed one bf16 step
    apart on a few draws (7 of 200 at seeds 1 .. 20), which one draw a case
    did not show; the f32 rows hold every draw."""
    name, S, Sk, T, layout, empty, slots, heads = case
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, kv, do, idx = chip_smoke.k5b_inputs(g, S, Sk, T, layout, empty, heads)
    chip_smoke.k5b_check(f"{name} (seed {seed})", q, kv, do, idx, empty, slots)


@pytest.mark.parametrize("case", chip_smoke.K5B_EDGE_CASES, ids=lambda c: c[0])
def test_sparse_mla_forward_cases_match_plain(gen, case):
    """K5a over ``chip_smoke.K5B_EDGE_CASES``: out within 2e-2 + 2e-2 |ref|
    and lse within 1e-3 of the plain forward, two launches bit-equal, the
    kernel's tiles of ``FWD_TILE`` slots equal to
    ``sparse_mla_bwd_tiles_visited(idx, Sk, FWD_TILE)``, out 0 and lse below
    -1e29 for the token that selected nothing (``chip_smoke.k5a_check``)."""
    name, S, Sk, T, layout, empty, _ = case
    q, kv, _, idx = chip_smoke.k5b_inputs(gen, S, Sk, T, layout, empty)
    before = _build.launches["sparse_mla_fwd"]
    out, lse, _, visited = chip_smoke.k5a_check(name, q, kv, idx, empty)
    assert _build.launches["sparse_mla_fwd"] == before + 2
    assert tuple(out.shape) == (S, mla.HEADS, mla.DV) and tuple(lse.shape) == (S, mla.HEADS)
    assert visited == int(mla.sparse_mla_bwd_tiles_visited(idx, Sk, mla.FWD_TILE).sum())


def test_sparse_mla_forward_tile_counts(gen):
    """``sparse_mla_fwd_tile_counts`` at a ragged causal shape: every token's
    visited tiles of ``FWD_TILE`` slots and its candidates as the mirror gives."""
    q, kv, _, idx = _sparse_case(gen, 300, 200)
    idx[3] = 300
    tiles = mla.sparse_mla_fwd_tile_counts(q, kv, idx, mla.DQ ** -0.5, mla.DV)
    visit = mla.sparse_mla_bwd_tiles_visited(idx, 300, mla.FWD_TILE)
    assert tiles[:, 0].tolist() == visit.sum(-1).tolist()
    assert tiles[:, 1].tolist() == [visit.shape[1]] * 300
    assert int(tiles[3, 0]) == 0


def test_sparse_mla_backward_is_deterministic_over_chunks(gen, monkeypatch):
    """Several chunks of queries (the chunk cut to 64): two runs give the same
    bits, and the same values as one chunk within the dkv rounding."""
    q, kv, do, idx = _sparse_case(gen, 256, 128)
    scale = mla.DQ ** -0.5
    out, lse = mla.sparse_mla_fwd(q, kv, idx, scale, mla.DV)
    whole = mla.sparse_mla_bwd(q, kv, idx, out, lse, do, scale, mla.DV)
    monkeypatch.setattr(mla, "BWD_SLOTS", 64 * 128)
    assert mla.bwd_launches(256, 128) == 4
    a = mla.sparse_mla_bwd(q, kv, idx, out, lse, do, scale, mla.DV)
    b = mla.sparse_mla_bwd(q, kv, idx, out, lse, do, scale, mla.DV)
    for x, y, w in zip(a, b, whole):
        assert torch.equal(x, y)
        torch.testing.assert_close(x.float(), w.float(), atol=2e-2, rtol=2e-2)


def test_sparse_mla_wrapper_raises_for_other_widths(gen):
    q, kv = _bf16(gen, 8, 8, 1280), _bf16(gen, 8, 1280)
    idx = torch.zeros(8, 4, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="H % 8 == 0, Dq <= 1152 and v_dim <= 1024"):
        mla.sparse_mla_attention(q, kv, idx, 0.1, 128)
    with pytest.raises(ValueError, match="got H = 12, Dq = 576"):
        mla.sparse_mla_attention(_bf16(gen, 8, 12, 576), _bf16(gen, 8, 576), idx, 0.1, 512)
    with pytest.raises(TypeError, match="bfloat16"):
        mla.sparse_mla_attention(torch.zeros(8, 64, 576, device="cuda"),
                                 torch.zeros(8, 576, device="cuda"), idx, 0.1, 512)


def test_padded_head_dim_flash_kernels_match_plain(gen):
    """K1, K2a and K2b at head dim 96 (zero-padded to 128 by the wrappers, the
    scale of 96, the results sliced back) against the plain versions at 96:
    the padding adds nothing."""
    b, l, nh, nkv, hd = 2, 200, 4, 2, 96
    q, k, v = _bf16(gen, b, l, nh, hd), _bf16(gen, b, l, nkv, hd), _bf16(gen, b, l, nkv, hd)
    do = _bf16(gen, b, l, nh, hd)
    seg = _packed_seg(b, l)
    before = dict(_build.launches)
    out, lse = flash_attention_with_lse(q, k, v, seg, seg, causal=True)
    got = flash_attention_backward(q, k, v, seg, seg, out, lse, do, None, True, hd ** -0.5)
    torch.cuda.synchronize()
    for name in ("flash_attn_fwd", "flash_attn_bwd_dq", "flash_attn_bwd_dkv"):
        assert _build.launches[name] == before.get(name, 0) + 1, name
    assert out.shape == q.shape
    ref_out, ref_lse = flash_attention_reference(q.float(), k.float(), v.float(), seg, seg,
                                                 True, hd ** -0.5)
    _assert_close(out, ref_out)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=1e-4)
    ref = flash_attention_backward_reference(q, k, v, seg, seg, out, lse, do, None, True,
                                             hd ** -0.5)
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        assert g.shape == r.shape, name
        torch.testing.assert_close(g.float(), r.float(), atol=2e-2, rtol=2e-2, msg=name)


def test_sparse_mla_kernels_match_plain_at_padded_widths(gen):
    """K5a and K5b at Dq 320 and v_dim 256 (q and kv zero-padded to 576
    columns, do to 512, the results sliced back) against the plain versions at
    those widths, within 2e-2."""
    S, T, heads, dq_w, dv = 200, 100, 16, 320, 256
    q, kv, do = _bf16(gen, S, heads, dq_w), _bf16(gen, S, dq_w), _bf16(gen, S, heads, dv)
    _, _, _, idx = _sparse_case(gen, S, T)
    scale = dq_w ** -0.5
    before = dict(_build.launches)
    leaves = [q.clone().requires_grad_(), kv.clone().requires_grad_()]
    out = mla.sparse_mla_attention(*leaves, idx, scale, dv)
    dq, dkv = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    assert _build.launches["sparse_mla_fwd"] == before.get("sparse_mla_fwd", 0) + 1
    assert _build.launches["sparse_mla_bwd"] > before.get("sparse_mla_bwd", 0)
    ref_out, ref_lse = mla.sparse_mla_attention_reference(q, kv, idx, scale, dv)
    ref_dq, ref_dkv = mla.sparse_mla_backward_reference(q, kv, idx, out.detach(), ref_lse, do,
                                                        scale, dv)
    for name, g, r in (("out", out, ref_out), ("dq", dq, ref_dq), ("dkv", dkv, ref_dkv)):
        assert g.shape == r.shape, name
        torch.testing.assert_close(g.float(), r.float(), atol=2e-2, rtol=2e-2, msg=name)


@pytest.mark.parametrize("hd", [320, 512])
@pytest.mark.parametrize("nh,nkv,window,with_sinks", [(4, 2, 0, False), (4, 2, 48, True),
                                                      (16, 2, 0, False)],
                         ids=["group2", "window+sinks", "group8"])
def test_wide_head_dim_flash_kernels_match_plain(gen, hd, nh, nkv, window, with_sinks):
    """K1 (its plain form) and K2a and K2b (the forms that compute a part of
    D an item) at head dim 320 zero-padded to 384, and 512, through the
    autograd Function: GQA groups of 2 and 8, a window of 48 with sinks,
    packed segments and a padded tail, against the plain versions (1e-2 on
    out, 1e-3 on lse, 2e-2 on the gradients), one launch of each, two runs
    bit-equal, and the tiles K2a and K2b count equal to their mirrors' (64 x
    32 and 32 x 64 tiles)."""
    b, l = 2, 200
    q, k, v = _bf16(gen, b, l, nh, hd), _bf16(gen, b, l, nkv, hd), _bf16(gen, b, l, nkv, hd)
    do = _bf16(gen, b, l, nh, hd)
    seg = _packed_seg(b, l)
    sinks = torch.randn(nh, device="cuda", generator=gen) if with_sinks else None
    runs = []
    for _ in range(2):
        before = dict(_build.launches)
        out, lse = _fwd(q, k, v, seg, seg, True, None, window=window, sinks=sinks)
        got = flash_attention_backward(q, k, v, seg, seg, out, lse, do, None, True, hd ** -0.5,
                                       window, sinks)
        torch.cuda.synchronize()
        for name in ("flash_attn_fwd", "flash_attn_bwd_dq", "flash_attn_bwd_dkv"):
            assert _build.launches[name] == before.get(name, 0) + 1, name
            assert _build.launches[f"{name}/wide"] == before.get(f"{name}/wide", 0) + 1, name
        runs.append((out, lse, *got[:3]))
    for a, c in zip(*runs):
        assert torch.equal(a, c)
    out, lse, *grads = runs[0]
    ref_out, ref_lse = flash_attention_reference(q.float(), k.float(), v.float(), seg, seg,
                                                 True, hd ** -0.5, window, sinks)
    _assert_close(out, ref_out)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=1e-4)
    ref = flash_attention_backward_reference(q, k, v, seg, seg, out, lse, do, None, True,
                                             hd ** -0.5, window)
    for name, g, r in zip(("dq", "dk", "dv"), grads, ref):
        assert g.shape == r.shape, name
        torch.testing.assert_close(g.float(), r.float(), atol=2e-2, rtol=2e-2, msg=name)
    assert (grads[0][seg == 0] == 0).all()
    dq_tiles, dkv_tiles = flash_bwd_tile_counts(q, k, v, seg, seg, lse, _delta(out, do, None),
                                                do, True, window)
    assert dq_tiles_of(hd) == (64, 32) and dkv_tiles_of(hd) == (32, 64)
    for got, rule in ((dq_tiles, flash_tiles_visited(seg, seg, True, window, *dq_tiles_of(hd))),
                      (dkv_tiles, flash_bwd_dkv_tiles_visited(seg, seg, True, window,
                                                              *dkv_tiles_of(hd)))):
        want = rule.sum(-1, dtype=torch.int32)
        assert torch.equal(got[..., 0], want[:, None].expand_as(got[..., 0]))


@pytest.mark.parametrize("case", chip_smoke.K5_WIDE_CASES, ids=lambda c: c[0])
def test_sparse_mla_kernels_match_plain_at_wide_widths(gen, case):
    """K5a and K5b in their wide forms at ``chip_smoke.K5_WIDE_CASES`` (1152 /
    1024 and 640 / 512, zero-padded to it) against the plain versions within
    2e-2 + 2e-2 |ref|, twice bit-equal, the tiles counted as the mirror gives
    (``chip_smoke.k5_wide_case``), one wide K5a launch a call."""
    before = dict(_build.launches)
    chip_smoke.k5_wide_case(gen, *case)
    assert _build.launches["sparse_mla_fwd/wide"] == before.get("sparse_mla_fwd/wide", 0) + 2
    assert _build.launches["sparse_mla_bwd/wide"] > before.get("sparse_mla_bwd/wide", 0)

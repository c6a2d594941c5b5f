"""K3's split arithmetic on the CPU against the JAX package: the plain PyTorch
mirror of the kernel's order of arithmetic (``decode_qkv_prep_split_reference``:
D cut into the chunks of a cluster's blocks, each chunk's sum of squares
added in the order 0..k-1, each chunk's f32 partial product folded in the
order 0..k-1, then bias, qk-norm and rope) against the Pallas kernel run as
the JAX tests run it (interpret mode on the CPU), for splits of 1-4 blocks,
S of 1, 7, 64 and 65, D no multiple of k x 64, both head dims, a rotation
shorter than the head, and biases with and without qk-norm; and the weight
tiles mirror ``decode_qkv_tiles_visited`` against counts made by hand.
Inputs come from a numpy seed and go to both packages; everything runs in
float32.

Tolerance: 2e-5 absolute and relative, as for K4's split arithmetic: both
sides compute in f32 and differ only in summation order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prime_rl_tpu.ops.decode_qkv import decode_qkv_prep as j_decode_qkv
from prime_rl_tpu_torch.ops.decode_qkv import (
    d_chunks,
    decode_qkv_prep_reference,
    decode_qkv_prep_split_reference,
    decode_qkv_tile_counts,
    decode_qkv_tiles_visited,
)

torch.set_num_threads(1)

TOL = dict(atol=2e-5, rtol=2e-5)
D = 336  # 5.25 weight tiles of 64 rows: no multiple of k x 64 for any k

# (name, NH, NKV, HD, qk-norm, biases, rot): Qwen3's form (qk-norm, full
# rotation), gpt-oss's (biases, no qk-norm) with a partial rotation, and
# qk-norm with biases and a partial rotation at head dim 128, and debug_vlm's
# head dim 32 (four heads a column tile)
FORMS = (
    ("hd 128 qk-norm", 4, 2, 128, True, False, 128),
    ("hd 64 biases rot 32", 4, 2, 64, False, True, 32),
    ("hd 128 qk-norm + biases rot 96", 2, 1, 128, True, True, 96),
    ("hd 32 qk-norm", 4, 2, 32, True, False, 32),
)
ROWS = (1, 7, 64, 65)

_inputs: dict = {}
_jax_out: dict = {}


def _case_inputs(form, s):
    """numpy inputs of a form at S rows, from their own seed."""
    key = (form[0], s)
    if key not in _inputs:
        name, nh, nkv, hd, qk_norm, bias, rot = form
        rng = np.random.default_rng(FORMS.index(form) * 10 + ROWS.index(s) + 70)

        def arr(*shape, scale=1.0):
            return (rng.standard_normal(shape) * scale).astype(np.float32)

        x = dict(x=arr(s, D), norm_w=1 + arr(D, scale=0.1), wq=arr(D, nh * hd, scale=0.1),
                 wk=arr(D, nkv * hd, scale=0.1), wv=arr(D, nkv * hd, scale=0.1),
                 positions=rng.integers(0, 4000, s).astype(np.int32),
                 inv_freq=(1.0 / (1e4 ** (np.arange(0, rot, 2) / rot))).astype(np.float32))
        opt = {}
        if qk_norm:
            opt.update(q_norm_w=1 + arr(hd, scale=0.1), k_norm_w=1 + arr(hd, scale=0.1))
        if bias:
            opt.update(q_bias=arr(nh * hd), k_bias=arr(nkv * hd), v_bias=arr(nkv * hd))
        kw = dict(num_heads=nh, num_kv_heads=nkv, head_dim=hd, qk_norm=qk_norm, rot=rot,
                  scaling=1.1, eps=1e-6)
        _inputs[key] = (x, opt, kw)
    return _inputs[key]


def _jax(form, s):
    """The Pallas kernel's (q, k, v) in interpret mode, once a (form, S)."""
    key = (form[0], s)
    if key not in _jax_out:
        x, opt, kw = _case_inputs(form, s)
        out = j_decode_qkv(*(jnp.asarray(a) for a in x.values()), **kw,
                           **{n: jnp.asarray(a) for n, a in opt.items()}, interpret=True)
        _jax_out[key] = tuple(np.asarray(o) for o in out)
    return _jax_out[key]


def _torch(form, s):
    x, opt, kw = _case_inputs(form, s)
    return ([torch.from_numpy(a.copy()) for a in x.values()],
            {n: torch.from_numpy(a.copy()) for n, a in opt.items()}, kw)


@pytest.mark.parametrize("splits", [1, 2, 3, 4])
@pytest.mark.parametrize("s", ROWS)
@pytest.mark.parametrize("form", FORMS, ids=lambda f: f[0])
def test_split_reference_matches_jax(form, s, splits):
    """The kernel's split arithmetic over ``splits`` chunks of D gives the
    Pallas kernel's q, k and v, and the plain version's."""
    args, opt, kw = _torch(form, s)
    got = decode_qkv_prep_split_reference(*args, splits=splits, **kw, **opt)
    for g, w in zip(got, _jax(form, s)):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, **TOL)
    for g, r in zip(got, decode_qkv_prep_reference(*args, **kw, **opt)):
        np.testing.assert_allclose(g.numpy(), r.numpy(), **TOL)


def test_split_reference_casts_the_normed_x_to_the_weight_dtype():
    """With bf16 weights the normed x is cast to bf16 before the products, as
    the plain version and the TPU kernel do: the split arithmetic then
    matches the plain version at every split to f32 summation order, and
    differs from the same arithmetic without the cast."""
    form = FORMS[0]
    args, opt, kw = _torch(form, 7)
    args[2:5] = [w.to(torch.bfloat16) for w in args[2:5]]
    ref = decode_qkv_prep_reference(*args, **kw, **opt)
    for splits in (1, 3, 4):
        got = decode_qkv_prep_split_reference(*args, splits=splits, **kw, **opt)
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g.numpy(), r.numpy(), **TOL)
    f32 = [w.float() for w in args[2:5]]
    uncast = decode_qkv_prep_reference(*args[:2], *f32, *args[5:], **kw, **opt)
    assert max(float((a - b).abs().max()) for a, b in zip(ref, uncast)) > 1e-3


@pytest.mark.parametrize("d,splits,want", [
    (336, 1, [(0, 336)]),
    (336, 2, [(0, 192), (192, 336)]),
    (336, 4, [(0, 128), (128, 256), (256, 320), (320, 336)]),
    (2880, 4, [(0, 768), (768, 1472), (1472, 2176), (2176, 2880)]),
    (2880, 5, [(0, 576), (576, 1152), (1152, 1728), (1728, 2304), (2304, 2880)]),
    (1024, 6, [(0, 192), (192, 384), (384, 576), (576, 768), (768, 896), (896, 1024)]),
])
def test_d_chunks_by_hand(d, splits, want):
    """The chunks of a cluster's blocks: ceil(D / 64) tiles dealt b + 1 to
    the first e blocks and b to the rest (b, e = divmod(tiles, k)), cut at D."""
    assert d_chunks(d, splits) == want


def test_d_chunks_refuse_more_splits_than_tiles():
    with pytest.raises(ValueError):
        d_chunks(64, 2)


@pytest.mark.parametrize("s,d,ncols,splits,want_shape,per_block", [
    # Qwen3-0.6B at 64 slots: 16 + 8 + 8 column tiles of 128, 16 K tiles
    (64, 1024, (2048, 1024, 1024), 6, (1, 32, 6), [3, 3, 3, 3, 2, 2]),
    # gpt-oss-20b: 32 + 4 + 4 column tiles, 45 K tiles over 5 blocks
    (64, 2880, (4096, 512, 512), 5, (1, 40, 5), [9, 9, 9, 9, 9]),
    # one 64-wide kv head: half a column tile each; 65 rows still one group
    (65, 400, (384, 64, 64), 3, (1, 5, 3), [3, 2, 2]),
    # 130 and 256 rows: the weights again for every 128 rows
    (130, 1024, (2048, 1024, 1024), 4, (2, 32, 4), [4, 4, 4, 4]),
    (256, 336, 512, 2, (2, 4, 2), [3, 3]),
])
def test_tiles_visited_by_hand(s, d, ncols, splits, want_shape, per_block):
    got = decode_qkv_tiles_visited(s, d, ncols, splits)
    assert got.dtype == torch.int32 and tuple(got.shape) == want_shape
    assert torch.equal(got, torch.tensor(per_block, dtype=torch.int32).expand(want_shape))
    # every weight tile once a row group
    n_ct = want_shape[1]
    assert int(got.sum()) == want_shape[0] * n_ct * -(-d // 64)


def test_tile_counts_come_from_the_kernel_only():
    args, opt, kw = _torch(FORMS[0], 7)
    with pytest.raises(ValueError, match="CUDA"):
        decode_qkv_tile_counts(*args, **kw, **opt)

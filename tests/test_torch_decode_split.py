"""K4's split-K arithmetic on the CPU against the JAX package: the plain
PyTorch mirror of the kernel (``decode_paged_attention_split_reference``: the
kernel's splits of the attended rows, per-split f32 partials, the
fixed-order combine, then the new token and the sinks) against the Pallas
kernel run as the JAX tests run it (interpret mode on the CPU), at split
sizes of 8, 16 and 64 rows so that slots have one to many splits; and the
rows mirror ``decode_rows_visited`` against the plain version's mask. Inputs
come from a numpy seed and go to both packages; everything runs in float32.

Tolerance: 2e-5 absolute and relative (both sides compute in f32 and differ
only in summation order); pools written by the KV append must match exactly
outside the shared null page 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prime_rl_tpu.ops.decode_attention import decode_paged_attention as j_decode_attention
from prime_rl_tpu_torch.models.base import BUILTIN_SPECS
from prime_rl_tpu_torch.ops.flash_attention import check_head_dim
from prime_rl_tpu_torch.ops.decode_attention import (
    SPLIT_ROWS,
    check_shape,
    chunk_width,
    decode_paged_attention_reference,
    decode_paged_attention_split_reference,
    decode_rows_counts,
    decode_rows_visited,
    group_chunks,
    max_splits,
    one_split,
)
from prime_rl_tpu_torch.sampler.model import SERVED_FAMILIES

torch.set_num_threads(1)

TOL = dict(atol=2e-5, rtol=2e-5)

# (name, S, NH, NKV, HD, PS, P, lengths, active slots, window, sinks): ragged
# lengths across several pages, a slot of length 0, lengths that are a
# multiple of PS (the append opens a new page), inactive slots on the null
# page, window starts inside a page and across a page boundary, sinks with
# and without a window, PS 8 and 16, head dims 64 and 128, groups 1, 2 and 8;
# then groups the kernel cuts into chunks of up to 8 query heads (3, 5 and 6
# in one padded chunk, 12 in chunks of 8 and 4), at head dim 128, with and
# without a window; then head dim 256 at group 8 (Qwen3-Next), with and
# without a window
CASES = (
    ("hd 128 group 2 PS 8, ragged, an empty slot, two inactive", 6, 4, 2, 128, 8, 8,
     [5, 0, 13, 61, 3, 3], 4, 0, False),
    ("hd 64 group 8 PS 16, window 20 + sinks", 6, 16, 2, 64, 16, 6,
     [3, 19, 37, 16, 90, 2], 5, 20, True),
    ("hd 64 group 1 PS 8, sinks, lengths a multiple of PS", 5, 2, 2, 64, 8, 10,
     [8, 16, 0, 79, 40], 5, 0, True),
    ("hd 128 group 8 PS 16, window 8 inside a page", 4, 8, 1, 128, 16, 5,
     [7, 30, 64, 12], 3, 8, False),
    ("hd 64 group 2 PS 16, window 40 + sinks across pages", 4, 4, 2, 64, 16, 8,
     [100, 47, 5, 127], 4, 40, True),
    ("hd 128 group 3 PS 16, ragged", 4, 6, 2, 128, 16, 6, [5, 40, 90, 0], 4, 0, False),
    ("hd 128 group 5 PS 16, window 20", 4, 10, 2, 128, 16, 6, [3, 40, 90, 19], 4, 20, False),
    ("hd 128 group 6 PS 8, sinks, an inactive slot", 4, 6, 1, 128, 8, 10, [79, 8, 33, 2], 3, 0,
     True),
    ("hd 128 group 12 PS 16, ragged", 4, 24, 2, 128, 16, 6, [5, 41, 95, 16], 4, 0, False),
    ("hd 128 group 12 PS 16, window 30 + sinks", 3, 12, 1, 128, 16, 6, [60, 20, 95], 3, 30,
     True),
    ("hd 256 group 8 PS 16 (Qwen3-Next's 16/2), ragged, an inactive slot", 4, 16, 2, 256, 16, 6,
     [5, 40, 95, 0], 3, 0, False),
    ("hd 256 group 8 PS 8, window 20 + sinks", 3, 8, 1, 256, 8, 10, [60, 20, 79], 3, 20, True),
)

_inputs: dict = {}
_jax_out: dict = {}


def _case_inputs(case):
    """numpy inputs of a case from its own seed (active slots own pages
    1 + slot * P ..., the rest point at the null page 0)."""
    name, s, nh, nkv, hd, ps, p, lengths, active, window, with_sinks = case
    if name not in _inputs:
        rng = np.random.default_rng(CASES.index(case) + 40)
        table = np.zeros((s, p), np.int32)
        for slot in range(active):
            table[slot] = 1 + slot * p + np.arange(p)
        _inputs[name] = dict(
            q=rng.standard_normal((s, nh, hd)).astype(np.float32),
            k_new=rng.standard_normal((s, nkv, hd)).astype(np.float32),
            v_new=rng.standard_normal((s, nkv, hd)).astype(np.float32),
            k_pool=rng.standard_normal((nkv, s * p + 1, ps, hd)).astype(np.float32),
            v_pool=rng.standard_normal((nkv, s * p + 1, ps, hd)).astype(np.float32),
            lengths=np.asarray(lengths, np.int32), table=table,
            sinks=rng.standard_normal(nh).astype(np.float32) if with_sinks else None)
    return _inputs[name]


def _jax(case):
    """The Pallas kernel's (o, k_pool, v_pool) in interpret mode, once a case."""
    name, window = case[0], case[9]
    if name not in _jax_out:
        x = _case_inputs(case)
        args = [jnp.asarray(x[k]) for k in ("q", "k_new", "v_new", "k_pool", "v_pool", "lengths",
                                            "table")]
        sinks = None if x["sinks"] is None else jnp.asarray(x["sinks"])
        _jax_out[name] = tuple(np.asarray(a) for a in j_decode_attention(
            *args, sinks=sinks, window=window, block_pages=1 if window else 4, interpret=True))
    return _jax_out[name]


def _torch_args(x):
    return [torch.from_numpy(x[k].copy()) for k in ("q", "k_new", "v_new", "k_pool", "v_pool",
                                                    "lengths", "table")]


@pytest.mark.parametrize("split_rows", [8, 16, 64])
@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_split_reference_matches_jax(case, split_rows):
    """The kernel's split-K arithmetic (splits of ``split_rows`` rows) gives
    the Pallas kernel's output, and its appends the Pallas kernel's pools."""
    active, window = case[8], case[9]
    x = _case_inputs(case)
    sinks = None if x["sinks"] is None else torch.from_numpy(x["sinks"])
    got_o, got_k, got_v = decode_paged_attention_split_reference(
        *_torch_args(x), sinks=sinks, window=window, split_rows=split_rows)
    want_o, want_k, want_v = _jax(case)
    np.testing.assert_allclose(got_o.numpy()[:active], want_o[:active], **TOL)
    # every page but the shared null page is exact (inactive slots race for
    # page 0 in both packages; nothing reads it)
    np.testing.assert_array_equal(got_k.numpy()[:, 1:], want_k[:, 1:])
    np.testing.assert_array_equal(got_v.numpy()[:, 1:], want_v[:, 1:])
    # and it is the gathered masked softmax of the plain version
    ref_o, _, _ = decode_paged_attention_reference(*_torch_args(x), sinks=sinks, window=window)
    np.testing.assert_allclose(got_o.numpy()[:active], ref_o.numpy()[:active], **TOL)


@pytest.mark.parametrize("split_rows", [8, 16, 64, SPLIT_ROWS])
@pytest.mark.parametrize("window", [0, 20])
def test_rows_visited_match_the_mask(window, split_rows):
    """Every cached row the plain version's mask attends is read by exactly
    one work item; rows below the window and row n (the new token's) by
    none; the items past a slot's last split read nothing."""
    rng = np.random.default_rng(50 + window + split_rows)
    s, ps, p = 9, 8, 40
    lengths = torch.from_numpy(rng.integers(0, p * ps, s).astype(np.int32))
    lengths[:3] = torch.tensor([0, ps, p * ps - 1], dtype=torch.int32)
    ms = max_splits(p * ps, split_rows)
    rows = decode_rows_visited(lengths, window, split_rows, ms)
    assert rows.shape == (s, ms) and rows.dtype == torch.int32
    assert bool((rows >= 0).all()) and bool((rows <= split_rows).all())
    # the mask of decode_attention_xla over lengths + 1 tokens, less the new token
    pos = torch.arange(p * ps)[None, :]
    n = lengths.long()[:, None]
    mask = pos < n + 1
    if window:
        mask &= pos >= n + 1 - window
    mask &= pos != n
    lo = (n + 1 - window).clamp(min=0) if window else torch.zeros_like(n)
    cover = torch.zeros(s, p * ps, dtype=torch.int64)
    for j in range(ms):  # split j reads [lo + j*C, lo + j*C + rows[:, j])
        start = lo + j * split_rows
        cover += ((pos >= start) & (pos < start + rows[:, j:j + 1].long())).long()
    assert torch.equal(cover, mask.long())
    # a slot's splits are a prefix of the items; with one split the slot's only
    splits = (rows > 0).sum(1)
    assert torch.equal(rows[:, 1:] > 0, torch.arange(1, ms)[None, :] < splits[:, None])
    if one_split(p * ps, window, split_rows):
        assert bool((rows[:, 1:] == 0).all())


def test_rows_counts_come_from_the_kernel_only():
    x = _case_inputs(CASES[0])
    with pytest.raises(ValueError, match="CUDA"):
        decode_rows_counts(*_torch_args(x))


def test_split_reference_takes_the_new_token_alone_and_one_split_rule():
    """A slot of length 0 attends the new token only (its output is v_new);
    no slot has two splits where the table holds at most C rows or a window
    leaves at most C cached rows."""
    x = _case_inputs(CASES[0])
    got_o, _, _ = decode_paged_attention_split_reference(*_torch_args(x), split_rows=8)
    nkv, group = x["k_new"].shape[1], x["q"].shape[1] // x["k_new"].shape[1]
    np.testing.assert_allclose(got_o.numpy()[1].reshape(nkv, group, -1),
                               np.repeat(x["v_new"][1][:, None], group, axis=1), **TOL)
    assert one_split(64, 0, 64) and not one_split(65, 0, 64)
    assert one_split(4096, 128, 256) and one_split(4096, 257, 256)
    assert not one_split(4096, 258, 256) and not one_split(4096, 0, 256)


def test_shape_check_takes_every_served_spec():
    """The wrappers' shape checks (no launch) take the heads of every built-in
    spec of a published model of a served family (the ``debug*`` specs'
    head dim of 32 is for the CPU), as the JAX kernels do (groups 2 to 12: Qwen3-14B
    40/8, Llama-3.2-3B 24/8, GLM-4.5 96/8 among them, and Qwen3-Next's 16/2
    heads of 256): K4's ``check_shape`` and K1/K2's ``check_head_dim``. K4
    refuses head dims other than 64/128/256/384/512 (96 among them:
    ``takes_k4`` sends those to the plain decode attention; 16/2 heads of 512
    it takes since the range repair), K1/K2 only head dims above 512
    (narrower ones are zero-padded to the next built width), and both heads
    that are not a multiple of the kv heads. The kernel's chunks: one for groups up to
    8 (padded to a power of two), two at 12 (8 + 4), each chunk at most 8
    query heads."""
    served = {name: spec for name, spec in BUILTIN_SPECS.items()
              if spec.family in SERVED_FAMILIES and "/" in name}
    groups = set()
    for name, spec in served.items():
        check_shape(spec.num_heads, spec.num_kv_heads, spec.head_dim)
        if spec.kv_lora_rank == 0:  # MLA trains through K5a/K5b
            for kernel in ("flash_attn_fwd", "flash_attn_bwd"):
                check_head_dim(kernel, spec.head_dim, spec.num_heads, spec.num_kv_heads)
        groups.add(spec.num_heads // spec.num_kv_heads)
    assert {2, 3, 4, 5, 8, 12} <= groups
    assert {"Qwen/Qwen3-14B", "meta-llama/Llama-3.2-3B", "zai-org/GLM-4.5-Air",
            "Qwen/Qwen3-30B-A3B", "Qwen/Qwen3-Next-80B-A3B-Instruct"} <= set(served)
    assert served["Qwen/Qwen3-Next-80B-A3B-Instruct"].head_dim == 256
    for nh, nkv, hd in ((16, 8, 96), (12, 8, 128), (8, 0, 128), (16, 2, 640)):
        with pytest.raises(ValueError, match="decode_paged_attention"):
            check_shape(nh, nkv, hd)
        if hd <= 512 and nkv and nh % nkv == 0:
            check_head_dim("flash_attn_fwd", hd, nh, nkv)
            continue
        with pytest.raises(ValueError, match="flash_attn_fwd"):
            check_head_dim("flash_attn_fwd", hd, nh, nkv)
    # the widths of the range repairs: K4 at 384 and 512 (16/2 heads of 512 among
    # them), K1/K2 at any head dim up to 512
    for nh, nkv, hd in ((16, 2, 512), (8, 2, 384), (4, 4, 512)):
        check_shape(nh, nkv, hd)
    for hd in (32, 96, 192, 320, 384, 512):
        check_head_dim("flash_attn_bwd", hd, 8, 2)
    for hd in (513, 640, 1024):
        with pytest.raises(ValueError, match="head_dim up to 512"):
            check_head_dim("flash_attn_bwd", hd, 8, 2)
    assert [chunk_width(g) for g in (1, 2, 3, 4, 5, 6, 7, 8, 12)] == [1, 2, 4, 4, 8, 8, 8, 8, 8]
    assert [group_chunks(g) for g in (1, 2, 3, 4, 5, 6, 7, 8, 12, 16, 17)] == [
        1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 3]
    for g in range(1, 40):
        w, n = chunk_width(g), group_chunks(g)
        assert w <= 8 and (n - 1) * w < g <= n * w

"""The tile-skipping rules on the CPU: ``flash_tiles_visited``, the plain
mirror of the kv tiles ``csrc/flash_attn_fwd.cu`` (K1, 128 x 128 tiles) and
K2a in ``csrc/flash_attn_bwd.cu`` (128 x 64) visit for each q tile, and
``flash_bwd_dkv_tiles_visited``, the q tiles K2b visits for each kv tile
(64 x 64).

The JAX package's kernel skips tiles by the causal diagonal and the band only,
so the rule has no JAX counterpart; it is held against the port's dense mask
(``_mask``), which the other CPU tests hold against the JAX package. A
skipped tile must hold no visible (query, key) pair, whatever the packing, the
order of the segment ids, the window or the lengths; the packings that
``chip_smoke.py`` reports visit the counts stated here. On the card,
``chip_smoke.py`` and ``tests/test_torch_cuda.py`` hold the kernels' own
counts (``flash_tile_counts``, ``flash_bwd_tile_counts``) against these rules.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402  (its K1 edge cases and packings)
from prime_rl_tpu_torch.ops.flash_attention import (  # noqa: E402
    DKV_TILE,
    DQ_TILES,
    TILE,
    _mask,
    flash_bwd_dkv_tiles_visited,
    flash_bwd_tile_counts,
    flash_tile_counts,
    flash_tiles_visited,
)


def _packing(rng, b, l, shuffle):
    """[b, l] int32: random sequence lengths (some 1-token), random padding
    gaps and tails; ids ascending, or shuffled (any order must be safe)."""
    seg = np.zeros((b, l), np.int32)
    for r in range(b):
        off, sid = 0, 1
        while off < l:
            n = int(rng.choice([1, 2, 7, 40, 127, 128, 129, 300]))
            if rng.random() < 0.2:
                off += n  # a gap of padding
                continue
            seg[r, off:off + n] = sid
            off += n
            sid += 1
        if shuffle:  # 0 stays padding
            seg[r] = np.concatenate([[0], rng.permutation(np.arange(1, sid))])[seg[r]]
    return torch.from_numpy(seg)


def _covered(seg_q, seg_kv, causal, window, bq, bk, transposed=False):
    """True iff every visible pair of the dense mask lies in a visited tile:
    of ``flash_tiles_visited`` ([B, nq, nk]) or, ``transposed``, of
    ``flash_bwd_dkv_tiles_visited`` ([B, nk, nq])."""
    lq, lk = seg_q.shape[1], seg_kv.shape[1]
    visible = _mask(seg_q[..., None], seg_kv[..., None], seg_q, seg_kv, causal, window)[:, 0]
    if transposed:
        visit = flash_bwd_dkv_tiles_visited(seg_q, seg_kv, causal, window, bq, bk)
        tiles = visit.transpose(1, 2)
    else:
        visit = tiles = flash_tiles_visited(seg_q, seg_kv, causal, window, bq, bk)
    tiles = tiles.repeat_interleave(bq, 1).repeat_interleave(bk, 2)[:, :lq, :lk]
    return bool((tiles | ~visible).all()), int(visit.sum()), int(visible.sum())


def _random_case(seed):
    rng = np.random.default_rng(seed)
    b = int(rng.integers(1, 4))
    causal = bool(seed % 3)
    lq = int(rng.integers(1, 700))
    lk = lq if causal else int(rng.integers(1, 700))
    window = int(rng.choice([0, 1, 17, 128, 300])) if causal else 0
    seg_q = _packing(rng, b, lq, shuffle=seed % 2 == 1)
    seg_kv = seg_q if lk == lq and causal else _packing(rng, b, lk, shuffle=seed % 2 == 1)
    return rng, seg_q, seg_kv, causal, window


@pytest.mark.parametrize("seed", range(12))
def test_no_visible_pair_is_skipped(seed):
    """Random packings, windows, tiles, Lq != Lk (the cross-block form, not
    causal) and shuffled ids: the skipped tiles hold no visible pair."""
    rng, seg_q, seg_kv, causal, window = _random_case(seed)
    bq = bk = int(rng.choice([16, 64, TILE]))
    ok, n_visited, n_visible = _covered(seg_q, seg_kv, causal, window, bq, bk)
    assert ok, (seed, causal, window, bq)
    assert n_visible == 0 or n_visited > 0


@pytest.mark.parametrize("seed", range(12))
@pytest.mark.parametrize("kernel", ["dq", "dkv"])
def test_backward_rules_skip_no_visible_pair(seed, kernel):
    """K2a's rule at its own tiles (128 x 64) and K2b's transposed rule (64 x
    64, and other sizes) over random packings, windows, Lq != Lk (the
    cross-block form, not causal) and shuffled ids: the skipped tiles hold no
    visible pair."""
    rng, seg_q, seg_kv, causal, window = _random_case(seed)
    if kernel == "dq":
        bq, bk = DQ_TILES
    else:
        bq = bk = int(rng.choice([16, DKV_TILE, TILE]))
    ok, n_visited, n_visible = _covered(seg_q, seg_kv, causal, window, bq, bk,
                                        transposed=kernel == "dkv")
    assert ok, (seed, causal, window, bq)
    assert n_visible == 0 or n_visited > 0


@pytest.mark.parametrize("lens,b,l,window,dq_visited,dq_candidates,dkv_visited,dkv_candidates", [
    ([[1024] * 4], 1, 4096, 0, 288, 1056, 544, 2080),  # gpt-oss full layers, four sequences
    ([[4096]], 1, 4096, 0, 1056, 1056, 2080, 2080),  # one sequence: the whole causal triangle
    ([[4096]], 1, 4096, 128, 126, 126, 189, 189),  # gpt-oss windowed layers: the band
    ([[120, 130, 100, 110]] * 8, 8, 512, 0, 88, 160, 144, 288),  # the Qwen3 trainer's rows
])
def test_chip_smoke_packings_visit_the_stated_backward_tiles(lens, b, l, window, dq_visited,
                                                             dq_candidates, dkv_visited,
                                                             dkv_candidates):
    """The K2 rows of ``chip_smoke.py``: K2a's kv tiles (128 x 64) and K2b's
    q tiles (64 x 64) visited and candidate, summed over the batch for one
    head; a row of four sequences visits about a quarter of its triangle."""
    seg = chip_smoke.packed_segments(b, l, lens, "cpu")[0]
    ones = torch.ones_like(seg)
    assert int(flash_tiles_visited(seg, seg, True, window, *DQ_TILES).sum()) == dq_visited
    assert int(flash_tiles_visited(ones, ones, True, window, *DQ_TILES).sum()) == dq_candidates
    assert int(flash_bwd_dkv_tiles_visited(seg, seg, True, window).sum()) == dkv_visited
    assert int(flash_bwd_dkv_tiles_visited(ones, ones, True, window).sum()) == dkv_candidates
    assert _covered(seg, seg, True, window, *DQ_TILES)[0]
    assert _covered(seg, seg, True, window, DKV_TILE, DKV_TILE, transposed=True)[0]


def test_a_padded_kv_tile_visits_nothing():
    seg = torch.zeros(1, 300, dtype=torch.int32)
    seg[0, :100] = 1
    visit = flash_bwd_dkv_tiles_visited(seg, seg, causal=False)[0]  # [kv tile, q tile]
    assert visit[:2, :2].all() and not visit[:, 2:].any() and not visit[2:].any()


@pytest.mark.parametrize("lens,b,l,window,visited,candidates", [
    ([[1024] * 4], 1, 4096, 0, 144, 528),  # gpt-oss full layers, four sequences a row
    ([[4096]], 1, 4096, 0, 528, 528),  # one sequence: the whole causal triangle
    ([[4096]], 1, 4096, 128, 63, 63),  # gpt-oss windowed layers: the band
    ([[120, 130, 100, 110]] * 8, 8, 512, 0, 56, 80),  # the Qwen3 trainer's rows
    ([[200, 250], [512], [37], []], 4, 512, 0, 19, 40),  # the serving case of chip_smoke.py
])
def test_chip_smoke_packings_visit_the_stated_tiles(lens, b, l, window, visited, candidates):
    seg = chip_smoke.packed_segments(b, l, lens, "cpu")[0]
    ones = torch.ones_like(seg)
    assert int(flash_tiles_visited(seg, seg, True, window).sum()) == visited
    assert int(flash_tiles_visited(ones, ones, True, window).sum()) == candidates
    assert _covered(seg, seg, True, window, TILE, TILE)[0]


def test_a_padded_q_tile_visits_nothing():
    seg = torch.zeros(1, 300, dtype=torch.int32)
    seg[0, :100] = 1
    visit = flash_tiles_visited(seg, seg, causal=False)[0]
    assert visit[0, 0] and not visit[0, 1:].any() and not visit[1:].any()


@pytest.mark.parametrize("case", chip_smoke.K1_EDGE_CASES, ids=lambda c: c[0])
def test_chip_smoke_edge_cases_skip_no_visible_pair(case):
    """The packings of ``chip_smoke.K1_EDGE_CASES`` (padded rows, short
    segments, Lq != Lk, windows), at the tiles of K1, K2a and K2b."""
    _, b, lq, lk, _, _, _, q_lens, kv_lens, causal, window, _ = case
    seg_q = chip_smoke.packed_segments(b, lq, q_lens, "cpu")[0]
    seg_kv = seg_q if kv_lens is None else chip_smoke.packed_segments(b, lk, kv_lens, "cpu")[0]
    assert _covered(seg_q, seg_kv, causal, window, TILE, TILE)[0]
    assert _covered(seg_q, seg_kv, causal, window, *DQ_TILES)[0]
    assert _covered(seg_q, seg_kv, causal, window, DKV_TILE, DKV_TILE, transposed=True)[0]


def test_tile_counts_come_only_from_the_kernel():
    seg = torch.ones(1, 64, dtype=torch.int32)
    q = torch.zeros(1, 64, 2, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="kernel"):
        flash_tile_counts(q, q, q, seg, seg, True)
    lse = torch.zeros(1, 2, 64)
    with pytest.raises(ValueError, match="kernel"):
        flash_bwd_tile_counts(q, q, q, seg, seg, lse, lse, q, True)

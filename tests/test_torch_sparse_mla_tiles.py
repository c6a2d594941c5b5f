"""The tile-skipping rule of K5a and K5b on the CPU:
``sparse_mla_bwd_tiles_visited``, the plain mirror of the tiles of
``FWD_TILE`` (K5a) and ``BWD_TILE`` (K5b) slots that ``csrc/sparse_mla.cu``'s
forward and backward visit for each token, against a dense count of the real
indices in every tile.

A tile is visited iff it holds an index in ``[0, Sk)``, wherever the
sentinels lie in the row; slots past T count as sentinels. The JAX package's
kernels compute every tile (their rows are gathered outside the kernels), so
the rule has no JAX counterpart; a skipped tile must hold no real index, or
its share of out, dq and dkv would be lost. On the card, ``chip_smoke.py``
and ``tests/test_torch_cuda.py`` hold the kernels' own counts
(``sparse_mla_fwd_tile_counts``, ``sparse_mla_bwd_tile_counts``) against this
rule.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from prime_rl_tpu_torch.ops.sparse_mla_kernel import (
    BWD_TILE,
    FWD_TILE,
    WIDE_BWD_TILE,
    WIDE_FWD_TILE,
    WIDE_HEADS,
    sparse_mla_bwd_tile_counts,
    sparse_mla_bwd_tiles_visited,
    sparse_mla_fwd_tile_counts,
)


def _dense(indices: np.ndarray, sk: int, bt: int) -> np.ndarray:
    """[S, ceil(T / bt)] bool by a loop over every slot: does the tile hold a
    real index?"""
    s, t = indices.shape
    n = -(-t // bt)
    out = np.zeros((s, n), dtype=bool)
    for i in range(s):
        for j in range(t):
            if 0 <= indices[i, j] < sk:
                out[i, j // bt] = True
    return out


def _causal(rng, s: int, t: int) -> np.ndarray:
    """Token i selects min(t, i + 1) distinct rows of [0, i]; the rest of its
    row is the sentinel s (sentinels last, as a top-k leaves them)."""
    idx = np.full((s, t), s, dtype=np.int32)
    for i in range(s):
        k = min(t, i + 1)
        idx[i, :k] = rng.permutation(i + 1)[:k]
    return idx


def _case(name: str, rng) -> tuple[np.ndarray, int]:
    if name == "sentinels last":
        return _causal(rng, 150, 96), 150
    if name == "sentinels scattered":
        idx = _causal(rng, 150, 96)
        idx = np.take_along_axis(idx, rng.random(idx.shape).argsort(-1), -1)
        return idx, 150
    if name == "all-sentinel rows":
        idx = _causal(rng, 80, 64)
        idx[[0, 7, 41]] = 80
        return idx, 80
    if name == "T not a multiple of the tile":
        return _causal(rng, 120, 100), 120
    if name == "indices below 0 and at or above Sk":
        idx = rng.integers(-40, 140, size=(90, 77)).astype(np.int32)
        idx[3] = -1  # a row of negative sentinels only
        idx[5] = 100  # a row of the sentinel Sk only
        idx[9] = -1  # real indices only in the row's first and last 7 slots
        idx[9, :7], idx[9, 70:] = 1, 2
        return idx, 100
    raise ValueError(name)


CASES = ("sentinels last", "sentinels scattered", "all-sentinel rows",
         "T not a multiple of the tile", "indices below 0 and at or above Sk")


@pytest.mark.parametrize("bt", [FWD_TILE, BWD_TILE, 16])
@pytest.mark.parametrize("name", CASES)
def test_tiles_visited_match_a_dense_count(name, bt):
    rng = np.random.default_rng(100 * CASES.index(name) + bt)
    idx, sk = _case(name, rng)
    got = sparse_mla_bwd_tiles_visited(torch.from_numpy(idx), sk, bt)
    want = _dense(idx, sk, bt)
    assert got.dtype == torch.bool and tuple(got.shape) == want.shape
    assert np.array_equal(got.numpy(), want)
    if name == "all-sentinel rows":
        assert not got[[0, 7, 41]].any()
    if name == "indices below 0 and at or above Sk":
        assert not got[[3, 5]].any()
        assert got[9, 0] and got[9, -1] and not got[9, 1:-1].any()


def _check_causal_count(bt: int) -> None:
    """The causal layout of the DSA trainer's shape at small size: token i
    visits ceil(min(T, i + 1) / bt) tiles of ceil(T / bt)."""
    s, t = 200, 160
    idx = _causal(np.random.default_rng(0), s, t)
    got = sparse_mla_bwd_tiles_visited(torch.from_numpy(idx), s, bt)
    want = [-(-min(t, i + 1) // bt) for i in range(s)]
    assert got.shape[1] == -(-t // bt)
    assert got.sum(-1).tolist() == want


def test_causal_tiles_visited_count():
    _check_causal_count(BWD_TILE)  # K5b's tiles (the mirror's default)


def test_causal_fwd_tiles_visited_count():
    _check_causal_count(FWD_TILE)  # K5a's tiles


def test_fwd_tile_is_the_kernels():
    """``FWD_TILE`` and ``BWD_TILE`` are the tiles K5a and K5b are compiled
    with (``BT`` in the source's namespaces ``k5a`` and ``k5b``; on the card
    ``chip_smoke.py`` also reads K5a's from the library)."""
    src = (Path(__file__).resolve().parents[1] / "prime_rl_tpu_torch" / "csrc"
           / "sparse_mla.cu").read_text()
    for ns, tile in (("k5a", FWD_TILE), ("k5b", BWD_TILE)):
        bt = re.search(rf"namespace {ns} {{\s+constexpr int BT = (\d+);", src)
        assert bt is not None and int(bt.group(1)) == tile


@pytest.mark.parametrize("name", CASES)
def test_wide_bwd_tiles_visited_match_a_dense_count(name):
    """The mirror at the wide K5b's tile of ``WIDE_BWD_TILE`` slots."""
    rng = np.random.default_rng(7 * CASES.index(name) + WIDE_BWD_TILE)
    idx, sk = _case(name, rng)
    got = sparse_mla_bwd_tiles_visited(torch.from_numpy(idx), sk, WIDE_BWD_TILE)
    assert tuple(got.shape) == (idx.shape[0], -(-idx.shape[1] // WIDE_BWD_TILE))
    assert np.array_equal(got.numpy(), _dense(idx, sk, WIDE_BWD_TILE))


def test_causal_wide_bwd_tiles_visited_count():
    _check_causal_count(WIDE_BWD_TILE)  # the wide K5b's tiles


def test_wide_tiles_and_heads_are_the_kernels():
    """``WIDE_FWD_TILE``, ``WIDE_BWD_TILE`` and ``WIDE_HEADS`` are what the
    wide K5a and K5b are compiled with (``FWD_BT`` in namespace ``k5w``, ``BT``
    and ``HG`` in ``k5bw``; on the card ``chip_smoke.py`` also reads them from
    the library)."""
    src = (Path(__file__).resolve().parents[1] / "prime_rl_tpu_torch" / "csrc"
           / "sparse_mla.cu").read_text()
    fwd = re.search(r"namespace k5w \{.*?constexpr int FWD_BT = (\d+);", src, re.S)
    assert fwd is not None and int(fwd.group(1)) == WIDE_FWD_TILE
    for name, want in (("BT", WIDE_BWD_TILE), ("HG", WIDE_HEADS)):
        got = re.search(rf"namespace k5bw \{{.*?constexpr int {name} = (\d+);", src, re.S)
        assert got is not None and int(got.group(1)) == want, name


def test_tile_counts_need_the_kernel():
    q = torch.zeros(4, 64, 576, dtype=torch.bfloat16)
    kv = torch.zeros(8, 576, dtype=torch.bfloat16)
    idx = torch.zeros(4, 32, dtype=torch.int32)
    out, lse = torch.zeros(4, 64, 512, dtype=torch.bfloat16), torch.zeros(4, 64)
    with pytest.raises(ValueError, match="CUDA tensors"):
        sparse_mla_bwd_tile_counts(q, kv, idx, out, lse, out, 0.1, 512)
    with pytest.raises(ValueError, match="CUDA tensors"):
        sparse_mla_fwd_tile_counts(q, kv, idx, 0.1, 512)

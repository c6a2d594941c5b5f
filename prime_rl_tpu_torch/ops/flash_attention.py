"""K1, K2a, K2b: flash attention over packed sequences, forward and backward
- the hand-written CUDA kernels ``csrc/flash_attn_fwd.cu`` and
``csrc/flash_attn_bwd.cu`` and their plain PyTorch versions.

Replaces the TPU kernels of ``prime_rl_tpu/ops/flash_attention.py``:
``_fwd_kernel`` (K1, the ``pallas_call`` in ``_fwd``), ``_bwd_dq_kernel``
(K2a) and ``_bwd_dkv_kernel`` (K2b, the two ``pallas_call``s in ``_bwd``).
Public entry points keep the JAX signatures and the ``[B, L, N, D]`` layout:
``flash_attention`` (out) and ``flash_attention_with_lse`` (out, lse
``[B, NH, Lq]``). Both are differentiable through one
``torch.autograd.Function`` that saves ``q, k, v, sinks, seg_q, seg_kv, out,
lse`` and takes cotangents of ``out`` and of ``lse``.

Contract: segment 0 is padding; a query attends a key only within its own
segment, (causal) at or before its own position and (``window > 0``) fewer
than ``window`` positions back; GQA maps q head h to kv head ``h // (NH //
NKV)``; f32 online softmax; an attention sink (one learned logit per q head,
gpt-oss) joins the softmax denominator as a key of value 0. A row that sees
no key gets output 0 and lse -1e30 (with a sink: lse = the sink), gradient 0,
and adds nothing to dk/dv. The sinks' gradient, ``-sum exp(sink - lse) *
delta`` over batch and rows, is a plain PyTorch reduction beside the kernels,
as it is an XLA reduction beside the TPU kernels. On the card the kernels take
bf16 tensors of any head dim up to 512: they are built for 64, 128, 256,
384 and 512 (``HEAD_DIMS``; 256 is Qwen3-Next's), and the wrappers zero-pad
any other head dim to the next of these (``padded_head_dim``; the JAX
kernels set no limit, the debug specs' 32 among them). That is exact: a zero
column adds 0 to every score, so out, lse and delta do not change, the scale
is the true head dim's, and the padded columns of out, dq, dk and dv are
dropped. At 384 and 512 K1 is a plain SIMT form (16 x 32 tiles, f32
products: ``fwd_tiles``), and K2a and K2b are ``wgmma`` forms of their own
that compute a part of D an item (K2a: 64 q rows over kv tiles of 32,
``dq_tiles``; K2b: 64 kv rows over q tiles of 32, ``dkv_tiles``); above 512
they raise (the tiles and accumulators stop fitting the SM's shared memory
and registers). A
length that is no multiple of the
tile is masked inside the kernels; windows run banded (tiles outside the
band are never loaded). ``flash_attention_with_lse`` (the cross-block form)
takes neither window nor sinks, as in the JAX package.

What bounds them on the H100 and what the design does about it: see the
source notes in ``csrc/flash_attn_fwd.cu`` and ``csrc/flash_attn_bwd.cu``.
All three are compute-bound at prefill and training lengths, and all three
are Hopper kernels of one shape: blocks that walk work items heaviest first,
a producer warp that loads tiles by TMA into a ring behind mbarriers,
consumer warpgroups whose products are all ``wgmma`` with the score-sized
tiles in registers, and tiles skipped by the causal diagonal, the band and
the range of the other side's segments. K1 and K2a skip kv tiles for a q tile
(``flash_tiles_visited`` is the plain mirror of that rule, at 128 x 128
tiles for K1 and 128 x 64 for K2a, 64 x 64 for both at head dim 256:
``fwd_tiles``, ``dq_tiles``); K2b skips q tiles for a kv tile
(``flash_bwd_dkv_tiles_visited``, 64 x 64) and sums dk/dv over the GQA group
inside one block, so that no atomics are needed (at head dim 256 a block
computes one half of D of dk and dv, at 384 and 512 K2a a half of D of dq and
K2b a third or a quarter of dk and dv).

For CPU tensors the wrappers run ``flash_attention_reference`` and
``flash_attention_backward_reference``, the plain versions of the same
functions; for CUDA tensors they launch the kernels or raise.
"""

from __future__ import annotations

import ctypes

import torch

from prime_rl_tpu_torch.ops import _build

NEG_INF = -1e30
HEAD_DIMS = (64, 128, 256, 384, 512)  # the head dims the kernels are built for
WIDE_TILES = (16, 32)  # K1's (q tile, kv tile) at 384 and 512 (the plain form)
WIDE_DQ_TILES = (64, 32)  # K2a's (q tile, kv tile) there (DqWide<HD> in csrc/flash_attn_bwd.cu)
WIDE_DKV_TILES = (32, 64)  # K2b's (q tile, kv tile) there (DkvWide<HD>)
TILE = 128  # K1's q and kv tile at head dim 64 and 128 (Tiles<HD> in csrc/flash_attn_fwd.cu)
DQ_TILES = (128, 64)  # K2a's q tile and kv tile there (DqCfg<HD> in csrc/flash_attn_bwd.cu)
DKV_TILE = 64  # K2b's kv tile and q tile at every head dim (KV_BK = KV_BQ)
KERNEL = "flash_attn_fwd"
KERNEL_BWD = "flash_attn_bwd"  # one source, two kernels, counted separately:
KERNEL_DQ = "flash_attn_bwd_dq"
KERNEL_DKV = "flash_attn_bwd_dkv"

_fns = None
_bwd_fns: dict = {}


def padded_head_dim(head_dim: int) -> int:
    """The built head dim the kernels run ``head_dim`` at: the least of
    ``HEAD_DIMS`` that holds it (0 above 512)."""
    return next((w for w in HEAD_DIMS if head_dim <= w), 0)


def fwd_tiles(head_dim: int) -> tuple[int, int]:
    """K1's (q tile, kv tile) at ``head_dim``: 128 x 128, or 64 x 64 where it
    runs at 256, one consumer warpgroup holding a 64-row item's output
    accumulator; 16 x 32 in the plain form at 384 and 512."""
    w = padded_head_dim(head_dim)
    return WIDE_TILES if w > 256 else (64, 64) if w == 256 else (TILE, TILE)


def dq_tiles(head_dim: int) -> tuple[int, int]:
    """K2a's (q tile, kv tile) at ``head_dim``: 128 x 64, or 64 x 64 where it
    runs at 256, 64 x 32 at 384 and 512."""
    w = padded_head_dim(head_dim)
    return WIDE_DQ_TILES if w > 256 else (64, 64) if w == 256 else DQ_TILES


def dkv_tiles(head_dim: int) -> tuple[int, int]:
    """K2b's (q tile, kv tile) at ``head_dim``: 64 x 64, or 32 x 64 at 384
    and 512."""
    return WIDE_DKV_TILES if padded_head_dim(head_dim) > 256 else (DKV_TILE, DKV_TILE)


def check_head_dim(name: str, head_dim: int, num_heads: int, num_kv_heads: int) -> None:
    """Raise unless the kernels take these heads: head dim 1 to 512 (padded
    to the next of ``HEAD_DIMS``) and ``num_heads`` a multiple of
    ``num_kv_heads``."""
    if not 0 < head_dim <= HEAD_DIMS[-1] or num_kv_heads <= 0 or num_heads % num_kv_heads:
        raise ValueError(f"{name} takes head_dim up to {HEAD_DIMS[-1]} and NH % NKV == 0, "
                         f"got head_dim {head_dim}, heads {num_heads}/{num_kv_heads}")


def count_wide(kernel: str, head_dim: int) -> None:
    """A launch at head dim 384 or 512 counts under ``<kernel>/wide`` as
    well."""
    if head_dim > 256:
        _build.launches[f"{kernel}/wide"] += 1


def _pad_last(x: torch.Tensor, width: int) -> torch.Tensor:
    return x if x.shape[-1] == width else torch.nn.functional.pad(x, (0, width - x.shape[-1]))


def fwd_padded(fwd, q, k, v, *rest, **kw):
    """``fwd(q, k, v, *rest, **kw) -> (out, lse)`` run at the built head dim:
    q, k and v zero-padded along the head dim to ``padded_head_dim``, out
    sliced back (lse is the same at either width). The caller passes the true
    head dim's scale in ``rest``."""
    hd = q.shape[-1]
    w = padded_head_dim(hd)
    if w in (0, hd):
        return fwd(q, k, v, *rest, **kw)
    out, lse = fwd(_pad_last(q, w), _pad_last(k, w), _pad_last(v, w), *rest, **kw)
    return out[..., :hd].contiguous(), lse


def bwd_padded(bwd, q, k, v, seg_q, seg_kv, lse, delta, do, *rest, **kw):
    """``bwd(q, k, v, seg_q, seg_kv, lse, delta, do, *rest, **kw)`` (K2a's dq
    or K2b's (dk, dv)) run at the built head dim: q, k, v and do zero-padded
    along the head dim, every result sliced back. ``delta`` (the true width's
    rowsum(out * do)) is what the padded inputs give too."""
    hd = q.shape[-1]
    w = padded_head_dim(hd)
    if w in (0, hd):
        return bwd(q, k, v, seg_q, seg_kv, lse, delta, do, *rest, **kw)
    got = bwd(_pad_last(q, w), _pad_last(k, w), _pad_last(v, w), seg_q, seg_kv, lse, delta,
              _pad_last(do, w), *rest, **kw)
    if isinstance(got, torch.Tensor):
        return got[..., :hd].contiguous()
    return tuple(g[..., :hd].contiguous() for g in got)


def _kernel(tiles: bool = False):
    """K1's C entry point; ``tiles``: the one that also writes each work
    item's kv tile counts (one more pointer argument)."""
    global _fns
    if _fns is None:
        lib = _build.load(KERNEL)
        p, i = ctypes.c_void_p, ctypes.c_int
        fwd, fwd_tiles = lib.flash_attn_fwd, lib.flash_attn_fwd_tiles
        fwd.argtypes = [p] * 8 + [i] * 6 + [ctypes.c_float, i, i, p]
        fwd_tiles.argtypes = fwd.argtypes + [p]
        fwd.restype = fwd_tiles.restype = i
        _fns = (fwd, fwd_tiles)
    return _fns[tiles]


def _mask(q, k, seg_q, seg_kv, causal: bool, window: int):
    """[B, 1, Lq, Lk] bool: same non-zero segment, (causal) row >= col and
    (window > 0) row - col < window, rows and columns by absolute index."""
    mask = (seg_q[:, :, None] == seg_kv[:, None, :]) & (seg_q[:, :, None] != 0)
    if causal or window > 0:
        rows = torch.arange(q.shape[1], device=q.device)[:, None]
        cols = torch.arange(k.shape[1], device=q.device)[None, :]
        if causal:
            mask = mask & (rows >= cols)
        if window > 0:
            mask = mask & (rows - cols < window)
    return mask[:, None]


def flash_tiles_visited(seg_q, seg_kv, causal: bool, window: int = 0, bq: int = TILE,
                        bk: int = TILE) -> torch.Tensor:
    """[B, nq, nk] bool: the kv tiles K1 visits for each q tile, the plain
    mirror of the kernel's rule. Candidates are the tiles up to the causal
    diagonal of the q tile's last row (``causal``) and from the band's first
    tile (``window > 0``); of those, a tile is visited only if it holds a key
    whose segment is non-zero and lies in [smallest non-zero, largest] of the
    q tile's segment ids. Rows and keys past the end count as padding."""
    b, lq = seg_q.shape
    lk = seg_kv.shape[1]
    nq, nk = -(-lq // bq), -(-lk // bk)
    sq = torch.nn.functional.pad(seg_q.long(), (0, nq * bq - lq)).reshape(b, nq, bq)
    sk = torch.nn.functional.pad(seg_kv.long(), (0, nk * bk - lk)).reshape(b, 1, nk, bk)
    big = torch.iinfo(torch.int64).max
    lo = torch.where(sq != 0, sq, big).amin(-1)[..., None, None]
    hi = torch.where(sq != 0, sq, -big).amax(-1)[..., None, None]
    visit = ((sk != 0) & (sk >= lo) & (sk <= hi)).any(-1)
    i = torch.arange(nq, device=seg_q.device)[:, None]
    j = torch.arange(nk, device=seg_q.device)[None, :]
    if causal:
        visit = visit & (j <= (torch.clamp((i + 1) * bq, max=lq) - 1) // bk)
    if window > 0:
        visit = visit & (j >= torch.clamp(i * bq - window + 1, min=0) // bk)
    return visit


def flash_bwd_dkv_tiles_visited(seg_q, seg_kv, causal: bool, window: int = 0,
                                bq: int = DKV_TILE, bk: int = DKV_TILE) -> torch.Tensor:
    """[B, nk, nq] bool: the q tiles K2b visits for each kv tile, the plain
    mirror of the kernel's rule (``flash_tiles_visited`` transposed).
    Candidates are the q tiles from the one that holds the kv tile's first key
    (``causal``) to the last one whose rows reach the kv tile through the band
    (``window > 0``); of those, a tile is visited only if it holds a query
    whose segment is non-zero and lies in [smallest non-zero, largest] of the
    kv tile's segment ids. Rows and keys past the end count as padding."""
    b, lq = seg_q.shape
    lk = seg_kv.shape[1]
    nq, nk = -(-lq // bq), -(-lk // bk)
    sk = torch.nn.functional.pad(seg_kv.long(), (0, nk * bk - lk)).reshape(b, nk, bk)
    sq = torch.nn.functional.pad(seg_q.long(), (0, nq * bq - lq)).reshape(b, 1, nq, bq)
    big = torch.iinfo(torch.int64).max
    lo = torch.where(sk != 0, sk, big).amin(-1)[..., None, None]
    hi = torch.where(sk != 0, sk, -big).amax(-1)[..., None, None]
    visit = ((sq != 0) & (sq >= lo) & (sq <= hi)).any(-1)
    j = torch.arange(nk, device=seg_q.device)[:, None]
    i = torch.arange(nq, device=seg_q.device)[None, :]
    if causal:
        visit = visit & (i >= j * bk // bq)
    if window > 0:
        visit = visit & (i <= (j * bk + bk - 1 + window - 1) // bq)
    return visit


def flash_tile_counts(q, k, v, seg_q, seg_kv, causal: bool, window: int = 0,
                      sinks=None) -> torch.Tensor:
    """int32 [B, NH, nq, 2]: the kv tiles K1 visited and its candidates
    (the tiles the causal cut and the band leave) for each q tile and head, as
    the kernel counted them in one launch on these inputs. Only the kernel
    counts: CPU tensors raise (``flash_tiles_visited`` is the rule's plain
    mirror)."""
    if not q.is_cuda:
        raise ValueError("flash_tile_counts: the counts come from the kernel, which takes CUDA "
                         "tensors")
    b, lq, nh, hd = q.shape
    tiles = torch.full((b, nh, -(-lq // fwd_tiles(hd)[0]), 2), -1, dtype=torch.int32,
                       device=q.device)
    _fwd_cuda(q, k, v, seg_q, seg_kv, causal, q.shape[-1] ** -0.5, window, sinks, tiles)
    return tiles


def flash_attention_reference(q, k, v, seg_q, seg_kv, causal: bool, scale: float,
                              window: int = 0, sinks=None):
    """Plain version: (out [B, Lq, NH, HD] in q.dtype, lse [B, NH, Lq] f32),
    scores and softmax in f32, rows without any visible key -> 0 / -1e30; a
    sink ([NH]) joins the denominator as a key of value 0 (such rows then get
    0 / the sink)."""
    nh, nkv = q.shape[2], k.shape[2]
    g = nh // nkv
    kf = k.float().repeat_interleave(g, dim=2)
    vf = v.float().repeat_interleave(g, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * scale
    mask = _mask(q, k, seg_q, seg_kv, causal, window)
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    if sinks is not None:
        sk = sinks.float().reshape(1, nh, 1, 1)
        m = torch.maximum(m, sk)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    if sinks is not None:
        l = l + torch.exp(sk - m)
    out = torch.einsum("bhqk,bkhd->bqhd", p / torch.where(l > 0, l, 1.0), vf)
    lse = torch.where(l > 0, m + torch.log(torch.where(l > 0, l, 1.0)), NEG_INF)[..., 0]
    return out.to(q.dtype), lse


def _fwd_cuda(q, k, v, seg_q, seg_kv, causal: bool, scale: float, window: int = 0,
              sinks=None, tiles=None):
    b, lq, nh, hd = q.shape
    lk, nkv = k.shape[1], k.shape[2]
    check_head_dim("flash_attn_fwd", hd, nh, nkv)
    if hd not in HEAD_DIMS:
        return fwd_padded(_fwd_cuda, q, k, v, seg_q, seg_kv, causal, scale, window, sinks, tiles)
    _build.require(q, "q", torch.bfloat16)
    _build.require(k, "k", torch.bfloat16, (b, lk, nkv, hd))
    _build.require(v, "v", torch.bfloat16, (b, lk, nkv, hd))
    _build.require(seg_q, "seg_q", torch.int32, (b, lq))
    _build.require(seg_kv, "seg_kv", torch.int32, (b, lk))
    if sinks is not None:
        _build.require(sinks, "sinks", torch.float32, (nh,))
    if tiles is not None:
        _build.require(tiles, "tiles", torch.int32, (b, nh, -(-lq // fwd_tiles(hd)[0]), 2))
    out = torch.empty_like(q)
    lse = torch.empty((b, nh, lq), dtype=torch.float32, device=q.device)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), seg_q.data_ptr(), seg_kv.data_ptr(),
            out.data_ptr(), lse.data_ptr(), None if sinks is None else sinks.data_ptr(), b, lq,
            lk, nh, nkv, hd, float(scale), int(causal), int(window), _build.stream_ptr(q))
    fn = _kernel(tiles is not None)
    _build.check(KERNEL, fn(*args) if tiles is None else fn(*args, tiles.data_ptr()))
    _build.count(KERNEL, window, sinks is not None)
    count_wide(KERNEL, hd)
    return out, lse


def _bwd_kernels(tiles: bool = False):
    """K2a's and K2b's C entry points; ``tiles``: the ones that also write each
    work item's tile counts (one more pointer argument)."""
    if tiles not in _bwd_fns:
        lib = _build.load(KERNEL_BWD)
        p, i = ctypes.c_void_p, ctypes.c_int
        suffix = "_tiles" if tiles else ""
        dq = getattr(lib, f"flash_attn_bwd_dq{suffix}")
        dkv = getattr(lib, f"flash_attn_bwd_dkv{suffix}")
        dq.argtypes = [p] * 10 + [i] * 6 + [ctypes.c_float, i, i, p] + [p] * tiles
        dkv.argtypes = [p] * 11 + [i] * 6 + [ctypes.c_float, i, i, p] + [p] * tiles
        dq.restype = dkv.restype = i
        _bwd_fns[tiles] = (dq, dkv)
    return _bwd_fns[tiles]


def _queue(x, head_dim: int):
    """The work queue of K2a's or K2b's forms at head dims 384 and 512: one
    int32 zeroed on ``x``'s device, which the blocks take their items from
    (None below 384, where the kernels walk a fixed order)."""
    return torch.zeros(1, dtype=torch.int32, device=x.device) if head_dim > 256 else None


def _delta(out, do, dlse):
    """[B, NH, Lq] f32: sum(out * do, -1), minus the lse cotangent (d lse /
    d s_j = p_j, so it folds into delta: ds = p * (dp - delta + dlse))."""
    delta = (out.float() * do.float()).sum(dim=-1).permute(0, 2, 1)
    if dlse is not None:
        delta = delta - dlse.float()
    return delta.contiguous()


def _reference_p_ds(q, k, v, seg_q, seg_kv, lse, delta, do, causal: bool, scale: float,
                    window: int = 0):
    """(p, ds) [B, NH, Lq, Lk] f32 of the plain backward: p = where(mask,
    exp(s - lse), 0), selected so that rows with lse -1e30 give exact zeros,
    and ds = p * (dp - delta) rounded to q's dtype as the kernels round it."""
    g = q.shape[2] // k.shape[2]
    kf = k.float().repeat_interleave(g, dim=2)
    vf = v.float().repeat_interleave(g, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * scale
    mask = _mask(q, k, seg_q, seg_kv, causal, window)
    # masked entries are replaced before the exponential: exp(s + 1e30) never runs
    p = torch.where(mask, torch.exp(torch.where(mask, s - lse[..., None], 0.0)), 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), vf)
    ds = (p * (dp - delta[..., None])).to(q.dtype).float()
    return p, ds


def flash_attention_dq_reference(q, k, v, seg_q, seg_kv, lse, delta, do, causal: bool,
                                 scale: float, window: int = 0):
    """Plain version of K2a: dq = (ds k) * scale, f32 accumulation."""
    _, ds = _reference_p_ds(q, k, v, seg_q, seg_kv, lse, delta, do, causal, scale, window)
    kf = k.float().repeat_interleave(q.shape[2] // k.shape[2], dim=2)
    return (torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale).to(q.dtype)


def _dkv_from(p, ds, q, k, v, do, scale: float):
    b, lk, nkv, hd = k.shape
    g = q.shape[2] // nkv
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), do.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * scale
    dk = dk.reshape(b, lk, nkv, g, hd).sum(dim=3)
    dv = dv.reshape(b, lk, nkv, g, hd).sum(dim=3)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_dkv_reference(q, k, v, seg_q, seg_kv, lse, delta, do, causal: bool,
                                  scale: float, window: int = 0):
    """Plain version of K2b: dv = p^T do with p rounded to ``do``'s dtype,
    dk = (ds^T q) * scale, both summed over the GQA group in f32."""
    p, ds = _reference_p_ds(q, k, v, seg_q, seg_kv, lse, delta, do, causal, scale, window)
    return _dkv_from(p, ds, q, k, v, do, scale)


def sinks_grad(sinks, lse, delta):
    """d loss / d sinks [NH] in ``sinks``' dtype: a sink's probability in row
    q is exp(sink - lse(q)), and its logit's gradient is -p_sink * delta
    (delta with the lse cotangent folded in), summed over batch and rows; rows
    that saw neither key nor sink (lse -1e30) give nothing. Plain PyTorch
    beside the kernels, as the TPU package does it in XLA beside its own."""
    w = torch.where(lse > NEG_INF / 2, torch.exp(sinks.float()[None, :, None] - lse), 0.0)
    return (-(w * delta).sum(dim=(0, 2))).to(sinks.dtype)


def flash_attention_backward_reference(q, k, v, seg_q, seg_kv, out, lse, do, dlse,
                                       causal: bool, scale: float, window: int = 0):
    """Plain version of K2a + K2b: (dq, dk, dv) from the saved ``lse``, with
    the kernels' arithmetic: p selected by the mask, p rounded to ``do``'s
    dtype before p^T do, ds rounded to q's dtype before both of its products,
    f32 accumulation, ``scale`` applied to s and again to the dq/dk sums,
    dk/dv summed over the GQA group. A sink needs no term here: it is inside
    ``lse`` (its own gradient is ``sinks_grad``)."""
    delta = _delta(out, do, dlse)  # [B, NH, Lq]
    p, ds = _reference_p_ds(q, k, v, seg_q, seg_kv, lse, delta, do, causal, scale, window)
    kf = k.float().repeat_interleave(q.shape[2] // k.shape[2], dim=2)
    dq = (torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale).to(q.dtype)
    return (dq, *_dkv_from(p, ds, q, k, v, do, scale))


def _check_bwd_args(q, k, v, seg_q, seg_kv, lse, delta, do):
    b, lq, nh, hd = q.shape
    lk, nkv = k.shape[1], k.shape[2]
    check_head_dim("flash_attn_bwd", hd, nh, nkv)
    _build.require(q, "q", torch.bfloat16)
    _build.require(k, "k", torch.bfloat16, (b, lk, nkv, hd))
    _build.require(v, "v", torch.bfloat16, (b, lk, nkv, hd))
    _build.require(do, "do", torch.bfloat16, (b, lq, nh, hd))
    _build.require(seg_q, "seg_q", torch.int32, (b, lq))
    _build.require(seg_kv, "seg_kv", torch.int32, (b, lk))
    _build.require(lse, "lse", torch.float32, (b, nh, lq))
    _build.require(delta, "delta", torch.float32, (b, nh, lq))
    return b, lq, lk, nh, nkv, hd


def flash_attention_dq(q, k, v, seg_q, seg_kv, lse, delta, do, causal: bool, scale: float,
                       window: int = 0, tiles=None):
    """K2a on CUDA tensors: dq [B, Lq, NH, HD] bf16. ``delta`` [B, NH, Lq] f32
    is sum(out * do, -1) minus the lse cotangent. ``tiles`` (int32 [B, NH,
    ceil(Lq / bq), 2] with ``bq`` of ``dq_tiles``, or None) receives each q
    tile's visited and candidate kv tiles."""
    b, lq, lk, nh, nkv, hd = _check_bwd_args(q, k, v, seg_q, seg_kv, lse, delta, do)
    if hd not in HEAD_DIMS:
        return bwd_padded(flash_attention_dq, q, k, v, seg_q, seg_kv, lse, delta, do, causal,
                          scale, window, tiles)
    if tiles is not None:
        _build.require(tiles, "tiles", torch.int32, (b, nh, -(-lq // dq_tiles(hd)[0]), 2))
    dq, queue = torch.empty_like(q), _queue(q, hd)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), seg_q.data_ptr(),
            seg_kv.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            None if queue is None else queue.data_ptr(), b, lq, lk, nh, nkv, hd, float(scale),
            int(causal), int(window), _build.stream_ptr(q))
    fn = _bwd_kernels(tiles is not None)[0]
    _build.check(KERNEL_DQ, fn(*args) if tiles is None else fn(*args, tiles.data_ptr()))
    _build.count(KERNEL_DQ, window)
    count_wide(KERNEL_DQ, hd)
    return dq


def flash_attention_dkv(q, k, v, seg_q, seg_kv, lse, delta, do, causal: bool, scale: float,
                        window: int = 0, tiles=None):
    """K2b on CUDA tensors: (dk, dv) [B, Lk, NKV, HD] bf16, the GQA group
    summed inside the kernel. ``tiles`` (int32 [B, NKV, ceil(Lk / bk), 2]
    with ``bk`` of ``dkv_tiles``, or None) receives each kv tile's visited and
    candidate q tiles (of one head: every head of the group visits the
    same)."""
    b, lq, lk, nh, nkv, hd = _check_bwd_args(q, k, v, seg_q, seg_kv, lse, delta, do)
    if hd not in HEAD_DIMS:
        return bwd_padded(flash_attention_dkv, q, k, v, seg_q, seg_kv, lse, delta, do, causal,
                          scale, window, tiles)
    if tiles is not None:
        _build.require(tiles, "tiles", torch.int32, (b, nkv, -(-lk // dkv_tiles(hd)[1]), 2))
    dk, dv, queue = torch.empty_like(k), torch.empty_like(v), _queue(q, hd)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), seg_q.data_ptr(),
            seg_kv.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            None if queue is None else queue.data_ptr(), b, lq, lk, nh, nkv, hd, float(scale),
            int(causal), int(window), _build.stream_ptr(q))
    fn = _bwd_kernels(tiles is not None)[1]
    _build.check(KERNEL_DKV, fn(*args) if tiles is None else fn(*args, tiles.data_ptr()))
    _build.count(KERNEL_DKV, window)
    count_wide(KERNEL_DKV, hd)
    return dk, dv


def flash_bwd_tile_counts(q, k, v, seg_q, seg_kv, lse, delta, do, causal: bool,
                          window: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """(K2a's int32 [B, NH, nq, 2], K2b's int32 [B, NKV, nk, 2]): the tiles
    each kernel visited and its candidates, as the kernels counted them in one
    launch each on these inputs (K2a: kv tiles for each q tile of
    ``dq_tiles``; K2b: q tiles for each kv tile of ``dkv_tiles``). Only the kernels count: CPU
    tensors raise (``flash_tiles_visited`` and ``flash_bwd_dkv_tiles_visited``
    are the rules' plain mirrors)."""
    if not q.is_cuda:
        raise ValueError("flash_bwd_tile_counts: the counts come from the kernels, which take "
                         "CUDA tensors")
    b, lq, nh, hd = q.shape
    lk, nkv = k.shape[1], k.shape[2]
    dq_counts = torch.full((b, nh, -(-lq // dq_tiles(hd)[0]), 2), -1, dtype=torch.int32,
                           device=q.device)
    dkv_counts = torch.full((b, nkv, -(-lk // dkv_tiles(hd)[1]), 2), -1, dtype=torch.int32,
                            device=q.device)
    args = (q, k, v, seg_q, seg_kv, lse, delta, do, causal, hd ** -0.5, window)
    flash_attention_dq(*args, tiles=dq_counts)
    flash_attention_dkv(*args, tiles=dkv_counts)
    return dq_counts, dkv_counts


def flash_attention_backward(q, k, v, seg_q, seg_kv, out, lse, do, dlse, causal: bool,
                             scale: float, window: int = 0, sinks=None):
    """(dq, dk, dv, dsinks): K2a and K2b for CUDA tensors, the plain version
    for CPU tensors; ``dsinks`` (None without sinks) is ``sinks_grad`` on both.
    ``do`` is the cotangent of ``out``, ``dlse`` (or None) of ``lse``."""
    if not q.is_cuda:
        dq, dk, dv = flash_attention_backward_reference(q, k, v, seg_q, seg_kv, out, lse, do,
                                                        dlse, causal, scale, window)
        delta = _delta(out, do, dlse) if sinks is not None else None
    else:
        do = do.contiguous()
        delta = _delta(out, do, dlse)
        dq = flash_attention_dq(q, k, v, seg_q, seg_kv, lse, delta, do, causal, scale, window)
        dk, dv = flash_attention_dkv(q, k, v, seg_q, seg_kv, lse, delta, do, causal, scale,
                                     window)
    dsinks = None if sinks is None else sinks_grad(sinks, lse, delta)
    return dq, dk, dv, dsinks


class AttnSaved:
    """Kernel outputs of one attention call, kept across a recomputation: a
    checkpointed layer that runs again for its backward hands them back
    instead of launching K1 a second time (the ``save_attn`` remat mode)."""

    __slots__ = ("out", "lse")

    def __init__(self):
        self.out = None
        self.lse = None


class _Flash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, sinks, seg_q, seg_kv, causal, scale, window, saved):
        if saved is not None and saved.out is not None:
            # fresh views: the Function ties the tensors it returns to its own node
            out, lse = saved.out.detach(), saved.lse.detach()
        elif q.is_cuda:
            sinks32 = None if sinks is None else sinks.float().contiguous()
            out, lse = _fwd_cuda(q, k, v, seg_q, seg_kv, causal, scale, window, sinks32)
        else:
            out, lse = flash_attention_reference(q, k, v, seg_q, seg_kv, causal, scale, window,
                                                 sinks)
        if saved is not None:
            saved.out, saved.lse = out.detach(), lse.detach()
        ctx.save_for_backward(q, k, v, sinks, seg_q, seg_kv, out, lse)
        ctx.causal, ctx.scale, ctx.window = causal, scale, window
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, sinks, seg_q, seg_kv, out, lse = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(out)
        dq, dk, dv, dsinks = flash_attention_backward(q, k, v, seg_q, seg_kv, out, lse, do, dlse,
                                                      ctx.causal, ctx.scale, ctx.window, sinks)
        return dq, dk, dv, dsinks, None, None, None, None, None, None


def _fwd(q, k, v, seg_q, seg_kv, causal: bool, scale: float | None,
         saved: AttnSaved | None = None, window: int = 0, sinks: torch.Tensor | None = None):
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.is_cuda:
        seg_q, seg_kv = seg_q.to(torch.int32), seg_kv.to(torch.int32)
    return _Flash.apply(q, k, v, sinks, seg_q, seg_kv, bool(causal), float(scale), int(window),
                        saved)


def flash_attention(
    q: torch.Tensor,  # [B, L, NH, HD]
    k: torch.Tensor,  # [B, L, NKV, HD]
    v: torch.Tensor,  # [B, L, NKV, HD]
    segment_ids: torch.Tensor,  # [B, L] int32, 0 = pad
    causal: bool = True,
    scale: float | None = None,
    window: int = 0,
    sinks: torch.Tensor | None = None,
    saved: AttnSaved | None = None,
) -> torch.Tensor:
    """Public entry, [B, L, N, D] layout in and out (matches ops.attention).
    ``window`` (a sliding window, 0 = full) and ``sinks`` ([NH] learned
    logits, differentiable) are the gpt-oss forms. ``saved`` keeps the
    kernel's outputs across a checkpoint's recomputation."""
    out, _ = _fwd(q, k, v, segment_ids, segment_ids, causal, scale, saved, int(window or 0),
                  sinks)
    return out


def flash_attention_with_lse(
    q: torch.Tensor,  # [B, Lq, NH, HD]
    k: torch.Tensor,  # [B, Lkv, NKV, HD]
    v: torch.Tensor,  # [B, Lkv, NKV, HD]
    seg_q: torch.Tensor,  # [B, Lq]
    seg_kv: torch.Tensor,  # [B, Lkv]
    causal: bool = False,
    scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(out [B, Lq, NH, HD], lse [B, NH, Lq]): partials over different KV
    blocks merge exactly through their lse, and the lse cotangent folds into
    delta so that gradients flow through the merge. ``causal`` compares
    absolute row and column indices, so it only makes sense for the diagonal
    block."""
    return _fwd(q, k, v, seg_q, seg_kv, causal, scale)

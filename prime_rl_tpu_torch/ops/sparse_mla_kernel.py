"""K5a, K5b: sparse MLA attention (DSA) over each token's selected latent-KV
rows, forward and backward: the hand-written CUDA kernels of
``csrc/sparse_mla.cu`` and their plain PyTorch versions.

The counterpart of the JAX package's ``ops/sparse_mla_pallas.py`` (renamed:
there is no Pallas here). It replaces the TPU kernels ``_fwd_kernel`` (K5a,
the ``pallas_call`` in ``_fwd_call``) and ``_bwd_kernel`` (K5b, the
``pallas_call`` in ``_bwd_call``) together with the row gather and its
transpose, the dKV scatter-add, which the JAX package leaves to XLA.

Contract of ``sparse_mla_attention(q [S, H, Dq], kv [Sk, Dq], indices
[S, topk] int32, sm_scale, v_dim) -> [S, H, v_dim]`` (a leading batch dim on
all three is looped over): softmax over each query's selected rows, an index
outside ``[0, Sk)`` (the sentinel is ``Sk``) masked out, value = the first
``v_dim`` channels of the row. A token that selected nothing gets output 0,
lse -5e29 and gradient 0. **The real indices of one row must be distinct**
(a top-k gives that): the backward sums one dkv contribution per selected
slot. One ``torch.autograd.Function`` saves ``q, kv, indices, out, lse``,
never the gathered rows.

Where bfloat16 rounds, in the kernels and in the plain versions alike: ``p``
to kv's dtype before ``p v``, ``ds`` to kv's dtype before both of its
products (``ds`` is exactly 0 for a token with one valid slot, whose softmax
is 1 on it: the f32 noise of ``dp - delta`` broke bf16 ties of its dkv row
differently in the kernel and the plain version), ``p`` to do's dtype for
dv, float32 sums. The per-slot dkv rows stay float32 (the wide forms round
them to kv's dtype once): rounded, the kernel's sum over 64 heads and the
plain version's, in other orders, could land one bf16 step apart, which
large rows that cancel in dkv turned into a miss of the tolerance. Unlike
the JAX package, which rounds those rows and adds them up in bfloat16, dkv
is summed in float32 and rounded once.

On the card the kernels are built for bfloat16 tensors with ``Dq = 576,
v_dim = 512`` (latent 512 + rope 64, the MLA widths of the glm_moe_dsa
family) and any ``H % 8 == 0`` (the JAX kernel's condition on H). The
wrappers take any ``Dq <= 576`` and ``v_dim <= 512`` with ``v_dim % 128 ==
0`` (and ``v_dim <= Dq``) by zero-padding the columns of q and kv to 576 and
of do to 512 (``fwd_padded``, ``bwd_padded``), then slicing out to ``v_dim``
and dq and dkv to ``Dq``. That is exact: the zero columns add 0 to every
score, the kernels' V is ``kv[:, :512]``, whose first ``v_dim`` columns are
the real V, and the zero columns of do add 0 to dP and to dkv. Wider widths
go to the wide forms: any ``Dq <= 1152`` and ``v_dim <= 1024`` (twice the
MLA widths; ``v_dim % 128 == 0``) zero-padded the same way to 1152/1024
(``built_widths``). The wide K5a is a plain SIMT kernel (groups of 8 heads,
tiles of ``WIDE_FWD_TILE`` slots); the wide K5b a ``wgmma`` kernel that
takes a chunk's heads in groups of ``WIDE_HEADS`` = 16 (the last one of
8 where ``H % 16 == 8``), one launch a group in ascending order, each
followed by the dkv reduction, with tiles of ``WIDE_BWD_TILE`` slots: each
slot's dkvg row summed over a group's heads and rounded once to bf16, the groups'
rows summed in f32 (``sparse_mla_grouped_reference`` mirrors it). Wider widths raise
(``check_widths``: the wide forms' shared memory and registers end there);
the TPU version's quiet fall-back to the XLA form is not carried over. A
576-wide kernel block holds one group of ``HEADS`` = 64
heads: the wrappers pad q (and do) with zero heads to ``Hp = ceil(H / 64) *
64`` and launch once a group, the padded heads' rows dropped
(``sparse_mla_grouped_reference`` is the plain mirror of that decomposition). The backward runs over chunks of queries: K5b writes
each chunk's per-slot dkv rows into a ``[chunk, topk, Dq]`` buffer of
1.2 GB (f32 rows; bf16 in the wide form, at twice the width), and ``sparse_mla_dkv_reduce`` gives every kv row one block that sums
the rows of the slots that selected it, in the order of a stable sort of the
chunk's indices: no atomics, so two runs give the same bits. Each chunk's
groups run in ascending order, each launch followed by its reduction into
the same f32 dkv. K5a and K5b skip
the tiles (of ``FWD_TILE`` and ``BWD_TILE`` slots) that hold only sentinels
and count the ones they visit (``sparse_mla_fwd_tile_counts``,
``sparse_mla_bwd_tile_counts``; ``sparse_mla_bwd_tiles_visited`` with the
tile size is the rule's plain mirror for both). What bounds the kernels and what their design does
about it: the note in ``csrc/sparse_mla.cu``.

For CPU tensors the wrappers run ``sparse_mla_attention_reference`` and
``sparse_mla_backward_reference``; for CUDA tensors they launch the kernels
or raise.
"""

from __future__ import annotations

import ctypes

import torch

from prime_rl_tpu_torch.ops import _build

NEG_INF = -1e30
KERNEL = "sparse_mla"  # one source, three kernels, counted separately:
KERNEL_FWD = "sparse_mla_fwd"
KERNEL_BWD = "sparse_mla_bwd"
KERNEL_REDUCE = "sparse_mla_dkv_reduce"
HEADS, DQ, DV = 64, 576, 512  # heads a kernel block (a group) and the widths compiled for
DQ_WIDE, DV_WIDE = 1152, 1024  # the wide forms' widths
WIDE_FWD_TILE, WIDE_BWD_TILE = 16, 64  # slots a tile of the wide K5a and K5b
WIDE_HEADS = 16  # heads a launch of the wide K5b (its group; the kernel's k5bw::HG)
# (query, slot) pairs per backward launch: a 1.2 GB dkvg buffer of rows of 2304
# bytes (576 f32 values in K5b's, 1152 bf16 in the wide K5b's)
BWD_SLOTS = 1 << 19
BWD_TILE = 32  # slots a K5b tile
FWD_TILE = 64  # slots a K5a tile (the kernel's k5a::BT)

_fns = None


def _kernels():
    global _fns
    if _fns is None:
        lib = _build.load(KERNEL)
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fwd, bwd, red = lib.sparse_mla_fwd, lib.sparse_mla_bwd, lib.sparse_mla_dkv_reduce
        fwd_tiles, bwd_tiles = lib.sparse_mla_fwd_tiles, lib.sparse_mla_bwd_tiles
        fwd.argtypes = [p] * 5 + [i] * 7 + [f, p]
        fwd_tiles.argtypes = [p] * 5 + [i] * 7 + [f, p, p]
        bwd.argtypes = [p] * 8 + [i] * 7 + [f, p]
        bwd_tiles.argtypes = [p] * 8 + [i] * 7 + [f, p, p]
        red.argtypes = [p] * 4 + [i] * 2 + [p]
        fwd_w, bwd_w = lib.sparse_mla_fwd_wide, lib.sparse_mla_bwd_wide
        fwd_w.argtypes = [p] * 5 + [i] * 4 + [f, p, p]
        bwd_w.argtypes = [p] * 8 + [i] * 5 + [f, p, p]
        for fn in (fwd, fwd_tiles, bwd, bwd_tiles, red, fwd_w, bwd_w):
            fn.restype = i
        _fns = (fwd, bwd, red, bwd_tiles, fwd_tiles, fwd_w, bwd_w)
    return _fns


def bwd_chunk(S: int, T: int) -> int:
    """Queries per backward launch: as many as keep the dkvg buffer within
    ``BWD_SLOTS`` rows, a multiple of 8, so that every chunk's slice of the
    indices starts on a 32-byte boundary."""
    return max(1, min(S, max(8, BWD_SLOTS // max(T, 1) // 8 * 8)))


def bwd_launches(S: int, T: int, H: int = HEADS) -> int:
    """K5b launches (and reductions) of one backward call: one a chunk and
    group of ``HEADS`` heads."""
    return -(-S // bwd_chunk(S, T)) * (-(-H // HEADS))


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _gather(kv, ic):
    Sk = kv.shape[0]
    valid = (ic >= 0) & (ic < Sk)
    return kv[ic.clamp(0, Sk - 1)], valid


def sparse_mla_attention_reference(q, kv, indices, sm_scale: float, v_dim: int,
                                   chunk: int = 128):
    """Plain version of K5a: (out [S, H, v_dim] in q's dtype, lse [S, H] f32).
    Scores and softmax in f32, p rounded to kv's dtype before the value
    product, the sum taken before the rounding."""
    outs, lses = [], []
    for c0 in range(0, q.shape[0], chunk):
        qc, ic = q[c0:c0 + chunk], indices[c0:c0 + chunk].long()
        kvg, valid = _gather(kv, ic)
        valid = valid[:, None, :]
        s = torch.einsum("chd,ctd->cht", qc.float(), kvg.float()) * sm_scale
        s = torch.where(valid, s, NEG_INF)
        m = s.amax(dim=-1, keepdim=True).clamp(min=NEG_INF / 2)
        p = torch.where(valid, torch.exp(s - m), 0.0)
        l = p.sum(dim=-1, keepdim=True).clamp(min=1e-30)
        o = torch.einsum("cht,ctd->chd", p.to(kv.dtype).float(), kvg[..., :v_dim].float()) / l
        outs.append(o.to(q.dtype))
        lses.append((m + torch.log(l))[..., 0])
    return torch.cat(outs, dim=0), torch.cat(lses, dim=0)


def sparse_mla_backward_reference(q, kv, indices, out, lse, do, sm_scale: float, v_dim: int,
                                  chunk: int = 128):
    """Plain version of K5b and the dkv reduction: (dq [S, H, Dq], dkv
    [Sk, Dq]) from the saved lse, rounding where the kernels round (the
    per-slot dkv rows only at the wide widths: ``_backward_into``)."""
    dkv = torch.zeros(kv.shape, dtype=torch.float32, device=kv.device)
    delta = (out.float() * do.float()).sum(dim=-1)  # [S, H]
    wide = built_widths(q.shape[-1], v_dim)[0] == DQ_WIDE
    dq = _backward_into(q, kv, indices, lse, delta, do, dkv, sm_scale, v_dim, chunk,
                        round_rows=wide)
    return dq, dkv.to(kv.dtype)


def _backward_into(q, kv, indices, lse, delta, do, dkv, sm_scale: float, v_dim: int,
                   chunk: int = 128, round_rows: bool = False):
    """dq [S, H, Dq] of the plain backward; the per-slot dkv rows are added
    into the f32 ``dkv`` as f32, as K5b writes them, or with ``round_rows``
    rounded to kv's dtype first, as the wide K5b writes them."""
    Sk = kv.shape[0]
    dqs = []
    for c0 in range(0, q.shape[0], chunk):
        qc, ic = q[c0:c0 + chunk].float(), indices[c0:c0 + chunk].long()
        doc = do[c0:c0 + chunk]
        kvg, valid = _gather(kv, ic)
        kvg = kvg.float()
        s = torch.einsum("chd,ctd->cht", qc, kvg) * sm_scale
        mask = valid[:, None, :]
        # masked entries are replaced before the exponential: exp(s + 5e29) never runs
        p = torch.where(mask, torch.exp(torch.where(mask, s - lse[c0:c0 + chunk, :, None], 0.0)),
                        0.0)
        dp = torch.einsum("chd,ctd->cht", doc.float(), kvg[..., :v_dim])
        ds = p * (dp - delta[c0:c0 + chunk, :, None]) * sm_scale
        # a token with one valid slot has p = 1 and delta = dp: ds is exactly 0
        # there (the kernels store 0 too, rather than the f32 noise of dp - delta)
        ds = torch.where((valid.sum(-1) == 1)[:, None, None], 0.0, ds).to(kv.dtype).float()
        dqs.append(torch.einsum("cht,ctd->chd", ds, kvg).to(q.dtype))
        dkvg = torch.einsum("cht,chd->ctd", ds, qc)
        dkvg[..., :v_dim] += torch.einsum("cht,chd->ctd", p.to(do.dtype).float(), doc.float())
        if round_rows:
            dkvg = dkvg.to(kv.dtype).float()
        dkv.index_add_(0, ic[valid], dkvg[valid])
    return torch.cat(dqs, dim=0)


def padded_heads(H: int) -> int:
    """Hp: H rounded up to whole kernel blocks of ``HEADS`` heads."""
    return -(-H // HEADS) * HEADS


def _pad_heads(x: torch.Tensor, Hp: int) -> torch.Tensor:
    """x [S, H, ...] with zero heads appended up to Hp (x itself when H = Hp)."""
    H = x.shape[1]
    if H == Hp:
        return x
    pad = x.new_zeros((x.shape[0], Hp - H) + tuple(x.shape[2:]))
    return torch.cat([x, pad], dim=1)


def sparse_mla_grouped_reference(q, kv, indices, sm_scale: float, v_dim: int, do=None,
                                 out=None, lse=None):
    """The kernels' decomposition in plain PyTorch: q's heads padded with zero
    rows to ``padded_heads(H)``, the plain forward run a group of ``HEADS``
    heads at a time and the padded rows dropped. Returns (out [S, H, v_dim],
    lse [S, H]), and given ``do`` [S, H, v_dim] also (dq [S, H, Dq], dkv [Sk,
    Dq]): the plain backward run over the same groups (do and delta padded
    with zeros; from the given ``out`` and ``lse``, where the caller has the
    forward's), each query chunk of ``bwd_chunk`` tokens in ascending group
    order adding its f32 rows into one f32 dkv, rounded once, as K5b and the
    reduction do. At the wide widths (``built_widths``) the groups are the
    wide K5b's: ``WIDE_HEADS`` heads each, unpadded (the last group may hold
    8), and their rows are rounded to kv's dtype a group, as it writes
    them."""
    S, H, _ = q.shape
    wide = built_widths(q.shape[-1], v_dim)[0] == DQ_WIDE
    Hp = H if wide else padded_heads(H)
    qp = _pad_heads(q, Hp)
    size = WIDE_HEADS if wide else HEADS
    groups = [slice(g, min(g + size, Hp)) for g in range(0, Hp, size)]
    if out is None or lse is None:
        fwd = [sparse_mla_attention_reference(qp[:, g], kv, indices, sm_scale, v_dim)
               for g in groups]
        out = torch.cat([o for o, _ in fwd], dim=1)[:, :H]
        lse = torch.cat([l for _, l in fwd], dim=1)[:, :H]
    if do is None:
        return out, lse
    dop = _pad_heads(do, Hp)
    delta = _pad_heads((out.float() * do.float()).sum(dim=-1), Hp)
    lsep = _pad_heads(lse, Hp)
    dkv = torch.zeros(kv.shape, dtype=torch.float32, device=kv.device)
    dq = torch.empty_like(qp)
    chunk = bwd_chunk(S, indices.shape[1])
    for c0 in range(0, S, chunk):
        c = slice(c0, c0 + chunk)
        for g in groups:
            dq[c, g] = _backward_into(qp[c, g], kv, indices[c], lsep[c, g], delta[c, g],
                                      dop[c, g], dkv, sm_scale, v_dim, round_rows=wide)
    return out, lse, dq[:, :H], dkv.to(kv.dtype)


def sparse_mla_bwd_tiles_visited(indices: torch.Tensor, Sk: int,
                                 bt: int = BWD_TILE) -> torch.Tensor:
    """[S, ceil(T / bt)] bool: the tiles of ``bt`` slots K5b (``bt`` =
    ``BWD_TILE``) or K5a (``FWD_TILE``) visits for each token, the plain mirror
    of the kernels' rule: a tile is visited iff it
    holds an index in ``[0, Sk)``, wherever the sentinels lie in the row; the
    slots past T count as sentinels."""
    S, T = indices.shape
    n = -(-T // bt)
    real = (indices >= 0) & (indices < Sk)
    real = torch.nn.functional.pad(real, (0, n * bt - T))
    return real.reshape(S, n, bt).any(-1)


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

def check_widths(H: int, Dq: int, v_dim: int) -> None:
    """Raise ValueError unless the wrappers take these widths: any ``H % 8 ==
    0`` (the JAX kernel's condition on H), ``Dq <= 1152`` and ``v_dim <=
    1024`` with ``v_dim % 128 == 0`` and ``v_dim <= Dq`` (the kernels run at
    576/512 or, wider, at 1152/1024: ``built_widths``; the narrower widths
    zero-padded)."""
    if (H <= 0 or H % 8 or not 0 < Dq <= DQ_WIDE or not 0 < v_dim <= min(DV_WIDE, Dq)
            or v_dim % 128):
        raise ValueError(f"the sparse MLA kernels take H % 8 == 0, Dq <= {DQ_WIDE} and v_dim <= "
                         f"{DV_WIDE} with v_dim % 128 == 0; got H = {H}, Dq = {Dq}, "
                         f"v_dim = {v_dim}")


def built_widths(Dq: int, v_dim: int) -> tuple[int, int]:
    """The (Dq, Dv) the kernels run (Dq, v_dim) at: the MLA widths 576/512
    where they hold it, else the wide forms' 1152/1024."""
    return (DQ, DV) if Dq <= DQ and v_dim <= DV else (DQ_WIDE, DV_WIDE)



def _pad_cols(x: torch.Tensor, width: int) -> torch.Tensor:
    return x if x.shape[-1] == width else torch.nn.functional.pad(x, (0, width - x.shape[-1]))


def fwd_padded(fwd, q, kv, indices, sm_scale: float, v_dim: int, **kw):
    """``fwd(q, kv, indices, sm_scale, v_dim, **kw) -> (out, lse)`` run at
    the built widths (``built_widths``): q and kv zero-padded to their Dq
    columns, the call made at their Dv, out sliced back to ``v_dim``."""
    dq_b, dv_b = built_widths(q.shape[-1], v_dim)
    if (q.shape[-1], v_dim) == (dq_b, dv_b):
        return fwd(q, kv, indices, sm_scale, v_dim, **kw)
    out, lse = fwd(_pad_cols(q, dq_b), _pad_cols(kv, dq_b), indices, sm_scale, dv_b, **kw)
    return out[..., :v_dim].contiguous(), lse


def bwd_padded(bwd, q, kv, indices, out, lse, do, sm_scale: float, v_dim: int, **kw):
    """``bwd(q, kv, indices, out, lse, do, sm_scale, v_dim, **kw) -> (dq,
    dkv)`` run at the built widths (``built_widths``): q and kv zero-padded
    to their Dq columns, out and do to their Dv (rowsum(out * do) is
    unchanged), dq and dkv sliced back to q's width."""
    dq_w = q.shape[-1]
    dq_b, dv_b = built_widths(dq_w, v_dim)
    if (dq_w, v_dim) == (dq_b, dv_b):
        return bwd(q, kv, indices, out, lse, do, sm_scale, v_dim, **kw)
    dq, dkv = bwd(_pad_cols(q, dq_b), _pad_cols(kv, dq_b), indices, _pad_cols(out, dv_b), lse,
                  _pad_cols(do, dv_b), sm_scale, dv_b, **kw)
    return dq[..., :dq_w].contiguous(), dkv[..., :dq_w].contiguous()


def _check_args(q, kv, indices, v_dim: int):
    S, H, Dq = q.shape
    check_widths(H, Dq, v_dim)
    _build.require(q, "q", torch.bfloat16)
    _build.require(kv, "kv", torch.bfloat16, (kv.shape[0], Dq))
    _build.require(indices, "indices", torch.int32, (S, indices.shape[1]))
    return S, kv.shape[0], indices.shape[1]


def sparse_mla_fwd(q, kv, indices, sm_scale: float, v_dim: int, tiles=None):
    """K5a on CUDA tensors: (out [S, H, v_dim] bf16, lse [S, H] f32), one
    launch a group of ``HEADS`` heads over q padded to ``padded_heads(H)``.
    Given ``tiles`` (int32 [S, 2]), the launches also write each token's tiles
    of ``FWD_TILE`` slots visited and its candidates there."""
    S, Sk, T = _check_args(q, kv, indices, v_dim)
    if (q.shape[-1], v_dim) == (DQ_WIDE, DV_WIDE):
        return _fwd_wide(q, kv, indices, sm_scale, tiles)
    if (q.shape[-1], v_dim) != (DQ, DV):
        return fwd_padded(sparse_mla_fwd, q, kv, indices, sm_scale, v_dim, tiles=tiles)
    H = q.shape[1]
    Hp = padded_heads(H)
    qp = _pad_heads(q, Hp)
    out = torch.empty((S, Hp, v_dim), dtype=q.dtype, device=q.device)
    lse = torch.empty((S, Hp), dtype=torch.float32, device=q.device)
    if tiles is not None:
        _build.require(tiles, "tiles", torch.int32, (S, 2))
    for h0 in range(0, Hp, HEADS):
        args = (qp.data_ptr(), kv.data_ptr(), indices.data_ptr(), out.data_ptr(), lse.data_ptr(),
                S, Sk, T, Hp, h0, DQ, v_dim, float(sm_scale), _build.stream_ptr(q))
        if tiles is None:
            _build.check(KERNEL_FWD, _kernels()[0](*args))
        else:
            _build.check(KERNEL_FWD, _kernels()[4](*args, tiles.data_ptr()))
        _build.launches[KERNEL_FWD] += 1
    if Hp == H:
        return out, lse
    return out[:, :H].contiguous(), lse[:, :H].contiguous()


def _fwd_wide(q, kv, indices, sm_scale: float, tiles=None):
    """The wide K5a at Dq 1152, Dv 1024: one launch for all H heads."""
    S, H, _ = q.shape
    out = torch.empty((S, H, DV_WIDE), dtype=q.dtype, device=q.device)
    lse = torch.empty((S, H), dtype=torch.float32, device=q.device)
    if tiles is not None:
        _build.require(tiles, "tiles", torch.int32, (S, 2))
    _build.check(KERNEL_FWD, _kernels()[5](
        q.data_ptr(), kv.data_ptr(), indices.data_ptr(), out.data_ptr(), lse.data_ptr(), S,
        kv.shape[0], indices.shape[1], H, float(sm_scale), _build.stream_ptr(q),
        None if tiles is None else tiles.data_ptr()))
    _build.count(KERNEL_FWD)
    _build.launches[f"{KERNEL_FWD}/wide"] += 1
    return out, lse


def sparse_mla_fwd_tile_counts(q, kv, indices, sm_scale: float, v_dim: int) -> torch.Tensor:
    """int32 [S, 2]: the tiles of ``FWD_TILE`` slots (``WIDE_FWD_TILE`` at
    the wide widths) K5a visited for each token and its candidates, as the
    kernel counted them in one launch on these inputs. Only the kernel
    counts: CPU tensors raise (the rule's plain mirror is
    ``sparse_mla_bwd_tiles_visited(indices, Sk, FWD_TILE)``)."""
    if not q.is_cuda:
        raise ValueError("sparse_mla_fwd_tile_counts: the counts come from the kernel, which "
                         "takes CUDA tensors")
    tiles = torch.full((q.shape[0], 2), -1, dtype=torch.int32, device=q.device)
    sparse_mla_fwd(q, kv, indices, sm_scale, v_dim, tiles=tiles)
    return tiles


def sparse_mla_dkv_reduce(dkvg, order, seg, dkv):
    """dkv [Sk, Dq] f32 += the rows of dkvg [slots, Dq] named by
    ``order[seg[r]:seg[r + 1]]`` for every kv row r, summed in that order:
    f32 rows at Dq 576 (K5b's), bf16 rows at 1152 (the wide K5b's)."""
    Sk = dkv.shape[0]
    width = dkv.shape[1]
    if width not in (DQ, DQ_WIDE):
        raise ValueError(f"dkv: the reduction runs at width {DQ} or {DQ_WIDE}, got {width}")
    _build.require(dkvg, "dkvg", torch.float32 if width == DQ else torch.bfloat16)
    _build.require(order, "order", torch.int64)
    _build.require(seg, "seg", torch.int32, (Sk + 1,))
    _build.require(dkv, "dkv", torch.float32, (Sk, width))
    _build.check(KERNEL_REDUCE, _kernels()[2](
        dkvg.data_ptr(), order.data_ptr(), seg.data_ptr(), dkv.data_ptr(), Sk, width,
        _build.stream_ptr(dkv)))
    _build.launches[KERNEL_REDUCE] += 1


def slot_order(indices: torch.Tensor, Sk: int):
    """The inverse of a chunk's selection: (order int64 [slots], seg int32
    [Sk + 1]) such that ``order[seg[r]:seg[r + 1]]`` are the flat slots that
    selected kv row r, ascending (a stable sort: the same order every run)."""
    flat = indices.reshape(-1)
    keys = torch.where((flat >= 0) & (flat < Sk), flat, Sk)
    sorted_keys, order = torch.sort(keys, stable=True)
    bounds = torch.arange(Sk + 1, dtype=keys.dtype, device=keys.device)
    seg = torch.searchsorted(sorted_keys, bounds).to(torch.int32)
    return order, seg


def sparse_mla_bwd_chunk(q, kv, indices, do, lse, delta, dq, dkvg, sm_scale: float,
                         v_dim: int, tiles=None, h0: int = 0) -> None:
    """One K5b launch over a chunk of C queries and the group of ``HEADS``
    heads from ``h0`` (``q, indices, do, lse, delta`` and ``dq`` are the
    chunk's slices, their heads a multiple of ``HEADS``, padded with zeros):
    writes the group's rows of ``dq`` [C, Hp, Dq] and, for every slot with a
    real index, the group's dkv row into ``dkvg`` [>= C, T, Dq] f32. Given
    ``tiles`` (int32 [C, 2]), the same launch also writes each token's tiles
    of ``BWD_TILE`` slots visited and its candidates there."""
    C, Sk, T = _check_args(q, kv, indices, v_dim)
    Hp = q.shape[1]
    if (q.shape[-1], v_dim) != (DQ, DV):
        raise ValueError(f"sparse_mla_bwd_chunk runs at the built widths Dq = {DQ}, v_dim = "
                         f"{DV} (sparse_mla_bwd pads narrower ones); got {q.shape[-1]}, {v_dim}")
    if Hp % HEADS or h0 % HEADS or not 0 <= h0 < Hp:
        raise ValueError(f"sparse_mla_bwd_chunk: heads must be whole groups of {HEADS} and h0 "
                         f"one of their starts; got {Hp} heads, h0 = {h0}")
    _build.require(do, "do", torch.bfloat16, (C, Hp, v_dim))
    _build.require(lse, "lse", torch.float32, (C, Hp))
    _build.require(delta, "delta", torch.float32, (C, Hp))
    _build.require(dq, "dq", torch.bfloat16, (C, Hp, DQ))
    _build.require(dkvg, "dkvg", torch.float32)
    if dkvg.shape[0] < C or tuple(dkvg.shape[1:]) != (T, DQ):
        raise ValueError(f"dkvg: expected at least [{C}, {T}, {DQ}], got {tuple(dkvg.shape)}")
    args = (q.data_ptr(), kv.data_ptr(), indices.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), dkvg.data_ptr(), C, Sk, T, Hp, h0, DQ, v_dim,
            float(sm_scale), _build.stream_ptr(q))
    if tiles is None:
        _build.check(KERNEL_BWD, _kernels()[1](*args))
    else:
        _build.require(tiles, "tiles", torch.int32, (C, 2))
        _build.check(KERNEL_BWD, _kernels()[3](*args, tiles.data_ptr()))
    _build.launches[KERNEL_BWD] += 1


def sparse_mla_bwd(q, kv, indices, out, lse, do, sm_scale: float, v_dim: int, tiles=None):
    """K5b and the dkv reduction on CUDA tensors, chunk by chunk and, in a
    chunk, group by group in ascending order: (dq [S, H, Dq], dkv [Sk, Dq]),
    both bf16. Given ``tiles`` (int32 [S, 2]), each chunk's K5b launches also
    write its tokens' tile counts there."""
    S, Sk, T = _check_args(q, kv, indices, v_dim)
    if (q.shape[-1], v_dim) == (DQ_WIDE, DV_WIDE):
        return _bwd_wide(q, kv, indices, out, lse, do, sm_scale, tiles)
    if (q.shape[-1], v_dim) != (DQ, DV):
        return bwd_padded(sparse_mla_bwd, q, kv, indices, out, lse, do, sm_scale, v_dim,
                          tiles=tiles)
    H = q.shape[1]
    Hp = padded_heads(H)
    do = do.contiguous()
    # the plain version's f32 sum(out * do); do is widened inside the product
    delta = _pad_heads((out.float() * do).sum(dim=-1), Hp)
    q, do, lse = _pad_heads(q, Hp), _pad_heads(do, Hp), _pad_heads(lse, Hp)
    dq = torch.empty_like(q)
    dkv = torch.zeros((Sk, DQ), dtype=torch.float32, device=q.device)
    chunk = bwd_chunk(S, T)
    dkvg = torch.empty((chunk, T, DQ), dtype=torch.float32, device=q.device)
    for c0 in range(0, S, chunk):
        sl = slice(c0, min(c0 + chunk, S))
        order, seg = slot_order(indices[sl], Sk)
        for h0 in range(0, Hp, HEADS):
            sparse_mla_bwd_chunk(q[sl], kv, indices[sl], do[sl], lse[sl], delta[sl], dq[sl],
                                 dkvg, sm_scale, v_dim, None if tiles is None else tiles[sl], h0)
            sparse_mla_dkv_reduce(dkvg, order, seg, dkv)
    if Hp != H:
        dq = dq[:, :H].contiguous()
    return dq, dkv.to(kv.dtype)


def sparse_mla_bwd_wide_chunk(q, kv, indices, do, lse, delta, dq, dkvg, sm_scale: float,
                              tiles=None, h0: int = 0) -> None:
    """One wide K5b launch over a chunk of C queries and the group of
    ``WIDE_HEADS`` heads from ``h0`` (``q, indices, do, lse, delta`` and
    ``dq`` are the chunk's slices at Dq 1152, Dv 1024, all H heads): writes
    the group's rows of ``dq`` [C, H, 1152] and, for every slot of the
    group's tiles, its dkv row over the group's heads into ``dkvg`` [>= C,
    T, 1152] bf16 (a sentinel slot's row as zeros). Given ``tiles`` (int32
    [C, 2]), it also writes each token's tiles of ``WIDE_BWD_TILE`` slots
    visited and its candidates there."""
    C, Sk, T = _check_args(q, kv, indices, DV_WIDE)
    H = q.shape[1]
    if q.shape[-1] != DQ_WIDE:
        raise ValueError(f"sparse_mla_bwd_wide_chunk runs at Dq = {DQ_WIDE}; got {q.shape[-1]}")
    if h0 % WIDE_HEADS or not 0 <= h0 < H:
        raise ValueError(f"sparse_mla_bwd_wide_chunk: h0 must start a group of {WIDE_HEADS} "
                         f"of the {H} heads; got {h0}")
    _build.require(do, "do", torch.bfloat16, (C, H, DV_WIDE))
    _build.require(lse, "lse", torch.float32, (C, H))
    _build.require(delta, "delta", torch.float32, (C, H))
    _build.require(dq, "dq", torch.bfloat16, (C, H, DQ_WIDE))
    _build.require(dkvg, "dkvg", torch.bfloat16)
    if dkvg.shape[0] < C or tuple(dkvg.shape[1:]) != (T, DQ_WIDE):
        raise ValueError(f"dkvg: expected at least [{C}, {T}, {DQ_WIDE}], got {tuple(dkvg.shape)}")
    if tiles is not None:
        _build.require(tiles, "tiles", torch.int32, (C, 2))
    _build.check(KERNEL_BWD, _kernels()[6](
        q.data_ptr(), kv.data_ptr(), indices.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), dkvg.data_ptr(), C, Sk, T, H, h0, float(sm_scale),
        _build.stream_ptr(q), None if tiles is None else tiles.data_ptr()))
    _build.count(KERNEL_BWD)
    _build.launches[f"{KERNEL_BWD}/wide"] += 1


def _bwd_wide(q, kv, indices, out, lse, do, sm_scale: float, tiles=None):
    """The wide K5b and the dkv reduction at Dq 1152, Dv 1024, chunk by chunk
    and, in a chunk, group by group of ``WIDE_HEADS`` heads in ascending
    order: one K5b launch a group, each followed by the reduction into one
    f32 dkv."""
    S, H, _ = q.shape
    Sk, T = kv.shape[0], indices.shape[1]
    do = do.contiguous()
    _build.require(lse, "lse", torch.float32, (S, H))
    delta = (out.float() * do).sum(dim=-1).contiguous()
    dq = torch.empty_like(q)
    dkv = torch.zeros((Sk, DQ_WIDE), dtype=torch.float32, device=q.device)
    chunk = bwd_chunk(S, T)
    dkvg = torch.empty((chunk, T, DQ_WIDE), dtype=torch.bfloat16, device=q.device)
    for c0 in range(0, S, chunk):
        sl = slice(c0, min(c0 + chunk, S))
        order, seg = slot_order(indices[sl], Sk)
        for h0 in range(0, H, WIDE_HEADS):
            sparse_mla_bwd_wide_chunk(q[sl], kv, indices[sl], do[sl], lse[sl], delta[sl], dq[sl],
                                      dkvg, sm_scale, None if tiles is None else tiles[sl], h0)
            sparse_mla_dkv_reduce(dkvg, order, seg, dkv)
    return dq, dkv.to(kv.dtype)


def sparse_mla_bwd_tile_counts(q, kv, indices, out, lse, do, sm_scale: float,
                               v_dim: int) -> torch.Tensor:
    """int32 [S, 2]: the tiles of ``BWD_TILE`` slots (``WIDE_BWD_TILE`` at
    the wide widths) K5b visited for each token and its candidates, as the
    kernel counted them in one backward call on these inputs. Only the kernel counts: CPU tensors raise
    (``sparse_mla_bwd_tiles_visited`` is the rule's plain mirror)."""
    if not q.is_cuda:
        raise ValueError("sparse_mla_bwd_tile_counts: the counts come from the kernel, which "
                         "takes CUDA tensors")
    tiles = torch.full((q.shape[0], 2), -1, dtype=torch.int32, device=q.device)
    sparse_mla_bwd(q, kv, indices, out, lse, do, sm_scale, v_dim, tiles=tiles)
    return tiles


def sparse_mla_forward(q, kv, indices, sm_scale: float, v_dim: int):
    """(out, lse): K5a for CUDA tensors, the plain version for CPU tensors."""
    if not q.is_cuda:
        return sparse_mla_attention_reference(q, kv, indices, sm_scale, v_dim)
    return sparse_mla_fwd(q, kv, indices, sm_scale, v_dim)


def sparse_mla_backward(q, kv, indices, out, lse, do, sm_scale: float, v_dim: int):
    """(dq, dkv): K5b for CUDA tensors, the plain version for CPU tensors."""
    if not q.is_cuda:
        return sparse_mla_backward_reference(q, kv, indices, out, lse, do, sm_scale, v_dim)
    return sparse_mla_bwd(q, kv, indices, out, lse, do, sm_scale, v_dim)


class _SparseMLA(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, kv, indices, sm_scale, v_dim):
        out, lse = sparse_mla_forward(q, kv, indices, sm_scale, v_dim)
        ctx.save_for_backward(q, kv, indices, out, lse)
        ctx.sm_scale, ctx.v_dim = sm_scale, v_dim
        return out

    @staticmethod
    def backward(ctx, do):
        q, kv, indices, out, lse = ctx.saved_tensors
        dq, dkv = sparse_mla_backward(q, kv, indices, out, lse, do, ctx.sm_scale, ctx.v_dim)
        return dq, dkv, None, None, None


def sparse_mla_attention(
    q: torch.Tensor,  # [S, H, Dq] or [B, S, H, Dq]
    kv: torch.Tensor,  # [Sk, Dq] or [B, Sk, Dq]
    indices: torch.Tensor,  # [S, topk] or [B, S, topk] int, sentinel = Sk
    sm_scale: float,
    v_dim: int,
) -> torch.Tensor:
    """[S, H, v_dim] (or [B, S, H, v_dim]): the drop-in for
    ``ops.sparse_mla.sparse_mla_attention`` with the same sentinel contract,
    through K5a/K5b on the card."""
    if q.dim() == 4:
        return torch.stack([sparse_mla_attention(q[b], kv[b], indices[b], sm_scale, v_dim)
                            for b in range(q.shape[0])])
    if q.is_cuda:
        q, kv, indices = q.contiguous(), kv.contiguous(), indices.to(torch.int32).contiguous()
    return _SparseMLA.apply(q, kv, indices, float(sm_scale), int(v_dim))

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
products, ``p`` to do's dtype for dv, float32 sums, the per-slot dkv rows to
kv's dtype once. Unlike the JAX package, which adds those rows up in
bfloat16, dkv is summed in float32 and rounded once.

On the card the kernels take bfloat16 tensors with ``Dq = 576, v_dim = 512``
(latent 512 + rope 64, the MLA widths of the glm_moe_dsa family) and any
``H % 8 == 0`` (what the JAX kernel takes at these widths), and raise for
anything else (``check_widths``); the TPU version's quiet fall-back to the XLA
form is not carried over. A kernel block holds one group of ``HEADS`` = 64
heads: the wrappers pad q (and do) with zero heads to ``Hp = ceil(H / 64) *
64`` and launch once a group, the padded heads' rows dropped
(``sparse_mla_grouped_reference`` is the plain mirror of that decomposition). The backward runs over chunks of queries: K5b writes
each chunk's per-slot dkv rows into a ``[chunk, topk, Dq]`` buffer of about
1.2 GB, and ``sparse_mla_dkv_reduce`` gives every kv row one block that sums
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
BWD_SLOTS = 1 << 20  # (query, slot) pairs per backward launch: a 1.2 GB dkvg buffer
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
        for fn in (fwd, fwd_tiles, bwd, bwd_tiles, red):
            fn.restype = i
        _fns = (fwd, bwd, red, bwd_tiles, fwd_tiles)
    return _fns


def bwd_chunk(S: int, T: int) -> int:
    """Queries per backward launch: a multiple of 8, so that every chunk's
    slice of the indices starts on a 32-byte boundary."""
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
    [Sk, Dq]) from the saved lse, rounding where the kernels round."""
    dkv = torch.zeros(kv.shape, dtype=torch.float32, device=kv.device)
    delta = (out.float() * do.float()).sum(dim=-1)  # [S, H]
    dq = _backward_into(q, kv, indices, lse, delta, do, dkv, sm_scale, v_dim, chunk)
    return dq, dkv.to(kv.dtype)


def _backward_into(q, kv, indices, lse, delta, do, dkv, sm_scale: float, v_dim: int,
                   chunk: int = 128):
    """dq [S, H, Dq] of the plain backward; the per-slot dkv rows (rounded to
    kv's dtype, as K5b writes them) are added into the f32 ``dkv``."""
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
        ds = (p * (dp - delta[c0:c0 + chunk, :, None]) * sm_scale).to(kv.dtype).float()
        dqs.append(torch.einsum("cht,ctd->chd", ds, kvg).to(q.dtype))
        dkvg = torch.einsum("cht,chd->ctd", ds, qc)
        dkvg[..., :v_dim] += torch.einsum("cht,chd->ctd", p.to(do.dtype).float(), doc.float())
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
    order adding its rows, rounded to kv's dtype a group, into one f32 dkv,
    rounded once, as K5b and the reduction do."""
    S, H, _ = q.shape
    Hp = padded_heads(H)
    qp = _pad_heads(q, Hp)
    groups = [slice(g, g + HEADS) for g in range(0, Hp, HEADS)]
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
                                      dop[c, g], dkv, sm_scale, v_dim)
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
    """Raise ValueError unless the kernels take these widths: any ``H % 8 ==
    0`` (the JAX kernel's condition on H) at ``Dq = 576, v_dim = 512``."""
    if H <= 0 or H % 8 or (Dq, v_dim) != (DQ, DV):
        raise ValueError(f"the sparse MLA kernels take H % 8 == 0, Dq = {DQ}, v_dim = {DV}; "
                         f"got H = {H}, Dq = {Dq}, v_dim = {v_dim}")


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


def sparse_mla_fwd_tile_counts(q, kv, indices, sm_scale: float, v_dim: int) -> torch.Tensor:
    """int32 [S, 2]: the tiles of ``FWD_TILE`` slots K5a visited for each token
    and its candidates, as the kernel counted them in one launch on these
    inputs. Only the kernel counts: CPU tensors raise (the rule's plain mirror
    is ``sparse_mla_bwd_tiles_visited(indices, Sk, FWD_TILE)``)."""
    if not q.is_cuda:
        raise ValueError("sparse_mla_fwd_tile_counts: the counts come from the kernel, which "
                         "takes CUDA tensors")
    tiles = torch.full((q.shape[0], 2), -1, dtype=torch.int32, device=q.device)
    sparse_mla_fwd(q, kv, indices, sm_scale, v_dim, tiles=tiles)
    return tiles


def sparse_mla_dkv_reduce(dkvg, order, seg, dkv):
    """dkv [Sk, Dq] f32 += the rows of dkvg [slots, Dq] bf16 named by
    ``order[seg[r]:seg[r + 1]]`` for every kv row r, summed in that order."""
    Sk = dkv.shape[0]
    _build.require(dkvg, "dkvg", torch.bfloat16)
    _build.require(order, "order", torch.int64)
    _build.require(seg, "seg", torch.int32, (Sk + 1,))
    _build.require(dkv, "dkv", torch.float32, (Sk, DQ))
    _build.check(KERNEL_REDUCE, _kernels()[2](
        dkvg.data_ptr(), order.data_ptr(), seg.data_ptr(), dkv.data_ptr(), Sk, DQ,
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
    real index, the group's dkv row into ``dkvg`` [>= C, T, Dq] bf16. Given
    ``tiles`` (int32 [C, 2]), the same launch also writes each token's tiles
    of ``BWD_TILE`` slots visited and its candidates there."""
    C, Sk, T = _check_args(q, kv, indices, v_dim)
    Hp = q.shape[1]
    if Hp % HEADS or h0 % HEADS or not 0 <= h0 < Hp:
        raise ValueError(f"sparse_mla_bwd_chunk: heads must be whole groups of {HEADS} and h0 "
                         f"one of their starts; got {Hp} heads, h0 = {h0}")
    _build.require(do, "do", torch.bfloat16, (C, Hp, v_dim))
    _build.require(lse, "lse", torch.float32, (C, Hp))
    _build.require(delta, "delta", torch.float32, (C, Hp))
    _build.require(dq, "dq", torch.bfloat16, (C, Hp, DQ))
    _build.require(dkvg, "dkvg", torch.bfloat16)
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
    H = q.shape[1]
    Hp = padded_heads(H)
    do = do.contiguous()
    # the plain version's f32 sum(out * do); do is widened inside the product
    delta = _pad_heads((out.float() * do).sum(dim=-1), Hp)
    q, do, lse = _pad_heads(q, Hp), _pad_heads(do, Hp), _pad_heads(lse, Hp)
    dq = torch.empty_like(q)
    dkv = torch.zeros((Sk, DQ), dtype=torch.float32, device=q.device)
    chunk = bwd_chunk(S, T)
    dkvg = torch.empty((chunk, T, DQ), dtype=torch.bfloat16, device=q.device)
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


def sparse_mla_bwd_tile_counts(q, kv, indices, out, lse, do, sm_scale: float,
                               v_dim: int) -> torch.Tensor:
    """int32 [S, 2]: the tiles of ``BWD_TILE`` slots K5b visited for each token
    and its candidates, as the kernel counted them in one backward call on
    these inputs. Only the kernel counts: CPU tensors raise
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

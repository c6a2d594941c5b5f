"""K4: fused paged decode attention with KV-cache append — the hand-written
CUDA kernel ``csrc/decode_attention.cu`` and its plain PyTorch version.

Replaces the TPU kernel ``prime_rl_tpu/ops/decode_attention.py`` ``_kernel``
(the ``pallas_call`` in ``decode_paged_attention``): each slot's new k/v
goes into the paged pool at position ``lengths[s]`` through ``page_table``,
then the slot's query heads attend over ``lengths[s] + 1`` tokens (GQA), or
over the last ``window`` of them (a sliding window that counts the new token),
with an optional attention sink per q head joining the denominator.
The pools are updated IN PLACE (the JAX kernel aliases them in and out of a
donated buffer); the function still returns them, as the JAX one does.

Layout contract (matches sampler/cache.KVPool):
  q, k_new, v_new  [S, NH|NKV, HD]   one new token per slot
  k/v pool         [NKV, NP, PS, HD] paged, per layer
  lengths          [S] int32         tokens in cache BEFORE the new one
  page_table       [S, P] int32      pages owned by each slot, in order

What bounds it on the H100 and what the design does about it: see the
source note in ``csrc/decode_attention.cu`` (bound by the bytes of the
cached rows; split-K over the attended rows in items of ``SPLIT_ROWS``, k/v
tiles staged by ``cp.async`` through a shared-memory ring, one softmax step
a tile on ``mma.sync``, and a fixed-order combine of the splits' f32
partials, so that two launches give equal bits).

For CPU tensors ``decode_paged_attention`` runs ``write_tokens`` +
``decode_attention_xla`` (the JAX package's ``_write_tokens`` and
``_decode_attention_xla``); for CUDA tensors it launches the kernel or
raises. ``decode_paged_attention_split_reference`` is the kernel's
arithmetic in plain PyTorch (the same splits, per-split f32 partials, the
fixed-order combine, then the new token and the sinks), and
``decode_rows_visited`` the plain mirror of the rows each work item reads;
``decode_rows_counts`` gives the kernel's own count.
"""

from __future__ import annotations

import ctypes

import torch

from prime_rl_tpu_torch.ops import _build

NEG_INF = -1e30
KERNEL = "decode_paged_attention"
_LIB = "decode_attention"
# C: the cached rows one work item of the kernel covers (csrc SPLIT_ROWS)
SPLIT_ROWS = 256
# query heads one block of the kernel takes at most (csrc MAX_CHUNK)
MAX_CHUNK = 8
HEAD_DIMS = (64, 128, 256, 384, 512)  # the head dims the kernel is built for (csrc Cfg<HD>)

_fns: dict[bool, object] = {}
_tickets: dict[tuple, torch.Tensor] = {}


def _kernel(rows: bool = False):
    """The C entry point; ``rows``: the one that also writes each work
    item's rows read (one more pointer argument)."""
    fn = _fns.get(rows)
    if fn is None:
        lib = _build.load(_LIB)
        if lib.decode_split_rows() != SPLIT_ROWS:
            raise RuntimeError(f"csrc/decode_attention.cu splits by {lib.decode_split_rows()} "
                               f"rows, ops/decode_attention.py by {SPLIT_ROWS}")
        lib.decode_group_chunks.argtypes = [ctypes.c_int]
        for g in range(1, 4 * MAX_CHUNK + 1):
            if lib.decode_group_chunks(g) != group_chunks(g):
                raise RuntimeError(f"csrc/decode_attention.cu cuts a group of {g} into "
                                   f"{lib.decode_group_chunks(g)} chunks, "
                                   f"ops/decode_attention.py into {group_chunks(g)}")
        fn = lib.decode_paged_attention_rows if rows else lib.decode_paged_attention
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 11 + [i] * 7 + [ctypes.c_float, i, p] + [p] * rows
        fn.restype = i
        _fns[rows] = fn
    return fn


def _ticket_counters(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """int32 zeros, at least one a (slot, kv head, chunk), kept for each device
    and stream: the kernel's last block of each of them sets its counter
    back to zero, so the buffer is all zero whenever a launch on the stream
    starts."""
    buf = _tickets.get((device, stream))
    if buf is None or buf.numel() < n:
        buf = _tickets[(device, stream)] = torch.zeros(max(n, 1024), dtype=torch.int32,
                                                       device=device)
    return buf


def chunk_width(group: int) -> int:
    """Query heads a block of the kernel takes: the group up to 8 where it is
    a power of two, else the next power of two, capped at ``MAX_CHUNK``."""
    return min(MAX_CHUNK, 1 << max(group - 1, 0).bit_length())


def group_chunks(group: int) -> int:
    """Blocks a (slot, kv head, split) takes: ceil(group / chunk_width). One
    for groups 1, 2, 4 and 8 (and 3, 5, 6, 7, padded); two at 12 (8 + 4)."""
    return -(-group // chunk_width(group))


def max_splits(page_rows: int, split_rows: int = SPLIT_ROWS) -> int:
    """Work items a (slot, kv head) can have: ceil(P * PS / C)."""
    return max(1, -(-page_rows // split_rows))


def one_split(page_rows: int, window: int = 0, split_rows: int = SPLIT_ROWS) -> bool:
    """No slot can have two splits (the kernel then needs no workspace and no
    ticket counters): the table holds at most C rows, or a window leaves at
    most C cached rows."""
    return page_rows <= split_rows or 0 < (window or 0) <= split_rows + 1


def _window_lo(lengths: torch.Tensor, window: int) -> torch.Tensor:
    """First cached row each slot attends (the window counts the new token)."""
    n = lengths.long()
    return (n + 1 - window).clamp(min=0) if window and window > 0 else torch.zeros_like(n)


def decode_rows_visited(lengths: torch.Tensor, window: int, split_rows: int,
                        max_splits: int) -> torch.Tensor:
    """int32 [S, max_splits]: the cached rows work item j of each slot reads
    (each chunk of a kv head's group reads them),
    the plain mirror of the kernel's split rule. Split j covers rows
    [lo + j*C, min(lo + (j+1)*C, n)) with n = lengths[s] and lo the window's
    first row (0 without one); rows below lo and row n (the new token's) are
    never read, and every attended row is read once."""
    n = lengths.long()[:, None]
    start = _window_lo(lengths, window)[:, None] + split_rows * torch.arange(
        max_splits, device=lengths.device)[None, :]
    return (torch.minimum(start + split_rows, n) - start).clamp(min=0).to(torch.int32)


def token_slots(page_table: torch.Tensor, lengths: torch.Tensor, page_size: int) -> torch.Tensor:
    """Flat pool row (page * PS + offset) of position ``lengths[s]`` of each
    slot. The page index is clamped to the table (the engine caps lengths
    below ``max_seq_len``, so the clamp never fires on its path)."""
    pidx = (lengths.long() // page_size).clamp_max(page_table.shape[1] - 1)
    page = page_table.long().gather(1, pidx[:, None])[:, 0]
    return page * page_size + lengths.long() % page_size


def write_tokens(pool: torch.Tensor, new_kv: torch.Tensor, flat_idx: torch.Tensor) -> torch.Tensor:
    """In-place single-token writes: pool [NKV, NP, PS, HD] viewed flat as
    [NKV, NP*PS, HD]; new_kv [NKV, S, HD] at token rows ``flat_idx [S]``.
    Returns the (same) pool."""
    nkv, np_, ps, hd = pool.shape
    pool.view(nkv, np_ * ps, hd)[:, flat_idx.long()] = new_kv.to(pool.dtype)
    return pool


def decode_attention_xla(q, k_l, v_l, lengths, page_table, window=0, sinks=None):
    """Gathered masked attention, the plain version of K4's attention:
    q [S, NH, HD]; k_l/v_l [NKV, NP, PS, HD]; page_table [S, P]; attends
    positions < lengths. Scores, softmax and output in f32."""
    s, nh, hd = q.shape
    nkv, _, ps, _ = k_l.shape
    p = page_table.shape[1]
    group = nh // nkv
    table = page_table.long()
    # [NKV, S, P, PS, HD] -> [S, NKV, P*PS, HD]
    k_g = k_l[:, table].transpose(0, 1).reshape(s, nkv, p * ps, hd).float()
    v_g = v_l[:, table].transpose(0, 1).reshape(s, nkv, p * ps, hd).float()
    qf = q.reshape(s, nkv, group, hd).float()
    scores = torch.einsum("skgd,sktd->skgt", qf, k_g) * (hd ** -0.5)
    pos = torch.arange(p * ps, device=q.device)[None, :]
    mask = pos < lengths.long()[:, None]  # [S, T]
    if window and window > 0:
        # pages are allocated contiguously per slot: flat index == position
        mask = mask & (pos >= (lengths.long() - window)[:, None])
    scores = torch.where(mask[:, None, None, :], scores, NEG_INF)
    if sinks is not None:
        sf = sinks.float().reshape(nkv, group)[None, :, :, None]
        m = torch.maximum(scores.amax(dim=-1, keepdim=True), sf)
        pexp = torch.exp(scores - m)
        probs = pexp / (pexp.sum(dim=-1, keepdim=True) + torch.exp(sf - m))
    else:
        probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("skgt,sktd->skgd", probs, v_g)
    return out.reshape(s, nh, hd)


def decode_paged_attention_reference(q, k_new, v_new, k_pool, v_pool, lengths, page_table, *,
                                     sinks=None, window: int = 0):
    """Plain version: append with ``write_tokens``, then ``decode_attention_xla``
    over ``lengths + 1`` tokens. Returns (o in q.dtype, k_pool, v_pool)."""
    flat_idx = token_slots(page_table, lengths, k_pool.shape[2])
    write_tokens(k_pool, k_new.transpose(0, 1), flat_idx)
    write_tokens(v_pool, v_new.transpose(0, 1), flat_idx)
    o = decode_attention_xla(q, k_pool, v_pool, lengths + 1, page_table,
                             window=window, sinks=sinks)
    return o.to(q.dtype), k_pool, v_pool


def decode_paged_attention_split_reference(q, k_new, v_new, k_pool, v_pool, lengths, page_table,
                                           *, sinks=None, window: int = 0,
                                           split_rows: int = SPLIT_ROWS):
    """The kernel's arithmetic in plain PyTorch, f32: append with
    ``write_tokens``; for each slot and split j (the rows of
    ``decode_rows_visited``) the partial (m_j, l_j, acc_j) over its rows;
    the splits folded in the fixed order 0..k-1; then the new token's term
    from k_new/v_new and the sinks. Returns (o in q.dtype, k_pool, v_pool)."""
    flat_idx = token_slots(page_table, lengths, k_pool.shape[2])
    write_tokens(k_pool, k_new.transpose(0, 1), flat_idx)
    write_tokens(v_pool, v_new.transpose(0, 1), flat_idx)
    s, nh, hd = q.shape
    nkv, _, ps, _ = k_pool.shape
    p = page_table.shape[1]
    group, ms, c = nh // nkv, max_splits(p * ps, split_rows), split_rows
    scale = hd ** -0.5
    table = page_table.long()
    # [NKV, S, P, PS, HD] -> [S, NKV, P*PS, HD]: row t of a slot is its position t
    k_g = k_pool[:, table].transpose(0, 1).reshape(s, nkv, p * ps, hd).float()
    v_g = v_pool[:, table].transpose(0, 1).reshape(s, nkv, p * ps, hd).float()
    pos = _window_lo(lengths, window)[:, None] + torch.arange(ms * c, device=q.device)[None, :]
    valid = (pos < lengths.long()[:, None]).reshape(s, 1, 1, ms, c)
    idx = pos.clamp(max=p * ps - 1)[:, None, :, None].expand(s, nkv, ms * c, hd)
    k_s = k_g.gather(2, idx).reshape(s, nkv, ms, c, hd)
    v_s = v_g.gather(2, idx).reshape(s, nkv, ms, c, hd)
    qf = q.float().reshape(s, nkv, group, hd)
    scores = torch.einsum("skgd,skjcd->skgjc", qf, k_s) * scale
    scores = torch.where(valid, scores, -torch.inf)
    m = scores.amax(dim=-1)  # [S, NKV, G, MS]; -inf for a split with no row
    pexp = torch.exp(scores - torch.where(torch.isfinite(m), m, 0.0)[..., None])
    l = pexp.sum(dim=-1)
    acc = torch.einsum("skgjc,skjcd->skgjd", pexp, v_s)
    # the splits in order 0..k-1 (empty splits add 0)
    m_all = m.amax(dim=-1)
    coef = torch.exp(m - torch.where(torch.isfinite(m_all), m_all, 0.0)[..., None])
    l_all = torch.zeros_like(m_all)
    acc_all = torch.zeros(s, nkv, group, hd, device=q.device)
    for j in range(ms):
        l_all = l_all + l[..., j] * coef[..., j]
        acc_all = acc_all + acc[..., j, :] * coef[..., j, None]
    # the new token, then the sinks
    s_new = torch.einsum("skgd,skd->skg", qf, k_new.float()) * scale
    m_f = torch.maximum(m_all, s_new)
    alpha, p_new = torch.exp(m_all - m_f), torch.exp(s_new - m_f)
    l_all = l_all * alpha + p_new
    acc_all = acc_all * alpha[..., None] + p_new[..., None] * v_new.float()[:, :, None, :]
    if sinks is not None:
        sk = sinks.float().reshape(1, nkv, group)
        m2 = torch.maximum(m_f, sk)
        c_f = torch.exp(m_f - m2)
        l_all = l_all * c_f + torch.exp(sk - m2)
        acc_all = acc_all * c_f[..., None]
    o = (acc_all / l_all[..., None]).reshape(s, nh, hd)
    return o.to(q.dtype), k_pool, v_pool


def decode_paged_attention(
    q: torch.Tensor,  # [S, NH, HD]
    k_new: torch.Tensor,  # [S, NKV, HD] — the new token's K per slot
    v_new: torch.Tensor,
    k_pool: torch.Tensor,  # [NKV, NP, PS, HD]
    v_pool: torch.Tensor,
    lengths: torch.Tensor,  # [S] int32: cache tokens BEFORE the new one
    page_table: torch.Tensor,  # [S, P] int32
    *,
    sinks: torch.Tensor | None = None,  # [NH] attention-sink logits
    window: int = 0,
    sm_scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused decode attention + cache append. Returns (o [S, NH, HD] in
    q.dtype, k_pool, v_pool) with the pools holding the new token's K/V at
    position ``lengths[s]`` of each slot (updated in place)."""
    s, nh, hd = q.shape
    if not q.is_cuda:
        if sm_scale is not None and sm_scale != hd ** -0.5:
            raise NotImplementedError("the plain version uses the default hd**-0.5 scale")
        return decode_paged_attention_reference(q, k_new, v_new, k_pool, v_pool, lengths,
                                                page_table, sinks=sinks, window=window)
    return _launch(q, k_new, v_new, k_pool, v_pool, lengths, page_table, sinks, window, sm_scale)


def decode_rows_counts(q, k_new, v_new, k_pool, v_pool, lengths, page_table, *, sinks=None,
                       window: int = 0, sm_scale: float | None = None) -> torch.Tensor:
    """int32 [S, NKV * group_chunks(NH / NKV), max_splits]: the cached rows
    each work item of the kernel read, one row of items a (kv head, chunk)
    (each chunk reads its kv head's rows and counts them), as it counted them
    in one launch on these inputs (which also
    appends, as ``decode_paged_attention`` does). Only the kernel counts: CPU
    tensors raise (``decode_rows_visited`` is the split rule's plain mirror)."""
    if not q.is_cuda:
        raise ValueError("decode_rows_counts: the counts come from the kernel, which takes CUDA "
                         "tensors")
    s, nh, nkv = q.shape[0], q.shape[1], k_pool.shape[0]
    rows = torch.zeros((s, nkv * group_chunks(nh // nkv), max_splits(page_table.shape[1] * k_pool.shape[2], SPLIT_ROWS)),
                       dtype=torch.int32, device=q.device)
    _launch(q, k_new, v_new, k_pool, v_pool, lengths, page_table, sinks, window, sm_scale, rows)
    return rows


def check_shape(num_heads: int, num_kv_heads: int, head_dim: int) -> None:
    """Raise unless the kernel takes these heads: head dim 64, 128, 256, 384
    or 512 (the JAX decode path's ``hd % 128 == 0`` and 64, up to the widest
    ring and accumulators an SM holds: ``HEAD_DIMS``) and any GQA group
    (``num_heads`` a multiple of ``num_kv_heads``), as the JAX kernel does.
    The wrapper's only check on the heads; launches nothing."""
    if (head_dim not in HEAD_DIMS or num_kv_heads <= 0 or num_heads <= 0
            or num_heads % num_kv_heads):
        raise ValueError(f"decode_paged_attention takes head_dim 64/128/256/384/512 and num_heads a "
                         f"multiple of num_kv_heads; got head_dim {head_dim}, heads "
                         f"{num_heads}/{num_kv_heads}")


def _launch(q, k_new, v_new, k_pool, v_pool, lengths, page_table, sinks, window, sm_scale,
            rows=None):
    s, nh, hd = q.shape
    nkv, np_, ps, _ = k_pool.shape
    p = page_table.shape[1]
    check_shape(nh, nkv, hd)
    bf = torch.bfloat16
    _build.require(q, "q", bf)
    _build.require(k_new, "k_new", bf, (s, nkv, hd))
    _build.require(v_new, "v_new", bf, (s, nkv, hd))
    _build.require(k_pool, "k_pool", bf)
    _build.require(v_pool, "v_pool", bf, tuple(k_pool.shape))
    lengths = lengths.to(torch.int32)
    page_table = page_table.to(torch.int32)
    _build.require(lengths, "lengths", torch.int32, (s,))
    _build.require(page_table, "page_table", torch.int32, (s, p))
    if sinks is not None:
        sinks = sinks.to(torch.float32).reshape(nh).contiguous()
        _build.require(sinks, "sinks", torch.float32, (nh,))
    window = int(window or 0)
    out = torch.empty_like(q)
    # the splits' f32 partials (acc [S, NH, MS, HD] then (m, l) [S, NH, MS, 2])
    # and the counters that find each (slot, kv head, chunk)'s last split
    work = tickets = None
    stream = _build.stream_ptr(q)
    chunks = group_chunks(nh // nkv)
    if not one_split(p * ps, window, SPLIT_ROWS):
        work = torch.empty(s * nh * max_splits(p * ps, SPLIT_ROWS) * (hd + 2),
                           dtype=torch.float32, device=q.device)
        tickets = _ticket_counters(q.device, stream, s * nkv * chunks)
    scale = hd ** -0.5 if sm_scale is None else float(sm_scale)
    args = (q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), k_pool.data_ptr(),
            v_pool.data_ptr(), lengths.data_ptr(), page_table.data_ptr(),
            None if sinks is None else sinks.data_ptr(), out.data_ptr(),
            None if work is None else work.data_ptr(),
            None if tickets is None else tickets.data_ptr(), s, nh, nkv, hd, np_, ps, p, scale,
            window, stream)
    if rows is not None:
        _build.require(rows, "rows", torch.int32,
                       (s, nkv * chunks, max_splits(p * ps, SPLIT_ROWS)))
        args += (rows.data_ptr(),)
    _build.check(KERNEL, _kernel(rows is not None)(*args))
    _build.count(KERNEL, window, sinks is not None)
    if hd > 256:  # the rings of Cfg<384> and Cfg<512>: counted apart as well
        _build.launches[f"{KERNEL}/wide"] += 1
    if chunks > 1:  # a group cut into chunks (GLM-4.5's 12): counted apart as well
        _build.launches[f"{KERNEL}/chunked"] += 1
    return out, k_pool, v_pool

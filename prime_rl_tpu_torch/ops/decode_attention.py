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
cached rows; one block per (slot, kv head) serves the GQA group, plain row
store for the append, the new token's term from registers; the row loop
starts at the window's first row, so rows below it are never read).

For CPU tensors ``decode_paged_attention`` runs ``write_tokens`` +
``decode_attention_xla`` (the JAX package's ``_write_tokens`` and
``_decode_attention_xla``); for CUDA tensors it launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes

import torch

from prime_rl_tpu_torch.ops import _build

NEG_INF = -1e30
KERNEL = "decode_paged_attention"
_LIB = "decode_attention"

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load(_LIB).decode_paged_attention
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 9 + [i] * 7 + [ctypes.c_float, i, p]
        fn.restype = i
        _fn = fn
    return _fn


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
    nkv, np_, ps, _ = k_pool.shape
    p = page_table.shape[1]
    if hd not in (64, 128) or nh % nkv or nh // nkv not in (1, 2, 4, 8):
        raise ValueError(f"decode_paged_attention takes head_dim 64/128 and a GQA group of "
                         f"1, 2, 4 or 8; got head_dim {hd}, heads {nh}/{nkv}")
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
    out = torch.empty_like(q)
    scale = hd ** -0.5 if sm_scale is None else float(sm_scale)
    fn = _kernel()
    _build.check(KERNEL, fn(q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), k_pool.data_ptr(),
                            v_pool.data_ptr(), lengths.data_ptr(), page_table.data_ptr(),
                            None if sinks is None else sinks.data_ptr(), out.data_ptr(), s, nh,
                            nkv, hd, np_, ps, p, scale, int(window or 0), _build.stream_ptr(q)))
    _build.count(KERNEL, window or 0, sinks is not None)
    return out, k_pool, v_pool

"""K3: fused decode-time QKV preparation — the hand-written CUDA kernel
``csrc/decode_qkv.cu`` and its plain PyTorch version.

Replaces the TPU kernel ``prime_rl_tpu/ops/decode_qkv.py`` ``_kernel`` (the
``pallas_call`` in ``decode_qkv_prep``): for S decode tokens, rms-norm ->
q/k/v projections (computed inside the kernel) -> optional bias -> per-head
RMS qk-norm -> half-split rope with partial rotation and a cos/sin
``scaling`` (YaRN). The normed x is cast to the weight dtype before the
product, as the TPU kernel does; bias, qk-norm and rope stay in f32 until
the final cast. The TPU kernel's VMEM budget gate (``fits_vmem``) is a TPU
tile-size concern and has no counterpart here.

What bounds it on the H100 and what the design does about it: see the
source note in ``csrc/decode_qkv.cu`` (bound by the weight read: each weight
tile of 64 rows of D x 128 columns loaded once a call by TMA through a ring,
D split between the blocks of a thread-block cluster, the norm's partial
sums and the f32 partial products exchanged and reduced in a fixed order
through distributed shared memory, bias, qk-norm and rope as the epilogue).

For CPU tensors ``decode_qkv_prep`` runs ``decode_qkv_prep_reference``; for
CUDA tensors it launches the kernel or raises.
``decode_qkv_prep_split_reference`` is the kernel's arithmetic in plain
PyTorch (the norm's sums of squares over D chunks added in order, the
chunks' f32 partial products folded in order), ``decode_qkv_tiles_visited``
the plain mirror of the weight tiles each block loads, and
``decode_qkv_tile_counts`` the kernel's own count.
"""

from __future__ import annotations

import ctypes

import torch

from prime_rl_tpu_torch.ops import _build

KERNEL = "decode_qkv_prep"
_LIB = "decode_qkv"
# the kernel's tiling (csrc/decode_qkv.cu): a weight tile is WEIGHT_TILE_ROWS
# rows of D by COL_TILE columns of one projection; a block holds up to
# ROWS_PER_BLOCK token rows (64-row M tiles)
WEIGHT_TILE_ROWS = 64
COL_TILE = 128
ROWS_PER_BLOCK = 128

_fns: dict[bool, object] = {}


def _kernel(tiles: bool = False):
    """The C entry point; ``tiles``: the one that also writes the weight
    tiles each block loaded (one more pointer argument)."""
    fn = _fns.get(tiles)
    if fn is None:
        lib = _build.load(_LIB)
        fn = lib.decode_qkv_prep_tiles if tiles else lib.decode_qkv_prep
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p] * 15 + [i, i, i, i, i, i, f, f, i, p] + [p] * tiles
        fn.restype = i
        _fns[tiles] = fn
    return fn


def d_chunks(d: int, splits: int, tile_rows: int = WEIGHT_TILE_ROWS) -> list[tuple[int, int]]:
    """The columns [c0, c1) of D that each of ``splits`` blocks of a cluster
    takes: block r the tiles [r*b + min(r, e), ...) of ceil(D / tile_rows),
    b + (r < e) of them (b, e = divmod(tiles, splits)), cut at D."""
    kt = -(-d // tile_rows)
    if not 1 <= splits <= kt:
        raise ValueError(f"{splits} splits of {kt} weight tiles of D = {d}")
    b, e = divmod(kt, splits)
    out = []
    for r in range(splits):
        t0 = r * b + min(r, e)
        out.append((t0 * tile_rows, min((t0 + b + (r < e)) * tile_rows, d)))
    return out


def decode_qkv_tiles_visited(s: int, d: int, ncols, splits: int, col_tile: int = COL_TILE,
                             tile_rows: int = WEIGHT_TILE_ROWS) -> torch.Tensor:
    """int32 [row groups, column tiles, splits]: the weight tiles each block
    of the kernel loads, the plain mirror of its tiling. ``ncols``: the
    columns of each projection (wq, wk, wv), or of one. Column tiles are
    ``col_tile`` columns of one projection (ceil(n / col_tile) of each); a
    cluster of ``splits`` blocks shares one, block r loading the K tiles of
    its D chunk (``d_chunks``); a row group is up to ROWS_PER_BLOCK token rows
    and loads every tile once. So up to 128 rows every weight tile is loaded
    exactly once."""
    ncols = [ncols] if isinstance(ncols, int) else list(ncols)
    groups = max(1, -(-s // ROWS_PER_BLOCK))
    n_ct = sum(-(-n // col_tile) for n in ncols)
    per_block = [-(-(c1 - c0) // tile_rows) for c0, c1 in d_chunks(d, splits, tile_rows)]
    return torch.tensor(per_block, dtype=torch.int32).expand(groups, n_ct, splits).contiguous()


def _normed(xf, norm_w, mean_square, eps):
    """The normed rows in f32: x * rsqrt(mean_square + eps) * norm_w."""
    return xf * torch.rsqrt(mean_square + eps)[:, None] * norm_w.float()


def _epilogue(qf, kf, vf, positions, inv_freq, *, num_heads, num_kv_heads, head_dim, qk_norm,
              q_norm_w, k_norm_w, q_bias, k_bias, v_bias, rot, scaling, eps, dtype):
    """Bias, per-head RMS qk-norm and rope in f32 on the f32 products, then
    the one cast to ``dtype``."""
    s = qf.shape[0]
    if rot is None:
        rot = 2 * inv_freq.shape[0]
    r2 = rot // 2
    angles = positions.float()[:, None] * inv_freq.float()[None, :]  # [S, R2]
    cos = (torch.cos(angles) * scaling)[:, None, :]
    sin = (torch.sin(angles) * scaling)[:, None, :]

    def head_prep(flat, n_heads, norm, bias):
        h3 = flat.reshape(s, n_heads, head_dim)
        if bias is not None:
            h3 = h3 + bias.float().reshape(1, n_heads, head_dim)
        if qk_norm:
            h3 = h3 * torch.rsqrt(h3.square().mean(-1, keepdim=True) + eps)
            if norm is not None:
                h3 = h3 * norm.float()
        x1, x2 = h3[..., :r2], h3[..., r2:rot]
        rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
        return rotated if rot == head_dim else torch.cat([rotated, h3[..., rot:]], dim=-1)

    q = head_prep(qf, num_heads, q_norm_w, q_bias)
    k = head_prep(kf, num_kv_heads, k_norm_w, k_bias)
    v = vf.reshape(s, num_kv_heads, head_dim)
    if v_bias is not None:
        v = v + v_bias.float().reshape(1, num_kv_heads, head_dim)
    return q.to(dtype), k.to(dtype), v.to(dtype)


def decode_qkv_prep_reference(x, norm_w, wq, wk, wv, positions, inv_freq, *, num_heads,
                              num_kv_heads, head_dim, qk_norm=True, q_norm_w=None,
                              k_norm_w=None, q_bias=None, k_bias=None, v_bias=None,
                              rot=None, scaling=1.0, eps=1e-6):
    """Plain version with the kernel's arithmetic: f32 norm, cast of the
    normed x to the weight dtype, f32 products, bias/qk-norm/rope in f32."""
    xf = x.float()
    xb = _normed(xf, norm_w, xf.square().mean(-1), eps).to(wq.dtype).float()
    return _epilogue(xb @ wq.float(), xb @ wk.float(), xb @ wv.float(), positions, inv_freq,
                     num_heads=num_heads, num_kv_heads=num_kv_heads, head_dim=head_dim,
                     qk_norm=qk_norm, q_norm_w=q_norm_w, k_norm_w=k_norm_w, q_bias=q_bias,
                     k_bias=k_bias, v_bias=v_bias, rot=rot, scaling=scaling, eps=eps,
                     dtype=x.dtype)


def decode_qkv_prep_split_reference(x, norm_w, wq, wk, wv, positions, inv_freq, *, splits,
                                    num_heads, num_kv_heads, head_dim, qk_norm=True,
                                    q_norm_w=None, k_norm_w=None, q_bias=None, k_bias=None,
                                    v_bias=None, rot=None, scaling=1.0, eps=1e-6):
    """The kernel's order of arithmetic in plain PyTorch, f32: D cut into
    the ``splits`` chunks of a cluster (``d_chunks``); each chunk's sum of
    squares of x, the sums added in the order 0..k-1 for the rstd; the normed
    x cast to the weight dtype; each chunk's f32 partial product folded in
    the order 0..k-1; then the epilogue of ``decode_qkv_prep_reference``."""
    xf = x.float()
    chunks = d_chunks(x.shape[1], splits)
    ss = torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)
    for c0, c1 in chunks:
        ss = ss + xf[:, c0:c1].square().sum(-1)
    xb = _normed(xf, norm_w, ss / x.shape[1], eps).to(wq.dtype).float()
    outs = []
    for w in (wq, wk, wv):
        acc = torch.zeros(x.shape[0], w.shape[1], dtype=torch.float32, device=x.device)
        for c0, c1 in chunks:
            acc = acc + xb[:, c0:c1] @ w[c0:c1].float()
        outs.append(acc)
    return _epilogue(*outs, positions, inv_freq, num_heads=num_heads,
                     num_kv_heads=num_kv_heads, head_dim=head_dim, qk_norm=qk_norm,
                     q_norm_w=q_norm_w, k_norm_w=k_norm_w, q_bias=q_bias, k_bias=k_bias,
                     v_bias=v_bias, rot=rot, scaling=scaling, eps=eps, dtype=x.dtype)


def decode_qkv_prep(
    x: torch.Tensor,  # [S, D] hidden states (pre-attn-norm)
    norm_w: torch.Tensor,  # [D]
    wq: torch.Tensor,  # [D, NH*HD]
    wk: torch.Tensor,  # [D, NKV*HD]
    wv: torch.Tensor,
    positions: torch.Tensor,  # [S] int
    inv_freq: torch.Tensor,  # [rot // 2] f32
    *,
    num_heads: int,
    num_kv_heads: int,
    head_dim: int,
    qk_norm: bool = True,
    q_norm_w: torch.Tensor | None = None,  # [HD]
    k_norm_w: torch.Tensor | None = None,
    q_bias: torch.Tensor | None = None,  # flat or per-head bias
    k_bias: torch.Tensor | None = None,
    v_bias: torch.Tensor | None = None,
    rot: int | None = None,
    scaling: float = 1.0,
    eps: float = 1e-6,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (q [S, NH, HD], k [S, NKV, HD], v [S, NKV, HD]) in x.dtype."""
    kw = dict(num_heads=num_heads, num_kv_heads=num_kv_heads, head_dim=head_dim,
              qk_norm=qk_norm, q_norm_w=q_norm_w, k_norm_w=k_norm_w, q_bias=q_bias,
              k_bias=k_bias, v_bias=v_bias, rot=rot, scaling=scaling, eps=eps)
    if not x.is_cuda:
        return decode_qkv_prep_reference(x, norm_w, wq, wk, wv, positions, inv_freq, **kw)
    return _launch(x, norm_w, wq, wk, wv, positions, inv_freq, **kw)


def decode_qkv_plan(s: int, d: int, num_heads: int, num_kv_heads: int,
                    head_dim: int) -> dict:
    """The launch the kernel gives these shapes on this card: the split of D
    (blocks a cluster), the ring's stages, row groups, column tiles, 64-row M
    tiles a block, dynamic shared memory a block, and the clusters of that
    split the card holds at once (``cudaOccupancyMaxActiveClusters``). Needs
    the card."""
    out = (ctypes.c_int * 7)()
    lib = _build.load(_LIB)
    _build.check(KERNEL, lib.decode_qkv_plan(s, d, num_heads, num_kv_heads, head_dim, out))
    return dict(zip(("splits", "stages", "groups", "col_tiles", "m_tiles", "smem", "clusters"),
                    out))


def decode_qkv_tile_counts(x, norm_w, wq, wk, wv, positions, inv_freq,
                           **kw) -> torch.Tensor:
    """int32 [row groups, column tiles, splits]: the weight tiles each block
    of the kernel loaded, as it counted them in one launch on these inputs.
    Only the kernel counts: CPU tensors raise (``decode_qkv_tiles_visited``
    is the tiling's plain mirror)."""
    if not x.is_cuda:
        raise ValueError("decode_qkv_tile_counts: the counts come from the kernel, which takes "
                         "CUDA tensors")
    plan = decode_qkv_plan(x.shape[0], x.shape[1], kw["num_heads"], kw["num_kv_heads"],
                           kw["head_dim"])
    tiles = torch.full((plan["groups"], plan["col_tiles"], plan["splits"]), -1,
                       dtype=torch.int32, device=x.device)
    _launch(x, norm_w, wq, wk, wv, positions, inv_freq, tiles=tiles, **kw)
    return tiles


def _launch(x, norm_w, wq, wk, wv, positions, inv_freq, *, num_heads, num_kv_heads, head_dim,
            qk_norm=True, q_norm_w=None, k_norm_w=None, q_bias=None, k_bias=None, v_bias=None,
            rot=None, scaling=1.0, eps=1e-6, tiles=None):
    s, d = x.shape
    nh, nkv, hd = num_heads, num_kv_heads, head_dim
    if rot is None:
        rot = 2 * inv_freq.shape[0]
    if hd not in (32, 64, 128) or d % 16 or rot % 2 or rot > hd:
        raise ValueError(f"decode_qkv_prep takes head_dim 32, 64 or 128, hidden % 16 == 0 and an "
                         f"even rot <= head_dim; got {hd}, {d}, {rot}")
    bf = torch.bfloat16
    _build.require(x, "x", bf)
    _build.require(norm_w, "norm_w", bf, (d,))
    _build.require(wq, "wq", bf, (d, nh * hd))
    _build.require(wk, "wk", bf, (d, nkv * hd))
    _build.require(wv, "wv", bf, (d, nkv * hd))
    positions = positions.to(torch.int32)
    _build.require(positions, "positions", torch.int32, (s,))
    _build.require(inv_freq, "inv_freq", torch.float32, (rot // 2,))
    biases = (q_bias, k_bias, v_bias)
    if any(b is not None for b in biases) and any(b is None for b in biases):
        raise ValueError("q/k/v biases come together")
    for name, b, n in zip(("q_bias", "k_bias", "v_bias"), biases, (nh, nkv, nkv)):
        if b is not None:
            _build.require(b, name, bf)
            if b.numel() != n * hd:
                raise ValueError(f"{name}: expected {n * hd} values, got {b.numel()}")
    if qk_norm:
        if q_norm_w is None or k_norm_w is None:
            raise ValueError("qk_norm needs q_norm_w and k_norm_w")
        _build.require(q_norm_w, "q_norm_w", bf, (hd,))
        _build.require(k_norm_w, "k_norm_w", bf, (hd,))
    q = torch.empty((s, nh, hd), dtype=bf, device=x.device)
    k = torch.empty((s, nkv, hd), dtype=bf, device=x.device)
    v = torch.empty((s, nkv, hd), dtype=bf, device=x.device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    args = (x.data_ptr(), norm_w.data_ptr(), wq.data_ptr(), wk.data_ptr(), wv.data_ptr(),
            ptr(q_bias), ptr(k_bias), ptr(v_bias),
            ptr(q_norm_w) if qk_norm else None, ptr(k_norm_w) if qk_norm else None,
            positions.data_ptr(), inv_freq.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(),
            s, d, nh, nkv, hd, rot, float(scaling), float(eps), int(qk_norm),
            _build.stream_ptr(x))
    if tiles is not None:
        _build.require(tiles, "tiles", torch.int32)
        args += (tiles.data_ptr(),)
    _build.check(KERNEL, _kernel(tiles is not None)(*args))
    _build.launches[KERNEL] += 1
    return q, k, v

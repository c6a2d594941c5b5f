"""Qwen3-VL-class vision tower: a ViT with 2D rotary, interpolated position
embeddings, spatial patch merging and DeepStack feature taps (the port of the
JAX package's ``models/vision.py``).

The tower's parameters and arithmetic are the JAX package's:

- The Conv3d patch embed (kernel == stride) is one product on the flattened
  patch vector, ``[P, C*T*p*p] @ [., D]``.
- The patches of all images of a micro-batch ride one padded ``[P, .]``
  buffer with per-frame segment ids (0 = pad); attention is block-diagonal
  over the frames (HF ``cu_seqlens``).
- Blocks: LayerNorm (f32) -> qkv -> 2D rope (half the rotary dims carry the
  row coordinate, half the column) -> attention -> proj; LayerNorm -> fc1 ->
  GELU (tanh form) -> fc2. The mergers: LayerNorm (before the 2x2 merge, or
  after it for the DeepStack mergers) -> fc1 -> GELU (exact form) -> fc2.

The attention has no TPU kernel (the JAX package leaves it to XLA as one
full-matrix einsum) and stays plain PyTorch products here, on the card too.
Where the JAX form builds a ``[heads, P, P]`` score matrix over the whole
padded buffer and masks it, this one computes each frame on its own (frames
of one length batched together): the same block-diagonal function on the
real rows, without the padded bucket's scores. Pad rows are left out of the
attention and of the mergers (their outputs are zero; no real row reads
them, and the image slots never point at them).

The host prep (``prep_patch_metadata``, ``prep_mrope_position_ids``,
``prep_image_slots``, ``mrope_dim_select``) is numpy, copied from the JAX
package (which the port may not import): functions of ``grid_thw`` and the
token ids, computed once a sample in the data pipeline.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from prime_rl_tpu_torch.ops.layers import layer_norm, rope_frequencies

Params = dict
# the most f32 score bytes one batched attention product of equal-length
# frames may hold (16 heads of a 3072-patch frame are 604 MB)
SCORE_BYTES = 1 << 30


@dataclass(frozen=True)
class VisionSpec:
    """Vision-tower dims (HF Qwen3VLVisionConfig contract)."""

    depth: int = 27
    hidden_size: int = 1152
    intermediate_size: int = 4304
    num_heads: int = 16
    in_channels: int = 3
    patch_size: int = 16
    temporal_patch_size: int = 2
    spatial_merge_size: int = 2
    out_hidden_size: int = 3584
    num_position_embeddings: int = 2304  # G*G learned table
    deepstack_visual_indexes: tuple[int, ...] = (8, 16, 24)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def patch_dim(self) -> int:
        return self.in_channels * self.temporal_patch_size * self.patch_size**2

    @property
    def merge_unit(self) -> int:
        return self.spatial_merge_size**2

    @property
    def grid_side(self) -> int:
        return int(self.num_position_embeddings**0.5)


def init_vision_params(vspec: VisionSpec, generator: torch.Generator, dtype=torch.float32,
                       device: torch.device | str = "cpu") -> Params:
    """Random init on ``device`` from ``generator`` (truncated normal, std
    0.02 cut at 2 sigma; norms one, biases zero), in the JAX package's layout
    (blocks stacked ``[depth, ...]``, DeepStack mergers ``[n_ds, ...]``,
    projections ``[in, out]``). The numbers differ from ``jax.random``'s."""
    from prime_rl_tpu_torch.models.qwen3 import trunc_normal

    def w(*shape):
        return trunc_normal(shape, generator, dtype, device)

    def full(value, *shape):
        return torch.full(shape, value, dtype=dtype, device=device)

    D, I, dep = vspec.hidden_size, vspec.intermediate_size, vspec.depth
    md = D * vspec.merge_unit
    blocks = {
        "ln1_w": full(1.0, dep, D), "ln1_b": full(0.0, dep, D),
        "ln2_w": full(1.0, dep, D), "ln2_b": full(0.0, dep, D),
        "qkv_w": w(dep, D, 3 * D), "qkv_b": full(0.0, dep, 3 * D),
        "proj_w": w(dep, D, D), "proj_b": full(0.0, dep, D),
        "fc1_w": w(dep, D, I), "fc1_b": full(0.0, dep, I),
        "fc2_w": w(dep, I, D), "fc2_b": full(0.0, dep, D),
    }

    def merger(postshuffle: bool, *lead):
        nd = md if postshuffle else D
        return {
            "ln_w": full(1.0, *lead, nd), "ln_b": full(0.0, *lead, nd),
            "fc1_w": w(*lead, md, md), "fc1_b": full(0.0, *lead, md),
            "fc2_w": w(*lead, md, vspec.out_hidden_size),
            "fc2_b": full(0.0, *lead, vspec.out_hidden_size),
        }

    n_ds = len(vspec.deepstack_visual_indexes)
    return {
        "patch_w": w(vspec.patch_dim, D),
        "patch_b": full(0.0, D),
        "pos_embed": w(vspec.num_position_embeddings, D),
        "blocks": blocks,
        "merger": merger(False),
        "ds_mergers": merger(True, n_ds) if n_ds else {},
    }


def frame_runs(seg_ids: torch.Tensor) -> list[tuple[int, int]]:
    """The [start, end) rows of each real frame of a patch buffer (runs of one
    non-zero segment id; pads carry 0). One copy to the host."""
    ids, counts = torch.unique_consecutive(seg_ids.detach().cpu(), return_counts=True)
    runs, start = [], 0
    for i, n in zip(ids.tolist(), counts.tolist()):
        if i != 0:
            runs.append((start, start + n))
        start += n
    return runs


def frame_attention(q, k, v, runs: list[tuple[int, int]], scale: float) -> torch.Tensor:
    """Non-causal attention of each frame over itself. q/k/v: [P, H, hd]; the
    rows outside every run (pads) get 0. Scores and softmax in f32, the
    probabilities rounded to v's dtype before the value product (the JAX
    form's ``preferred_element_type`` f32 scores and ``astype(v.dtype)``).
    Frames of one length go through one batched product, at most
    ``SCORE_BYTES`` of scores at a time."""
    out = torch.zeros_like(q)
    by_len: dict[int, list[int]] = {}
    for a, b in runs:
        by_len.setdefault(b - a, []).append(a)
    heads = q.shape[1]
    for n, starts in by_len.items():
        per = max(1, SCORE_BYTES // (heads * n * n * 4))
        for c in range(0, len(starts), per):
            st = torch.tensor(starts[c:c + per], device=q.device)
            idx = (st[:, None] + torch.arange(n, device=q.device)[None, :]).reshape(-1)
            qs, ks, vs = (t.index_select(0, idx).reshape(-1, n, *t.shape[1:]) for t in (q, k, v))
            scores = torch.einsum("fqhd,fkhd->fhqk", qs.float(), ks.float()) * scale
            probs = torch.softmax(scores, dim=-1).to(v.dtype)
            o = torch.einsum("fhqk,fkhd->fqhd", probs, vs)
            out = out.index_copy(0, idx, o.reshape(-1, *o.shape[2:]))
    return out


def _vision_block(h, bp, vspec: VisionSpec, runs, cos, sin):
    P = h.shape[0]
    x = layer_norm(h, bp["ln1_w"], bp["ln1_b"])
    qkv = x @ bp["qkv_w"] + bp["qkv_b"].to(x.dtype)
    q, k, v = qkv.reshape(P, 3 * vspec.num_heads, vspec.head_dim).chunk(3, dim=1)

    def rope(t):
        tf = t.float()
        t1, t2 = tf.chunk(2, dim=-1)
        return torch.cat([t1 * cos - t2 * sin, t2 * cos + t1 * sin], dim=-1).to(t.dtype)

    o = frame_attention(rope(q), rope(k), v, runs, vspec.head_dim ** -0.5)
    h = h + (o.reshape(P, vspec.hidden_size) @ bp["proj_w"] + bp["proj_b"].to(h.dtype))
    x = layer_norm(h, bp["ln2_w"], bp["ln2_b"])
    x = F.gelu(x @ bp["fc1_w"] + bp["fc1_b"].to(x.dtype), approximate="tanh")
    return h + (x @ bp["fc2_w"] + bp["fc2_b"].to(x.dtype))


def _merger(h, mp, vspec: VisionSpec, postshuffle: bool):
    """[P, D] -> [P/m^2, out]. postshuffle (DeepStack): the norm AFTER the
    m^2-merge reshape; the final merger norms before it (HF
    Qwen3VLVisionPatchMerger)."""
    mu = vspec.merge_unit
    if postshuffle:
        x = layer_norm(h.reshape(-1, mu * vspec.hidden_size), mp["ln_w"], mp["ln_b"])
    else:
        x = layer_norm(h, mp["ln_w"], mp["ln_b"]).reshape(-1, mu * vspec.hidden_size)
    x = F.gelu(x @ mp["fc1_w"] + mp["fc1_b"].to(x.dtype), approximate="none")
    return x @ mp["fc2_w"] + mp["fc2_b"].to(x.dtype)


def vision_forward(
    vparams: Params,
    vspec: VisionSpec,
    patches: torch.Tensor,      # [P, patch_dim] f32 (HF processor layout, merge-block order)
    seg_ids: torch.Tensor,      # [P] int, 1-based frame index, 0 = pad
    pos_idx: torch.Tensor,      # [4, P] int bilinear gather rows into pos_embed
    pos_w: torch.Tensor,        # [4, P] f32 bilinear weights
    rope_coords: torch.Tensor,  # [P, 2] int (row, col) full-res coords
    compute_dtype=torch.float32,
    remat: str = "full",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (merged [P/m^2, out_hidden], deepstack [n_ds, P/m^2,
    out_hidden]), the rows of pad patches zero. ``remat``: ``none`` keeps
    every block's activations; any other mode recomputes each block in the
    backward (the tower has no kernel outputs to keep)."""
    def cast(t):
        return t.to(compute_dtype) if t.is_floating_point() else t

    P = patches.shape[0]
    mu = vspec.merge_unit
    runs = frame_runs(seg_ids)
    real = runs[-1][1] if runs else 0  # the real patches lead, pads trail
    h = patches.to(compute_dtype) @ cast(vparams["patch_w"]) + cast(vparams["patch_b"])
    pos = torch.einsum("gpd,gp->pd", vparams["pos_embed"].float()[pos_idx.long()], pos_w.float())
    h = h + pos.to(compute_dtype)

    # 2D rope: half the rotary dims carry the row coordinate, half the column
    inv_freq = rope_frequencies(vspec.head_dim // 2, 10000.0, device=patches.device)
    angles = (rope_coords[..., None].float() * inv_freq).reshape(P, -1)  # [P, hd//2]
    cos, sin = torch.cos(angles)[:, None, :], torch.sin(angles)[:, None, :]

    blocks = {k: cast(v).unbind(0) for k, v in vparams["blocks"].items()}

    def block(h, *leaves):
        return _vision_block(h, dict(zip(blocks, leaves)), vspec, runs, cos, sin)

    taps = sorted(vspec.deepstack_visual_indexes)
    ds_feats = []

    def merged_rows(x, mp, postshuffle):
        # the mergers see the real rows only; pad rows stay zero
        out = x.new_zeros((P // mu, vspec.out_hidden_size))
        if real:
            out = torch.cat([_merger(x[:real], mp, vspec, postshuffle), out[real // mu:]])
        return out

    for i in range(vspec.depth):
        leaves = [blocks[k][i] for k in blocks]
        if remat == "none" or not torch.is_grad_enabled():
            h = block(h, *leaves)
        else:
            h = checkpoint(block, h, *leaves, use_reentrant=False, preserve_rng_state=False)
        if i in taps:
            k = taps.index(i)
            mp = {n: cast(t[k]) for n, t in vparams["ds_mergers"].items()}
            ds_feats.append(merged_rows(h, mp, True))
    merged = merged_rows(h, {n: cast(t) for n, t in vparams["merger"].items()}, False)
    ds = torch.stack(ds_feats) if ds_feats else merged.new_zeros((0,) + merged.shape)
    return merged, ds


# ---------------------------------------------------------------------------
# Host-side prep (numpy, data pipeline): pure functions of grid_thw and the
# token ids, computed once a sample and shipped as arrays.
# ---------------------------------------------------------------------------

def prep_patch_metadata(
    grid_thw: np.ndarray, vspec: VisionSpec, pad_to: int | None = None
) -> dict[str, np.ndarray]:
    """Per-patch arrays for a concatenated multi-image stream.

    Returns dict with seg_ids [P], pos_idx [4, P], pos_w [4, P],
    rope_coords [P, 2]; P = sum(t*h*w) padded to ``pad_to``.
    Order matches the HF processor's merge-block patch layout."""
    m, G = vspec.spatial_merge_size, vspec.grid_side
    segs, idxs, ws, coords = [], [], [], []
    seg_counter = 0
    for img_i, (t, hh, ww) in enumerate(np.asarray(grid_thw, np.int64), start=1):
        # attention is block-diagonal per FRAME, not per image (HF
        # Qwen3VLVisionModel: cu_seqlens = repeat_interleave(h*w, t).cumsum())
        fr = int(hh * ww)
        segs.append(np.repeat(
            np.arange(seg_counter + 1, seg_counter + 1 + int(t), dtype=np.int32), fr))
        seg_counter += int(t)

        # --- bilinear pos-embed gather (HF fast_pos_embed_interpolate) ---
        h_idx = np.linspace(0, G - 1, hh, dtype=np.float32)
        w_idx = np.linspace(0, G - 1, ww, dtype=np.float32)
        h_fl = h_idx.astype(np.int32)
        w_fl = w_idx.astype(np.int32)
        h_ce = np.clip(h_fl + 1, None, G - 1)
        w_ce = np.clip(w_fl + 1, None, G - 1)
        dh, dw = h_idx - h_fl, w_idx - w_fl
        idx4 = np.stack([
            (h_fl[:, None] * G + w_fl[None, :]).ravel(),
            (h_fl[:, None] * G + w_ce[None, :]).ravel(),
            (h_ce[:, None] * G + w_fl[None, :]).ravel(),
            (h_ce[:, None] * G + w_ce[None, :]).ravel(),
        ]).astype(np.int32)  # [4, h*w] row-major
        w4 = np.stack([
            ((1 - dh)[:, None] * (1 - dw)[None, :]).ravel(),
            ((1 - dh)[:, None] * dw[None, :]).ravel(),
            (dh[:, None] * (1 - dw)[None, :]).ravel(),
            (dh[:, None] * dw[None, :]).ravel(),
        ]).astype(np.float32)

        # merge-block permutation: row-major (h, w) -> (h/m, w/m, m, m) order
        perm = (
            np.arange(hh * ww)
            .reshape(hh // m, m, ww // m, m)
            .transpose(0, 2, 1, 3)
            .ravel()
        )
        idx4 = np.tile(idx4[:, perm], (1, t))
        w4 = np.tile(w4[:, perm], (1, t))
        idxs.append(idx4)
        ws.append(w4)

        # --- 2D rope coords, merge-block order (HF rot_pos_emb) ---
        rows = np.arange(hh).repeat(ww).reshape(hh, ww)
        cols = np.tile(np.arange(ww), (hh, 1))
        rc = np.stack([rows.ravel()[perm], cols.ravel()[perm]], axis=-1)
        coords.append(np.tile(rc, (t, 1)).astype(np.int32))

    seg_ids = np.concatenate(segs) if segs else np.zeros(0, np.int32)
    pos_idx = np.concatenate(idxs, axis=1) if idxs else np.zeros((4, 0), np.int32)
    pos_w = np.concatenate(ws, axis=1) if ws else np.zeros((4, 0), np.float32)
    rope_coords = np.concatenate(coords) if coords else np.zeros((0, 2), np.int32)
    P = seg_ids.shape[0]
    if pad_to is not None and pad_to > P:
        pad = pad_to - P
        seg_ids = np.pad(seg_ids, (0, pad))
        pos_idx = np.pad(pos_idx, ((0, 0), (0, pad)))
        pos_w = np.pad(pos_w, ((0, 0), (0, pad)))
        rope_coords = np.pad(rope_coords, ((0, pad), (0, 0)))
    return {"seg_ids": seg_ids, "pos_idx": pos_idx, "pos_w": pos_w,
            "rope_coords": rope_coords}


def prep_mrope_position_ids(
    token_ids: np.ndarray,
    grid_thw: np.ndarray,
    merge_size: int,
    image_token_id: int,
    video_token_id: int,
) -> np.ndarray:
    """[3, L] (t, h, w) positions for one UNPACKED sample: text tokens run
    sequentially (equal t/h/w), each vision block gets grid positions offset
    from the preceding text, and text resumes at max+1 (HF get_rope_index
    semantics; videos are pre-split to t=1 grids by the caller)."""
    L = len(token_ids)
    pos = np.zeros((3, L), np.int64)
    is_vis = (token_ids == image_token_id) | (token_ids == video_token_id)
    grid_iter = iter(np.asarray(grid_thw, np.int64))
    st, st_idx = 0, 0
    i = 0
    while i < L:
        if not is_vis[i]:
            i += 1
            continue
        # text span [st, i)
        text_len = i - st
        g = next(grid_iter, None)
        if g is None:
            # more vision-token runs than provided grids: a sampled/spurious
            # image token in an RL completion, the rest treated as plain text
            break
        pos[:, st:i] = np.arange(st_idx, st_idx + text_len)
        st_idx += text_len
        t, hh, ww = g
        gh, gw = int(hh) // merge_size, int(ww) // merge_size
        n = int(t) * gh * gw
        t_ix = np.arange(t).repeat(gh * gw)
        h_ix = np.tile(np.arange(gh).repeat(gw), int(t))
        w_ix = np.tile(np.arange(gw), int(t) * gh)
        m = min(n, L - i)  # a truncated sample may cut a vision block short
        pos[0, i : i + m] = st_idx + t_ix[:m]
        pos[1, i : i + m] = st_idx + h_ix[:m]
        pos[2, i : i + m] = st_idx + w_ix[:m]
        st_idx = st_idx + int(max(t - 1, gh - 1, gw - 1)) + 1
        i += m
        st = i
    if st < L:
        pos[:, st:L] = np.arange(st_idx, st_idx + (L - st))
    return pos.astype(np.int32)


def prep_image_slots(token_ids: np.ndarray, image_token_id: int,
                     video_token_id: int, base: int = 0,
                     max_slots: int | None = None) -> np.ndarray:
    """[L] int32: for each vision-token position, its row in the merged
    image-embed buffer (``base`` offsets into the micro-batch-wide buffer);
    -1 elsewhere: the in-model inject mask is ``slot >= 0``. ``max_slots``
    caps assignment at the merged-row count the grids actually provide, so
    sampled/spurious image tokens in an RL completion stay plain text."""
    is_vis = (token_ids == image_token_id) | (token_ids == video_token_id)
    slots = np.full(len(token_ids), -1, np.int32)
    vis_idx = np.nonzero(is_vis)[0]
    if max_slots is not None:
        vis_idx = vis_idx[:max_slots]
    slots[vis_idx] = base + np.arange(len(vis_idx), dtype=np.int32)
    return slots


def mrope_dim_select(mrope_section: tuple[int, ...], rot_half: int) -> np.ndarray:
    """Static [rot_half] array in {0,1,2}: which of (t,h,w) each frequency
    index reads, the interleaved-mRoPE layout (HF apply_interleaved_mrope:
    H at indices 1,4,7,...<3*sec[1], W at 2,5,8,...<3*sec[2], T elsewhere)."""
    sel = np.zeros(rot_half, np.int32)
    for dim, off in ((1, 1), (2, 2)):
        end = min(3 * mrope_section[dim], rot_half)
        sel[off:end:3] = dim
    return sel

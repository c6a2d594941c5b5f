"""Host-side sequence packing: TrainingSamples → fixed-shape micro-batches.

The port of the JAX package's ``trainer/batch.py``, numpy in and numpy out,
so both packages build identical arrays from the same samples: **static-shape**
[N, B, L] stacked micro-batches with segment ids (attention masks on segment
ids) and per-sequence restarting position ids. With a ``vlm_spec`` every
micro-batch also carries the vision streams (``_assemble_mm``): one padded
patch buffer, its host prep, the image slots and the mRoPE positions.

Packing algorithm: first-fit-decreasing into rows of length ``seq_len``,
then workload-balanced assignment of rows to micro-batches by quadratic
attention-aware cost (sum of len^2), mirroring the reference's ``bin_cost``
balancing. Dummy rows (segment 0 everywhere, loss-masked out) pad the last
micro-batch — every rank always sees the same shapes.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from prime_rl_tpu_torch.trainer.step import MicroBatchArrays
from prime_rl_tpu_torch.transport.types import TrainingSample


@dataclass
class PackedRow:
    """One [L] row of concatenated sequences (host-side, numpy)."""

    samples: list[TrainingSample]

    def tokens(self) -> int:
        return sum(len(s) for s in self.samples)

    def cost(self) -> float:
        return sum(float(len(s)) ** 2 for s in self.samples)


def truncate_sample(sample: TrainingSample, seq_len: int) -> TrainingSample:
    if len(sample) <= seq_len:
        return sample
    sl = slice(0, seq_len)

    def cut(x):
        return None if x is None else x[sl]

    return TrainingSample(
        token_ids=sample.token_ids[sl],
        mask=sample.mask[sl],
        logprobs=sample.logprobs[sl],
        temperatures=sample.temperatures[sl],
        env_name=sample.env_name,
        ref_logprobs=cut(sample.ref_logprobs),
        advantages=cut(sample.advantages),
        rl_weights=cut(sample.rl_weights),
        ce_weights=cut(sample.ce_weights),
        ref_kl_weights=cut(sample.ref_kl_weights),
        routed_experts=cut(sample.routed_experts),
        mm_kwargs=sample.mm_kwargs,
        mm_token_type_ids=cut(sample.mm_token_type_ids),
    )


def pack_rows(samples: list[TrainingSample], seq_len: int) -> list[PackedRow]:
    """First-fit-decreasing into rows of capacity seq_len."""
    rows: list[PackedRow] = []
    for sample in sorted(samples, key=len, reverse=True):
        sample = truncate_sample(sample, seq_len)
        for row in rows:
            if row.tokens() + len(sample) <= seq_len:
                row.samples.append(sample)
                break
        else:
            rows.append(PackedRow(samples=[sample]))
    return rows


def balance_rows(
    rows: list[PackedRow], num_bins: int, capacity: int | None = None
) -> list[list[PackedRow]]:
    """Greedy longest-processing-time assignment by quadratic cost
    (reference: trainer/utils.py:146 build_bin_cost).

    ``capacity`` caps rows per bin (the micro-batch row count): assignment
    always picks the cheapest bin *with space*, so no row is ever silently
    dropped downstream. Raises if ``num_bins * capacity < len(rows)``.
    """
    if capacity is not None and num_bins * capacity < len(rows):
        raise ValueError(
            f"{len(rows)} packed rows do not fit in {num_bins} micro-batches "
            f"of {capacity} rows; grow num_micro_batches or micro_batch_size"
        )
    bins: list[list[PackedRow]] = [[] for _ in range(num_bins)]
    costs = [0.0] * num_bins
    for row in sorted(rows, key=lambda r: r.cost(), reverse=True):
        order = np.argsort(costs, kind="stable")
        i = next(
            int(j) for j in order if capacity is None or len(bins[j]) < capacity
        )
        bins[i].append(row)
        costs[i] += row.cost()
    return bins


def _assemble_mm(row_slots, shape, vlm_spec, pad_patches: int):
    """Per-micro-batch vision arrays (the VLM path).

    Each sample's ``mm_kwargs`` holds the HF-processor outputs
    ``{"pixel_values": [P_i, patch_dim] f32, "image_grid_thw": [n_i, 3]}``.
    All samples' patches ride ONE padded [P, patch_dim] buffer; per-frame
    segment ids keep vision attention block-diagonal, per-sample slot bases
    point each image token at its row of the merged-embedding buffer, and
    mRoPE grid positions overwrite the sequential default at vision spans.
    Text-only samples keep sequential (t==h==w) positions: exactly plain
    rope, so mixing text and VLM samples in one packed row is safe."""
    from prime_rl_tpu_torch.models.vision import (
        prep_image_slots,
        prep_mrope_position_ids,
        prep_patch_metadata,
    )

    vspec = vlm_spec.vision
    B, L = shape
    mu = vspec.merge_unit
    img_slot = np.full((B, L), -1, np.int32)  # -1 = not a vision position
    mm_position_ids = np.zeros((3, B, L), np.int32)
    pixels, segs, idxs, ws, coords = [], [], [], [], []
    seg_base = 0  # running frame count (vision segment ids are 1-based)
    merged_base = 0  # running rows in the merged-embedding buffer

    for b, start, s in row_slots:
        n = len(s)
        sl = slice(start, start + n)
        # default: sequential positions on all three mrope dims == plain rope
        mm_position_ids[:, b, sl] = np.arange(n, dtype=np.int32)
        mm = s.mm_kwargs
        if not mm or "pixel_values" not in mm:
            continue
        grid = np.asarray(mm["image_grid_thw"], np.int64)
        meta = prep_patch_metadata(grid, vspec)
        pixels.append(np.asarray(mm["pixel_values"], np.float32))
        segs.append(np.where(meta["seg_ids"] > 0, meta["seg_ids"] + seg_base, 0))
        idxs.append(meta["pos_idx"])
        ws.append(meta["pos_w"])
        coords.append(meta["rope_coords"])
        mm_position_ids[:, b, sl] = prep_mrope_position_ids(
            s.token_ids, grid, vspec.spatial_merge_size,
            vlm_spec.image_token_id, vlm_spec.video_token_id,
        )
        slots = prep_image_slots(
            s.token_ids, vlm_spec.image_token_id, vlm_spec.video_token_id,
            base=merged_base, max_slots=meta["seg_ids"].shape[0] // mu,
        )
        img_slot[b, sl] = slots
        seg_base += int(meta["seg_ids"].max(initial=0))
        merged_base += meta["seg_ids"].shape[0] // mu

    P_real = sum(p.shape[0] for p in pixels)
    if P_real > pad_patches:
        raise ValueError(
            f"{P_real} vision patches exceed max_mm_patches={pad_patches} "
            "for one micro-batch; raise batch.max_mm_patches"
        )
    pd = vspec.patch_dim

    def cat_pad(parts, empty_shape, pad_width):
        out = np.concatenate(parts, axis=0) if parts else np.zeros(empty_shape, np.float32)
        return np.pad(out, pad_width(pad_patches - out.shape[0]))

    patches = cat_pad(pixels, (0, pd), lambda p: ((0, p), (0, 0)))
    seg_arr = np.concatenate(segs) if segs else np.zeros(0, np.int32)
    seg_arr = np.pad(seg_arr, (0, pad_patches - seg_arr.shape[0]))
    pos_idx = (np.concatenate(idxs, axis=1) if idxs else np.zeros((4, 0), np.int32))
    pos_idx = np.pad(pos_idx, ((0, 0), (0, pad_patches - pos_idx.shape[1])))
    pos_w = np.concatenate(ws, axis=1) if ws else np.zeros((4, 0), np.float32)
    pos_w = np.pad(pos_w, ((0, 0), (0, pad_patches - pos_w.shape[1])))
    rc = np.concatenate(coords) if coords else np.zeros((0, 2), np.int32)
    rc = np.pad(rc, ((0, pad_patches - rc.shape[0]), (0, 0)))
    return {
        "mm_patches": patches.astype(np.float32),
        "mm_vis_seg_ids": seg_arr.astype(np.int32),
        "mm_vis_pos_idx": pos_idx.astype(np.int32),
        "mm_vis_pos_w": pos_w.astype(np.float32),
        "mm_vis_rope_coords": rc.astype(np.int32),
        "mm_img_slot": img_slot,
        "mm_position_ids": mm_position_ids,
    }


def _optional_stream(samples, row_slots, shape, attr, fill=0.0):
    """Assemble an optional [B, L] stream; None iff absent in every sample."""
    if not any(getattr(s, attr) is not None for _, _, s in row_slots):
        return None
    out = np.full(shape, fill, dtype=np.float32)
    for b, start, s in row_slots:
        v = getattr(s, attr)
        if v is not None:
            out[b, start : start + len(s)] = v
    return out


def rows_to_arrays(rows: list[PackedRow], seq_len: int, batch_rows: int,
                   vlm_spec=None, max_mm_patches: int = 0) -> MicroBatchArrays:
    """One micro-batch: ``batch_rows`` packed rows → [B, L] arrays.

    Alignment contract (current-token convention): the first token of every
    sequence is force-masked out of the loss — its "logprob" is the uniform
    pad emitted by the model head, and in a packed row the head's prediction
    at the previous position belongs to a different sequence.
    """
    B, L = batch_rows, seq_len
    input_ids = np.zeros((B, L), np.int32)
    loss_mask = np.zeros((B, L), bool)
    advantages = np.zeros((B, L), np.float32)
    inference_logprobs = np.zeros((B, L), np.float32)
    position_ids = np.zeros((B, L), np.int32)
    segment_ids = np.zeros((B, L), np.int32)
    temperatures = np.ones((B, L), np.float32)

    if len(rows) > B:
        raise ValueError(f"{len(rows)} rows exceed micro-batch capacity {B}")
    row_slots: list[tuple[int, int, TrainingSample]] = []
    for b, row in enumerate(rows):
        cursor = 0
        for seg, s in enumerate(row.samples, start=1):
            n = len(s)
            sl = slice(cursor, cursor + n)
            input_ids[b, sl] = s.token_ids
            mask = np.asarray(s.mask, bool).copy()
            mask[0] = False  # first token of a sequence is never trainable
            loss_mask[b, sl] = mask
            if s.advantages is not None:
                advantages[b, sl] = s.advantages
            inference_logprobs[b, sl] = s.logprobs
            position_ids[b, sl] = np.arange(n, dtype=np.int32)
            segment_ids[b, sl] = seg
            temperatures[b, sl] = s.temperatures
            row_slots.append((b, cursor, s))
            cursor += n

    shape = (B, L)
    mm = (_assemble_mm(row_slots, shape, vlm_spec, max_mm_patches)
          if vlm_spec is not None else {})
    routed = None
    if any(s.routed_experts is not None for _, _, s in row_slots):
        # router replay stream [B, L, NL, K]; -1 rows = no recording (context
        # tokens / non-replayed samples) -> trainer's own routing
        nl, k = next(s.routed_experts.shape[1:]
                     for _, _, s in row_slots if s.routed_experts is not None)
        routed = np.full((B, L, nl, k), -1, np.int32)
        for b, start, s in row_slots:
            if s.routed_experts is not None:
                routed[b, start : start + len(s)] = s.routed_experts
    return MicroBatchArrays(
        **mm,
        routed_experts=routed,
        input_ids=input_ids,
        loss_mask=loss_mask,
        advantages=advantages,
        inference_logprobs=inference_logprobs,
        position_ids=position_ids,
        segment_ids=segment_ids,
        temperatures=temperatures,
        ref_logprobs=_optional_stream(None, row_slots, shape, "ref_logprobs"),
        rl_weights=_optional_stream(None, row_slots, shape, "rl_weights"),
        ce_weights=_optional_stream(None, row_slots, shape, "ce_weights"),
        ref_kl_weights=_optional_stream(None, row_slots, shape, "ref_kl_weights"),
    )


def stack_micro_batches(micro_batches: list[MicroBatchArrays]) -> MicroBatchArrays:
    """[B, L] micro-batches → one [N, B, L] stacked pytree. Optional streams
    must be uniformly present/absent (the packer materializes zeros when any
    sample in the step carries a stream)."""
    def stack(field: str):
        vals = [getattr(m, field) for m in micro_batches]
        if any(v is None for v in vals):
            if all(v is None for v in vals):
                return None
            # mixed presence: materialize zeros for the missing ones
            ref = next(v for v in vals if v is not None)
            vals = [np.zeros_like(ref) if v is None else v for v in vals]
        return np.stack(vals)

    return MicroBatchArrays(*[stack(f) for f in MicroBatchArrays._fields])


def prepare_batch(
    samples: list[TrainingSample],
    seq_len: int,
    micro_batch_rows: int,
    num_micro_batches: int | None = None,
    vlm_spec=None,
    max_mm_patches: int = 0,
) -> MicroBatchArrays:
    """TrainingSamples → one stacked [N, B, L] batch.

    ``num_micro_batches=None`` uses the minimum count that fits; a fixed count
    keeps shapes constant across steps (recommended: set from config). If the
    rollouts overflow the pinned count, N grows to the minimum that fits:
    never a dropped sample.

    ``vlm_spec`` (a VLM ModelSpec) turns on the vision streams: every
    micro-batch then carries a padded ``max_mm_patches``-patch vision buffer
    and mRoPE positions (sequential for text samples), so a step's streams
    have the same fields whether or not a micro-batch holds images.
    ``max_mm_patches`` 0 sizes the buffer from the batch (the largest bin's
    patches, rounded up to 256).
    """
    rows = pack_rows(samples, seq_len)
    rows_per_mb = micro_batch_rows
    needed = max(1, -(-len(rows) // rows_per_mb))
    if num_micro_batches is None:
        num_micro_batches = needed
    elif needed > num_micro_batches:
        import warnings

        warnings.warn(
            f"batch needs {needed} micro-batches > pinned {num_micro_batches}; "
            "growing. Tighten the orchestrator's max_batch_tokens.",
            stacklevel=2,
        )
        num_micro_batches = needed
    bins = balance_rows(rows, num_micro_batches, capacity=rows_per_mb)
    if vlm_spec is not None and max_mm_patches <= 0:
        # auto-size: the largest real patch count over the bins, padded up;
        # pin batch.max_mm_patches in config to keep step shapes constant
        per_bin = [
            sum(int(np.asarray(s.mm_kwargs["image_grid_thw"]).prod(axis=1).sum())
                for row in b for s in row.samples
                if s.mm_kwargs and "pixel_values" in s.mm_kwargs)
            for b in bins
        ]
        max_mm_patches = max(256, -(-max(per_bin, default=0) // 256) * 256)
    mbs = [rows_to_arrays(b, seq_len, rows_per_mb, vlm_spec, max_mm_patches)
           for b in bins]
    return stack_micro_batches(mbs)


def token_counts(batch: MicroBatchArrays) -> dict[str, int]:
    """Host-side per-component token counts for the whole stacked batch
    (the trainer all-reduces these across processes into Scales)."""
    mask = batch.loss_mask
    if batch.rl_weights is None:
        rl = int(mask.sum())
    else:
        rl = int((mask & (batch.rl_weights != 0)).sum())
    ce = int((batch.ce_weights != 0).sum()) if batch.ce_weights is not None else 0
    rk = int((batch.ref_kl_weights != 0).sum()) if batch.ref_kl_weights is not None else 0
    return {"rl": rl, "ce": ce, "ref_kl": rk}

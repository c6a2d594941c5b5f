"""Qwen3-VL family: the ViT vision tower (``models/vision.py``) and the Qwen3
text trunk with interleaved mRoPE and DeepStack feature injection, dense
(``qwen3_vl``) or MoE (``qwen3_vl_moe``); the port of the JAX package's
``models/qwen3_vl.py``, trained and served.

- The tower consumes one padded patch buffer a micro-batch with the host
  prep's arrays (``mm``) and returns the merged embeddings and the DeepStack
  features.
- The merged embeddings replace the token embeddings where the host prep gave
  a token an image slot (``img_slot >= 0``), never by token id: an image
  token the policy sampled has no pixels behind it and stays a text token.
- Interleaved mRoPE is a per-frequency position gather: ``mrope_dim_select``
  turns the [3, B, L] grid positions into [B, L, rot//2] positions, and
  ``ops.layers.apply_rope`` rotates with them. Text-only rows carry equal t/h/w
  positions, which is plain rope.
- DeepStack: after each of the first ``n_ds`` decoder layers the k-th feature
  map is added at the image slots (HF ``Qwen3VLTextModel._deepstack_process``).

The attention of the trunk is ``qwen3._attn_block`` (K1 forward, K2a/K2b
backward on the card); the MoE variant's experts are ``qwen3_moe.moe_block``.
Params: the text family's tree plus ``"vision"`` (``vision.init_vision_params``).
The init and the HF converters also serve ``qwen3_next_vl``, whose trunk is
``qwen3_next`` (its forward is ``qwen3_next.forward``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from prime_rl_tpu_torch.models import qwen3, qwen3_moe
from prime_rl_tpu_torch.models.base import ModelSpec
from prime_rl_tpu_torch.models.lora import layer_slices
from prime_rl_tpu_torch.models.qwen3 import layer_remat, parse_remat, rope_setup, run_layer
from prime_rl_tpu_torch.models.vision import (
    VisionSpec,
    init_vision_params,
    mrope_dim_select,
    vision_forward,
)
from prime_rl_tpu_torch.ops.layers import rms_norm

Params = dict
FAMILIES = ("qwen3_vl", "qwen3_vl_moe")
# the ac.modes the JAX function names (prime_rl_tpu/models/qwen3_vl.py:150-155) and the mode
# each runs as; any other keeps every activation (``qwen3.parse_remat``)
REMAT = {"full": "full", "selective": "selective"}
# the tower's inputs in a ``mm`` dict
MM_KEYS = ("patches", "vis_seg_ids", "vis_pos_idx", "vis_pos_w", "vis_rope_coords", "img_slot",
           "mm_position_ids")


def _trunk(spec: ModelSpec):
    """The trunk's module: ``qwen3_next`` under ``qwen3_next_vl`` (imported
    here: it imports this module), else ``qwen3_moe`` or ``qwen3``."""
    if spec.family == "qwen3_next_vl":
        from prime_rl_tpu_torch.models import qwen3_next

        return qwen3_next
    return qwen3_moe if spec.is_moe else qwen3


def text_spec(spec: ModelSpec) -> ModelSpec:
    """The trunk's spec under its text family's name (qwen3, qwen3_moe or
    qwen3_next)."""
    return dataclasses.replace(spec, family=_trunk(spec).__name__.rsplit(".", 1)[1])


def init_params(spec: ModelSpec, generator: torch.Generator, dtype=torch.float32,
                device: torch.device | str = "cpu") -> Params:
    """Random init of the trunk (``qwen3``, ``qwen3_moe`` or ``qwen3_next``)
    and the tower on ``device`` from ``generator``. The numbers differ from
    ``jax.random``'s; tests bring JAX weights over with
    ``qwen3.params_from_jax``."""
    params = _trunk(spec).init_params(text_spec(spec), generator, dtype=dtype, device=device)
    params["vision"] = init_vision_params(spec.vision, generator, dtype=dtype, device=device)
    return params


get_lm_head = qwen3.get_lm_head


def _mrope_positions(spec: ModelSpec, mm_position_ids: torch.Tensor) -> torch.Tensor:
    """[3, B, L] grid positions -> [B, L, rot//2] per-frequency positions (rot
    respects partial rotary)."""
    rot_half = int(spec.head_dim * spec.partial_rotary_factor) // 2
    sel = torch.as_tensor(mrope_dim_select(tuple(spec.mrope_section), rot_half),
                          device=mm_position_ids.device).long()
    return mm_position_ids[sel].permute(1, 2, 0)


def embed_mm(params: Params, spec: ModelSpec, h: torch.Tensor, mm: dict, compute_dtype,
             remat: str = "full"):
    """The tower over ``mm`` and the injection of its merged embeddings into
    ``h`` [B, L, D] at the image slots. Returns (h, ds_feats [n_ds, rows, D]
    in ``compute_dtype``, slot [B, L] clamped at 0, mask [B, L, 1])."""
    merged, ds_feats = vision_forward(
        params["vision"], spec.vision, mm["patches"], mm["vis_seg_ids"], mm["vis_pos_idx"],
        mm["vis_pos_w"], mm["vis_rope_coords"], compute_dtype=compute_dtype, remat=remat)
    img_slot = mm["img_slot"].long()
    mask = (img_slot >= 0)[..., None]
    slot = img_slot.clamp(min=0)
    h = torch.where(mask, merged.to(compute_dtype)[slot], h)
    return h, ds_feats.to(compute_dtype), slot, mask


def forward(
    params: Params,
    spec: ModelSpec,
    input_ids: torch.Tensor,  # [B, L] int
    segment_ids: torch.Tensor,  # [B, L] int (0 = pad)
    position_ids: torch.Tensor,  # [B, L] int text positions (used when mm is None)
    compute_dtype=torch.bfloat16,
    attn_impl: str = "auto",
    block_q: int = 512,
    block_kv: int = 512,
    remat: str = "full",
    mesh=None,
    lora: Params | None = None,
    lora_scale: float = 1.0,
    cp_style: str = "ulysses",
    collect_aux: bool = False,
    routed_experts: torch.Tensor | None = None,  # [B, L, NL, K] (MoE); -1 = own routing
    quantized_compute: str | None = None,
    mm: dict | None = None,
):
    """Final normed hidden states [B, L, D], or (hidden, load-balance aux) with
    ``collect_aux`` on the MoE variant.

    ``mm`` (tensors; None = a text-only forward with plain rope):
    patches [P, patch_dim], vis_seg_ids [P], vis_pos_idx [4, P], vis_pos_w
    [4, P], vis_rope_coords [P, 2], img_slot [B, L] (the row of the merged
    buffer a vision token takes, -1 elsewhere), mm_position_ids [3, B, L].
    ``remat``: the modes the JAX function names for the trunk's layers
    (``REMAT``: ``full``, ``selective``, as in ``qwen3.forward``); any other
    mode (``save_attn`` among them) and any ``mode/K`` keeps every
    activation, as there. The tower's blocks recompute under any mode but
    ``none``. ``lora`` and ``lora_scale`` go through the trunk."""
    if spec.family not in FAMILIES:
        raise ValueError(f"qwen3_vl.forward: family {spec.family!r} is not a Qwen3-VL family")
    qwen3_moe.check_forward_args(spec, mesh, lora, quantized_compute)
    nl = spec.num_layers
    base_remat, save_stride = parse_remat(remat, nl, REMAT)
    inv_freq, rope_scaling = rope_setup(spec, device=input_ids.device)
    h = params["embed"].to(compute_dtype)[input_ids]

    ds_feats = slot = mask = None
    if mm is not None:
        h, ds_feats, slot, mask = embed_mm(params, spec, h, mm, compute_dtype, base_remat)
        rope_pos = _mrope_positions(spec, mm["mm_position_ids"])
    else:
        rope_pos = position_ids

    def attn(h, lp, saved, window, ll):
        lp = {k: (v.to(compute_dtype) if v.dim() >= 2 else v)
              for k, v in lp.items() if k not in qwen3_moe._MOE_FIELDS}
        return qwen3._attn_block(h, lp, spec, segment_ids, rope_pos, inv_freq, attn_impl,
                                 rope_scaling, saved, window, ll, lora_scale)

    if spec.is_moe:
        def block(h, lp, saved, window, forced, ll):
            return qwen3_moe.moe_block(attn(h, lp, saved, window, ll), lp, spec, compute_dtype,
                                       forced, ll, lora_scale)
    else:
        def block(h, lp, saved, window, forced, ll):
            mlp = {k: (v.to(compute_dtype) if v.dim() >= 2 else v) for k, v in lp.items()}
            out = qwen3._mlp_block(attn(h, lp, saved, window, ll), mlp, spec, ll, lora_scale)
            return out, torch.zeros((), dtype=torch.float32, device=out.device)

    forced = (qwen3_moe.forced_by_layer(routed_experts, nl, spec.num_experts_per_tok)
              if spec.is_moe else None)
    per_layer = {k: v.unbind(0) for k, v in params["layers"].items()}
    lora_layers = layer_slices(lora, nl)
    n_ds = 0 if ds_feats is None else ds_feats.shape[0]
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(nl):
        lp = {k: v[i] for k, v in per_layer.items()}
        h, lb = run_layer(block, h, lp, 0, layer_remat(base_remat, save_stride, i),
                          None if forced is None else forced[i], lora_layers[i])
        aux = aux + lb
        if i < n_ds:  # DeepStack: the i-th feature map at the image slots
            h = torch.where(mask, h + ds_feats[i][slot], h)
    h = rms_norm(h, params["final_norm"], spec.rms_eps)
    return (h, aux) if collect_aux and spec.is_moe else h


# ---------------------------------------------------------------------------
# HF interchange: the text keys under model.language_model.*, the tower under
# model.visual.* (HF Qwen3VLForConditionalGeneration layout).
# ---------------------------------------------------------------------------

_MERGER_MAP = {
    "ln_w": ("norm.weight", False), "ln_b": ("norm.bias", False),
    "fc1_w": ("linear_fc1.weight", True), "fc1_b": ("linear_fc1.bias", False),
    "fc2_w": ("linear_fc2.weight", True), "fc2_b": ("linear_fc2.bias", False),
}

_BLOCK_MAP = {
    "ln1_w": ("norm1.weight", False), "ln1_b": ("norm1.bias", False),
    "ln2_w": ("norm2.weight", False), "ln2_b": ("norm2.bias", False),
    "qkv_w": ("attn.qkv.weight", True), "qkv_b": ("attn.qkv.bias", False),
    "proj_w": ("attn.proj.weight", True), "proj_b": ("attn.proj.bias", False),
    "fc1_w": ("mlp.linear_fc1.weight", True), "fc1_b": ("mlp.linear_fc1.bias", False),
    "fc2_w": ("mlp.linear_fc2.weight", True), "fc2_b": ("mlp.linear_fc2.bias", False),
}


def _vision_from_hf(state: dict, vspec: VisionSpec, dtype=torch.float32,
                    device: torch.device | str = "cpu") -> Params:
    def get(key, tr):
        t = torch.as_tensor(state[key]).to(device=device, dtype=dtype)
        return t.T.contiguous() if tr else t

    blocks = {f: torch.stack([get(f"model.visual.blocks.{i}.{suf}", tr)
                              for i in range(vspec.depth)])
              for f, (suf, tr) in _BLOCK_MAP.items()}
    merger = {f: get(f"model.visual.merger.{suf}", tr) for f, (suf, tr) in _MERGER_MAP.items()}
    n_ds = len(vspec.deepstack_visual_indexes)
    ds = {f: torch.stack([get(f"model.visual.deepstack_merger_list.{k}.{suf}", tr)
                          for k in range(n_ds)])
          for f, (suf, tr) in _MERGER_MAP.items()} if n_ds else {}
    # Conv3d [D, C, T, p, p] with kernel == stride == patch dims is a product
    # on the (C, T, p, p)-flattened patch vector
    patch_w = get("model.visual.patch_embed.proj.weight", False)
    return {
        "patch_w": patch_w.reshape(vspec.hidden_size, -1).T.contiguous(),
        "patch_b": get("model.visual.patch_embed.proj.bias", False),
        "pos_embed": get("model.visual.pos_embed.weight", False),
        "blocks": blocks, "merger": merger, "ds_mergers": ds,
    }


def _host(t) -> np.ndarray:
    return t.detach().float().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _vision_to_hf(vparams: Params, vspec: VisionSpec) -> dict[str, np.ndarray]:
    state: dict[str, np.ndarray] = {}
    pw = _host(vparams["patch_w"]).T  # [D, patch_dim]
    state["model.visual.patch_embed.proj.weight"] = pw.reshape(
        vspec.hidden_size, vspec.in_channels, vspec.temporal_patch_size,
        vspec.patch_size, vspec.patch_size).copy()
    state["model.visual.patch_embed.proj.bias"] = _host(vparams["patch_b"])
    state["model.visual.pos_embed.weight"] = _host(vparams["pos_embed"])
    for f, (suf, tr) in _BLOCK_MAP.items():
        stacked = _host(vparams["blocks"][f])
        for i in range(vspec.depth):
            state[f"model.visual.blocks.{i}.{suf}"] = stacked[i].T.copy() if tr else stacked[i]
    for f, (suf, tr) in _MERGER_MAP.items():
        arr = _host(vparams["merger"][f])
        state[f"model.visual.merger.{suf}"] = arr.T.copy() if tr else arr
        if vparams["ds_mergers"]:
            ds = _host(vparams["ds_mergers"][f])
            for k in range(len(vspec.deepstack_visual_indexes)):
                state[f"model.visual.deepstack_merger_list.{k}.{suf}"] = (
                    ds[k].T.copy() if tr else ds[k])
    return state


def _retarget_text_keys(state: dict) -> dict:
    """The VLM state dict's text keys moved from model.language_model.* to
    model.*, so that the text family's converters apply."""
    out = {}
    for k, v in state.items():
        if k.startswith("model.language_model."):
            out["model." + k[len("model.language_model."):]] = v
        elif not k.startswith("model.visual."):
            out[k] = v
    return out


def params_from_hf_state_dict(state: dict, spec: ModelSpec, dtype=torch.float32,
                              device: torch.device | str = "cpu") -> Params:
    params = _trunk(spec).params_from_hf_state_dict(_retarget_text_keys(state), text_spec(spec),
                                                    dtype=dtype, device=device)
    params["vision"] = _vision_from_hf(state, spec.vision, dtype, device)
    return params


def params_to_hf_state_dict(params: Params, spec: ModelSpec) -> dict[str, np.ndarray]:
    text = {k: v for k, v in params.items() if k != "vision"}
    out = {}
    for k, v in _trunk(spec).params_to_hf_state_dict(text, text_spec(spec)).items():
        out["model.language_model." + k[len("model."):] if k.startswith("model.") else k] = v
    out.update(_vision_to_hf(params["vision"], spec.vision))
    return out

"""MiniMax-M2 / AFMoE / Laguna: gated-attention MoE transformers (the port of
the JAX package's ``models/gated_moe.py``, trained and served).

All three run glm4_moe's init and forward (sigmoid-scored routing with a
selection-only correction bias, optional shared experts, dense first
layers), which read their spec axes:

- ``minimax_m2``: a q/k RMSNorm over the full flat width of each layer
  (``qk_norm_scope="layer"``), partial rotary, every layer MoE;
- ``afmoe``: sliding windows with a full layer every n, a sigmoid
  attention-output gate, sandwich norms, shared experts, dense first layers,
  and a router without a correction bias;
- ``laguna``: a per-head softplus attention-output gate, a rope base of its
  own on the sliding layers, a shared expert of absolute size, dense first
  layers.

This module owns the per-family HF key layouts (``HF_KEYS``), which
glm4_moe's converter reads, and registers nothing itself:
``models/__init__.py`` maps the three families here.
"""

from __future__ import annotations

import torch

from prime_rl_tpu_torch.models import glm4_moe
from prime_rl_tpu_torch.models.base import ModelSpec
from prime_rl_tpu_torch.models.glm4_moe import HFKeys

Params = dict
FAMILIES = ("minimax_m2", "afmoe", "laguna")


def init_params(spec: ModelSpec, generator: torch.Generator, dtype=torch.float32,
                device: torch.device | str = "cpu") -> Params:
    """``glm4_moe.init_params``; AFMoE's router has no correction-bias tensor
    in its checkpoints, so its selection stays unbiased and the zero bias is
    dropped."""
    params = glm4_moe.init_params(spec, generator, dtype=dtype, device=device)
    if spec.family == "afmoe":
        params["layers"].pop("router_correction_bias", None)
    return params


forward = glm4_moe.forward
get_lm_head = glm4_moe.get_lm_head


HF_KEYS = {
    # block_sparse_moe.{gate, experts.{e}.w1/w2/w3}: w1 gate [m, d], w2 down
    # [d, m], w3 up [m, d], all torch Linears (transposed)
    "minimax_m2": HFKeys(
        router="block_sparse_moe.gate.weight",
        bias="block_sparse_moe.e_score_correction_bias",
        experts="block_sparse_moe.experts",
        expert_projs=("w1.weight", "w3.weight", "w2.weight"),
        shared=None,
        mlp_norm="post_attention_layernorm.weight",
    ),
    # mlp.{router.gate, experts.{e}.*_proj, shared_experts.*}; sandwich norms
    # pre_mlp / post_mlp_layernorm
    "afmoe": HFKeys(
        router="mlp.router.gate.weight",
        bias=None,
        experts="mlp.experts",
        expert_projs=("gate_proj.weight", "up_proj.weight", "down_proj.weight"),
        shared="mlp.shared_experts",
        mlp_norm="pre_mlp_layernorm.weight",
        attn_gate="self_attn.gate_proj.weight",
        post_attn_norm="post_attention_layernorm.weight",
        post_mlp_norm="post_mlp_layernorm.weight",
    ),
    # mlp.gate.weight router, mlp.experts.e_score_correction_bias, a single
    # mlp.shared_expert.*
    "laguna": HFKeys(
        router="mlp.gate.weight",
        bias="mlp.experts.e_score_correction_bias",
        experts="mlp.experts",
        expert_projs=("gate_proj.weight", "up_proj.weight", "down_proj.weight"),
        shared="mlp.shared_expert",
        mlp_norm="post_attention_layernorm.weight",
        attn_gate="self_attn.g_proj.weight",
    ),
}


def params_from_hf_state_dict(state: dict, spec: ModelSpec, dtype=torch.float32,
                              device: torch.device | str = "cpu") -> Params:
    return glm4_moe.params_from_hf_state_dict(state, spec, dtype=dtype, device=device,
                                              keys=HF_KEYS[spec.family])


def params_to_hf_state_dict(params: Params, spec: ModelSpec) -> dict:
    return glm4_moe.params_to_hf_state_dict(params, spec, keys=HF_KEYS[spec.family])

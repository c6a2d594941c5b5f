"""Qwen3-MoE family (Qwen3-30B-A3B class): Qwen3 attention blocks over a
token-choice top-k sparse MLP (the port of the JAX package's
``models/qwen3_moe.py``, trained and served).

Attention reuses ``qwen3._attn_block``: on the card it runs K1 (forward) and
K2a/K2b (backward). The experts ride the sorted grouped MoE op
(``ops/moe.py``): softmax over all experts, then the top k, renormalized
with ``norm_topk_prob``.

Params, in the JAX package's stacked layout: ``{"embed": [V, D], "layers":
{name: [NL, ...]}, "final_norm": [D], "lm_head": [D, V]}``; the layers hold
the dense attention leaves of ``qwen3.init_params``, ``router`` [NL, D, E]
and ``expert_{gate,up}`` [NL, E, D, M], ``expert_down`` [NL, E, M, D]. LoRA
and context parallelism raise.
"""

from __future__ import annotations

import numpy as np
import torch

from prime_rl_tpu_torch.models import qwen3
from prime_rl_tpu_torch.models.base import ModelSpec
from prime_rl_tpu_torch.models.lora import layer_slices
from prime_rl_tpu_torch.models.qwen3 import (
    layer_remat,
    parse_remat,
    rope_setup,
    run_layer,
    spec_dense_view,
    trunc_normal,
)
from prime_rl_tpu_torch.ops.layers import rms_norm
from prime_rl_tpu_torch.ops.moe import moe_mlp

Params = dict
FAMILY = "qwen3_moe"
# the ac.modes the JAX function names (prime_rl_tpu/models/qwen3_moe.py:102-107) and the mode
# each runs as; any other keeps every activation (``qwen3.parse_remat``)
REMAT = {"full": "full", "selective": "selective"}
_MOE_FIELDS = ("router", "expert_gate", "expert_up", "expert_down")
_EXPERT_KEYS = (("expert_gate", "gate_proj"), ("expert_up", "up_proj"),
                ("expert_down", "down_proj"))


def init_params(spec: ModelSpec, generator: torch.Generator, dtype=torch.float32,
                device: torch.device | str = "cpu") -> Params:
    """Random init on ``device`` from ``generator`` (which must live there):
    the dense attention and embeddings of ``qwen3.init_params``, then the
    router and the experts, std 0.02 cut at 2 sigma. Stacks are drawn a layer
    at a time straight into ``dtype`` (``qwen3.trunc_normal``), so
    Qwen3-30B-A3B in bf16 peaks near its own 61 GB (one float32 stack of
    ``expert_gate`` would be 38.7 GB). The numbers differ from the JAX
    package's ``jax.random`` init."""
    if spec.family != FAMILY:
        raise ValueError(f"qwen3_moe.init_params: family {spec.family!r} is not qwen3_moe")
    params = qwen3.init_params(spec_dense_view(spec), generator, dtype=dtype, device=device)
    nl, d = spec.num_layers, spec.hidden_size
    e, m = spec.num_experts, spec.moe_intermediate_size
    layers = params["layers"]
    for f in ("gate", "up", "down"):
        layers.pop(f, None)

    def w(*shape):
        return trunc_normal(shape, generator, dtype, device)

    layers["router"] = w(nl, d, e)
    layers["expert_gate"] = w(nl, e, d, m)
    layers["expert_up"] = w(nl, e, d, m)
    layers["expert_down"] = w(nl, e, m, d)
    return params


def moe_block(h: torch.Tensor, lp: dict, spec: ModelSpec, compute_dtype,
              forced: torch.Tensor | None = None, lora: dict | None = None,
              lora_scale: float = 1.0):
    """Post-attention routed experts with residual. Returns (h, load-balance
    aux). The expert matrices are cast to ``compute_dtype``; the router stays
    as stored (its math runs in f32). ``forced`` ([B*L, K] int, -1 = own
    routing) replays the sampler's expert selection; ``lora``: the layer's
    adapter slices, whose ``moe_*`` targets apply per expert."""
    b, l, d = h.shape
    x = rms_norm(h, lp["mlp_norm"], spec.rms_eps)
    out, routing = moe_mlp(
        x.reshape(b * l, d),
        lp["router"],
        *(lp[k].to(compute_dtype) for k in ("expert_gate", "expert_up", "expert_down")),
        spec.num_experts_per_tok, spec.norm_topk_prob,
        forced_experts=forced, lora=lora, lora_scale=lora_scale,
    )
    return h + out.reshape(b, l, d), routing.load_balance_loss


def forced_by_layer(routed_experts: torch.Tensor | None, n_layers: int,
                    top_k: int) -> torch.Tensor | None:
    """Router replay [B, L, NL, K] -> layer-major [NL, B*L, K] (None stays None)."""
    if routed_experts is None:
        return None
    if routed_experts.shape[2] != n_layers:
        raise ValueError(f"routed_experts holds {routed_experts.shape[2]} MoE layers, the "
                         f"model has {n_layers}")
    b, l = routed_experts.shape[:2]
    return routed_experts.permute(2, 0, 1, 3).reshape(n_layers, b * l, top_k)


def check_forward_args(spec: ModelSpec, mesh, lora, quantized_compute) -> None:
    """Raise for what the MoE families' forwards do not take yet (LoRA they
    take, ``lora`` is checked by nothing here)."""
    if mesh is not None:
        raise NotImplementedError("context parallelism waits for the multi-card slice "
                                  "(ROADMAP.md, Queue 1 item 11)")
    if quantized_compute:
        raise ValueError(f"quantized_compute={quantized_compute!r} is only wired for the "
                         f"qwen3/llama dense families, not {spec.family!r}")


def forward(
    params: Params,
    spec: ModelSpec,
    input_ids: torch.Tensor,  # [B, L] int
    segment_ids: torch.Tensor,  # [B, L] int (0 = pad)
    position_ids: torch.Tensor,  # [B, L] int
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
    routed_experts: torch.Tensor | None = None,  # [B, L, NL, K]; -1 = own routing
    quantized_compute: str | None = None,
):
    """Token ids -> final hidden states [B, L, D] (pre-LM-head, normed), or
    (hidden, load-balance aux summed over the layers) with ``collect_aux``.
    ``routed_experts`` replays the sampler's expert selection layer by layer;
    rows of -1 keep the trainer's own routing. ``remat``: the modes the JAX
    function names (``REMAT``: ``full``, ``selective``, as in
    ``qwen3.forward``); any other mode (``save_attn`` among them) and any
    ``mode/K`` keeps every activation, as there. ``block_q``/``block_kv``
    are accepted and unused."""
    if spec.family != FAMILY:
        raise ValueError(f"qwen3_moe.forward: family {spec.family!r} is not qwen3_moe")
    check_forward_args(spec, mesh, lora, quantized_compute)
    if spec.sandwich_norm or spec.attn_gate:
        raise NotImplementedError("qwen3_moe has no sandwich norms or attention gates (the "
                                  "gated-MoE families run glm4_moe's block)")
    nl = spec.num_layers
    base_remat, save_stride = parse_remat(remat, nl, REMAT)
    inv_freq, rope_scaling = rope_setup(spec, device=input_ids.device)
    h = params["embed"].to(compute_dtype)[input_ids]

    def block(h, lp, saved, window, forced, ll):
        attn = {k: (v.to(compute_dtype) if v.dim() >= 2 else v)
                for k, v in lp.items() if k not in _MOE_FIELDS}
        h = qwen3._attn_block(h, attn, spec, segment_ids, position_ids, inv_freq, attn_impl,
                              rope_scaling, saved, window, ll, lora_scale)
        return moe_block(h, lp, spec, compute_dtype, forced, ll, lora_scale)

    forced = forced_by_layer(routed_experts, nl, spec.num_experts_per_tok)
    # unbind once: its backward stacks the per-layer gradients in one copy
    per_layer = {k: v.unbind(0) for k, v in params["layers"].items()}
    lora_layers = layer_slices(lora, nl)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(nl):
        lp = {k: v[i] for k, v in per_layer.items()}
        h, lb = run_layer(block, h, lp, 0, layer_remat(base_remat, save_stride, i),
                          None if forced is None else forced[i], lora_layers[i])
        aux = aux + lb
    h = rms_norm(h, params["final_norm"], spec.rms_eps)
    return (h, aux) if collect_aux else h


get_lm_head = qwen3.get_lm_head


# ---------------------------------------------------------------------------
# HF interchange (HF ``Qwen3MoeForCausalLM``): the qwen3 attention keys, the
# router ``mlp.gate.weight`` [E, D] and per-expert Linears ``mlp.experts.{j}.*``
# ([out, in]: transposed).
# ---------------------------------------------------------------------------

def _attn_key_map(spec: ModelSpec) -> dict[str, tuple[str, bool]]:
    m = qwen3.hf_key_map(spec)
    for f in ("gate", "up", "down"):
        m.pop(f)
    return m


def params_from_hf_state_dict(state: dict, spec: ModelSpec, dtype=torch.float32,
                              device: torch.device | str = "cpu") -> Params:
    """Stacked params from a flat HF state dict (torch tensors or numpy
    arrays), on ``device`` in ``dtype``."""

    def get(key: str, transpose: bool) -> torch.Tensor:
        t = torch.as_tensor(state[key]).to(device=device, dtype=dtype)
        return t.T.contiguous() if transpose else t

    nl, e = spec.num_layers, spec.num_experts
    layers = {field: torch.stack([get(f"model.layers.{i}.{suffix}", tr) for i in range(nl)])
              for field, (suffix, tr) in _attn_key_map(spec).items()}
    layers["router"] = torch.stack([get(f"model.layers.{i}.mlp.gate.weight", True)
                                    for i in range(nl)])
    for ours, theirs in _EXPERT_KEYS:
        layers[ours] = torch.stack([
            torch.stack([get(f"model.layers.{i}.mlp.experts.{j}.{theirs}.weight", True)
                         for j in range(e)])
            for i in range(nl)])
    params: Params = {
        "embed": get("model.embed_tokens.weight", False),
        "layers": layers,
        "final_norm": get("model.norm.weight", False),
    }
    if not spec.tie_embeddings:
        params["lm_head"] = get("lm_head.weight", True)
    return params


def params_to_hf_state_dict(params: Params, spec: ModelSpec) -> dict[str, np.ndarray]:
    """Flat HF state dict (numpy f32), converted a layer at a time so that a
    stack's float32 copy never sits whole on the device."""

    def host(t: torch.Tensor) -> np.ndarray:
        return t.detach().float().cpu().numpy()

    state: dict[str, np.ndarray] = {
        "model.embed_tokens.weight": host(params["embed"]),
        "model.norm.weight": host(params["final_norm"]),
    }
    layers = params["layers"]
    for i in range(spec.num_layers):
        pre = f"model.layers.{i}."
        for field, (suffix, tr) in _attn_key_map(spec).items():
            arr = host(layers[field][i])
            state[pre + suffix] = arr.T.copy() if tr else arr
        state[pre + "mlp.gate.weight"] = host(layers["router"][i]).T.copy()
        for ours, theirs in _EXPERT_KEYS:
            stacked = host(layers[ours][i])
            for j in range(spec.num_experts):
                state[f"{pre}mlp.experts.{j}.{theirs}.weight"] = stacked[j].T.copy()
    if not spec.tie_embeddings:
        state["lm_head.weight"] = host(params["lm_head"]).T.copy()
    return state


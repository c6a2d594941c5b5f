"""GLM-4.5 MoE family (glm4_moe; the port of the JAX package's
``models/glm4_moe.py``, trained and served): GQA attention with partial
rotary and optional qk-norm, DeepSeek-V3-style noaux-tc routing (sigmoid
scores, a selection-only correction bias, group-limited top-k, routed
scaling), always-on shared experts, and dense MLPs for the first
``first_k_dense_replace`` layers. ``glm_moe_block`` and the HF conversion
also serve the MLA families (``models/mla_moe.py`` calls them with its own
attention key table).

Attention reuses ``qwen3._attn_block`` (the half-split rope over the first
``head_dim * partial_rotary_factor`` dims): on the card K1 forward and
K2a/K2b backward, at any GQA group (GLM-4.5: 96/8 heads).

Layout: the first ``first_k_dense_replace`` layers live under
``dense_layers`` (stacked ``[k, ...]``), the MoE layers under ``layers``
(stacked ``[NL - k, ...]``), routed experts as ``expert_{gate,up,down}``
``[n, E, in, out]``. Sandwich norms (the gated-MoE families) raise.
"""

from __future__ import annotations

import torch

from prime_rl_tpu_torch.models import qwen3
from prime_rl_tpu_torch.models.base import ModelSpec
from prime_rl_tpu_torch.models.qwen3 import (
    layer_remat,
    layer_windows_list,
    parse_remat,
    rope_setup,
    run_layer,
    spec_dense_view,
    trunc_normal,
)
from prime_rl_tpu_torch.models.qwen3_moe import check_forward_args, forced_by_layer
from prime_rl_tpu_torch.ops.layers import rms_norm, swiglu
from prime_rl_tpu_torch.ops.moe import moe_mlp

Params = dict
FAMILY = "glm4_moe"
_MOE_FIELDS = ("router", "router_correction_bias", "expert_gate", "expert_up", "expert_down",
               "shared_gate", "shared_up", "shared_down")


def init_params(spec: ModelSpec, generator: torch.Generator, dtype=torch.float32,
                device: torch.device | str = "cpu") -> Params:
    """Random init on ``device`` from ``generator`` (which must live there):
    the attention and embeddings of ``qwen3.init_params``, split into the
    dense-first and the MoE stacks, then the router (correction bias zero),
    the routed and the shared experts, std 0.02 cut at 2 sigma, drawn a layer
    at a time straight into ``dtype``. The numbers differ from the JAX
    package's ``jax.random`` init."""
    if spec.family != FAMILY:
        raise ValueError(f"glm4_moe.init_params: family {spec.family!r} is not glm4_moe")
    params = qwen3.init_params(spec_dense_view(spec), generator, dtype=dtype, device=device)
    k_dense = spec.first_k_dense_replace
    n_moe = spec.num_layers - k_dense
    # copies, not views: the two stacks are separate parameters
    all_layers = params["layers"]
    dense_layers = {k: v[:k_dense].clone() for k, v in all_layers.items()}
    moe_layers = {k: v[k_dense:].clone() for k, v in all_layers.items()
                  if k not in ("gate", "up", "down")}
    del all_layers, params["layers"]
    d, e, m = spec.hidden_size, spec.num_experts, spec.moe_intermediate_size

    def w(*shape):
        return trunc_normal(shape, generator, dtype, device)

    moe_layers["router"] = w(n_moe, d, e)
    moe_layers["router_correction_bias"] = torch.zeros((n_moe, e), dtype=torch.float32,
                                                       device=device)
    moe_layers["expert_gate"] = w(n_moe, e, d, m)
    moe_layers["expert_up"] = w(n_moe, e, d, m)
    moe_layers["expert_down"] = w(n_moe, e, m, d)
    ms = spec.shared_expert_size or m * spec.n_shared_experts
    if ms:
        moe_layers["shared_gate"] = w(n_moe, d, ms)
        moe_layers["shared_up"] = w(n_moe, d, ms)
        moe_layers["shared_down"] = w(n_moe, ms, d)
    params["layers"] = moe_layers
    if k_dense:
        params["dense_layers"] = dense_layers
    return params


def glm_moe_block(h: torch.Tensor, lp: dict, spec: ModelSpec, compute_dtype,
                  forced_experts: torch.Tensor | None = None):
    """Routed experts + shared experts, post-attention. Returns (h, aux).
    ``lp`` holds one layer's weights as stored; matrices other than the
    router are cast to ``compute_dtype`` here, the router math stays f32.
    ``forced_experts`` ([B*L, K] int, -1 = own routing) replays the sampler's
    expert selection (router replay)."""
    if spec.sandwich_norm:
        raise NotImplementedError("sandwich norms come with the gated-MoE slice (ROADMAP.md, "
                                  "Queue 1 item 5)")
    b, l, d = h.shape
    cast = {k: (v.to(compute_dtype) if v.dim() >= 2 and "router" not in k else v)
            for k, v in lp.items()}
    x = rms_norm(h, cast["mlp_norm"], spec.rms_eps)
    out, routing = moe_mlp(
        x.reshape(b * l, d),
        lp["router"],
        cast["expert_gate"], cast["expert_up"], cast["expert_down"],
        spec.num_experts_per_tok, spec.norm_topk_prob,
        sigmoid_noaux=spec.router_sigmoid,
        correction_bias=lp.get("router_correction_bias"),
        n_group=spec.n_group, topk_group=spec.topk_group,
        routed_scaling=spec.routed_scaling_factor,
        forced_experts=forced_experts,
    )
    out = out.reshape(b, l, d)
    if "shared_gate" in cast:
        out = out + torch.matmul(
            swiglu(torch.matmul(x, cast["shared_gate"]), torch.matmul(x, cast["shared_up"])),
            cast["shared_down"])
    return h + out, routing.load_balance_loss


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
    routed_experts: torch.Tensor | None = None,  # [B, L, NL_moe, K]; -1 = own routing
    quantized_compute: str | None = None,
):
    """Token ids -> final hidden states [B, L, D] (pre-LM-head, normed), or
    (hidden, load-balance aux summed over the MoE layers) with
    ``collect_aux``. The first ``first_k_dense_replace`` layers run a dense
    SwiGLU; ``routed_experts`` covers the MoE layers only and replays the
    sampler's selection there (rows of -1 keep the trainer's own routing).
    ``remat`` as in ``qwen3.forward``; ``block_q``/``block_kv`` are accepted
    and unused."""
    if spec.family != FAMILY:
        raise ValueError(f"glm4_moe.forward: family {spec.family!r} is not glm4_moe")
    check_forward_args(spec, mesh, lora, quantized_compute)
    if spec.rope_theta_local:
        raise NotImplementedError("a local rope base comes with the gated-MoE slice "
                                  "(ROADMAP.md, Queue 1 item 5)")
    nl, k_dense = spec.num_layers, spec.first_k_dense_replace
    base_remat, save_stride = parse_remat(remat, nl)
    inv_freq, rope_scaling = rope_setup(spec, device=input_ids.device)
    h = params["embed"].to(compute_dtype)[input_ids]
    windows = layer_windows_list(spec)

    def attn(h, lp, saved, window):
        cast = {k: (v.to(compute_dtype) if v.dim() >= 2 else v)
                for k, v in lp.items() if k not in _MOE_FIELDS}
        return qwen3._attn_block(h, cast, spec, segment_ids, position_ids, inv_freq, attn_impl,
                                 rope_scaling, saved, window), cast

    def dense_block(h, lp, saved, window):
        h, cast = attn(h, lp, saved, window)
        x = rms_norm(h, cast["mlp_norm"], spec.rms_eps)
        return h + torch.matmul(
            swiglu(torch.matmul(x, cast["gate"]), torch.matmul(x, cast["up"])), cast["down"])

    def moe_block(h, lp, saved, window, forced):
        h, _ = attn(h, lp, saved, window)
        moe = {k: v for k, v in lp.items() if k in _MOE_FIELDS or k == "mlp_norm"}
        return glm_moe_block(h, moe, spec, compute_dtype, forced_experts=forced)

    for i in range(k_dense):
        lp = {k: v[i] for k, v in params["dense_layers"].items()}
        h = run_layer(dense_block, h, lp, windows[i], layer_remat(base_remat, save_stride, i))
    forced = forced_by_layer(routed_experts, nl - k_dense, spec.num_experts_per_tok)
    # unbind once: its backward stacks the per-layer gradients in one copy
    per_layer = {k: v.unbind(0) for k, v in params["layers"].items()}
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for li in range(nl - k_dense):
        i = k_dense + li
        lp = {k: v[li] for k, v in per_layer.items()}
        h, lb = run_layer(moe_block, h, lp, windows[i], layer_remat(base_remat, save_stride, i),
                          None if forced is None else forced[li])
        aux = aux + lb
    h = rms_norm(h, params["final_norm"], spec.rms_eps)
    return (h, aux) if collect_aux else h


get_lm_head = qwen3.get_lm_head


# ---------------------------------------------------------------------------
# HF interchange. Per-expert torch Linears ([out, in] -> transpose), router
# weight [E, D] -> [D, E], e_score_correction_bias buffer, shared_experts.* MLP.
# ---------------------------------------------------------------------------

_MLP = (("gate", "gate_proj"), ("up", "up_proj"), ("down", "down_proj"))


def _attn_keys(spec: ModelSpec):
    keys = [
        ("attn_norm", "input_layernorm.weight", False),
        ("q", "self_attn.q_proj.weight", True),
        ("k", "self_attn.k_proj.weight", True),
        ("v", "self_attn.v_proj.weight", True),
        ("o", "self_attn.o_proj.weight", True),
        ("mlp_norm", "post_attention_layernorm.weight", False),
    ]
    if spec.qk_norm:
        keys += [("q_norm", "self_attn.q_norm.weight", False),
                 ("k_norm", "self_attn.k_norm.weight", False)]
    if spec.attn_bias:
        keys += [("q_bias", "self_attn.q_proj.bias", False),
                 ("k_bias", "self_attn.k_proj.bias", False),
                 ("v_bias", "self_attn.v_proj.bias", False)]
    return keys


def params_from_hf_state_dict(state: dict, spec: ModelSpec, dtype=torch.float32,
                              device: torch.device | str = "cpu", attn_keys=None) -> Params:
    """Stacked params from a flat HF state dict (torch tensors or numpy
    arrays), placed on ``device`` in ``dtype`` (the selection-only
    ``router_correction_bias`` stays float32). ``attn_keys`` lets the
    MLA-attention families reuse this converter's shared trunk
    (embed/norm/MoE/dense-MLP) with their own attention key table."""

    def get(key, tr, dt=dtype):
        t = torch.as_tensor(state[key]).to(device=device, dtype=dt)
        return t.T.contiguous() if tr else t

    k_dense = spec.first_k_dense_replace
    nl, e = spec.num_layers, spec.num_experts
    akeys = attn_keys or _attn_keys(spec)

    def layer_attn(i):
        return {f: get(f"model.layers.{i}.{suf}", tr) for f, suf, tr in akeys}

    def stack(layers: list[dict]) -> dict:
        return {k: torch.stack([lp[k] for lp in layers]) for k in layers[0]}

    dense_layers = []
    for i in range(k_dense):
        lp = layer_attn(i)
        for ours, theirs in _MLP:
            lp[ours] = get(f"model.layers.{i}.mlp.{theirs}.weight", True)
        dense_layers.append(lp)

    moe_layers = []
    for i in range(k_dense, nl):
        lp = layer_attn(i)
        lp["router"] = get(f"model.layers.{i}.mlp.gate.weight", True)
        lp["router_correction_bias"] = get(
            f"model.layers.{i}.mlp.gate.e_score_correction_bias", False, torch.float32)
        for ours, theirs in _MLP:
            lp[f"expert_{ours}"] = torch.stack([
                get(f"model.layers.{i}.mlp.experts.{j}.{theirs}.weight", True)
                for j in range(e)])
        if spec.n_shared_experts:
            for ours, theirs in _MLP:
                lp[f"shared_{ours}"] = get(
                    f"model.layers.{i}.mlp.shared_experts.{theirs}.weight", True)
        moe_layers.append(lp)

    params: Params = {
        "embed": get("model.embed_tokens.weight", False),
        "layers": stack(moe_layers),
        "final_norm": get("model.norm.weight", False),
    }
    if k_dense:
        params["dense_layers"] = stack(dense_layers)
    if not spec.tie_embeddings:
        params["lm_head"] = get("lm_head.weight", True)
    return params


def params_to_hf_state_dict(params: Params, spec: ModelSpec, attn_keys=None) -> dict:
    """Flat HF state dict from the stacked params: tensors on the params'
    device in their dtype (transposed views where HF stores [out, in]), so a
    multi-gigabyte snapshot is not widened to float32 on the host."""
    state: dict[str, torch.Tensor] = {
        "model.embed_tokens.weight": params["embed"].detach(),
        "model.norm.weight": params["final_norm"].detach(),
    }
    k_dense = spec.first_k_dense_replace
    akeys = attn_keys or _attn_keys(spec)

    def put_attn(i, lp):
        for f, suf, tr in akeys:
            state[f"model.layers.{i}.{suf}"] = lp[f].T if tr else lp[f]

    for i in range(k_dense):
        lp = {k: v[i].detach() for k, v in params["dense_layers"].items()}
        put_attn(i, lp)
        for ours, theirs in _MLP:
            state[f"model.layers.{i}.mlp.{theirs}.weight"] = lp[ours].T
    for li in range(spec.num_layers - k_dense):
        i = k_dense + li
        lp = {k: v[li].detach() for k, v in params["layers"].items()}
        put_attn(i, lp)
        state[f"model.layers.{i}.mlp.gate.weight"] = lp["router"].T
        state[f"model.layers.{i}.mlp.gate.e_score_correction_bias"] = lp["router_correction_bias"]
        for ours, theirs in _MLP:
            stacked = lp[f"expert_{ours}"]
            for j in range(spec.num_experts):
                state[f"model.layers.{i}.mlp.experts.{j}.{theirs}.weight"] = stacked[j].T
        if spec.n_shared_experts:
            for ours, theirs in _MLP:
                state[f"model.layers.{i}.mlp.shared_experts.{theirs}.weight"] = (
                    lp[f"shared_{ours}"].T)
    if not spec.tie_embeddings:
        state["lm_head.weight"] = params["lm_head"].detach().T
    return state

"""GLM-4.5 MoE block and HF interchange (the part of the JAX package's
``models/glm4_moe.py`` that the MLA families borrow): ``glm_moe_block``
(noaux-tc routed experts + always-on shared experts, after the attention) and
the HF state-dict conversion, which ``models/mla_moe.py`` calls with its own
attention key table.

The ``glm4_moe`` family's own ``forward`` and ``init_params`` (GQA attention
with partial rotary over this MoE stack) are not ported yet: they wait for
the MoE-families slice, and the family is not registered.

Layout: the first ``first_k_dense_replace`` layers live under
``dense_layers`` (stacked ``[k, ...]``), the MoE layers under ``layers``
(stacked ``[NL - k, ...]``), routed experts as ``expert_{gate,up,down}``
``[n, E, in, out]``.
"""

from __future__ import annotations

import torch

from prime_rl_tpu_torch.models.base import ModelSpec
from prime_rl_tpu_torch.ops.layers import rms_norm, swiglu
from prime_rl_tpu_torch.ops.moe import moe_mlp

Params = dict


def glm_moe_block(h: torch.Tensor, lp: dict, spec: ModelSpec, compute_dtype,
                  forced_experts: torch.Tensor | None = None):
    """Routed experts + shared experts, post-attention. Returns (h, aux).
    ``lp`` holds one layer's weights as stored; matrices other than the
    router are cast to ``compute_dtype`` here, the router math stays f32.
    ``forced_experts`` ([B*L, K] int, -1 = own routing) replays the sampler's
    expert selection (router replay)."""
    if spec.sandwich_norm:
        raise NotImplementedError("sandwich norms come with the gated-MoE slice")
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

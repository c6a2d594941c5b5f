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
``[n, E, in, out]``.

The gated-MoE families (``minimax_m2``, ``afmoe``, ``laguna``;
``models/gated_moe.py``) run this init and forward, which read their spec
axes: the layer-scope qk-norm and the attention-output gates (in
``qwen3._attn_block``), the sandwich norms, a shared expert of absolute
size (``shared_expert_size``) and a local rope base on windowed layers
(``rope_theta_local``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from prime_rl_tpu_torch.models import qwen3
from prime_rl_tpu_torch.models.base import ModelSpec
from prime_rl_tpu_torch.models.lora import layer_slices
from prime_rl_tpu_torch.models.qwen3 import (
    layer_remat,
    layer_rope_frequencies,
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
# glm4_moe and the gated-MoE families, which share its block
FAMILIES = ("glm4_moe", "minimax_m2", "afmoe", "laguna")
# the ac.modes the JAX function names (prime_rl_tpu/models/glm4_moe.py:168-179) and the mode
# each runs as; any other keeps every activation (``qwen3.parse_remat``)
REMAT = {"full": "full", "save_attn": "save_attn", "selective": "selective"}
_MOE_FIELDS = ("router", "router_correction_bias", "expert_gate", "expert_up", "expert_down",
               "shared_gate", "shared_up", "shared_down", "post_mlp_norm")


def init_params(spec: ModelSpec, generator: torch.Generator, dtype=torch.float32,
                device: torch.device | str = "cpu") -> Params:
    """Random init on ``device`` from ``generator`` (which must live there):
    the attention and embeddings of ``qwen3.init_params``, split into the
    dense-first and the MoE stacks, then the router (correction bias zero),
    the routed and the shared experts, std 0.02 cut at 2 sigma, drawn a layer
    at a time straight into ``dtype``. The numbers differ from the JAX
    package's ``jax.random`` init."""
    if spec.family not in FAMILIES:
        raise ValueError(f"glm4_moe.init_params: family {spec.family!r} is not one of "
                         f"{', '.join(FAMILIES)}")
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
                  forced_experts: torch.Tensor | None = None, lora: dict | None = None,
                  lora_scale: float = 1.0):
    """Routed experts + shared experts, post-attention. Returns (h, aux).
    ``lp`` holds one layer's weights as stored; matrices other than the
    router are cast to ``compute_dtype`` here, the router math stays f32.
    ``forced_experts`` ([B*L, K] int, -1 = own routing) replays the sampler's
    expert selection (router replay); ``lora``: the layer's adapter slices,
    whose ``moe_*`` targets apply per expert. Under sandwich norms the
    output is normed (``post_mlp_norm``) before the residual add."""
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
        forced_experts=forced_experts, lora=lora, lora_scale=lora_scale,
    )
    out = out.reshape(b, l, d)
    if "shared_gate" in cast:
        out = out + torch.matmul(
            swiglu(torch.matmul(x, cast["shared_gate"]), torch.matmul(x, cast["shared_up"])),
            cast["shared_down"])
    return h + qwen3.post_mlp(out, cast, spec), routing.load_balance_loss


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
    ``remat``: the modes the JAX function names (``REMAT``: ``full``,
    ``save_attn``, ``selective``, as in ``qwen3.forward``); any other mode,
    and any ``mode/K``, keeps every activation, as there.
    ``block_q``/``block_kv`` are accepted
    and unused. Windowed layers take their own rope base where the spec has
    one (``rope_theta_local``, Laguna)."""
    if spec.family not in FAMILIES:
        raise ValueError(f"glm4_moe.forward: family {spec.family!r} is not one of "
                         f"{', '.join(FAMILIES)}")
    check_forward_args(spec, mesh, lora, quantized_compute)
    nl, k_dense = spec.num_layers, spec.first_k_dense_replace
    base_remat, save_stride = parse_remat(remat, nl, REMAT)
    inv_freq, rope_scaling = rope_setup(spec, device=input_ids.device)
    h = params["embed"].to(compute_dtype)[input_ids]
    windows = layer_windows_list(spec)

    def attn(h, lp, saved, window, ll):
        cast = {k: (v.to(compute_dtype) if v.dim() >= 2 else v)
                for k, v in lp.items() if k not in _MOE_FIELDS}
        return qwen3._attn_block(h, cast, spec, segment_ids, position_ids,
                                 layer_rope_frequencies(spec, inv_freq, window), attn_impl,
                                 rope_scaling, saved, window, ll, lora_scale), cast

    # LoRA: attention projections on every layer, the moe_* targets per
    # expert; the dense layers' MLP takes no adapter, as in the JAX package
    def dense_block(h, lp, saved, window, ll):
        h, cast = attn(h, lp, saved, window, ll)
        x = rms_norm(h, cast["mlp_norm"], spec.rms_eps)
        return h + qwen3.post_mlp(torch.matmul(
            swiglu(torch.matmul(x, cast["gate"]), torch.matmul(x, cast["up"])), cast["down"]),
            lp, spec)

    def moe_block(h, lp, saved, window, forced, ll):
        h, _ = attn(h, lp, saved, window, ll)
        moe = {k: v for k, v in lp.items() if k in _MOE_FIELDS or k == "mlp_norm"}
        return glm_moe_block(h, moe, spec, compute_dtype, forced_experts=forced, lora=ll,
                             lora_scale=lora_scale)

    lora_layers = layer_slices(lora, nl)
    for i in range(k_dense):
        lp = {k: v[i] for k, v in params["dense_layers"].items()}
        h = run_layer(dense_block, h, lp, windows[i], layer_remat(base_remat, save_stride, i),
                      lora_layers[i])
    forced = forced_by_layer(routed_experts, nl - k_dense, spec.num_experts_per_tok)
    # unbind once: its backward stacks the per-layer gradients in one copy
    per_layer = {k: v.unbind(0) for k, v in params["layers"].items()}
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for li in range(nl - k_dense):
        i = k_dense + li
        lp = {k: v[li] for k, v in per_layer.items()}
        h, lb = run_layer(moe_block, h, lp, windows[i], layer_remat(base_remat, save_stride, i),
                          None if forced is None else forced[li], lora_layers[i])
        aux = aux + lb
    h = rms_norm(h, params["final_norm"], spec.rms_eps)
    return (h, aux) if collect_aux else h


get_lm_head = qwen3.get_lm_head



# ---------------------------------------------------------------------------
# HF interchange. Per-expert torch Linears ([out, in] -> transpose), router
# weight [E, D] -> [D, E], a selection-only correction-bias buffer, shared
# expert MLPs. One converter for every family over this MoE stack: the key
# names of the MoE half, the pre-MLP norm, the gate and the sandwich norms
# come from an ``HFKeys`` table (``GLM4_KEYS`` here, the gated families' in
# ``models/gated_moe.py``); the MLA families pass their own attention keys.
# ---------------------------------------------------------------------------

_MLP = (("gate", "gate_proj"), ("up", "up_proj"), ("down", "down_proj"))


@dataclass(frozen=True)
class HFKeys:
    """One family's HF key layout of the MoE half and the block's extras."""
    router: str                    # router weight, stored [E, D] (transposed)
    bias: str | None               # e_score_correction_bias, [E]
    experts: str                   # per-expert prefix
    expert_projs: tuple            # (gate, up, down) suffixes under experts.{e}.
    shared: str | None             # shared-expert prefix
    mlp_norm: str                  # the pre-MLP norm's HF name
    attn_gate: str | None = None
    post_attn_norm: str | None = None
    post_mlp_norm: str | None = None


GLM4_KEYS = HFKeys(
    router="mlp.gate.weight",
    bias="mlp.gate.e_score_correction_bias",
    experts="mlp.experts",
    expert_projs=("gate_proj.weight", "up_proj.weight", "down_proj.weight"),
    shared="mlp.shared_experts",
    mlp_norm="post_attention_layernorm.weight",
)


def _attn_keys(spec: ModelSpec, t: HFKeys):
    keys = [
        ("attn_norm", "input_layernorm.weight", False),
        ("q", "self_attn.q_proj.weight", True),
        ("k", "self_attn.k_proj.weight", True),
        ("v", "self_attn.v_proj.weight", True),
        ("o", "self_attn.o_proj.weight", True),
        ("mlp_norm", t.mlp_norm, False),
    ]
    if spec.qk_norm:
        keys += [("q_norm", "self_attn.q_norm.weight", False),
                 ("k_norm", "self_attn.k_norm.weight", False)]
    if t.attn_gate:
        keys.append(("attn_gate", t.attn_gate, True))
    if t.post_attn_norm:
        keys.append(("post_attn_norm", t.post_attn_norm, False))
    if t.post_mlp_norm:
        keys.append(("post_mlp_norm", t.post_mlp_norm, False))
    if spec.attn_bias:
        keys += [("q_bias", "self_attn.q_proj.bias", False),
                 ("k_bias", "self_attn.k_proj.bias", False),
                 ("v_bias", "self_attn.v_proj.bias", False)]
    return keys


def _has_shared(spec: ModelSpec, t: HFKeys) -> bool:
    return bool(t.shared and (spec.n_shared_experts or spec.shared_expert_size))


def params_from_hf_state_dict(state: dict, spec: ModelSpec, dtype=torch.float32,
                              device: torch.device | str = "cpu", attn_keys=None,
                              keys: HFKeys = GLM4_KEYS) -> Params:
    """Stacked params from a flat HF state dict (torch tensors or numpy
    arrays), placed on ``device`` in ``dtype`` (the selection-only
    ``router_correction_bias`` stays float32). ``keys`` names the family's
    layout; ``attn_keys`` lets the MLA-attention families reuse this
    converter's shared trunk (embed/norm/MoE/dense-MLP) with their own
    attention key table."""
    t = keys

    def get(key, tr, dt=dtype):
        x = torch.as_tensor(state[key]).to(device=device, dtype=dt)
        return x.T.contiguous() if tr else x

    k_dense = spec.first_k_dense_replace
    nl, e = spec.num_layers, spec.num_experts
    akeys = attn_keys or _attn_keys(spec, t)

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
        lp["router"] = get(f"model.layers.{i}.{t.router}", True)
        if t.bias:
            lp["router_correction_bias"] = get(f"model.layers.{i}.{t.bias}", False,
                                               torch.float32)
        for (ours, _), suf in zip(_MLP, t.expert_projs):
            lp[f"expert_{ours}"] = torch.stack([
                get(f"model.layers.{i}.{t.experts}.{j}.{suf}", True) for j in range(e)])
        if _has_shared(spec, t):
            for ours, theirs in _MLP:
                lp[f"shared_{ours}"] = get(f"model.layers.{i}.{t.shared}.{theirs}.weight", True)
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


def params_to_hf_state_dict(params: Params, spec: ModelSpec, attn_keys=None,
                            keys: HFKeys = GLM4_KEYS) -> dict:
    """Flat HF state dict from the stacked params: tensors on the params'
    device in their dtype (transposed views where HF stores [out, in]), so a
    multi-gigabyte snapshot is not widened to float32 on the host."""
    t = keys
    state: dict[str, torch.Tensor] = {
        "model.embed_tokens.weight": params["embed"].detach(),
        "model.norm.weight": params["final_norm"].detach(),
    }
    k_dense = spec.first_k_dense_replace
    akeys = attn_keys or _attn_keys(spec, t)

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
        state[f"model.layers.{i}.{t.router}"] = lp["router"].T
        if t.bias:
            state[f"model.layers.{i}.{t.bias}"] = lp["router_correction_bias"]
        for (ours, _), suf in zip(_MLP, t.expert_projs):
            stacked = lp[f"expert_{ours}"]
            for j in range(spec.num_experts):
                state[f"model.layers.{i}.{t.experts}.{j}.{suf}"] = stacked[j].T
        if _has_shared(spec, t):
            for ours, theirs in _MLP:
                state[f"model.layers.{i}.{t.shared}.{theirs}.weight"] = lp[f"shared_{ours}"].T
    if not spec.tie_embeddings:
        state["lm_head.weight"] = params["lm_head"].detach().T
    return state

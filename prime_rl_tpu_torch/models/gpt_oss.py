"""gpt-oss family (gpt-oss-20b/120b): a MoE transformer with alternating
128-token sliding windows, learned attention sinks, q/k/v/o biases, YaRN RoPE,
top-k-softmax routing and clamped-GLU experts with per-expert biases (the port
of the JAX package's ``models/gpt_oss.py``, training and serving).

Attention reuses ``qwen3._attn_block`` (biases, sinks and the window are spec
axes there); on the card it runs K1 (forward) and K2a/K2b (backward) in their
window and sink forms. The experts ride the sorted grouped MoE op
(``ops/moe.py``) with the clamped activation and per-expert biases.

Params, in the JAX package's stacked layout: ``{"embed": [V, D], "layers":
{name: [NL, ...]}, "final_norm": [D], "lm_head": [D, V]}``; the layers hold the
dense attention leaves of ``qwen3.init_params`` (with ``sink`` and the
``*_bias`` leaves), ``router`` [NL, D, E], ``router_bias`` [NL, E],
``expert_{gate,up}`` [NL, E, D, M], ``expert_down`` [NL, E, M, D] and their
biases. LoRA and context parallelism raise.
"""

from __future__ import annotations

import torch

from prime_rl_tpu_torch.models import qwen3
from prime_rl_tpu_torch.models.base import ModelSpec
from prime_rl_tpu_torch.models.lora import layer_slices
from prime_rl_tpu_torch.models.qwen3 import (
    layer_windows_list,
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
FAMILY = "gpt_oss"
# the ac.modes the JAX function names (prime_rl_tpu/models/gpt_oss.py:114-130) and the mode
# each runs as; any other keeps every activation (``qwen3.parse_remat``)
REMAT = {"full": "full", "save_attn": "save_attn", "offload_attn": "offload_attn",
         "selective": "selective"}
_MOE_FIELDS = ("router", "router_bias", "expert_gate", "expert_up", "expert_down",
               "expert_gate_bias", "expert_up_bias", "expert_down_bias")


def init_params(spec: ModelSpec, generator: torch.Generator, dtype=torch.float32,
                device: torch.device | str = "cpu") -> Params:
    """Random init on ``device`` from ``generator`` (which must live there):
    the dense attention and embeddings of ``qwen3.init_params``, then the
    router and the experts, std 0.02 cut at 2 sigma, biases zero. Stacks are
    drawn a layer at a time straight into ``dtype`` (``qwen3.trunc_normal``),
    so gpt-oss-20b in bf16 peaks near its own 41.8 GB. The numbers differ from
    the JAX package's ``jax.random`` init."""
    if spec.family != FAMILY:
        raise ValueError(f"gpt_oss.init_params: family {spec.family!r} is not gpt_oss")
    params = qwen3.init_params(spec_dense_view(spec), generator, dtype=dtype, device=device)
    nl, d = spec.num_layers, spec.hidden_size
    e, m = spec.num_experts, spec.moe_intermediate_size
    layers = params["layers"]
    for f in ("gate", "up", "down"):
        layers.pop(f, None)

    def w(*shape):
        return trunc_normal(shape, generator, dtype, device)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    layers["router"] = w(nl, d, e)
    layers["router_bias"] = zeros(nl, e)
    layers["expert_gate"] = w(nl, e, d, m)
    layers["expert_up"] = w(nl, e, d, m)
    layers["expert_down"] = w(nl, e, m, d)
    layers["expert_gate_bias"] = zeros(nl, e, m)
    layers["expert_up_bias"] = zeros(nl, e, m)
    layers["expert_down_bias"] = zeros(nl, e, d)
    return params


def moe_block(h: torch.Tensor, lp: dict, spec: ModelSpec, compute_dtype,
              forced: torch.Tensor | None = None, lora: dict | None = None,
              lora_scale: float = 1.0):
    """Post-attention routed experts with residual. Returns (h, load-balance
    aux). ``lp`` holds one layer's weights as stored: the expert matrices are
    cast to ``compute_dtype``, the router and every bias stay as stored (the
    router math runs in f32, the biases are added in f32). ``forced`` ([B*L,
    K] int, -1 = own routing) replays the sampler's expert selection;
    ``lora``: the layer's adapter slices, whose ``moe_*`` targets apply per
    expert."""
    b, l, d = h.shape
    cast = {k: (v.to(compute_dtype) if v.dim() >= 2 and "router" not in k
                and not k.endswith("_bias") else v)
            for k, v in lp.items()}
    x = rms_norm(h, cast["mlp_norm"], spec.rms_eps)
    out, routing = moe_mlp(
        x.reshape(b * l, d),
        lp["router"],
        cast["expert_gate"], cast["expert_up"], cast["expert_down"],
        spec.num_experts_per_tok, spec.norm_topk_prob,
        router_b=lp.get("router_bias"),
        b_gate=lp.get("expert_gate_bias"), b_up=lp.get("expert_up_bias"),
        b_down=lp.get("expert_down_bias"),
        softmax_topk=spec.router_softmax_topk,
        activation_alpha=spec.swiglu_alpha, activation_limit=spec.swiglu_limit,
        forced_experts=forced, lora=lora, lora_scale=lora_scale,
    )
    return h + out.reshape(b, l, d), routing.load_balance_loss


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
    (hidden, summed load-balance aux) with ``collect_aux``.

    Each layer's window (``layer_windows_list``: 128 on even layers, 0 on odd
    ones for gpt-oss) and sinks go to the attention, so on the card K1/K2 run
    banded with the sink. ``remat``: the modes the JAX function names
    (``REMAT``: ``full``, ``save_attn``, ``offload_attn``, ``selective``, as
    in ``qwen3.forward``); any other mode, and any ``mode/K``, keeps every
    activation, as there.
    ``routed_experts`` replays the sampler's expert selection.
    ``block_q``/``block_kv`` are accepted and unused."""
    if spec.family != FAMILY:
        raise ValueError(f"gpt_oss.forward: family {spec.family!r} is not gpt_oss")
    if mesh is not None:
        raise NotImplementedError("context parallelism waits for the multi-card slice")
    if quantized_compute:
        raise ValueError(f"quantized_compute={quantized_compute!r} is only wired for the "
                         f"qwen3/llama dense families, not {spec.family!r}")
    nl = spec.num_layers
    base_remat, save_stride = parse_remat(remat, nl, REMAT)
    inv_freq, rope_scaling = rope_setup(spec, device=input_ids.device)
    h = params["embed"].to(compute_dtype)[input_ids]
    windows = layer_windows_list(spec)

    def block(h, lp, saved, window, forced, ll):
        attn = {k: (v.to(compute_dtype) if v.dim() >= 2 else v)
                for k, v in lp.items() if k not in _MOE_FIELDS}
        h = qwen3._attn_block(h, attn, spec, segment_ids, position_ids, inv_freq, attn_impl,
                              rope_scaling, saved, window, ll, lora_scale)
        return moe_block(h, lp, spec, compute_dtype, forced, ll, lora_scale)

    forced = None
    if routed_experts is not None:
        # [B, L, NL, K] -> layer-major [NL, B*L, K]
        b_, l_ = routed_experts.shape[:2]
        forced = routed_experts.permute(2, 0, 1, 3).reshape(nl, b_ * l_,
                                                            spec.num_experts_per_tok)

    # unbind once: its backward stacks the per-layer gradients in one copy
    per_layer = {k: v.unbind(0) for k, v in params["layers"].items()}
    lora_layers = layer_slices(lora, nl)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    chain: list = []
    for i in range(nl):
        lp = {k: v[i] for k, v in per_layer.items()}
        h, lb = run_layer(block, h, lp, windows[i], layer_remat(base_remat, save_stride, i),
                          None if forced is None else forced[i], lora_layers[i], chain=chain)
        aux = aux + lb
    h = rms_norm(h, params["final_norm"], spec.rms_eps)
    return (h, aux) if collect_aux else h


get_lm_head = qwen3.get_lm_head


# ---------------------------------------------------------------------------
# HF interchange (HF ``GptOssForCausalLM``). Experts are stored FUSED and
# INTERLEAVED: gate_up_proj [E, D, 2M] with gate = [..., ::2] and up =
# [..., 1::2], used as x @ W (no transpose), and their biases likewise.
# ---------------------------------------------------------------------------

_ATTN_KEYS = [
    ("attn_norm", "input_layernorm.weight", False),
    ("q", "self_attn.q_proj.weight", True),
    ("k", "self_attn.k_proj.weight", True),
    ("v", "self_attn.v_proj.weight", True),
    ("o", "self_attn.o_proj.weight", True),
    ("q_bias", "self_attn.q_proj.bias", False),
    ("k_bias", "self_attn.k_proj.bias", False),
    ("v_bias", "self_attn.v_proj.bias", False),
    ("o_bias", "self_attn.o_proj.bias", False),
    ("sink", "self_attn.sinks", False),
    ("mlp_norm", "post_attention_layernorm.weight", False),
    ("router", "mlp.router.weight", True),
    ("router_bias", "mlp.router.bias", False),
]
_EXPERTS = "mlp.experts."


def params_from_hf_state_dict(state: dict, spec: ModelSpec, dtype=torch.float32,
                              device: torch.device | str = "cpu") -> Params:
    """Stacked params from a flat HF state dict (torch tensors or numpy
    arrays, bf16 or f32), on ``device`` in ``dtype``. The published
    checkpoint's MXFP4 expert blocks are not read here."""

    def get(key: str, transpose: bool = False) -> torch.Tensor:
        t = torch.as_tensor(state[key]).to(device=device, dtype=dtype)
        return t.T.contiguous() if transpose else t

    def stack(suffix: str, transpose: bool = False) -> torch.Tensor:
        return torch.stack([get(f"model.layers.{i}.{suffix}", transpose)
                            for i in range(spec.num_layers)])

    layers = {field: stack(suffix, tr) for field, suffix, tr in _ATTN_KEYS}
    for name, suffix in (("expert", "gate_up_proj"), ("expert_bias", "gate_up_proj_bias")):
        gu = stack(_EXPERTS + suffix)
        gate_f, up_f = (("expert_gate", "expert_up") if name == "expert"
                        else ("expert_gate_bias", "expert_up_bias"))
        layers[gate_f] = gu[..., ::2].contiguous()
        layers[up_f] = gu[..., 1::2].contiguous()
        del gu
    layers["expert_down"] = stack(_EXPERTS + "down_proj")
    layers["expert_down_bias"] = stack(_EXPERTS + "down_proj_bias")
    params: Params = {
        "embed": get("model.embed_tokens.weight"),
        "layers": layers,
        "final_norm": get("model.norm.weight"),
    }
    if not spec.tie_embeddings:
        params["lm_head"] = get("lm_head.weight", True)
    return params


def params_to_hf_state_dict(params: Params, spec: ModelSpec) -> dict:
    """Flat HF state dict (numpy f32), converted a layer at a time so that a
    stack's float32 copy never sits whole on the device."""

    def host(t: torch.Tensor):
        return t.detach().float().cpu().numpy()

    def interleave(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        # [..., M] x 2 -> [..., 2M] with a at the even and b at the odd columns
        return torch.stack((a, b), dim=-1).flatten(-2)

    state: dict = {
        "model.embed_tokens.weight": host(params["embed"]),
        "model.norm.weight": host(params["final_norm"]),
    }
    layers = params["layers"]
    for i in range(spec.num_layers):
        pre = f"model.layers.{i}."
        for field, suffix, tr in _ATTN_KEYS:
            arr = host(layers[field][i])
            state[pre + suffix] = arr.T.copy() if tr else arr
        state[pre + _EXPERTS + "gate_up_proj"] = host(
            interleave(layers["expert_gate"][i], layers["expert_up"][i]))
        state[pre + _EXPERTS + "gate_up_proj_bias"] = host(
            interleave(layers["expert_gate_bias"][i], layers["expert_up_bias"][i]))
        state[pre + _EXPERTS + "down_proj"] = host(layers["expert_down"][i])
        state[pre + _EXPERTS + "down_proj_bias"] = host(layers["expert_down_bias"][i])
    if not spec.tie_embeddings:
        state["lm_head.weight"] = host(params["lm_head"]).T.copy()
    return state


def params_from_jax(np_params: dict, spec: ModelSpec, device: torch.device | str = "cpu",
                    dtype=torch.float32) -> Params:
    """The JAX package's gpt-oss training pytree, fetched as numpy arrays
    (``jax.device_get``), as this package's params: the same layout and
    values."""
    if spec.family != FAMILY:
        raise ValueError(f"gpt_oss.params_from_jax: family {spec.family!r} is not gpt_oss")
    return qwen3.params_from_jax(np_params, spec, device=device, dtype=dtype)

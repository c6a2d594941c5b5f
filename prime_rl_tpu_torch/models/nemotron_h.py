"""Nemotron-H (``nemotron_h``): the hybrid of Mamba-2 mixers, bare attention,
relu^2 MLPs and LatentMoE blocks (the port of the JAX package's
``models/nemotron_h.py``, trained and served).

- The layer pattern (``spec.layer_pattern``), one character a layer: M =
  Mamba-2 (``ops/mamba.mamba2_mixer``: the chunked SSD, plain PyTorch, as it
  is XLA in the JAX package), * = attention without rope, qk-norm or gate
  (K1/K2a/K2b through ``ops.attention`` on the card), - = a relu^2 MLP, E =
  LatentMoE (routing at the model width, non-gated relu^2 experts at the
  latent width between ``fc1_latent`` and ``fc2_latent``, plus a relu^2
  shared expert at the model width; sigmoid noaux-tc routing).
- Every layer is ``h + block(rms_norm(h))``: no attention + MLP pairs.

Params, in the JAX package's layout: ``{"embed", "final_norm", "lm_head"
(untied), "mamba_layers", "attn_layers", "mlp_layers", "moe_layers"}``, one
stack a layer kind (only the kinds the pattern holds); a layer's index in its
stack is its rank among the layers of its kind. Router replay
(``routed_experts`` [B, L, NL_E, K]) holds a row a LatentMoE layer, which the
JAX forward does not take. Not ported yet, and raising: a mesh (ROADMAP.md
Queue 1 item 11).
"""

from __future__ import annotations

import numpy as np
import torch

from prime_rl_tpu_torch.models.base import ModelSpec
from prime_rl_tpu_torch.models.lora import apply_lora_proj, layer_slices
from prime_rl_tpu_torch.models import qwen3
from prime_rl_tpu_torch.models.qwen3 import layer_remat, parse_remat, run_layer
from prime_rl_tpu_torch.models.qwen3 import trunc_normal
from prime_rl_tpu_torch.models.qwen3_moe import check_forward_args, forced_by_layer
from prime_rl_tpu_torch.ops.attention import attention
from prime_rl_tpu_torch.ops.layers import rms_norm, weight_mm
from prime_rl_tpu_torch.ops.mamba import mamba2_mixer
from prime_rl_tpu_torch.ops.moe import moe_mlp

Params = dict
FAMILY = "nemotron_h"
# the ac.modes the JAX function names (prime_rl_tpu/models/nemotron_h.py:220-235) and the mode
# each runs as; any other keeps every activation (``qwen3.parse_remat``)
REMAT = {"full": "full", "save_attn": "save_attn", "offload_attn": "offload_attn",
         "selective": "selective"}
BLOCK_CHARS = "M*-E"
STACKS = {"M": "mamba_layers", "*": "attn_layers", "-": "mlp_layers", "E": "moe_layers"}


def stack_counts(spec: ModelSpec) -> dict[str, int]:
    """Layers of each kind; raises unless the pattern covers ``num_layers``."""
    pat = spec.layer_pattern
    if len(pat) != spec.num_layers:
        raise ValueError(f"layer_pattern length {len(pat)} != num_layers {spec.num_layers}")
    return {c: pat.count(c) for c in BLOCK_CHARS}


def relu2(x: torch.Tensor) -> torch.Tensor:
    return torch.square(torch.relu(x))


def init_params(spec: ModelSpec, generator: torch.Generator, dtype=torch.float32,
                device: torch.device | str = "cpu") -> Params:
    """Random init on ``device`` from ``generator`` (std 0.02 cut at 2 sigma,
    stacks drawn a leading slice at a time). ``dt_bias``, ``A_log`` and ``D``
    take the JAX package's own values (a seeded numpy draw, a linspace, ones)
    in float32, as does the routers' correction bias (zeros); the rest
    differs from its ``jax.random`` init."""
    if spec.family != FAMILY:
        raise ValueError(f"nemotron_h.init_params: family {spec.family!r} is not nemotron_h")
    counts = stack_counts(spec)
    d = spec.hidden_size

    def w(*shape):
        return trunc_normal(shape, generator, dtype, device)

    def f32(t):
        return torch.as_tensor(t).to(device=device, dtype=torch.float32)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    params: Params = {"embed": w(spec.vocab_size, d), "final_norm": ones(d)}
    if not spec.tie_embeddings:
        params["lm_head"] = w(d, spec.vocab_size)
    if counts["M"]:
        n, inter, conv, h = counts["M"], spec.mamba_inter, spec.mamba_conv_dim, spec.mamba_num_heads
        # dt_bias = softplus^-1(uniform in log [0.001, 0.1]), A in [1, 16]:
        # the HF Mamba2 init ranges, as JAX draws them
        dt = np.exp(np.random.RandomState(0).uniform(
            np.log(0.001), np.log(0.1), size=(n, h))).astype(np.float32)
        a_log = np.log(np.linspace(1.0, 16.0, h, dtype=np.float32))[None, :]
        params["mamba_layers"] = {
            "norm": ones(n, d),
            "in_proj": w(n, d, inter + conv + h),
            "conv_w": w(n, conv, spec.mamba_conv_kernel),
            "conv_b": torch.zeros((n, conv), dtype=dtype, device=device),
            "A_log": f32(np.repeat(a_log, n, axis=0)),
            "D": f32(np.ones((n, h))),
            "dt_bias": f32(dt + np.log(-np.expm1(-dt))),
            "ssm_norm": ones(n, inter),
            "out_proj": w(n, inter, d),
        }
    if counts["*"]:
        n = counts["*"]
        params["attn_layers"] = {"norm": ones(n, d), "q": w(n, d, spec.q_dim),
                                 "k": w(n, d, spec.kv_dim), "v": w(n, d, spec.kv_dim),
                                 "o": w(n, spec.q_dim, d)}
    if counts["-"]:
        n = counts["-"]
        params["mlp_layers"] = {"norm": ones(n, d), "up": w(n, d, spec.intermediate_size),
                                "down": w(n, spec.intermediate_size, d)}
    if counts["E"]:
        n, e, m = counts["E"], spec.num_experts, spec.moe_intermediate_size
        latent = spec.moe_latent_size or d
        moe = {
            "norm": ones(n, d),
            "router": w(n, d, e),
            "router_correction_bias": f32(np.zeros((n, e))),
            "expert_up": w(n, e, latent, m),
            "expert_down": w(n, e, m, latent),
            "shared_up": w(n, d, spec.moe_shared_expert_size),
            "shared_down": w(n, spec.moe_shared_expert_size, d),
        }
        if spec.moe_latent_size:
            moe["fc1_latent"] = w(n, d, spec.moe_latent_size)
            moe["fc2_latent"] = w(n, spec.moe_latent_size, d)
        params["moe_layers"] = moe
    return params


def mamba_block(h, lp, spec: ModelSpec, segment_ids, compute_dtype):
    """h + Mamba-2 mixer of rms_norm(h); in_proj and out_proj in the compute
    dtype, the rest as stored (the JAX block's cast)."""
    lp = {k: (v.to(compute_dtype) if k in ("in_proj", "out_proj") else v) for k, v in lp.items()}
    x = rms_norm(h, lp["norm"], spec.rms_eps)
    return h + mamba2_mixer(
        x, lp, num_heads=spec.mamba_num_heads, head_dim=spec.mamba_head_dim,
        ssm_state_size=spec.mamba_state_size, n_groups=spec.mamba_n_groups,
        chunk_size=spec.mamba_chunk_size, segment_ids=segment_ids)


def bare_qkv(x: torch.Tensor, lp: dict, spec: ModelSpec, ll=None, lora_scale: float = 1.0):
    """The attention layer's q [..., T, NH, HD], k, v [..., T, NKV, HD] of the
    normed input x [..., T, D]: no rope, no qk-norm. ``ll``: the layer's
    adapter slices on q, k and v."""
    lead = x.shape[:-1]
    q = apply_lora_proj(x, lp["q"], ll, "q", lora_scale).reshape(*lead, spec.num_heads,
                                                                 spec.head_dim)
    k = apply_lora_proj(x, lp["k"], ll, "k", lora_scale).reshape(*lead, spec.num_kv_heads,
                                                                 spec.head_dim)
    v = apply_lora_proj(x, lp["v"], ll, "v", lora_scale).reshape(*lead, spec.num_kv_heads,
                                                                 spec.head_dim)
    return q, k, v


def attn_block(h, lp, spec: ModelSpec, segment_ids, attn_impl, compute_dtype, saved=None,
               ll=None, lora_scale: float = 1.0):
    """h + the bare attention of rms_norm(h) (K1/K2a/K2b on the card), the
    adapter ``ll`` on q, k, v and o."""
    b, l, _ = h.shape
    lp = {k: v.to(compute_dtype) for k, v in lp.items()}
    x = rms_norm(h, lp["norm"], spec.rms_eps)
    q, k, v = bare_qkv(x, lp, spec, ll, lora_scale)
    o = attention(q, k, v, segment_ids, causal=True, impl=attn_impl, saved=saved)
    return h + apply_lora_proj(o.reshape(b, l, spec.q_dim), lp["o"], ll, "o", lora_scale)


def mlp_block(h, lp, spec: ModelSpec, compute_dtype):
    """h + relu^2 MLP of rms_norm(h)."""
    lp = {k: v.to(compute_dtype) for k, v in lp.items()}
    x = rms_norm(h, lp["norm"], spec.rms_eps)
    return h + relu2(x @ lp["up"]) @ lp["down"]


def latent_moe(x: torch.Tensor, lp: dict, spec: ModelSpec, forced=None, lora=None,
               lora_scale: float = 1.0):
    """LatentMoE of the normed input x [..., D] (its matrices already in the
    compute dtype): the routed relu^2 experts at the latent width, routed at
    the model width, plus the relu^2 shared expert. Returns (out [..., D],
    the router's output). ``lora``: per-expert adapters (``moe_up``,
    ``moe_down``, at the latent width)."""
    lead, d = x.shape[:-1], x.shape[-1]
    flat = x.reshape(-1, d)
    lat = flat @ lp["fc1_latent"] if "fc1_latent" in lp else flat
    out, routing = moe_mlp(
        flat, lp["router"], None, lp["expert_up"], lp["expert_down"],
        spec.num_experts_per_tok, spec.norm_topk_prob, x_experts=lat,
        sigmoid_noaux=spec.router_sigmoid, correction_bias=lp.get("router_correction_bias"),
        n_group=spec.n_group, topk_group=spec.topk_group,
        routed_scaling=spec.routed_scaling_factor, forced_experts=forced, lora=lora,
        lora_scale=lora_scale)
    if "fc2_latent" in lp:
        out = out @ lp["fc2_latent"]
    out = out.reshape(*lead, d)
    return out + weight_mm(relu2(weight_mm(x, lp["shared_up"])), lp["shared_down"]), routing


def moe_block(h, lp, spec: ModelSpec, compute_dtype, forced=None, lora=None,
              lora_scale: float = 1.0):
    """h + LatentMoE of rms_norm(h); returns (h, load-balance aux). The
    router and its correction bias stay float32."""
    lp = {k: (v.to(compute_dtype) if v.dim() >= 2 and "router" not in k else v)
          for k, v in lp.items()}
    x = rms_norm(h, lp["norm"], spec.rms_eps)
    out, routing = latent_moe(x, lp, spec, forced, lora, lora_scale)
    return h + out, routing.load_balance_loss


def layer_params(params: Params, spec: ModelSpec) -> list[tuple[str, dict]]:
    """(kind, that layer's params) for each layer in pattern order, views
    into the stacks (unbound once: the backward stacks the per-layer
    gradients in one copy)."""
    stack_counts(spec)
    per = {ch: {k: v.unbind(0) for k, v in params[name].items()}
           for ch, name in STACKS.items() if name in params}
    rank = dict.fromkeys(BLOCK_CHARS, 0)
    out = []
    for ch in spec.layer_pattern:
        out.append((ch, {k: v[rank[ch]] for k, v in per[ch].items()}))
        rank[ch] += 1
    return out


def forward(
    params: Params,
    spec: ModelSpec,
    input_ids: torch.Tensor,  # [B, L] int
    segment_ids: torch.Tensor,  # [B, L] int (0 = pad)
    position_ids: torch.Tensor,  # [B, L] int: unused, no rope in Nemotron-H
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
    routed_experts: torch.Tensor | None = None,  # [B, L, NL_E, K]; -1 = own routing
    quantized_compute: str | None = None,
):
    """Token ids -> final hidden states [B, L, D] (pre-LM-head, normed), or
    (hidden, load-balance aux summed over the LatentMoE layers) with
    ``collect_aux``. ``remat``: the modes the JAX function names (``REMAT``:
    ``full``, each layer recomputed in the backward; ``save_attn`` and
    ``offload_attn``, the attention layers' K1 outputs kept on the device or
    in pinned host memory, the other kinds recomputed in full, as JAX's
    policy names only the attention's outputs; ``selective``, the products
    with no batch dims kept); any other mode, and any ``mode/K``, keeps
    every activation, as there."""
    del position_ids
    if spec.family != FAMILY:
        raise ValueError(f"nemotron_h.forward: family {spec.family!r} is not nemotron_h")
    check_forward_args(spec, mesh, lora, quantized_compute)
    layers = layer_params(params, spec)
    base_remat, save_stride = parse_remat(remat, spec.num_layers, REMAT)
    h = params["embed"].to(compute_dtype)[input_ids]

    # LoRA: the adapters index full depth; the "*" layers take them on their
    # projections, the "E" layers on their experts (moe_* targets)
    def block(h, lp, saved, window, kind, forced, ll):
        if kind == "M":
            return mamba_block(h, lp, spec, segment_ids, compute_dtype), None
        if kind == "*":
            return attn_block(h, lp, spec, segment_ids, attn_impl, compute_dtype, saved, ll,
                              lora_scale), None
        if kind == "-":
            return mlp_block(h, lp, spec, compute_dtype), None
        return moe_block(h, lp, spec, compute_dtype, forced, ll, lora_scale)

    forced = forced_by_layer(routed_experts, spec.layer_pattern.count("E"),
                             spec.num_experts_per_tok)
    lora_layers = layer_slices(lora, spec.num_layers)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    e_rank = 0
    chain: list = []
    for i, (kind, lp) in enumerate(layers):
        f = None
        if kind == "E" and forced is not None:
            f = forced[e_rank]
        e_rank += kind == "E"
        h, lb = run_layer(block, h, lp, 0, layer_remat(base_remat, save_stride, i), kind, f,
                          lora_layers[i], chain=chain)
        if lb is not None:
            aux = aux + lb
    h = rms_norm(h, params["final_norm"], spec.rms_eps)
    return (h, aux) if collect_aux else h


get_lm_head = qwen3.get_lm_head


# ---------------------------------------------------------------------------
# HF interchange (HF ``NemotronHForCausalLM``: the ``backbone.`` prefix, one
# ``mixer.`` namespace a layer told apart by which keys it holds, per-expert
# up/down with no gate). Torch Linears are [out, in]: transposed.
# ---------------------------------------------------------------------------

_MAMBA_KEYS = (("in_proj", "in_proj.weight", True), ("conv_b", "conv1d.bias", False),
               ("A_log", "A_log", False), ("D", "D", False), ("dt_bias", "dt_bias", False),
               ("ssm_norm", "norm.weight", False), ("out_proj", "out_proj.weight", True))
_ATTN_KEYS = (("q", "q_proj.weight", True), ("k", "k_proj.weight", True),
              ("v", "v_proj.weight", True), ("o", "o_proj.weight", True))
_MLP_KEYS = (("up", "up_proj.weight", True), ("down", "down_proj.weight", True))


def _layer_type(state: dict, i: int) -> str:
    """Layer i's kind from the keys a checkpoint holds under its mixer."""
    pre = f"backbone.layers.{i}.mixer."
    if pre + "A_log" in state:
        return "M"
    if pre + "q_proj.weight" in state:
        return "*"
    if pre + "gate.weight" in state:
        return "E"
    if pre + "up_proj.weight" in state:
        return "-"
    raise KeyError(f"cannot classify layer {i}: no known mixer key under {pre!r}")


def params_from_hf_state_dict(state: dict, spec: ModelSpec, dtype=torch.float32,
                              device: torch.device | str = "cpu") -> Params:
    """Stacked params from a flat HF state dict (torch tensors or numpy
    arrays), on ``device`` in ``dtype``; raises where a layer's kind differs
    from the pattern's."""

    def get(key: str, transpose: bool = False) -> torch.Tensor:
        t = torch.as_tensor(state[key]).to(device=device, dtype=dtype)
        return t.T.contiguous() if transpose else t

    stacks: dict[str, dict[str, list]] = {c: {} for c in BLOCK_CHARS}
    for i in range(spec.num_layers):
        ch = _layer_type(state, i)
        if spec.layer_pattern and spec.layer_pattern[i] != ch:
            raise ValueError(f"layer {i}: checkpoint block type {ch!r} != spec pattern "
                             f"{spec.layer_pattern[i]!r}")
        pre = f"backbone.layers.{i}.mixer."
        lp = {"norm": get(f"backbone.layers.{i}.norm.weight")}
        if ch in "M*-":
            keys = {"M": _MAMBA_KEYS, "*": _ATTN_KEYS, "-": _MLP_KEYS}[ch]
            for ours, suf, tr in keys:
                lp[ours] = get(pre + suf, tr)
            if ch == "M":
                lp["conv_w"] = get(pre + "conv1d.weight")[:, 0, :]
        else:
            lp["router"] = get(pre + "gate.weight", True)
            lp["router_correction_bias"] = get(pre + "gate.e_score_correction_bias")
            if pre + "experts.up_proj" in state:  # the fused 3-D form
                lp["expert_up"] = get(pre + "experts.up_proj").transpose(1, 2).contiguous()
                lp["expert_down"] = get(pre + "experts.down_proj").transpose(1, 2).contiguous()
            else:
                for ours, theirs in (("expert_up", "up_proj"), ("expert_down", "down_proj")):
                    lp[ours] = torch.stack([get(f"{pre}experts.{e}.{theirs}.weight", True)
                                            for e in range(spec.num_experts)])
            lp["shared_up"] = get(pre + "shared_experts.up_proj.weight", True)
            lp["shared_down"] = get(pre + "shared_experts.down_proj.weight", True)
            if spec.moe_latent_size:
                lp["fc1_latent"] = get(pre + "fc1_latent_proj.weight", True)
                lp["fc2_latent"] = get(pre + "fc2_latent_proj.weight", True)
        for k, v in lp.items():
            stacks[ch].setdefault(k, []).append(v)
    params: Params = {"embed": get("backbone.embeddings.weight"),
                      "final_norm": get("backbone.norm_f.weight")}
    for ch, fields in stacks.items():
        if fields:
            params[STACKS[ch]] = {k: torch.stack(v) for k, v in fields.items()}
    if not spec.tie_embeddings:
        params["lm_head"] = get("lm_head.weight", True)
    return params


def params_to_hf_state_dict(params: Params, spec: ModelSpec) -> dict[str, np.ndarray]:
    """Flat HF state dict (numpy f32), a layer at a time, experts one by one.
    Transposes run where the params live (on the card, not in host copies)."""

    def host(t: torch.Tensor, transpose: bool = False) -> np.ndarray:
        t = t.detach()
        return (t.transpose(-1, -2) if transpose else t).float().contiguous().cpu().numpy()

    state: dict[str, np.ndarray] = {"backbone.embeddings.weight": host(params["embed"]),
                                    "backbone.norm_f.weight": host(params["final_norm"])}
    for i, (ch, lp) in enumerate(layer_params(params, spec)):
        pre = f"backbone.layers.{i}.mixer."
        state[f"backbone.layers.{i}.norm.weight"] = host(lp["norm"])
        if ch in "M*-":
            keys = {"M": _MAMBA_KEYS, "*": _ATTN_KEYS, "-": _MLP_KEYS}[ch]
            for ours, suf, tr in keys:
                state[pre + suf] = host(lp[ours], tr)
            if ch == "M":
                state[pre + "conv1d.weight"] = host(lp["conv_w"])[:, None, :]
            continue
        state[pre + "gate.weight"] = host(lp["router"], True)
        state[pre + "gate.e_score_correction_bias"] = host(lp["router_correction_bias"])
        for ours, theirs in (("expert_up", "up_proj"), ("expert_down", "down_proj")):
            stacked = host(lp[ours], True)
            for e in range(spec.num_experts):
                state[f"{pre}experts.{e}.{theirs}.weight"] = stacked[e]
        state[pre + "shared_experts.up_proj.weight"] = host(lp["shared_up"], True)
        state[pre + "shared_experts.down_proj.weight"] = host(lp["shared_down"], True)
        if spec.moe_latent_size:
            state[pre + "fc1_latent_proj.weight"] = host(lp["fc1_latent"], True)
            state[pre + "fc2_latent_proj.weight"] = host(lp["fc2_latent"], True)
    if not spec.tie_embeddings:
        state["lm_head.weight"] = host(params["lm_head"], True)
    return state

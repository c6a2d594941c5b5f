"""Qwen3 dense family (and llama, the same block without qk-norm): rope
setup, random init, the training forward, LM head and the HF state-dict
conversion (the port of the JAX package's ``models/qwen3.py``).

RMSNorm -> GQA attention with per-head q/k RMSNorm + RoPE (optional q/k/v/o
biases, sliding windows per layer, learned attention sinks) -> RMSNorm ->
SwiGLU. The gated-MoE axes live here too: a layer-scope qk-norm over the flat
q/k (MiniMax-M2), an attention-output gate on the normed block input
(``apply_attn_gate``: AFMoE's sigmoid, Laguna's per-head softplus) and the
sandwich norms on each block's output before the residual add (AFMoE). The
MoE families reuse the attention half (``_attn_block``, ``init_params``
through ``spec_dense_view``). Parameters are a plain dict of
tensors in the JAX package's stacked layout: ``{"embed": [V, D], "layers":
{name: [NL, ...]}, "final_norm": [D], "lm_head": [D, V] (untied only)}``,
projections stored ``[in, out]``. The
training forward loops over the leading layer axis; the serving engine
unstacks them per layer (sampler/model.unstack_params).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from prime_rl_tpu_torch.models.base import ModelSpec
from prime_rl_tpu_torch.ops.attention import attention
from prime_rl_tpu_torch.ops.layers import (
    apply_rope,
    rms_norm,
    rope_frequencies,
    swiglu,
    yarn_rope_parameters,
)

Params = dict
# families whose attention and embeddings this module initializes
_INIT_FAMILIES = ("qwen3", "llama", "gpt_oss", "qwen3_moe", "glm4_moe", "minimax_m2", "afmoe",
                  "laguna")


def rope_setup(spec: ModelSpec, device: torch.device | str = "cpu") -> tuple[torch.Tensor, float]:
    """(inv_freq f32 [rot//2], cos/sin scaling) from the spec: plain RoPE or
    YaRN. Partial rotary shortens inv_freq; apply_rope leaves the tail alone."""
    rot_dim = int(spec.head_dim * spec.partial_rotary_factor)
    if spec.rope_yarn_factor and spec.rope_yarn_factor > 1.0:
        return yarn_rope_parameters(
            rot_dim, spec.rope_theta, spec.rope_yarn_factor,
            spec.rope_yarn_orig_max or spec.max_position_embeddings,
            spec.rope_yarn_beta_fast, spec.rope_yarn_beta_slow,
            spec.rope_yarn_truncate, device=device,
        )
    return rope_frequencies(rot_dim, spec.rope_theta, device=device), 1.0


def layer_rope_frequencies(spec: ModelSpec, inv_freq: torch.Tensor, window: int) -> torch.Tensor:
    """A layer's rope frequencies: a windowed layer runs its own base where
    the spec has one (``rope_theta_local``, Laguna: 10k on sliding layers
    against 500k on full ones); every other layer ``inv_freq``."""
    if window and spec.rope_theta_local:
        rot_dim = int(spec.head_dim * spec.partial_rotary_factor)
        return rope_frequencies(rot_dim, spec.rope_theta_local, device=inv_freq.device)
    return inv_freq


def spec_dense_view(spec: ModelSpec) -> ModelSpec:
    """A dense-shaped twin of a MoE spec, to reuse the dense attention and
    embedding init (the JAX package keeps this in ``models/qwen3_moe.py``)."""
    return dataclasses.replace(spec, num_experts=0, num_experts_per_tok=0,
                               moe_intermediate_size=0)


def trunc_normal(shape, generator: torch.Generator, dtype, device) -> torch.Tensor:
    """std 0.02 cut at 2 sigma, drawn in float32. A stack of matrices in a
    narrower ``dtype`` is drawn one leading slice at a time, so that no float32
    copy of the whole stack exists (gpt-oss-20b's expert stacks hold 6.4 G
    values each: 25.5 GB in float32)."""
    def draw(part_shape):
        t = torch.empty(part_shape, dtype=torch.float32, device=device)
        return torch.nn.init.trunc_normal_(t, std=0.02, a=-0.04, b=0.04, generator=generator)

    if dtype == torch.float32 or len(shape) <= 2:
        return draw(shape).to(dtype)
    out = torch.empty(shape, dtype=dtype, device=device)
    for part in out.unbind(0):
        part.copy_(draw(part.shape))
    return out


def init_params(spec: ModelSpec, generator: torch.Generator, dtype=torch.float32,
                device: torch.device | str = "cpu") -> Params:
    """Random init (truncated normal, std 0.02 cut at 2 sigma, HF-style) on
    ``device``, drawn from ``generator`` (which must live on that device).
    The numbers differ from the JAX package's ``jax.random`` init. gpt-oss
    calls this on its ``spec_dense_view`` for the attention and embeddings."""
    if spec.family not in _INIT_FAMILIES:
        raise NotImplementedError(f"model family {spec.family!r} has no dense init here "
                                  f"(these do: {', '.join(_INIT_FAMILIES)})")
    d, nl = spec.hidden_size, spec.num_layers

    def w(*shape):
        return trunc_normal(shape, generator, dtype, device)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    layers = {
        "attn_norm": ones(nl, d),
        "q": w(nl, d, spec.q_dim),
        "k": w(nl, d, spec.kv_dim),
        "v": w(nl, d, spec.kv_dim),
        "o": w(nl, spec.q_dim, d),
        "mlp_norm": ones(nl, d),
        "gate": w(nl, d, spec.intermediate_size),
        "up": w(nl, d, spec.intermediate_size),
        "down": w(nl, spec.intermediate_size, d),
    }
    if spec.qk_norm:
        qw = spec.q_dim if spec.qk_norm_scope == "layer" else spec.head_dim
        kw_ = spec.kv_dim if spec.qk_norm_scope == "layer" else spec.head_dim
        layers["q_norm"] = ones(nl, qw)
        layers["k_norm"] = ones(nl, kw_)
    if spec.attn_gate == "sigmoid":
        layers["attn_gate"] = w(nl, d, spec.q_dim)
    elif spec.attn_gate == "softplus_head":
        layers["attn_gate"] = w(nl, d, spec.num_heads)
    if spec.sandwich_norm:
        layers["post_attn_norm"] = ones(nl, d)
        layers["post_mlp_norm"] = ones(nl, d)
    if spec.attn_sinks:
        layers["sink"] = zeros(nl, spec.num_heads)
    if spec.attn_bias:
        layers["q_bias"] = zeros(nl, spec.q_dim)
        layers["k_bias"] = zeros(nl, spec.kv_dim)
        layers["v_bias"] = zeros(nl, spec.kv_dim)
        layers["o_bias"] = zeros(nl, d)
    params: Params = {
        "embed": w(spec.vocab_size, d),
        "layers": layers,
        "final_norm": ones(d),
    }
    if not spec.tie_embeddings:
        params["lm_head"] = w(d, spec.vocab_size)
    return params


def get_lm_head(params: Params, spec: ModelSpec) -> torch.Tensor:
    """[D, V]: the tied transpose of embed, or the separate head."""
    if spec.tie_embeddings:
        return params["embed"].T
    return params["lm_head"]


def _attn_block(
    h: torch.Tensor,
    lp: dict[str, torch.Tensor],
    spec: ModelSpec,
    segment_ids: torch.Tensor,
    position_ids: torch.Tensor,
    inv_freq: torch.Tensor,
    attn_impl: str = "auto",
    rope_scaling: float = 1.0,
    saved=None,
    window: int = 0,
) -> torch.Tensor:
    def bias(t, name, heads):
        bb = lp.get(name)
        if bb is None:
            return t
        return t + bb.to(t.dtype).reshape(1, 1, heads, spec.head_dim)

    b, l, _ = h.shape
    x = rms_norm(h, lp["attn_norm"], spec.rms_eps)
    qf = torch.matmul(x, lp["q"])
    kf = torch.matmul(x, lp["k"])
    if spec.qk_norm and spec.qk_norm_scope == "layer":
        # one RMSNorm over the flattened head dims
        qf = rms_norm(qf, lp["q_norm"], spec.rms_eps)
        kf = rms_norm(kf, lp["k_norm"], spec.rms_eps)
    q = qf.reshape(b, l, spec.num_heads, spec.head_dim)
    k = kf.reshape(b, l, spec.num_kv_heads, spec.head_dim)
    v = torch.matmul(x, lp["v"]).reshape(b, l, spec.num_kv_heads, spec.head_dim)
    q = bias(q, "q_bias", spec.num_heads)
    k = bias(k, "k_bias", spec.num_kv_heads)
    v = bias(v, "v_bias", spec.num_kv_heads)
    if spec.qk_norm and spec.qk_norm_scope != "layer":
        q = rms_norm(q, lp["q_norm"], spec.rms_eps)
        k = rms_norm(k, lp["k_norm"], spec.rms_eps)
    q = apply_rope(q, position_ids, inv_freq, rope_scaling)
    k = apply_rope(k, position_ids, inv_freq, rope_scaling)
    o = attention(q, k, v, segment_ids, causal=True, window=window, sinks=lp.get("sink"),
                  impl=attn_impl, saved=saved)
    o = apply_attn_gate(o, x, lp, spec)
    proj = torch.matmul(o.reshape(b, l, spec.q_dim), lp["o"])
    if lp.get("o_bias") is not None:
        proj = proj + lp["o_bias"].to(proj.dtype)
    return h + post_attn(proj, lp, spec)


def apply_attn_gate(o: torch.Tensor, x: torch.Tensor, lp: dict, spec: ModelSpec) -> torch.Tensor:
    """Attention-output gating. o: [..., NH, HD]; x: the normed block input
    with o's leading dims. ``sigmoid``: o * sigmoid(x @ Wg) elementwise over
    the flat q_dim (AFMoE); ``softplus_head``: o * softplus(x @ Wg), one
    scalar a head, the softplus in float32 (Laguna)."""
    if not spec.attn_gate:
        return o
    g = torch.matmul(x, lp["attn_gate"])
    if spec.attn_gate == "sigmoid":
        return o * torch.sigmoid(g).reshape(o.shape)
    if spec.attn_gate == "softplus_head":
        return o * torch.nn.functional.softplus(g.float()).to(o.dtype)[..., None]
    raise ValueError(f"unknown attn_gate {spec.attn_gate!r}")


def _mlp_block(h: torch.Tensor, lp: dict[str, torch.Tensor], spec: ModelSpec) -> torch.Tensor:
    x = rms_norm(h, lp["mlp_norm"], spec.rms_eps)
    gate = torch.matmul(x, lp["gate"])
    up = torch.matmul(x, lp["up"])
    return h + post_mlp(torch.matmul(swiglu(gate, up), lp["down"]), lp, spec)


def post_attn(proj: torch.Tensor, lp: dict, spec: ModelSpec) -> torch.Tensor:
    """The attention's output before the residual add: normed under sandwich
    norms (AFMoE)."""
    return rms_norm(proj, lp["post_attn_norm"], spec.rms_eps) if spec.sandwich_norm else proj


def post_mlp(out: torch.Tensor, lp: dict, spec: ModelSpec) -> torch.Tensor:
    """The MLP's output before the residual add: normed under sandwich norms."""
    return rms_norm(out, lp["post_mlp_norm"], spec.rms_eps) if spec.sandwich_norm else out


_WAITING_REMAT = {
    "offload_attn": "the offload slice", "offload_dots": "the offload slice",
    "selective": "the remat-policy slice",
}


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
    quantized_compute: str | None = None,
) -> torch.Tensor:
    """Token ids -> final hidden states [B, L, D] (pre-LM-head, normed).

    Layer weights with two or more dims are cast to ``compute_dtype`` per
    layer; norm weights stay as stored. ``remat`` maps onto
    ``torch.utils.checkpoint`` per layer: ``none`` keeps every activation,
    ``full`` recomputes the whole layer in the backward, ``save_attn`` (and
    ``save_attn/K``: every K-th layer, the others ``full``) recomputes
    everything except the attention kernel, whose outputs are kept so K1 does
    not run again. ``block_q``/``block_kv`` are accepted and unused: the CUDA
    kernels choose their own tiles. The arguments that belong to later slices
    (``mesh``, ``lora``, ``quantized_compute``, the offload and selective
    remat modes) raise."""
    if spec.family not in ("qwen3", "llama"):
        raise NotImplementedError(f"model family {spec.family!r} is not ported yet")
    if mesh is not None:
        raise NotImplementedError("context parallelism waits for the multi-card slice")
    if lora is not None:
        raise NotImplementedError("LoRA adapters wait for the LoRA slice")
    if quantized_compute:
        raise NotImplementedError("quantized_compute waits for the int8/fp8 slice")
    nl = spec.num_layers
    base_remat, save_stride = parse_remat(remat, nl)
    inv_freq, rope_scaling = rope_setup(spec, device=input_ids.device)
    h = params["embed"].to(compute_dtype)[input_ids]

    windows = layer_windows_list(spec)

    def block(h, lp, saved, window):
        lp = {k: (v.to(compute_dtype) if v.dim() >= 2 else v) for k, v in lp.items()}
        h = _attn_block(h, lp, spec, segment_ids, position_ids, inv_freq, attn_impl,
                        rope_scaling, saved, window)
        return _mlp_block(h, lp, spec)

    # unbind once: its backward stacks the per-layer gradients in one copy
    # (indexing layer by layer would build a full-size zero stack per layer)
    per_layer = {k: v.unbind(0) for k, v in params["layers"].items()}
    for i in range(nl):
        lp = {k: v[i] for k, v in per_layer.items()}
        h = run_layer(block, h, lp, windows[i], layer_remat(base_remat, save_stride, i))
    return rms_norm(h, params["final_norm"], spec.rms_eps)


def parse_remat(remat: str, nl: int) -> tuple[str, int]:
    """(base mode, save stride) of an ``ac.mode``; the modes of later slices
    raise."""
    base_remat, _, k_str = remat.partition("/")
    save_stride = int(k_str) if k_str else 1
    if base_remat in _WAITING_REMAT:
        raise NotImplementedError(
            f"ac.mode {remat!r} waits for {_WAITING_REMAT[base_remat]}; "
            "use none, full or save_attn[/K]")
    if base_remat not in ("none", "full", "save_attn"):
        raise ValueError(f"unknown ac.mode {remat!r}")
    if save_stride > 1 and nl % save_stride:
        raise ValueError(f"ac.mode stride {save_stride} must divide the layer count {nl}")
    return base_remat, save_stride


def layer_remat(base_remat: str, save_stride: int, i: int) -> str:
    """Layer ``i``'s mode: ``save_attn/K`` keeps every K-th layer's attention
    outputs and recomputes the others in full."""
    return "full" if save_stride > 1 and i % save_stride else base_remat


def run_layer(block, h, lp, window: int, mode: str, *extra):
    """``block(h, lp, saved, window, *extra)`` under ``mode``: ``none`` (or no
    autograd) keeps every activation, ``full`` recomputes the layer in the
    backward, ``save_attn`` recomputes all but the attention kernel, whose
    outputs an ``AttnSaved`` slot keeps."""
    from prime_rl_tpu_torch.ops.flash_attention import AttnSaved

    if mode == "none" or not torch.is_grad_enabled():
        return block(h, lp, None, window, *extra)
    saved = AttnSaved() if mode == "save_attn" else None
    return checkpoint(block, h, lp, saved, window, *extra, use_reentrant=False,
                      preserve_rng_state=False)


def layer_windows_list(spec: ModelSpec) -> list[int]:
    """Per-layer sliding-window sizes (0 = full attention). Pattern n makes
    every n-th layer full; n <= 1 windows every layer."""
    if spec.sliding_window <= 0:
        return [0] * spec.num_layers
    pat = max(spec.sliding_window_pattern, 1)
    return [0 if (pat > 1 and (i % pat == pat - 1)) else spec.sliding_window
            for i in range(spec.num_layers)]


# ---------------------------------------------------------------------------
# HF interchange: torch Linear stores [out, in], the params keep [in, out],
# so projections transpose.
# ---------------------------------------------------------------------------

def hf_key_map(spec: ModelSpec) -> dict[str, tuple[str, bool]]:
    """layer field -> (HF per-layer key suffix, transpose?)"""
    m = {
        "attn_norm": ("input_layernorm.weight", False),
        "q": ("self_attn.q_proj.weight", True),
        "k": ("self_attn.k_proj.weight", True),
        "v": ("self_attn.v_proj.weight", True),
        "o": ("self_attn.o_proj.weight", True),
        "mlp_norm": ("post_attention_layernorm.weight", False),
        "gate": ("mlp.gate_proj.weight", True),
        "up": ("mlp.up_proj.weight", True),
        "down": ("mlp.down_proj.weight", True),
    }
    if spec.qk_norm:
        m["q_norm"] = ("self_attn.q_norm.weight", False)
        m["k_norm"] = ("self_attn.k_norm.weight", False)
    if spec.attn_sinks:
        m["sink"] = ("self_attn.sinks", False)
    return m


def params_from_hf_state_dict(state: dict, spec: ModelSpec, dtype=torch.float32,
                              device: torch.device | str = "cpu") -> Params:
    """Stacked params from a flat HF state dict (torch tensors or numpy
    arrays), placed on ``device`` in ``dtype``."""

    def get(key: str, transpose: bool) -> torch.Tensor:
        t = torch.as_tensor(state[key]).to(device=device, dtype=dtype)
        return t.T.contiguous() if transpose else t

    layers = {
        field: torch.stack([get(f"model.layers.{i}.{suffix}", tr)
                            for i in range(spec.num_layers)])
        for field, (suffix, tr) in hf_key_map(spec).items()
    }
    params: Params = {
        "embed": get("model.embed_tokens.weight", False),
        "layers": layers,
        "final_norm": get("model.norm.weight", False),
    }
    if not spec.tie_embeddings:
        params["lm_head"] = get("lm_head.weight", True)
    return params


def params_to_hf_state_dict(params: Params, spec: ModelSpec) -> dict[str, np.ndarray]:
    """Flat HF state dict (numpy f32) from the stacked params."""

    def host(t: torch.Tensor) -> np.ndarray:
        return t.detach().float().cpu().numpy()

    state: dict[str, np.ndarray] = {
        "model.embed_tokens.weight": host(params["embed"]),
        "model.norm.weight": host(params["final_norm"]),
    }
    for field, (suffix, tr) in hf_key_map(spec).items():
        stacked = host(params["layers"][field])
        for i in range(spec.num_layers):
            arr = stacked[i]
            state[f"model.layers.{i}.{suffix}"] = arr.T.copy() if tr else arr
    if not spec.tie_embeddings:
        state["lm_head.weight"] = host(params["lm_head"]).T.copy()
    return state


def load_hf_weights(path, spec: ModelSpec, dtype=torch.bfloat16,
                    device: torch.device | str = "cpu") -> Params:
    """Read an HF snapshot dir (one or more ``.safetensors`` shards, bf16 or
    f32) into the stacked params of ``spec``'s family on ``device``."""
    from pathlib import Path

    from safetensors.torch import load_file

    from prime_rl_tpu_torch.models import get_family

    state: dict[str, torch.Tensor] = {}
    for f in sorted(Path(path).glob("*.safetensors")):
        state.update(load_file(str(f)))
    return get_family(spec).from_hf(state, spec, dtype=dtype, device=device)


def params_from_jax(np_params: dict, spec: ModelSpec, device: torch.device | str = "cpu",
                    dtype=torch.float32) -> Params:
    """The JAX package's stacked training pytree, fetched as numpy arrays
    (``jax.device_get``), as this package's params: the same layout and
    values, so both packages compute the same function (every family this
    module initializes, and qwen3_next's two stacks)."""
    if spec.family not in _INIT_FAMILIES + ("qwen3_next", "nemotron_h"):
        raise NotImplementedError(f"model family {spec.family!r} is not ported yet")

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        return torch.as_tensor(np.asarray(x, np.float32)).to(device=device, dtype=dtype)

    return conv(np_params)

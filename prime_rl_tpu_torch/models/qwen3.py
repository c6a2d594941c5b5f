"""Qwen3 dense family (and llama, the same block without qk-norm): rope
setup, random init, LM head and the HF state-dict conversion — the parts of
the JAX package's ``models/qwen3.py`` that serving needs. The training
forward belongs to the training slice.

Parameters are a plain dict of tensors in the JAX package's stacked layout:
``{"embed": [V, D], "layers": {name: [NL, ...]}, "final_norm": [D],
"lm_head": [D, V] (untied only)}``, projections stored ``[in, out]``. The
serving engine unstacks them per layer (sampler/model.unstack_params).
"""

from __future__ import annotations

import numpy as np
import torch

from prime_rl_tpu_torch.models.base import ModelSpec
from prime_rl_tpu_torch.ops.layers import rope_frequencies, yarn_rope_parameters

Params = dict


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


def init_params(spec: ModelSpec, generator: torch.Generator, dtype=torch.float32,
                device: torch.device | str = "cpu") -> Params:
    """Random init (truncated normal, std 0.02 cut at 2 sigma, HF-style) on
    ``device``, drawn from ``generator`` (which must live on that device).
    The numbers differ from the JAX package's ``jax.random`` init."""
    if spec.family not in ("qwen3", "llama"):
        raise NotImplementedError(f"model family {spec.family!r} is not ported yet "
                                  "(this slice serves the dense qwen3/llama block)")
    d, nl = spec.hidden_size, spec.num_layers

    def w(*shape):
        t = torch.empty(shape, dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(t, std=0.02, a=-0.04, b=0.04, generator=generator)
        return t.to(dtype)

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
    f32) into stacked params on ``device``."""
    from pathlib import Path

    from safetensors.torch import load_file

    state: dict[str, torch.Tensor] = {}
    for f in sorted(Path(path).glob("*.safetensors")):
        state.update(load_file(str(f)))
    return params_from_hf_state_dict(state, spec, dtype=dtype, device=device)


def params_from_jax(np_params: dict, spec: ModelSpec, device: torch.device | str = "cpu",
                    dtype=torch.float32) -> Params:
    """The JAX package's stacked training pytree, fetched as numpy arrays
    (``jax.device_get``), as this package's params: the same layout and
    values, so both packages compute the same function."""
    if spec.family not in ("qwen3", "llama"):
        raise NotImplementedError(f"model family {spec.family!r} is not ported yet")

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        return torch.as_tensor(np.asarray(x, np.float32)).to(device=device, dtype=dtype)

    return conv(np_params)

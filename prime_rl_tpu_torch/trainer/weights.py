"""HF-format weight snapshots for serving + interchange (the port of the JAX
package's ``trainer/weights.py``): per-step
``weights/step_{N}/model.safetensors`` + config.json + STABLE marker, with
``keep_last`` retention; also the filesystem weight-broadcast payload the
sampler reloads from. ``load_hf_weights`` lives in ``models/qwen3.py``.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import torch

from prime_rl_tpu_torch.configs.shared import WeightCheckpointConfig
from prime_rl_tpu_torch.models.base import ModelSpec
from prime_rl_tpu_torch.utils import pathing

Params = dict


_ARCHITECTURES = {
    "qwen3": "Qwen3ForCausalLM",
    "qwen3_moe": "Qwen3MoeForCausalLM",
    "glm4_moe": "Glm4MoeForCausalLM",
    "llama": "LlamaForCausalLM",
    "gpt_oss": "GptOssForCausalLM",
    "deepseek_v3": "DeepseekV3ForCausalLM",
    "glm_moe_dsa": "GlmMoeDsaForCausalLM",
    "minimax_m2": "MiniMaxM2ForCausalLM",
    "afmoe": "AfmoeForCausalLM",
    "laguna": "LagunaForCausalLM",
    "qwen3_next": "Qwen3NextForCausalLM",
    "nemotron_h": "NemotronHForCausalLM",
}


def spec_to_hf_config(spec: ModelSpec) -> dict:
    """Minimal HF config.json so external tools recognize the snapshot, and so
    that ``get_spec`` on the snapshot's directory gives ``spec`` back. (The JAX
    package writes the MLA families under the Qwen3 name and without their
    latent, indexer and routing fields, so its snapshots of them do not
    reload; here they carry their own names and fields, gpt-oss its
    experts, window layout, biases and YaRN scaling, and the gated-MoE
    families theirs: MiniMax-M2's rotary width and qk-norm scope, AFMoE's and
    Laguna's window layouts, dense first layers and shared experts, Laguna's
    rope base a layer type, Qwen3-Next its layer types, linear-attention
    widths and shared expert, and Nemotron-H its ``hybrid_override_pattern``,
    Mamba-2 widths and LatentMoE fields, where JAX writes both as
    Qwen3ForCausalLM.)"""
    from prime_rl_tpu_torch.models.qwen3 import layer_windows_list

    if spec.family not in _ARCHITECTURES:
        raise NotImplementedError(f"no HF architecture name for family {spec.family!r}")
    cfg = {
        "architectures": [_ARCHITECTURES[spec.family]],
        "vocab_size": spec.vocab_size,
        "hidden_size": spec.hidden_size,
        "num_hidden_layers": spec.num_layers,
        "num_attention_heads": spec.num_heads,
        "num_key_value_heads": spec.num_kv_heads,
        "head_dim": spec.head_dim,
        "intermediate_size": spec.intermediate_size,
        "rope_theta": spec.rope_theta,
        "rms_norm_eps": spec.rms_eps,
        "tie_word_embeddings": spec.tie_embeddings,
        "max_position_embeddings": spec.max_position_embeddings,
        "eos_token_id": spec.eos_token_id,
        "pad_token_id": spec.pad_token_id,
        "torch_dtype": "bfloat16",
    }
    if spec.is_moe:
        cfg.update(
            num_experts=spec.num_experts,
            num_experts_per_tok=spec.num_experts_per_tok,
            moe_intermediate_size=spec.moe_intermediate_size,
            norm_topk_prob=spec.norm_topk_prob,
        )
    if spec.family in ("deepseek_v3", "glm_moe_dsa"):
        cfg.pop("num_experts", None)  # these configs name it n_routed_experts
        cfg.update(
            n_routed_experts=spec.num_experts,
            n_shared_experts=spec.n_shared_experts,
            first_k_dense_replace=spec.first_k_dense_replace,
            routed_scaling_factor=spec.routed_scaling_factor,
            scoring_func="sigmoid" if spec.router_sigmoid else "softmax",
            n_group=spec.n_group,
            topk_group=spec.topk_group,
            attention_bias=spec.attn_bias,
            q_lora_rank=spec.q_lora_rank or None,
            kv_lora_rank=spec.kv_lora_rank,
            qk_rope_head_dim=spec.qk_rope_head_dim,
            qk_nope_head_dim=spec.qk_nope_head_dim,
            v_head_dim=spec.v_head_dim,
            rope_interleave=spec.rope_interleave,
        )
        if spec.family == "glm_moe_dsa":
            cfg.update(index_n_heads=spec.index_n_heads, index_head_dim=spec.index_head_dim,
                       index_topk=spec.index_topk)
    if spec.family == "glm4_moe":
        cfg.pop("num_experts", None)  # this config names it n_routed_experts
        cfg.update(
            n_routed_experts=spec.num_experts,
            n_shared_experts=spec.n_shared_experts,
            first_k_dense_replace=spec.first_k_dense_replace,
            routed_scaling_factor=spec.routed_scaling_factor,
            n_group=spec.n_group,
            topk_group=spec.topk_group,
            partial_rotary_factor=spec.partial_rotary_factor,
            use_qk_norm=spec.qk_norm,
            attention_bias=spec.attn_bias,
        )
    layer_types = ["sliding_attention" if w else "full_attention"
                   for w in layer_windows_list(spec)]
    if spec.family == "minimax_m2":
        cfg.pop("num_experts", None)  # this config names it num_local_experts
        cfg.pop("moe_intermediate_size", None)  # and reads the experts' width here
        cfg.update(
            num_local_experts=spec.num_experts,
            intermediate_size=spec.moe_intermediate_size,
            use_qk_norm=spec.qk_norm,
            qk_norm_type="per_layer" if spec.qk_norm_scope == "layer" else "per_head",
            rotary_dim=int(spec.head_dim * spec.partial_rotary_factor),
            scoring_func="sigmoid" if spec.router_sigmoid else "softmax",
            attention_bias=spec.attn_bias,
        )
    if spec.family == "afmoe":
        cfg.update(
            num_dense_layers=spec.first_k_dense_replace,
            num_shared_experts=spec.n_shared_experts,
            score_func="sigmoid" if spec.router_sigmoid else "softmax",
            route_scale=spec.routed_scaling_factor,
            route_norm=spec.norm_topk_prob,
            n_group=spec.n_group,
            topk_group=spec.topk_group,
            sliding_window=spec.sliding_window,
            layer_types=layer_types,
        )
    if spec.family == "laguna":
        rope = {"full_attention": {"rope_theta": spec.rope_theta,
                                   "partial_rotary_factor": spec.partial_rotary_factor}}
        if spec.rope_theta_local:
            rope["sliding_attention"] = {"rope_theta": spec.rope_theta_local}
        cfg.update(
            mlp_layer_types=["dense" if i < spec.first_k_dense_replace else "sparse"
                             for i in range(spec.num_layers)],
            shared_expert_intermediate_size=spec.shared_expert_size,
            moe_routed_scaling_factor=spec.routed_scaling_factor,
            sliding_window=spec.sliding_window,
            layer_types=layer_types,
            rope_parameters=rope,
            partial_rotary_factor=spec.partial_rotary_factor,
            attention_bias=spec.attn_bias,
        )
    if spec.family == "qwen3_next":
        cfg.update(
            layer_types=["linear_attention" if c == "L" else "full_attention"
                         for c in spec.gdn_pattern],
            linear_num_key_heads=spec.gdn_k_heads,
            linear_num_value_heads=spec.gdn_v_heads,
            linear_key_head_dim=spec.gdn_k_dim,
            linear_value_head_dim=spec.gdn_v_dim,
            linear_conv_kernel_dim=spec.gdn_conv_kernel,
            partial_rotary_factor=spec.partial_rotary_factor,
            shared_expert_intermediate_size=spec.shared_expert_size,
        )
    if spec.family == "nemotron_h":
        cfg.pop("num_experts", None)  # this config names it n_routed_experts
        cfg.pop("rms_norm_eps")  # and the norms' epsilon layer_norm_epsilon
        cfg.update(
            hybrid_override_pattern=spec.layer_pattern,
            bos_token_id=spec.bos_token_id,
            mamba_num_heads=spec.mamba_num_heads,
            mamba_head_dim=spec.mamba_head_dim,
            mamba_n_groups=spec.mamba_n_groups,
            ssm_state_size=spec.mamba_state_size,
            mamba_d_conv=spec.mamba_conv_kernel,
            mamba_chunk_size=spec.mamba_chunk_size,
            layer_norm_epsilon=spec.rms_eps,
            n_routed_experts=spec.num_experts,
            num_experts_per_tok=spec.num_experts_per_tok,
            moe_intermediate_size=spec.moe_intermediate_size,
            norm_topk_prob=spec.norm_topk_prob,
            moe_latent_size=spec.moe_latent_size or None,
            moe_shared_expert_intermediate_size=spec.moe_shared_expert_size,
            n_shared_experts=spec.n_shared_experts,
            routed_scaling_factor=spec.routed_scaling_factor,
            n_group=spec.n_group,
            topk_group=spec.topk_group,
            attention_bias=spec.attn_bias,
        )
    if spec.family == "gpt_oss":
        cfg.pop("num_experts", None)  # this config names it num_local_experts
        cfg.pop("moe_intermediate_size", None)  # and reads the experts' width here
        cfg.update(
            num_local_experts=spec.num_experts,
            intermediate_size=spec.moe_intermediate_size,
            sliding_window=spec.sliding_window,
            layer_types=layer_types,
            attention_bias=spec.attn_bias,
        )
        if spec.rope_yarn_factor:
            cfg["rope_scaling"] = {
                "rope_type": "yarn", "factor": spec.rope_yarn_factor,
                "original_max_position_embeddings": spec.rope_yarn_orig_max,
                "beta_fast": spec.rope_yarn_beta_fast, "beta_slow": spec.rope_yarn_beta_slow,
                "truncate": spec.rope_yarn_truncate,
            }
    return cfg


def save_hf_weights(params: Params, spec: ModelSpec, path: str | Path) -> Path:
    """Convert + write ``model.safetensors`` (bf16, the serving dtype) and
    ``config.json``, then the STABLE marker."""
    from safetensors.torch import save_file

    from prime_rl_tpu_torch.models import get_family

    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    state = get_family(spec).to_hf(params, spec)
    # contiguous matters: safetensors writes the raw buffer
    state = {k: torch.as_tensor(v).to(torch.bfloat16).contiguous() for k, v in state.items()}
    save_file(state, str(path / "model.safetensors"))
    (path / "config.json").write_text(json.dumps(spec_to_hf_config(spec), indent=2))
    pathing.mark_stable(path)
    return path


class WeightCheckpointManager:
    """Serving snapshots under ``weights/step_{N}`` with retention."""

    def __init__(self, output_dir: str | Path, config: WeightCheckpointConfig, spec: ModelSpec):
        self.output_dir = Path(output_dir)
        self.config = config
        self.spec = spec

    def save(self, params: Params, step: int) -> Path:
        path = save_hf_weights(params, self.spec, pathing.weights_dir(self.output_dir, step))
        self._retain()
        return path

    def _retain(self) -> None:
        keep = self.config.keep_last
        if keep is None:
            return
        steps = pathing.list_step_dirs(self.output_dir / "weights", stable_only=False)
        for s in steps[:-keep] if keep else steps:
            shutil.rmtree(pathing.weights_dir(self.output_dir, s), ignore_errors=True)

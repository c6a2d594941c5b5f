"""Model architecture specs: ``ModelSpec``, the built-in registry and the
HF ``config.json`` reader.

The port's own copy of the JAX package's ``models/base.py`` spec section
(``ModelSpec``, ``BUILTIN_SPECS``, ``debug_spec``, ``get_spec``,
``spec_from_hf_config``), field for field, so a spec means the same model in
both packages. Parameters are plain dicts of ``torch.Tensor``s; the sharding
rules of the JAX file are not part of this slice. The vision-language specs:
``debug_vlm``, the Qwen3-VL configs (dense and MoE), and the hybrid
``qwen3_next_vl`` (``debug_qwen3_next_vl``, or a Qwen3.5 config whose
architecture names Qwen3-Next or Qwen3_5 and which holds a ``vision_config``).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any

Params = dict[str, Any]

@dataclass(frozen=True)
class ModelSpec:
    family: str
    vocab_size: int
    hidden_size: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    intermediate_size: int
    rope_theta: float = 1_000_000.0
    rms_eps: float = 1e-6
    tie_embeddings: bool = True
    qk_norm: bool = True  # Qwen3 per-head q/k RMSNorm; off for llama
    max_position_embeddings: int = 40960
    bos_token_id: int | None = None
    eos_token_id: int = 151645
    pad_token_id: int = 151643
    # MoE (qwen3_moe family)
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_intermediate_size: int = 0
    norm_topk_prob: bool = True
    # Sliding-window attention (mistral / gpt-oss / gemma-style):
    # 0 = full attention everywhere. ``sliding_window_pattern`` n makes every
    # n-th layer full attention (n=1: all layers windowed).
    sliding_window: int = 0
    sliding_window_pattern: int = 1
    # Learned per-head attention sinks (gpt-oss style): a virtual always-
    # attendable token contributing only to the softmax denominator.
    attn_sinks: bool = False
    # Gemma-style final-logit softcap: logits = cap * tanh(logits / cap).
    # 0 disables (reference: models/layers/lm_head_gemma.py).
    final_logit_softcap: float = 0.0
    # gpt-oss axes (reference: trainer/models/gpt_oss/modeling_gpt_oss.py):
    attn_bias: bool = False  # q/k/v/o projection biases
    # clamped-GLU expert activation: (clip(up)+1) * g*sigmoid(alpha*g),
    # g = min(gate, limit). alpha 0 = standard SwiGLU.
    swiglu_alpha: float = 0.0
    swiglu_limit: float = 0.0
    expert_bias: bool = False  # per-expert gate/up/down biases
    router_bias: bool = False
    # routing style: softmax over the top-k LOGITS (gpt-oss) instead of
    # softmax over all experts then top-k (qwen3-moe)
    router_softmax_topk: bool = False
    # glm4_moe axes (reference: trainer/models/glm_moe_dsa/ — the GLM-4.5
    # MoE block; DSA sparse attention is a separate op):
    partial_rotary_factor: float = 1.0  # rope on the first fraction of head_dim
    n_shared_experts: int = 0  # always-on shared expert of size moe_inter * n
    first_k_dense_replace: int = 0  # first k layers use a dense MLP
    routed_scaling_factor: float = 1.0
    # sigmoid scoring + group-limited top-k with a correction bias used for
    # SELECTION only (DeepSeek-V3 noaux-tc routing)
    router_sigmoid: bool = False
    n_group: int = 1
    topk_group: int = 1
    # nemotron_h axes (reference: trainer/models/nemotron_h/ — hybrid Mamba):
    # per-layer block pattern string, one char per layer: M=mamba-2 mixer,
    # *=attention (no RoPE, position comes from the SSM layers), -=relu^2 MLP,
    # E=LatentMoE. Empty = homogeneous transformer (the other families).
    layer_pattern: str = ""
    mamba_num_heads: int = 0
    mamba_head_dim: int = 64
    mamba_n_groups: int = 8
    mamba_state_size: int = 128
    mamba_conv_kernel: int = 4
    mamba_chunk_size: int = 128
    moe_latent_size: int = 0  # LatentMoE projection dim (0 = no latent proj)
    moe_shared_expert_size: int = 0  # non-gated shared expert hidden dim
    # qwen3_vl axes (reference: trainer/models/qwen3_5/modeling_qwen3_5.py
    # VLM composition + qwen3_5_moe/mrope.py): a vision tower whose merged
    # embeddings scatter into image-token slots, interleaved mRoPE, and
    # DeepStack feature injection into the first decoder layers.
    vision: "Any | None" = None  # vision tower spec (models/vision.VisionSpec); None = text-only
    mrope_section: tuple[int, ...] = ()  # (t, h, w) frequency split; () = plain rope
    image_token_id: int = -1
    video_token_id: int = -1
    vision_start_token_id: int = -1
    # MLA / DSA axes (deepseek_v3, glm_moe_dsa — reference:
    # glm_moe_dsa/sparse_mla_attention.py SparseMlaAttentionArgs): latent
    # q/kv projections; index_topk > 0 turns on the DSA sparse indexer.
    q_lora_rank: int = 0
    kv_lora_rank: int = 0  # > 0 selects MLA attention
    qk_rope_head_dim: int = 0
    qk_nope_head_dim: int = 0
    v_head_dim: int = 0
    index_n_heads: int = 0
    index_head_dim: int = 0
    index_topk: int = 0  # 0 = dense MLA attention
    rope_interleave: bool = False  # interleaved (non-neox) rope pairing
    # YaRN rope scaling (gpt-oss 131k; 0 factor = off)
    rope_yarn_factor: float = 0.0
    rope_yarn_orig_max: int = 0
    rope_yarn_beta_fast: float = 32.0
    rope_yarn_beta_slow: float = 1.0
    rope_yarn_truncate: bool = True
    # minimax_m2 / afmoe / laguna axes (reference: trainer/models/minimax_m2/,
    # afmoe/, laguna/ modeling files):
    # "head" = per-head q/k RMSNorm (qwen3); "layer" = one RMSNorm over the
    # full flattened q_dim/kv_dim (MiniMax-M2 qk_norm_type="per_layer",
    # reference layers/attn.py:77-83,135-137)
    qk_norm_scope: str = "head"
    # attention output gating: "" = none; "sigmoid" = elementwise
    # out * sigmoid(W_g x) with W_g: [D, q_dim] (afmoe/qwen3.5 gated attn,
    # reference afmoe/modeling_afmoe.py:79,94); "softplus_head" = per-head
    # scalar out * softplus(W_g x) with W_g: [D, H] (laguna
    # modeling_laguna.py:124,130-131)
    attn_gate: str = ""
    # afmoe sandwich norms: post-attention and post-MLP RMSNorms applied to
    # the block OUTPUT before the residual add (modeling_afmoe.py:238-296)
    sandwich_norm: bool = False
    # laguna: absolute shared-expert hidden dim (SwiGLU, fed the same normed
    # input as the routed experts — modeling_laguna.py:173-177,212-216);
    # glm4_moe instead uses n_shared_experts * moe_intermediate_size
    shared_expert_size: int = 0
    # laguna: sliding-window layers use their own rope base (10k local vs
    # 500k full — configuration_laguna.py:124-127). 0 = same theta everywhere.
    rope_theta_local: float = 0.0
    # qwen3_next (Qwen3.5 / Qwen3-Next) hybrid axes (reference:
    # trainer/models/qwen3_5_moe/modeling_qwen3_5_moe.py GatedDeltaNet +
    # gated attention; HF Qwen3NextConfig field names): per-layer pattern
    # string, L = GatedDeltaNet linear attention, A = gated full attention.
    gdn_pattern: str = ""
    gdn_k_heads: int = 0   # linear_num_key_heads
    gdn_v_heads: int = 0   # linear_num_value_heads
    gdn_k_dim: int = 0     # linear_key_head_dim
    gdn_v_dim: int = 0     # linear_value_head_dim
    gdn_conv_kernel: int = 4  # linear_conv_kernel_dim
    # Qwen2-MoE-style scalar sigmoid gate on the shared expert output
    shared_expert_gate: bool = False

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def mamba_inter(self) -> int:
        return self.mamba_num_heads * self.mamba_head_dim

    @property
    def mamba_conv_dim(self) -> int:
        return self.mamba_inter + 2 * self.mamba_n_groups * self.mamba_state_size

    @property
    def gdn_key_dim(self) -> int:
        return self.gdn_k_heads * self.gdn_k_dim

    @property
    def gdn_value_dim(self) -> int:
        return self.gdn_v_heads * self.gdn_v_dim

    @property
    def gdn_conv_dim(self) -> int:
        return 2 * self.gdn_key_dim + self.gdn_value_dim

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    def flops_per_token(self, seq_len: int) -> float:
        """Training FLOPs/token (fwd+bwd ≈ 6×params-matmuls + attention term),
        the MFU denominator (reference: trainer/perf.py)."""
        d, l = self.hidden_size, self.num_layers
        if self.layer_pattern:
            return self._hybrid_flops_per_token(seq_len)
        if self.gdn_pattern:
            return self._gdn_flops_per_token(seq_len)
        attn_proj = 2 * d * (self.q_dim + 2 * self.kv_dim + self.q_dim)  # qkvo (o: q_dim x d)
        if self.attn_gate == "sigmoid":
            attn_proj += 2 * d * self.q_dim
        elif self.attn_gate == "softplus_head":
            attn_proj += 2 * d * self.num_heads
        moe_mlp_f = 0.0
        if self.is_moe:
            moe_mlp_f = 2 * 3 * d * self.moe_intermediate_size * self.num_experts_per_tok
            moe_mlp_f += 2 * d * self.num_experts  # router
            shared = self.shared_expert_size or self.n_shared_experts * self.moe_intermediate_size
            moe_mlp_f += 2 * 3 * d * shared
        dense_mlp_f = 2 * 3 * d * self.intermediate_size
        k_dense = self.first_k_dense_replace if self.is_moe else l
        dense = l * attn_proj + k_dense * dense_mlp_f + (l - k_dense) * (moe_mlp_f or dense_mlp_f)
        dense += 2 * d * self.vocab_size
        attn = l * 2 * 2 * seq_len * self.q_dim  # scores + values (causal: /2, but count full for parity)
        return 3 * (dense + attn)  # fwd(1) + bwd(2)

    def _hybrid_flops_per_token(self, seq_len: int) -> float:
        """Per-layer-type FLOPs for nemotron_h-style hybrids. Mamba SSD cost is
        the chunked-matmul estimate: intra-chunk quadratic blocks at chunk_size
        plus B/C state matmuls — sequence-length independent."""
        d = self.hidden_size
        inter, gn = self.mamba_inter, self.mamba_n_groups * self.mamba_state_size
        q, n = self.mamba_chunk_size, self.mamba_state_size
        flops = 2.0 * d * self.vocab_size
        for ch in self.layer_pattern:
            if ch == "M":
                f = 2 * d * (inter + self.mamba_conv_dim + self.mamba_num_heads)  # in_proj
                f += 2 * self.mamba_conv_dim * self.mamba_conv_kernel  # depthwise conv
                # SSD: scores CB^T (~2*q*gn) + intra combine (~2*q*inter) +
                # state build/apply (~2*2*n*inter)
                f += 2 * q * gn + 2 * q * inter + 4 * n * inter
                f += 2 * inter * d  # out_proj
            elif ch == "*":
                f = 2 * d * (self.q_dim + 2 * self.kv_dim + self.q_dim)
                f += 2 * 2 * seq_len * self.q_dim
            elif ch == "-":
                f = 2 * 2 * d * self.intermediate_size
            elif ch == "E":
                latent = self.moe_latent_size or d
                f = 2 * d * self.num_experts  # router
                if self.moe_latent_size:
                    f += 2 * 2 * d * latent
                f += 2 * 2 * latent * self.moe_intermediate_size * self.num_experts_per_tok
                f += 2 * 2 * d * self.moe_shared_expert_size
            else:
                raise ValueError(f"bad layer_pattern char {ch!r}")
            flops += f
        return 3 * flops

    def _gdn_flops_per_token(self, seq_len: int, chunk: int = 64) -> float:
        """qwen3_next hybrid: GDN layers cost O(chunk) per token (intra-chunk
        quadratic blocks + fast-weight state matmuls); attention layers pay
        the usual O(seq_len) term; every layer runs the MoE MLP."""
        d = self.hidden_size
        kd, vd = self.gdn_key_dim, self.gdn_value_dim
        hv, dk, dv = self.gdn_v_heads, self.gdn_k_dim, self.gdn_v_dim
        moe = 2 * 3 * d * self.moe_intermediate_size * self.num_experts_per_tok
        moe += 2 * d * self.num_experts
        moe += 2 * 3 * d * self.shared_expert_size
        flops = 2.0 * d * self.vocab_size
        for ch in self.gdn_pattern:
            if ch == "L":
                f = 2 * d * (2 * kd + 2 * vd + 2 * hv)        # in projections
                f += 2 * self.gdn_conv_dim * self.gdn_conv_kernel
                f += hv * (2 * chunk * (dk + dv) + 4 * dk * dv)  # delta rule
                f += 2 * vd * d                               # out proj
            elif ch == "A":
                f = 2 * d * (2 * self.q_dim + 2 * self.kv_dim + self.q_dim)
                f += 2 * 2 * seq_len * self.q_dim
            else:
                raise ValueError(f"bad gdn_pattern char {ch!r}")
            flops += f + moe
        return 3 * flops

    def num_params(self) -> int:
        d, l = self.hidden_size, self.num_layers
        if self.layer_pattern:
            total = self.vocab_size * d + d
            if not self.tie_embeddings:
                total += d * self.vocab_size
            inter = self.mamba_inter
            for ch in self.layer_pattern:
                p = d  # pre-mixer norm
                if ch == "M":
                    p += d * (inter + self.mamba_conv_dim + self.mamba_num_heads)
                    p += self.mamba_conv_dim * (self.mamba_conv_kernel + 1)
                    p += 3 * self.mamba_num_heads + inter + inter * d
                elif ch == "*":
                    p += d * (self.q_dim + 2 * self.kv_dim) + self.q_dim * d
                elif ch == "-":
                    p += 2 * d * self.intermediate_size
                elif ch == "E":
                    latent = self.moe_latent_size or d
                    p += d * self.num_experts + self.num_experts
                    if self.moe_latent_size:
                        p += 2 * d * latent
                    p += 2 * latent * self.moe_intermediate_size * self.num_experts
                    p += 2 * d * self.moe_shared_expert_size
                total += p
            return total
        if self.gdn_pattern:
            kd, vd, hv = self.gdn_key_dim, self.gdn_value_dim, self.gdn_v_heads
            moe_p = 3 * d * self.moe_intermediate_size * self.num_experts + d * self.num_experts
            moe_p += 3 * d * self.shared_expert_size + (d if self.shared_expert_gate else 0)
            total = self.vocab_size * d + d + (0 if self.tie_embeddings else d * self.vocab_size)
            for ch in self.gdn_pattern:
                if ch == "L":
                    p = d * (2 * kd + 2 * vd + 2 * hv)
                    p += self.gdn_conv_dim * self.gdn_conv_kernel
                    p += 2 * hv + self.gdn_v_dim + vd * d
                else:
                    p = d * (2 * self.q_dim + 2 * self.kv_dim) + self.q_dim * d
                    p += 2 * self.head_dim
                total += p + moe_p + 2 * d
            return total
        per_layer = d * (self.q_dim + 2 * self.kv_dim) + self.q_dim * d + 2 * d
        if self.qk_norm:
            per_layer += (self.q_dim + self.kv_dim) if self.qk_norm_scope == "layer" \
                else 2 * self.head_dim
        if self.attn_gate == "sigmoid":
            per_layer += d * self.q_dim
        elif self.attn_gate == "softplus_head":
            per_layer += d * self.num_heads
        if self.sandwich_norm:
            per_layer += 2 * d
        moe_p = dense_p = 3 * d * self.intermediate_size
        if self.is_moe:
            moe_p = 3 * d * self.moe_intermediate_size * self.num_experts + d * self.num_experts
            shared = self.shared_expert_size or self.n_shared_experts * self.moe_intermediate_size
            moe_p += 3 * d * shared
        k_dense = self.first_k_dense_replace if self.is_moe else l
        total = l * per_layer + k_dense * dense_p + (l - k_dense) * moe_p
        total += self.vocab_size * d + d
        if not self.tie_embeddings:
            total += d * self.vocab_size
        return total


# ---------------------------------------------------------------------------
# Built-in architecture registry (offline image: no HF hub). Sizes match the
# public configs of each checkpoint so random-init benches are architecture-
# faithful (reference models list: SURVEY.md §2.2 custom model families).
# ---------------------------------------------------------------------------

_QWEN3 = dict(family="qwen3", rope_theta=1e6, rms_eps=1e-6, qk_norm=True, vocab_size=151936)

BUILTIN_SPECS: dict[str, ModelSpec] = {
    "Qwen/Qwen3-0.6B": ModelSpec(
        hidden_size=1024, num_layers=28, num_heads=16, num_kv_heads=8, head_dim=128,
        intermediate_size=3072, tie_embeddings=True, **_QWEN3,
    ),
    "Qwen/Qwen3-1.7B": ModelSpec(
        hidden_size=2048, num_layers=28, num_heads=16, num_kv_heads=8, head_dim=128,
        intermediate_size=6144, tie_embeddings=True, **_QWEN3,
    ),
    "Qwen/Qwen3-4B": ModelSpec(
        hidden_size=2560, num_layers=36, num_heads=32, num_kv_heads=8, head_dim=128,
        intermediate_size=9728, tie_embeddings=True, **_QWEN3,
    ),
    "Qwen/Qwen3-8B": ModelSpec(
        hidden_size=4096, num_layers=36, num_heads=32, num_kv_heads=8, head_dim=128,
        intermediate_size=12288, tie_embeddings=False, **_QWEN3,
    ),
    "Qwen/Qwen3-14B": ModelSpec(
        hidden_size=5120, num_layers=40, num_heads=40, num_kv_heads=8, head_dim=128,
        intermediate_size=17408, tie_embeddings=False, **_QWEN3,
    ),
    "Qwen/Qwen3-30B-A3B": ModelSpec(
        hidden_size=2048, num_layers=48, num_heads=32, num_kv_heads=4, head_dim=128,
        intermediate_size=6144, tie_embeddings=False, num_experts=128,
        num_experts_per_tok=8, moe_intermediate_size=768, norm_topk_prob=True,
        **{**_QWEN3, "family": "qwen3_moe"},
    ),
    "meta-llama/Llama-3.2-1B": ModelSpec(
        family="llama", vocab_size=128256, hidden_size=2048, num_layers=16, num_heads=32,
        num_kv_heads=8, head_dim=64, intermediate_size=8192, rope_theta=500000.0,
        rms_eps=1e-5, tie_embeddings=True, qk_norm=False, max_position_embeddings=131072,
        eos_token_id=128001, pad_token_id=128001,
    ),
    "meta-llama/Llama-3.2-3B": ModelSpec(
        family="llama", vocab_size=128256, hidden_size=3072, num_layers=28, num_heads=24,
        num_kv_heads=8, head_dim=128, intermediate_size=8192, rope_theta=500000.0,
        rms_eps=1e-5, tie_embeddings=True, qk_norm=False, max_position_embeddings=131072,
        eos_token_id=128001, pad_token_id=128001,
    ),
    "meta-llama/Llama-3.1-8B": ModelSpec(
        family="llama", vocab_size=128256, hidden_size=4096, num_layers=32, num_heads=32,
        num_kv_heads=8, head_dim=128, intermediate_size=14336, rope_theta=500000.0,
        rms_eps=1e-5, tie_embeddings=False, qk_norm=False, max_position_embeddings=131072,
        eos_token_id=128001, pad_token_id=128001,
    ),
    "zai-org/GLM-4.5-Air": ModelSpec(
        family="glm4_moe", vocab_size=151552, hidden_size=4096, num_layers=46,
        num_heads=96, num_kv_heads=8, head_dim=128, intermediate_size=10944,
        rope_theta=1e6, rms_eps=1e-5, tie_embeddings=False, qk_norm=True,
        max_position_embeddings=131072, eos_token_id=151329, pad_token_id=151329,
        num_experts=128, num_experts_per_tok=8, moe_intermediate_size=1408,
        norm_topk_prob=True, partial_rotary_factor=0.5, n_shared_experts=1,
        first_k_dense_replace=1, routed_scaling_factor=1.0, router_sigmoid=True,
        n_group=1, topk_group=1,
    ),
    "zai-org/GLM-4.5": ModelSpec(
        family="glm4_moe", vocab_size=151552, hidden_size=5120, num_layers=92,
        num_heads=96, num_kv_heads=8, head_dim=128, intermediate_size=12288,
        rope_theta=1e6, rms_eps=1e-5, tie_embeddings=False, qk_norm=True,
        max_position_embeddings=131072, eos_token_id=151329, pad_token_id=151329,
        num_experts=160, num_experts_per_tok=8, moe_intermediate_size=1536,
        norm_topk_prob=True, partial_rotary_factor=0.5, n_shared_experts=1,
        first_k_dense_replace=3, routed_scaling_factor=2.5, router_sigmoid=True,
        n_group=1, topk_group=1,
    ),
    "openai/gpt-oss-20b": ModelSpec(
        family="gpt_oss", vocab_size=201088, hidden_size=2880, num_layers=24,
        num_heads=64, num_kv_heads=8, head_dim=64, intermediate_size=2880,
        rope_theta=150000.0, rms_eps=1e-5, tie_embeddings=False, qk_norm=False,
        max_position_embeddings=131072, eos_token_id=200002, pad_token_id=199999,
        num_experts=32, num_experts_per_tok=4, moe_intermediate_size=2880,
        sliding_window=128, sliding_window_pattern=2, attn_sinks=True,
        attn_bias=True, swiglu_alpha=1.702, swiglu_limit=7.0,
        expert_bias=True, router_bias=True, router_softmax_topk=True,
        rope_yarn_factor=32.0, rope_yarn_orig_max=4096, rope_yarn_truncate=False,
    ),
    "openai/gpt-oss-120b": ModelSpec(
        family="gpt_oss", vocab_size=201088, hidden_size=2880, num_layers=36,
        num_heads=64, num_kv_heads=8, head_dim=64, intermediate_size=2880,
        rope_theta=150000.0, rms_eps=1e-5, tie_embeddings=False, qk_norm=False,
        max_position_embeddings=131072, eos_token_id=200002, pad_token_id=199999,
        num_experts=128, num_experts_per_tok=4, moe_intermediate_size=2880,
        sliding_window=128, sliding_window_pattern=2, attn_sinks=True,
        attn_bias=True, swiglu_alpha=1.702, swiglu_limit=7.0,
        expert_bias=True, router_bias=True, router_softmax_topk=True,
        rope_yarn_factor=32.0, rope_yarn_orig_max=4096, rope_yarn_truncate=False,
    ),
    # Nemotron-H 8B class (reference: trainer/models/nemotron_h/
    # configuration_nemotron_h.py defaults = the 8B dims). Composition is the
    # paper's 24 Mamba-2 / 4 attention / 24 relu^2-MLP in 52 layers with
    # attention evenly spaced; load a local checkpoint dir to use the exact
    # shipped hybrid_override_pattern.
    "nvidia/Nemotron-H-8B-Base-8K": ModelSpec(
        family="nemotron_h", vocab_size=131072, hidden_size=4096, num_layers=52,
        num_heads=32, num_kv_heads=8, head_dim=128, intermediate_size=21504,
        rms_eps=1e-5, tie_embeddings=False, qk_norm=False,
        max_position_embeddings=8192, bos_token_id=1, eos_token_id=2, pad_token_id=0,
        layer_pattern=("M-" * 6 + "*") * 4,  # 52 layers: 24 M / 24 - / 4 *
        mamba_num_heads=128, mamba_head_dim=64, mamba_n_groups=8,
        mamba_state_size=128, mamba_conv_kernel=4, mamba_chunk_size=128,
        router_sigmoid=True,  # NemotronH's routing (unused: no "E" layer)
    ),
    # MiniMaxAI/MiniMax-M2's published config.json: sigmoid + bias routing,
    # a layer-scope qk-norm, rotary over 64 of 128 dims, 256 experts of 1536.
    # (The JAX package's table gives 6144 wide, 92 layers and experts of
    # 24576, which is not the published model.)
    "MiniMaxAI/MiniMax-M2": ModelSpec(
        family="minimax_m2", vocab_size=200064, hidden_size=3072, num_layers=62,
        num_heads=48, num_kv_heads=8, head_dim=128, intermediate_size=1536,
        rope_theta=5e6, rms_eps=1e-6, tie_embeddings=False, qk_norm=True,
        qk_norm_scope="layer", max_position_embeddings=131072,
        eos_token_id=2, pad_token_id=0,
        num_experts=256, num_experts_per_tok=8, moe_intermediate_size=1536,
        norm_topk_prob=True, router_sigmoid=True, partial_rotary_factor=0.5,
    ),
    # ByteTokenizer-compatible tiny model for the offline sync-GRPO debug loop
    # (vocab 512 covers the 260-token byte vocab; eos = <|im_end|> = 258)
    "debug": ModelSpec(
        family="qwen3", vocab_size=512, hidden_size=128, num_layers=4, num_heads=4,
        num_kv_heads=2, head_dim=32, intermediate_size=256, rope_theta=1e6,
        tie_embeddings=True, qk_norm=True, eos_token_id=258, pad_token_id=256,
    ),
    "debug_moe": ModelSpec(
        family="qwen3_moe", vocab_size=512, hidden_size=128, num_layers=2, num_heads=4,
        num_kv_heads=2, head_dim=32, intermediate_size=256, rope_theta=1e6,
        tie_embeddings=True, qk_norm=True, eos_token_id=258, pad_token_id=256,
        num_experts=8, num_experts_per_tok=2, moe_intermediate_size=64,
    ),
    # Qwen3-Next-80B-A3B class (HF Qwen3NextConfig defaults; reference
    # qwen3_5_moe hybrid): 48 layers LLLA, 512 experts top-10
    "Qwen/Qwen3-Next-80B-A3B-Instruct": ModelSpec(
        family="qwen3_next", vocab_size=151936, hidden_size=2048, num_layers=48,
        num_heads=16, num_kv_heads=2, head_dim=256, intermediate_size=5632,
        rope_theta=10000.0, rms_eps=1e-6, tie_embeddings=False, qk_norm=True,
        max_position_embeddings=262144, eos_token_id=151645, pad_token_id=151643,
        num_experts=512, num_experts_per_tok=10, moe_intermediate_size=512,
        norm_topk_prob=True, shared_expert_size=512, shared_expert_gate=True,
        attn_gate="sigmoid", partial_rotary_factor=0.25,
        gdn_pattern="LLLA" * 12, gdn_k_heads=16, gdn_v_heads=32,
        gdn_k_dim=128, gdn_v_dim=128, gdn_conv_kernel=4,
    ),
    # tiny qwen3_next debug spec: both layer types + MoE + shared gate
    "debug_qwen3_next": ModelSpec(
        family="qwen3_next", vocab_size=512, hidden_size=128, num_layers=4,
        num_heads=4, num_kv_heads=2, head_dim=32, intermediate_size=256,
        rope_theta=1e4, tie_embeddings=True, qk_norm=True,
        eos_token_id=258, pad_token_id=256,
        num_experts=8, num_experts_per_tok=2, moe_intermediate_size=64,
        norm_topk_prob=True, shared_expert_size=96, shared_expert_gate=True,
        attn_gate="sigmoid", partial_rotary_factor=0.25,
        gdn_pattern="LLLA", gdn_k_heads=2, gdn_v_heads=4,
        gdn_k_dim=16, gdn_v_dim=16, gdn_conv_kernel=4,
    ),
    # tiny gated-MoE family debug specs (minimax_m2 / afmoe / laguna axes)
    "debug_minimax": ModelSpec(
        family="minimax_m2", vocab_size=512, hidden_size=128, num_layers=2,
        num_heads=4, num_kv_heads=2, head_dim=32, intermediate_size=256,
        rope_theta=5e6, tie_embeddings=True, qk_norm=True, qk_norm_scope="layer",
        eos_token_id=258, pad_token_id=256, partial_rotary_factor=0.5,
        num_experts=8, num_experts_per_tok=2, moe_intermediate_size=64,
        router_sigmoid=True, norm_topk_prob=True,
    ),
    "debug_afmoe": ModelSpec(
        family="afmoe", vocab_size=512, hidden_size=128, num_layers=4,
        num_heads=4, num_kv_heads=2, head_dim=32, intermediate_size=256,
        rope_theta=1e4, rms_eps=1e-5, tie_embeddings=True, qk_norm=True,
        eos_token_id=258, pad_token_id=256, attn_gate="sigmoid",
        sandwich_norm=True, sliding_window=64, sliding_window_pattern=2,
        num_experts=8, num_experts_per_tok=2, moe_intermediate_size=64,
        n_shared_experts=2, first_k_dense_replace=1, router_sigmoid=True,
        norm_topk_prob=True,
    ),
    "debug_laguna": ModelSpec(
        family="laguna", vocab_size=512, hidden_size=128, num_layers=4,
        num_heads=4, num_kv_heads=2, head_dim=32, intermediate_size=256,
        rope_theta=5e5, rope_theta_local=1e4, tie_embeddings=True, qk_norm=True,
        eos_token_id=258, pad_token_id=256, attn_gate="softplus_head",
        sliding_window=64, sliding_window_pattern=2,
        num_experts=8, num_experts_per_tok=2, moe_intermediate_size=64,
        shared_expert_size=96, first_k_dense_replace=1, router_sigmoid=True,
        norm_topk_prob=True, routed_scaling_factor=1.5,
    ),
    # hybrid-Mamba debug spec exercising all four nemotron_h block types
    "debug_nemotron": ModelSpec(
        family="nemotron_h", vocab_size=512, hidden_size=128, num_layers=4,
        num_heads=4, num_kv_heads=2, head_dim=32, intermediate_size=256,
        rms_eps=1e-5, tie_embeddings=True, qk_norm=False,
        eos_token_id=258, pad_token_id=256, layer_pattern="M*-E",
        mamba_num_heads=4, mamba_head_dim=32, mamba_n_groups=2,
        mamba_state_size=16, mamba_conv_kernel=4, mamba_chunk_size=32,
        num_experts=4, num_experts_per_tok=2, moe_intermediate_size=64,
        moe_latent_size=64, moe_shared_expert_size=64, router_sigmoid=True,
        n_group=1, topk_group=1,
    ),
}


def debug_spec(
    vocab_size: int = 512,
    hidden_size: int = 64,
    num_layers: int = 2,
    num_heads: int = 4,
    num_kv_heads: int = 2,
    head_dim: int = 16,
    intermediate_size: int = 128,
    family: str = "qwen3",
    **kw,
) -> ModelSpec:
    return ModelSpec(
        family=family, vocab_size=vocab_size, hidden_size=hidden_size, num_layers=num_layers,
        num_heads=num_heads, num_kv_heads=num_kv_heads, head_dim=head_dim,
        intermediate_size=intermediate_size, eos_token_id=vocab_size - 1, pad_token_id=0, **kw,
    )


def get_spec(name: str, num_layers: int | None = None,
             vocab_size: int | None = None) -> ModelSpec:
    """Resolve a model name to a spec: built-in registry, or a local HF
    checkpoint dir with config.json. ``num_layers`` truncates for debug
    (reference: trainer/model.py:656-663); ``vocab_size`` truncates the
    vocab for byte-tokenizer smoke runs (eos/pad remap to the ChatML byte
    ids when the family's own ids fall outside the truncated range)."""
    import json
    from pathlib import Path

    if name == "debug_vlm":
        # ByteTokenizer-compatible tiny VLM for the offline VLM RL debug loop
        # (vision token ids sit above the 260-token byte vocab); lazy so the
        # base module never imports models/vision at import time
        from prime_rl_tpu_torch.models.vision import VisionSpec

        spec = ModelSpec(
            family="qwen3_vl", vocab_size=512, hidden_size=128, num_layers=2,
            num_heads=4, num_kv_heads=2, head_dim=32, intermediate_size=256,
            rope_theta=1e6, tie_embeddings=False, qk_norm=True,
            eos_token_id=258, pad_token_id=256,
            mrope_section=(8, 4, 4), vision_start_token_id=300,
            image_token_id=301, video_token_id=302,
            vision=VisionSpec(
                depth=2, hidden_size=32, intermediate_size=64, num_heads=4,
                in_channels=3, patch_size=4, temporal_patch_size=2,
                spatial_merge_size=2, out_hidden_size=128,
                num_position_embeddings=16, deepstack_visual_indexes=(0,),
            ),
        )
    elif name == "debug_qwen3_next_vl":
        # tiny Qwen3.5-style hybrid VLM (the GatedDeltaNet trunk + the tower)
        from prime_rl_tpu_torch.models.vision import VisionSpec

        spec = replace(
            BUILTIN_SPECS["debug_qwen3_next"],
            family="qwen3_next_vl", tie_embeddings=False,
            mrope_section=(2, 1, 1), vision_start_token_id=300,
            image_token_id=301, video_token_id=302,
            vision=VisionSpec(
                depth=2, hidden_size=32, intermediate_size=64, num_heads=4,
                in_channels=3, patch_size=4, temporal_patch_size=2,
                spatial_merge_size=2, out_hidden_size=128,
                num_position_embeddings=16, deepstack_visual_indexes=(0,),
            ),
        )
    elif name in BUILTIN_SPECS:
        spec = BUILTIN_SPECS[name]
    elif (Path(name) / "config.json").exists():
        cfg = json.loads((Path(name) / "config.json").read_text())
        spec = spec_from_hf_config(cfg)
    else:
        raise ValueError(f"unknown model {name!r}: not in BUILTIN_SPECS and no local config.json")
    if num_layers is not None:
        spec = replace(spec, num_layers=num_layers)
    if vocab_size is not None:
        if vocab_size < 260:
            raise ValueError(
                f"debug vocab_size {vocab_size} < 260: must cover the byte "
                f"vocab (256 bytes + ChatML specials)")
        updates: dict = {"vocab_size": vocab_size}
        if spec.eos_token_id is not None and spec.eos_token_id >= vocab_size:
            updates["eos_token_id"] = 258  # ByteTokenizer <|im_end|>
        if spec.pad_token_id is not None and spec.pad_token_id >= vocab_size:
            updates["pad_token_id"] = 256
        spec = replace(spec, **updates)
    return spec


def _window_pattern_from_layer_types(
    layer_types: list, sliding_window: int, default_pattern: int
) -> tuple[int, int]:
    """(sliding_window, pattern) from an HF ``layer_types`` list. Supports
    the periodic "every n-th layer full" layouts the built-in families use
    (afmoe configuration_afmoe.py:91-95; laguna all-full default); raises on
    aperiodic mixes."""
    if not sliding_window:
        return 0, 1
    if not layer_types:
        # default_pattern 0 = "this family's HF default is all-full" (laguna
        # configuration_laguna.py:98): sliding only applies via layer_types
        if default_pattern <= 0:
            return 0, 1
        return sliding_window, default_pattern
    is_full = [t == "full_attention" for t in layer_types]
    if all(is_full):
        return 0, 1
    if not any(is_full):
        return sliding_window, 1
    n = len(is_full)
    for pat in range(2, n + 1):
        if all(f == (i % pat == pat - 1) for i, f in enumerate(is_full)):
            return sliding_window, pat
    raise ValueError(f"unsupported aperiodic layer_types layout: {layer_types}")


def spec_from_hf_config(cfg: dict) -> ModelSpec:
    arch = (cfg.get("architectures") or ["Qwen3ForCausalLM"])[0].lower()
    if "qwen3vl" in arch.replace("_", ""):
        return _vlm_spec_from_hf_config(cfg, arch)
    if "nemotronh" in arch.replace("_", ""):
        family = "nemotron_h"
    elif "glmmoedsa" in arch.replace("_", ""):
        family = "glm_moe_dsa"
    elif "deepseekv3" in arch.replace("_", ""):
        family = "deepseek_v3"
    elif "gptoss" in arch.replace("_", ""):
        family = "gpt_oss"
    elif "glm4moe" in arch.replace("_", ""):
        family = "glm4_moe"
    elif "qwen3moe" in arch.replace("_", ""):
        family = "qwen3_moe"
    elif "qwen3next" in arch.replace("_", "") or "qwen3_5" in arch:
        if "vision_config" in cfg:
            return _qwen3_next_vl_spec_from_hf_config(cfg)
        family = "qwen3_next"
    elif "minimaxm2" in arch.replace("_", ""):
        family = "minimax_m2"
    elif "afmoe" in arch:
        family = "afmoe"
    elif "laguna" in arch:
        family = "laguna"
    elif "qwen3" in arch:
        family = "qwen3"
    elif "llama" in arch:
        family = "llama"
    else:
        raise ValueError(f"unsupported architecture {arch}")
    head_dim = cfg.get("head_dim") or cfg["hidden_size"] // cfg["num_attention_heads"]
    extra: dict = {}
    if family in ("deepseek_v3", "glm_moe_dsa"):
        extra = dict(
            num_experts=cfg.get("n_routed_experts", 0) or 0,
            qk_norm=False,
            n_shared_experts=int(cfg.get("n_shared_experts", 0) or 0),
            first_k_dense_replace=int(cfg.get("first_k_dense_replace", 0) or 0),
            routed_scaling_factor=float(cfg.get("routed_scaling_factor", 1.0)),
            router_sigmoid=(cfg.get("scoring_func", "sigmoid") == "sigmoid"),
            n_group=int(cfg.get("n_group", 1) or 1),
            topk_group=int(cfg.get("topk_group", 1) or 1),
            attn_bias=bool(cfg.get("attention_bias", False)),
            q_lora_rank=int(cfg.get("q_lora_rank") or 0),
            kv_lora_rank=int(cfg["kv_lora_rank"]),
            qk_rope_head_dim=int(cfg["qk_rope_head_dim"]),
            qk_nope_head_dim=int(cfg["qk_nope_head_dim"]),
            v_head_dim=int(cfg["v_head_dim"]),
            rope_interleave=bool(cfg.get("rope_interleave", True)),
        )
        head_dim = int(cfg["qk_nope_head_dim"]) + int(cfg["qk_rope_head_dim"])
        if family == "glm_moe_dsa":
            extra.update(
                index_n_heads=int(cfg.get("index_n_heads", 32)),
                index_head_dim=int(cfg.get("index_head_dim", 128)),
                index_topk=int(cfg.get("index_topk", 2048)),
            )
    if family == "glm4_moe":
        extra = dict(
            num_experts=cfg.get("n_routed_experts", 0) or 0,
            qk_norm=bool(cfg.get("use_qk_norm", False)),
            partial_rotary_factor=float(cfg.get("partial_rotary_factor", 1.0)),
            n_shared_experts=int(cfg.get("n_shared_experts", 0) or 0),
            first_k_dense_replace=int(cfg.get("first_k_dense_replace", 0) or 0),
            routed_scaling_factor=float(cfg.get("routed_scaling_factor", 1.0)),
            router_sigmoid=True,
            n_group=int(cfg.get("n_group", 1) or 1),
            topk_group=int(cfg.get("topk_group", 1) or 1),
            attn_bias=bool(cfg.get("attention_bias", False)),
        )
    if family == "nemotron_h":
        # reference: nemotron_h/configuration_nemotron_h.py:129-141 —
        # hybrid_override_pattern string or layers_block_type list
        if "hybrid_override_pattern" in cfg:
            pattern = cfg["hybrid_override_pattern"]
        else:
            char = {"mamba": "M", "attention": "*", "mlp": "-", "moe": "E"}
            pattern = "".join(char[t] for t in cfg["layers_block_type"])
        cfg.setdefault("num_hidden_layers", len(pattern))
        extra = dict(
            layer_pattern=pattern,
            bos_token_id=cfg.get("bos_token_id"),
            mamba_num_heads=int(cfg.get("mamba_num_heads", 128)),
            mamba_head_dim=int(cfg.get("mamba_head_dim", 64)),
            mamba_n_groups=int(cfg.get("mamba_n_groups", 8)),
            mamba_state_size=int(cfg.get("ssm_state_size", 128)),
            mamba_conv_kernel=int(cfg.get("mamba_d_conv", 4)),
            mamba_chunk_size=int(cfg.get("mamba_chunk_size", 128)),
            num_experts=int(cfg.get("n_routed_experts", 0) or 0),
            moe_latent_size=int(cfg.get("moe_latent_size") or 0),
            moe_shared_expert_size=int(cfg.get("moe_shared_expert_intermediate_size", 0) or 0),
            n_shared_experts=int(cfg.get("n_shared_experts", 0) or 0),
            routed_scaling_factor=float(cfg.get("routed_scaling_factor", 1.0)),
            router_sigmoid=True,
            n_group=int(cfg.get("n_group", 1) or 1),
            topk_group=int(cfg.get("topk_group", 1) or 1),
            rms_eps=float(cfg.get("layer_norm_epsilon", 1e-5)),
            attn_bias=bool(cfg.get("attention_bias", False)),
        )
    if family == "qwen3_next":
        # reference: qwen3_5_moe/modeling_qwen3_5_moe.py + HF Qwen3NextConfig —
        # layer_types linear_attention/full_attention, GDN dims, gated full
        # attention (fused q+gate proj), MoE with sigmoid-gated shared expert
        lt = cfg.get("layer_types") or [
            "full_attention" if (i + 1) % 4 == 0 else "linear_attention"
            for i in range(cfg["num_hidden_layers"])
        ]
        extra = dict(
            gdn_pattern="".join("A" if t == "full_attention" else "L" for t in lt),
            gdn_k_heads=int(cfg.get("linear_num_key_heads", 16)),
            gdn_v_heads=int(cfg.get("linear_num_value_heads", 32)),
            gdn_k_dim=int(cfg.get("linear_key_head_dim", 128)),
            gdn_v_dim=int(cfg.get("linear_value_head_dim", 128)),
            gdn_conv_kernel=int(cfg.get("linear_conv_kernel_dim", 4)),
            attn_gate="sigmoid", qk_norm=True,
            partial_rotary_factor=float(cfg.get("partial_rotary_factor", 0.25)),
            num_experts=int(cfg.get("num_experts", 0) or 0),
            shared_expert_size=int(cfg.get("shared_expert_intermediate_size", 0) or 0),
            shared_expert_gate=True,
        )
    if family == "minimax_m2":
        # reference: minimax_m2/configuration_minimax_m2.py (rotary_dim ->
        # partial factor; sigmoid scoring + e_score_correction_bias routing;
        # qk_norm_type "per_layer" = full-width q/k norms)
        extra = dict(
            num_experts=int(cfg.get("num_local_experts", 256)),
            moe_intermediate_size=cfg["intermediate_size"],
            qk_norm=bool(cfg.get("use_qk_norm", True)),
            qk_norm_scope=("layer" if cfg.get("qk_norm_type", "per_layer") == "per_layer"
                           else "head"),
            partial_rotary_factor=float(cfg.get("rotary_dim", head_dim)) / head_dim,
            router_sigmoid=(cfg.get("scoring_func", "sigmoid") == "sigmoid"),
            attn_bias=bool(cfg.get("attention_bias", False)),
            norm_topk_prob=True,  # route_norm=True in MoEArgs (modeling_minimax_m2.py:48)
        )
    if family == "afmoe":
        # reference: afmoe/configuration_afmoe.py + modeling_afmoe.py —
        # sliding layers with a full layer every global_attn_every_n_layers,
        # sandwich norms, sigmoid attention-output gate, sigmoid-scored MoE
        # with shared experts and the first num_dense_layers dense
        lt = cfg.get("layer_types") or []
        win, pat = _window_pattern_from_layer_types(
            lt, int(cfg.get("sliding_window", 0) or 0),
            int(cfg.get("global_attn_every_n_layers", 4)))
        extra = dict(
            num_experts=int(cfg.get("num_experts", 0) or 0),
            first_k_dense_replace=int(cfg.get("num_dense_layers", 0) or 0),
            n_shared_experts=int(cfg.get("num_shared_experts", 0) or 0),
            router_sigmoid=(cfg.get("score_func", "sigmoid") == "sigmoid"),
            routed_scaling_factor=float(cfg.get("route_scale", 1.0)),
            norm_topk_prob=bool(cfg.get("route_norm", True)),
            n_group=int(cfg.get("n_group", 1) or 1),
            topk_group=int(cfg.get("topk_group", 1) or 1),
            qk_norm=True, attn_gate="sigmoid", sandwich_norm=True,
            sliding_window=win, sliding_window_pattern=pat,
        )
    if family == "laguna":
        # reference: laguna/configuration_laguna.py + modeling_laguna.py —
        # per-head softplus attention gate, per-layer-type rope theta
        # (full 500k / sliding 10k), sigmoid+bias routing with a separate
        # absolute-size shared expert; first mlp_layer_types "dense" layers
        # map to first_k_dense_replace
        lt = cfg.get("layer_types") or []
        win, pat = _window_pattern_from_layer_types(
            lt, int(cfg.get("sliding_window", 0) or 0), 0)
        mlt = cfg.get("mlp_layer_types") or ["dense"] + ["sparse"] * (cfg["num_hidden_layers"] - 1)
        k_dense = next((i for i, t in enumerate(mlt) if t == "sparse"), len(mlt))
        if any(t != "sparse" for t in mlt[k_dense:]):
            raise ValueError("laguna: only dense-prefix mlp_layer_types layouts are supported")
        heads_pl = cfg.get("num_attention_heads_per_layer")
        if heads_pl and len(set(heads_pl)) > 1:
            raise ValueError("laguna: varying num_attention_heads_per_layer is not supported")
        rp = cfg.get("rope_parameters") or cfg.get("rope_scaling") or {}
        theta_full = theta_local = float(cfg.get("rope_theta", 500000.0))
        prf = cfg.get("partial_rotary_factor")
        if isinstance(rp, dict) and "full_attention" in rp:
            theta_full = float(rp["full_attention"].get("rope_theta", 500000.0))
            theta_local = float(rp.get("sliding_attention", {}).get("rope_theta", 10000.0))
            prf = prf or rp["full_attention"].get("partial_rotary_factor")
        extra = dict(
            num_experts=int(cfg.get("num_experts", 0) or 0),
            first_k_dense_replace=k_dense,
            shared_expert_size=int(cfg.get("shared_expert_intermediate_size", 0) or 0),
            router_sigmoid=True, norm_topk_prob=True,
            routed_scaling_factor=float(cfg.get("moe_routed_scaling_factor", 1.0)),
            qk_norm=True, attn_gate="softplus_head",
            sliding_window=win, sliding_window_pattern=pat,
            rope_theta=theta_full, rope_theta_local=theta_local if win else 0.0,
            partial_rotary_factor=float(prf or 1.0),
            attn_bias=bool(cfg.get("attention_bias", False)),
        )
        if cfg.get("moe_router_logit_softcapping"):
            # parity with the reference (modeling_laguna.py:172)
            raise NotImplementedError("laguna router logit softcapping is not supported")
    if family == "gpt_oss":
        rs = cfg.get("rope_scaling") or {}
        lt = cfg.get("layer_types") or []
        extra = dict(
            num_experts=cfg.get("num_local_experts", 0) or 0,
            moe_intermediate_size=cfg["intermediate_size"],
            sliding_window=cfg.get("sliding_window", 0) or 0,
            sliding_window_pattern=2 if "full_attention" in lt or not lt else 1,
            attn_sinks=True, attn_bias=cfg.get("attention_bias", True),
            swiglu_alpha=1.702, swiglu_limit=7.0,
            expert_bias=True, router_bias=True, router_softmax_topk=True,
            rope_yarn_factor=float(rs.get("factor", 0.0) or 0.0),
            rope_yarn_orig_max=int(rs.get("original_max_position_embeddings", 0) or 0),
            rope_yarn_beta_fast=float(rs.get("beta_fast", 32.0) or 32.0),
            rope_yarn_beta_slow=float(rs.get("beta_slow", 1.0) or 1.0),
            rope_yarn_truncate=bool(rs.get("truncate", True)),
        )
    kw = dict(
        family=family,
        vocab_size=cfg["vocab_size"],
        hidden_size=cfg["hidden_size"],
        num_layers=cfg["num_hidden_layers"],
        num_heads=cfg["num_attention_heads"],
        num_kv_heads=cfg.get("num_key_value_heads", cfg["num_attention_heads"]),
        head_dim=head_dim,
        intermediate_size=cfg["intermediate_size"],
        rope_theta=cfg.get("rope_theta", 1e6),
        rms_eps=cfg.get("rms_norm_eps", 1e-6),
        tie_embeddings=cfg.get("tie_word_embeddings", False),
        qk_norm=family.startswith("qwen3"),
        max_position_embeddings=cfg.get("max_position_embeddings", 40960),
        eos_token_id=cfg.get("eos_token_id", 151645) if not isinstance(cfg.get("eos_token_id"), list) else cfg["eos_token_id"][0],
        pad_token_id=cfg.get("pad_token_id") or 0,
        num_experts=cfg.get("num_experts", 0) or 0,
        num_experts_per_tok=cfg.get("num_experts_per_tok", 0) or 0,
        moe_intermediate_size=cfg.get("moe_intermediate_size", 0) or 0,
        norm_topk_prob=cfg.get("norm_topk_prob", True),
    )
    kw.update(extra)
    return ModelSpec(**kw)



def _vision_spec(vc: dict):
    """The tower's ``VisionSpec`` from an HF ``vision_config``."""
    from prime_rl_tpu_torch.models.vision import VisionSpec

    return VisionSpec(
        depth=vc["depth"],
        hidden_size=vc["hidden_size"],
        intermediate_size=vc["intermediate_size"],
        num_heads=vc["num_heads"],
        in_channels=vc.get("in_channels", 3),
        patch_size=vc["patch_size"],
        temporal_patch_size=vc.get("temporal_patch_size", 2),
        spatial_merge_size=vc.get("spatial_merge_size", 2),
        out_hidden_size=vc["out_hidden_size"],
        num_position_embeddings=vc["num_position_embeddings"],
        deepstack_visual_indexes=tuple(vc.get("deepstack_visual_indexes", ())),
    )


def _qwen3_next_vl_spec_from_hf_config(cfg: dict) -> ModelSpec:
    """Qwen3.5-style VLM: the qwen3_next trunk (a nested ``text_config``),
    the Qwen3-VL tower (``vision_config``) and the mRoPE section and vision
    token ids, read as the JAX package reads them (an mRoPE section from the
    text config's ``rope_scaling``, else the top level's, else (16, 8, 8))."""
    tc = dict(cfg["text_config"])
    tc.setdefault("architectures", ["Qwen3NextForCausalLM"])
    rs = tc.get("rope_scaling") or {}
    return replace(
        spec_from_hf_config(tc),
        family="qwen3_next_vl",
        mrope_section=tuple(rs.get("mrope_section",
                                   (cfg.get("rope_scaling") or {}).get("mrope_section",
                                                                       (16, 8, 8)))),
        image_token_id=int(cfg.get("image_token_id", 151655)),
        video_token_id=int(cfg.get("video_token_id", 151656)),
        vision_start_token_id=int(cfg.get("vision_start_token_id", 151652)),
        vision=_vision_spec(cfg["vision_config"]),
    )


def _vlm_spec_from_hf_config(cfg: dict, arch: str) -> ModelSpec:
    """Qwen3-VL dense/MoE: nested text_config/vision_config (HF
    Qwen3VLConfig layout)."""
    tc, vc = cfg["text_config"], cfg["vision_config"]
    is_moe = "moe" in arch
    rs = tc.get("rope_scaling") or {}
    head_dim = tc.get("head_dim") or tc["hidden_size"] // tc["num_attention_heads"]
    eos = tc.get("eos_token_id", cfg.get("eos_token_id", 151645))
    return ModelSpec(
        family="qwen3_vl_moe" if is_moe else "qwen3_vl",
        vocab_size=tc["vocab_size"],
        hidden_size=tc["hidden_size"],
        num_layers=tc["num_hidden_layers"],
        num_heads=tc["num_attention_heads"],
        num_kv_heads=tc.get("num_key_value_heads", tc["num_attention_heads"]),
        head_dim=head_dim,
        intermediate_size=tc["intermediate_size"],
        rope_theta=tc.get("rope_theta", 5e6),
        rms_eps=tc.get("rms_norm_eps", 1e-6),
        tie_embeddings=cfg.get("tie_word_embeddings", tc.get("tie_word_embeddings", False)),
        qk_norm=True,
        max_position_embeddings=tc.get("max_position_embeddings", 262144),
        eos_token_id=eos if not isinstance(eos, list) else eos[0],
        pad_token_id=tc.get("pad_token_id") or 0,
        attn_bias=bool(tc.get("attention_bias", False)),
        num_experts=int(tc.get("num_experts", 0) or 0) if is_moe else 0,
        num_experts_per_tok=int(tc.get("num_experts_per_tok", 0) or 0) if is_moe else 0,
        moe_intermediate_size=int(tc.get("moe_intermediate_size", 0) or 0) if is_moe else 0,
        norm_topk_prob=tc.get("norm_topk_prob", True),
        mrope_section=tuple(rs.get("mrope_section", (24, 20, 20))),
        image_token_id=int(cfg.get("image_token_id", 151655)),
        video_token_id=int(cfg.get("video_token_id", 151656)),
        vision_start_token_id=int(cfg.get("vision_start_token_id", 151652)),
        vision=_vision_spec(vc),
    )

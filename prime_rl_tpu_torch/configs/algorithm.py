"""Algorithm configs — pluggable per-env credit assignment.

Mirrors the union in the reference
(reference: packages/prime-rl-configs/src/prime_rl/configs/algorithm.py:160-353):
grpo / max_rl / rae / hierarchical_grpo / echo / opd / opsd / sft.
"""

from __future__ import annotations

from typing import Annotated, Literal

from pydantic import Field

from prime_rl_tpu_torch.configs.shared import BaseConfig

ActionLossType = Literal["rl", "ce", "ref_kl"]


class SamplingConfig(BaseConfig):
    """Per-env sampling params forwarded to the inference engine."""

    temperature: float = 1.0
    top_p: float = 1.0
    top_k: int = -1
    max_tokens: int | None = None
    min_tokens: int = 0
    seed: int | None = None


class LengthPenaltyConfig(BaseConfig):
    """Linear length shaping of the GRPO baseline
    (reference: orchestrator/algo/grpo.py:24-43)."""

    num_output_tokens_weight: float = 0.0
    num_input_tokens_weight: float = 0.0
    num_turns_weight: float = 0.0


class FrozenModelConfig(BaseConfig):
    """An external frozen model the algorithm connects to (never launches)."""

    name: str
    base_url: list[str] = Field(default_factory=list)
    api_key: str | None = None


class GRPOAlgoConfig(BaseConfig):
    type: Literal["grpo"] = "grpo"
    length_penalty: LengthPenaltyConfig | None = None


class MaxRLAlgoConfig(BaseConfig):
    """Mean-normalized advantage: (r - mean) / max(|r - mean|)."""

    type: Literal["max_rl"] = "max_rl"


class RAEAlgoConfig(BaseConfig):
    """Per-agent EMA baseline (SPIRAL-style) instead of the group mean."""

    type: Literal["rae"] = "rae"
    ema_decay: float = 0.95


class HierarchicalGRPOAlgoConfig(BaseConfig):
    """Proposer/solver scoped group baselines."""

    type: Literal["hierarchical_grpo"] = "hierarchical_grpo"
    scope_key: str = "role"


class EchoAlgoConfig(BaseConfig):
    """GRPO plus weighted CE on env-observation tokens by role."""

    type: Literal["echo"] = "echo"
    observation_ce_weight: float = 1.0
    length_penalty: LengthPenaltyConfig | None = None


class OPDAlgoConfig(BaseConfig):
    """On-policy distillation: teacher prefill fills ref_logprobs; ref_kl loss."""

    type: Literal["opd"] = "opd"
    teacher: FrozenModelConfig | None = None


class OPSDAlgoConfig(BaseConfig):
    """On-policy self-distillation: demo-conditioned prefix self-teacher."""

    type: Literal["opsd"] = "opsd"
    demo_key: str = "demonstration"


class SFTAlgoConfig(BaseConfig):
    """Frozen teacher generates; CE on the teacher tokens."""

    type: Literal["sft"] = "sft"
    teacher: FrozenModelConfig | None = None


AlgoConfig = Annotated[
    GRPOAlgoConfig
    | MaxRLAlgoConfig
    | RAEAlgoConfig
    | HierarchicalGRPOAlgoConfig
    | EchoAlgoConfig
    | OPDAlgoConfig
    | OPSDAlgoConfig
    | SFTAlgoConfig,
    Field(discriminator="type"),
]

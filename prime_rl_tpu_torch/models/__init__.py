"""Model registry: family -> (init, forward, conversion). Ported so far: the
dense qwen3 block, llama (the same block with ``qk_norm=False``), gpt-oss
(windows, sinks and clamped-GLU experts), qwen3_moe (Qwen3-30B-A3B) and
glm4_moe (GLM-4.5: partial rotary, noaux-tc routing, shared experts, dense
first layers), the gated-MoE families minimax_m2, afmoe and laguna (glm4_moe's
block with attention-output gates, layer-scope qk-norm and sandwich norms),
the MLA families ``deepseek_v3`` (dense MLA) and ``glm_moe_dsa`` (MLA +
DSA sparse attention) over the noaux-tc MoE stack, and the hybrids
``qwen3_next`` (GatedDeltaNet linear attention, gated full attention at head
dim 256, MoE with a gated shared expert) and ``nemotron_h`` (Mamba-2 mixers,
bare attention, relu^2 MLPs and LatentMoE), all trained and served."""

from __future__ import annotations

from prime_rl_tpu_torch.models import (
    gated_moe,
    glm4_moe,
    gpt_oss,
    mla_moe,
    nemotron_h,
    qwen3,
    qwen3_moe,
    qwen3_next,
)
from prime_rl_tpu_torch.models.base import ModelSpec


class Family:
    def __init__(self, init, forward, from_hf, to_hf, get_lm_head):
        self.init = init
        self.forward = forward
        self.from_hf = from_hf
        self.to_hf = to_hf
        self.get_lm_head = get_lm_head


_DENSE = Family(qwen3.init_params, qwen3.forward, qwen3.params_from_hf_state_dict,
                qwen3.params_to_hf_state_dict, qwen3.get_lm_head)
_MLA = Family(mla_moe.init_params, mla_moe.forward, mla_moe.params_from_hf_state_dict,
              mla_moe.params_to_hf_state_dict, mla_moe.get_lm_head)
_GPT_OSS = Family(gpt_oss.init_params, gpt_oss.forward, gpt_oss.params_from_hf_state_dict,
                  gpt_oss.params_to_hf_state_dict, gpt_oss.get_lm_head)
_QWEN3_MOE = Family(qwen3_moe.init_params, qwen3_moe.forward, qwen3_moe.params_from_hf_state_dict,
                    qwen3_moe.params_to_hf_state_dict, qwen3_moe.get_lm_head)
_GLM4_MOE = Family(glm4_moe.init_params, glm4_moe.forward, glm4_moe.params_from_hf_state_dict,
                   glm4_moe.params_to_hf_state_dict, glm4_moe.get_lm_head)
_GATED_MOE = Family(gated_moe.init_params, gated_moe.forward,
                    gated_moe.params_from_hf_state_dict, gated_moe.params_to_hf_state_dict,
                    gated_moe.get_lm_head)
_NEMOTRON_H = Family(nemotron_h.init_params, nemotron_h.forward,
                     nemotron_h.params_from_hf_state_dict, nemotron_h.params_to_hf_state_dict,
                     nemotron_h.get_lm_head)
_QWEN3_NEXT = Family(qwen3_next.init_params, qwen3_next.forward,
                     qwen3_next.params_from_hf_state_dict, qwen3_next.params_to_hf_state_dict,
                     qwen3_next.get_lm_head)
FAMILIES: dict[str, Family] = {"qwen3": _DENSE, "llama": _DENSE, "gpt_oss": _GPT_OSS,
                               "qwen3_moe": _QWEN3_MOE, "glm4_moe": _GLM4_MOE,
                               "minimax_m2": _GATED_MOE, "afmoe": _GATED_MOE,
                               "laguna": _GATED_MOE, "deepseek_v3": _MLA, "glm_moe_dsa": _MLA,
                               "qwen3_next": _QWEN3_NEXT, "nemotron_h": _NEMOTRON_H}


def get_family(spec: ModelSpec) -> Family:
    if spec.family not in FAMILIES:
        raise NotImplementedError(f"model family {spec.family!r} is not ported yet "
                                  f"(ported: {', '.join(sorted(FAMILIES))})")
    return FAMILIES[spec.family]

"""Model registry: family -> (init, forward, conversion). This slice holds
the dense qwen3 block and llama (the same block with ``qk_norm=False``)."""

from __future__ import annotations

from prime_rl_tpu_torch.models import qwen3
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
FAMILIES: dict[str, Family] = {"qwen3": _DENSE, "llama": _DENSE}


def get_family(spec: ModelSpec) -> Family:
    if spec.family not in FAMILIES:
        raise NotImplementedError(f"model family {spec.family!r} is not ported yet "
                                  "(ported: qwen3, llama)")
    return FAMILIES[spec.family]

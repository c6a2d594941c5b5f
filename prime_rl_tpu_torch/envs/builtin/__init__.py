"""Builtin environments — importing this module populates the registry."""

from prime_rl_tpu_torch.envs.builtin import reverse_text  # noqa: F401

from prime_rl_tpu_torch.envs.builtin import dominant_color  # noqa: F401
from prime_rl_tpu_torch.envs.builtin import fixed_completion  # noqa: F401
from prime_rl_tpu_torch.envs.builtin import multi_turn  # noqa: F401

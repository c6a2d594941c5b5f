from prime_rl_tpu_torch.configs.inference import InferenceConfig, KVCacheConfig
from prime_rl_tpu_torch.configs.loader import parse_argv, parse_config, to_toml
from prime_rl_tpu_torch.configs.shared import (
    AttentionConfig,
    BaseConfig,
    LogConfig,
    MeshConfig,
    ModelConfig,
    MonitorConfig,
    TokenizerConfig,
)

__all__ = [k for k in dir() if not k.startswith("_")]

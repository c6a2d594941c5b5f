from prime_rl_tpu_torch.configs.inference import InferenceConfig, KVCacheConfig
from prime_rl_tpu_torch.configs.loader import parse_argv, parse_config, to_toml
from prime_rl_tpu_torch.configs.shared import (
    AttentionConfig,
    BaseConfig,
    CheckpointConfig,
    LogConfig,
    MeshConfig,
    ModelConfig,
    MonitorConfig,
    OptimizerConfig,
    SchedulerConfig,
    TokenizerConfig,
    WeightCheckpointConfig,
)
from prime_rl_tpu_torch.configs.trainer import (
    BatchConfig,
    DefaultLossConfig,
    FakeDataLoaderConfig,
    IPOLossConfig,
    LossConfig,
    RatioLossConfig,
    TrainerConfig,
    TransportConfig,
    WeightBroadcastConfig,
)

__all__ = [k for k in dir() if not k.startswith("_")]

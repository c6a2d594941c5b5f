from prime_rl_tpu_torch.configs.algorithm import (
    ActionLossType,
    AlgoConfig,
    EchoAlgoConfig,
    FrozenModelConfig,
    GRPOAlgoConfig,
    HierarchicalGRPOAlgoConfig,
    LengthPenaltyConfig,
    MaxRLAlgoConfig,
    OPDAlgoConfig,
    OPSDAlgoConfig,
    RAEAlgoConfig,
    SamplingConfig,
    SFTAlgoConfig,
)
from prime_rl_tpu_torch.configs.env_server import EnvServerConfig
from prime_rl_tpu_torch.configs.inference import InferenceConfig, KVCacheConfig
from prime_rl_tpu_torch.configs.loader import parse_argv, parse_config, to_toml
from prime_rl_tpu_torch.configs.orchestrator import (
    EnvSourceConfig,
    EvalSourceConfig,
    FilterConfig,
    OrchestratorConfig,
)
from prime_rl_tpu_torch.configs.rl import DeployConfig, RLConfig
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
    SFTConfig,
    SFTDataConfig,
    SFTSubsetConfig,
    SFTValConfig,
    TrainerConfig,
    TransportConfig,
    WeightBroadcastConfig,
)

__all__ = [k for k in dir() if not k.startswith("_")]

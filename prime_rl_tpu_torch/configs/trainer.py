"""RL and SFT trainer configs, field for field with the JAX package's
``configs/trainer.py``, plus ``device`` on ``TrainerConfig`` and
``SFTConfig``: the trainer runs on the card unless the caller asks for the
CPU.
"""

from __future__ import annotations

from typing import Annotated, Literal

from pydantic import Field

from prime_rl_tpu_torch.configs.shared import (
    BaseConfig,
    default_tag,
    CheckpointConfig,
    LogConfig,
    MeshConfig,
    MetricsServerConfig,
    ModelConfig,
    MonitorConfig,
    OptimizerConfig,
    SchedulerConfig,
    TokenizerConfig,
    WeightCheckpointConfig,
)


class DefaultLossConfig(BaseConfig):
    """DPPO-binary-TV + squared-log-ratio KL with advantage-sign-conditioned
    trust region (reference: trainer/rl/loss.py:109-161)."""

    type: Literal["default"] = "default"
    dppo_mask_high: float = 0.25
    dppo_mask_low: float = 0.25
    adv_tau: float = 1.0
    kl_tau: float = 1.0


class IPOLossConfig(BaseConfig):
    """Symmetric trust region variant (reference: trainer/rl/loss.py:164-196)."""

    type: Literal["ipo"] = "ipo"
    ipo_threshold: float = 0.25
    adv_tau: float = 1.0
    kl_tau: float = 1.0


class RatioLossConfig(BaseConfig):
    """Plain PPO-clip style token-level importance-ratio loss (GRPO default in
    most public implementations); kept as a third variant for ablations."""

    type: Literal["ratio"] = "ratio"
    clip_eps_low: float = 0.2
    clip_eps_high: float = 0.2
    adv_tau: float = 1.0


class CustomLossConfig(BaseConfig):
    type: Literal["custom"] = "custom"
    import_path: str
    kwargs: dict = Field(default_factory=dict)


LossConfig = Annotated[
    DefaultLossConfig | IPOLossConfig | RatioLossConfig | CustomLossConfig,
    Field(discriminator="type"),
    default_tag("default"),
]


class FakeDataLoaderConfig(BaseConfig):
    """Synthetic batches for --bench / debug, no orchestrator needed
    (reference: trainer/rl/data.py:62-176)."""

    type: Literal["fake"] = "fake"
    micro_batch_size: int = 1
    seq_len: int = 4096
    num_micro_batches: int = 4
    seed: int = 0


class TransportDataLoaderConfig(BaseConfig):
    type: Literal["transport"] = "transport"


DataLoaderConfig = Annotated[
    FakeDataLoaderConfig | TransportDataLoaderConfig,
    Field(discriminator="type"),
    default_tag("transport"),
]


class FileSystemWeightBroadcastConfig(BaseConfig):
    """Write HF-format weights per step + STABLE marker
    (reference: trainer/rl/broadcast/filesystem.py)."""

    type: Literal["filesystem"] = "filesystem"
    save_format: Literal["safetensors"] = "safetensors"


class DeviceWeightBroadcastConfig(BaseConfig):
    """The disaggregated weight plane: per-step weights reach sampler
    processes without a disk round-trip (``colocated``, ``shm``,
    ``zmq_stream``, ``dcn_pull``). Parsed so one TOML drives both packages;
    ``make_broadcast`` raises for it until the loop slice."""

    type: Literal["device"] = "device"
    mode: Literal["colocated", "shm", "zmq_stream", "dcn_pull"] = "colocated"
    num_pullers: int = 1  # dcn_pull: sampler processes pulling each version
    # cast float leaves before transfer (serving computes in bf16 anyway)
    transfer_dtype: Literal["bfloat16", "float32", "float8_e4m3"] | None = "bfloat16"
    pub_port: int = 5561  # zmq_stream publish port
    rep_port: int = 5562  # zmq_stream latest-pull port


WeightBroadcastConfig = Annotated[
    FileSystemWeightBroadcastConfig | DeviceWeightBroadcastConfig,
    Field(discriminator="type"),
    default_tag("filesystem"),
]


class ZMQTransportConfig(BaseConfig):
    type: Literal["zmq"] = "zmq"
    host: str = "127.0.0.1"
    batch_port: int = 5555
    micro_batch_port: int = 5556


class FileSystemTransportConfig(BaseConfig):
    type: Literal["filesystem"] = "filesystem"


TransportConfig = Annotated[
    ZMQTransportConfig | FileSystemTransportConfig,
    Field(discriminator="type"),
    default_tag("zmq"),
]


class BenchConfig(BaseConfig):
    warmup_steps: int = 3
    steps: int = 10


class BatchConfig(BaseConfig):
    """Sequence-packing knobs (reference: trainer/batch.py)."""

    micro_batch_size: int = 1  # sequences are packed; this is packed rows per micro-batch
    seq_len: int = 4096
    # pinned grad-accumulation depth: keeps the [N, B, L] step shape constant
    # across steps. None = minimum fit per batch.
    num_micro_batches: int | None = 4
    # bin-balancing: quadratic attn-aware cost (reference: trainer/utils.py:146)
    balance: Literal["tokens", "quadratic"] = "quadratic"
    # VLM: static per-micro-batch vision patch buffer size (0 = auto-size)
    max_mm_patches: int = 0


class TrainerConfig(BaseConfig):
    """RL trainer process config."""

    output_dir: str = "outputs"
    model: ModelConfig = ModelConfig()
    tokenizer: TokenizerConfig = TokenizerConfig()
    mesh: MeshConfig = MeshConfig()
    optimizer: OptimizerConfig = Field(default_factory=lambda: {"type": "adamw"})
    scheduler: SchedulerConfig = Field(default_factory=lambda: {"type": "constant"})
    loss: LossConfig = Field(default_factory=lambda: {"type": "default"})
    ckpt: CheckpointConfig = CheckpointConfig()
    weight_ckpt: WeightCheckpointConfig = WeightCheckpointConfig()
    data: DataLoaderConfig = Field(default_factory=lambda: {"type": "transport"})
    transport: TransportConfig = Field(default_factory=lambda: {"type": "zmq"})
    broadcast: WeightBroadcastConfig = Field(default_factory=lambda: {"type": "filesystem"})
    batch: BatchConfig = BatchConfig()
    monitor: MonitorConfig = Field(default_factory=lambda: {"type": "file"})
    log: LogConfig = LogConfig()
    metrics_server: MetricsServerConfig = MetricsServerConfig()
    max_steps: int | None = None
    grad_clip: float | None = 1.0
    seed: int = 0
    bench: BenchConfig | None = None
    # where the trainer runs: the card unless the caller asks for the CPU
    device: Literal["cuda", "cpu"] = "cuda"
    trace_path: str | None = None  # torch.profiler chrome-trace output dir
    # park optimizer state / master weights in host memory: accepted, and the
    # trainer raises for them until the offload slice
    offload_optimizer: bool = False
    offload_params: bool = False
    # accepted and inert: a host loop over the micro-batches is the only form
    # of the step here
    dispatch_micro_batches: bool = False
    # shutdown edge: skip the final N weight publishes — under a target_lag
    # pipeline, rollouts sampled from the last target_lag+1 policies are
    # never shipped, so those publishes are pure waste (reference:
    # rl/train.py:597-605 final-broadcast carve-out; the launcher sets this
    # to orchestrator.target_lag + 1). 0 = publish every step.
    final_publish_skip: int = 0
    # multi-tenant LoRA runs: route batches by TrainingBatch.run_idx to
    # per-tenant adapter states (requires model.lora; reference: runs.py)
    multi_run: bool = False
    max_runs: int = 8
    # per-step JSONL export of per-token training tensors for offline
    # analysis (reference: trainer/rl/token_export.py) — 0 = off, else max
    # packed rows written per step under <output_dir>/token_export/
    token_export_rows: int = 0
    # uptime heartbeat: GET this URL every heartbeat_interval seconds from a
    # daemon thread (reference: utils/heartbeat.py Better Stack pings)
    heartbeat_url: str | None = None
    heartbeat_interval: float = 30.0


class SFTDataConfig(BaseConfig):
    """SFT dataset config (reference: trainer/sft/data.py)."""

    type: Literal["hf", "fake"] = "fake"
    name: str | None = None  # HF dataset name
    split: str = "train"
    # weighted subset interleaving (reference: sft/data.py ratios): when
    # non-empty, examples mix across subsets by ratio
    subsets: list["SFTSubsetConfig"] = Field(default_factory=list)
    # prompt/completion column format or messages format
    format: Literal["prompt_completion", "messages"] = "messages"
    seq_len: int = 4096
    batch_size: int = 8  # sequences per optimizer step (pre-packing)
    micro_batch_size: int = 1
    num_examples: int | None = None
    fake_vocab: int = 2048  # for fake datasets
    seed: int = 0
    loss_mask: Literal["all", "assistant"] = "assistant"
    # VLM: static vision patch buffer per micro-batch (0 = auto-size)
    max_mm_patches: int = 0


class SFTSubsetConfig(BaseConfig):
    name: str
    split: str = "train"
    format: Literal["prompt_completion", "messages"] = "messages"
    ratio: float = 1.0


class SFTValConfig(BaseConfig):
    """Held-out validation (reference: sft/train.py validation loop)."""

    interval: int = 50
    num_batches: int = 4
    split: str = "test"
    seed: int = 1234  # held-out stream seed for fake datasets


class SFTConfig(BaseConfig):
    """SFT trainer process config."""

    output_dir: str = "outputs"
    model: ModelConfig = ModelConfig()
    tokenizer: TokenizerConfig = TokenizerConfig()
    mesh: MeshConfig = MeshConfig()
    optimizer: OptimizerConfig = Field(default_factory=lambda: {"type": "adamw", "lr": 2e-5})
    scheduler: SchedulerConfig = Field(default_factory=lambda: {"type": "cosine"})
    ckpt: CheckpointConfig = CheckpointConfig()
    weight_ckpt: WeightCheckpointConfig = WeightCheckpointConfig()
    data: SFTDataConfig = SFTDataConfig()
    val: SFTValConfig | None = None
    monitor: MonitorConfig = Field(default_factory=lambda: {"type": "file"})
    log: LogConfig = LogConfig()
    max_steps: int | None = 100
    grad_clip: float | None = 1.0
    seed: int = 0
    bench: BenchConfig | None = None
    # where the trainer runs: the card unless the caller asks for the CPU
    device: Literal["cuda", "cpu"] = "cuda"

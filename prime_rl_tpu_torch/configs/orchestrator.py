"""Orchestrator config (reference: configs/orchestrator.py)."""

from __future__ import annotations

from typing import Annotated, Literal

from pydantic import Field, model_validator

from prime_rl_tpu_torch.configs.algorithm import AlgoConfig, SamplingConfig
from prime_rl_tpu_torch.configs.shared import BaseConfig, LogConfig, MonitorConfig, TokenizerConfig
from prime_rl_tpu_torch.configs.trainer import TransportConfig


class GibberishFilterConfig(BaseConfig):
    """Drop rollouts whose mean sampled logprob is below a threshold
    (reference: orchestrator/filters.py:35)."""

    type: Literal["gibberish"] = "gibberish"
    min_mean_logprob: float = -4.0
    mode: Literal["monitor", "enforce"] = "monitor"


class RepetitionFilterConfig(BaseConfig):
    """Drop rollouts with heavy n-gram repetition (reference: filters.py:65)."""

    type: Literal["repetition"] = "repetition"
    ngram: int = 8
    max_repetition_frac: float = 0.3
    mode: Literal["monitor", "enforce"] = "monitor"


class ZeroAdvantageFilterConfig(BaseConfig):
    """Drop rollouts with all-zero advantages (reference: filters.py:100)."""

    type: Literal["zero_advantage"] = "zero_advantage"
    mode: Literal["monitor", "enforce"] = "enforce"


class DownsampleFilterConfig(BaseConfig):
    """Group-level rollout down-sampling: keep only the ``keep_frac`` most
    informative rollouts of each finalized group, ranked by |mean advantage|
    (extremes in both directions carry the gradient signal; near-baseline
    rollouts contribute almost nothing). Cuts trainer tokens at equal
    learning signal (PAPERS.md: "Not All Rollouts are Useful — Down-Sampling
    Rollouts in LLM Reinforcement Learning", arXiv:2504.13818 max-variance
    down-sampling)."""

    type: Literal["downsample"] = "downsample"
    keep_frac: float = 0.5
    min_keep: int = 2  # never shrink a group below this
    mode: Literal["monitor", "enforce"] = "monitor"


FilterConfig = Annotated[
    GibberishFilterConfig | RepetitionFilterConfig | ZeroAdvantageFilterConfig
    | DownsampleFilterConfig,
    Field(discriminator="type"),
]


class EnvSourceConfig(BaseConfig):
    """One env source in the train/eval mix (array-of-tables in TOML)."""

    name: str
    address: str | None = None  # env server ZMQ address; None = in-process
    module: str | None = None  # import path for in-process builtin envs
    ratio: float = 1.0
    group_size: int = 8
    sampling: SamplingConfig = SamplingConfig()
    algo: AlgoConfig = Field(default_factory=lambda: {"type": "grpo"})
    args: dict = Field(default_factory=dict)


class EvalSourceConfig(BaseConfig):
    name: str
    address: str | None = None
    module: str | None = None
    group_size: int = 1
    num_examples: int | None = None
    interval: int = 50
    sampling: SamplingConfig = SamplingConfig()
    args: dict = Field(default_factory=dict)
    # which episode metric marks a rollout "correct" for pass@k/pass^k.
    # None = auto: an explicit `correct`/`exact` metric if the env emits one,
    # else reward >= correct_threshold. Continuous-reward envs should set
    # either a metric name or a threshold explicitly — the old implicit
    # `reward >= 1.0` fallback reported pass@k = 0 for a 0.99-reward env.
    correct_metric: str | None = None
    correct_threshold: float = 1.0


class ClientConfig(BaseConfig):
    """Inference pool endpoints. ``discovery`` switches to the elastic pool:
    ``file:///path/to/urls.txt`` or ``dns://name`` re-read on an interval,
    with joiners weight-synced before admission (reference: utils/elastic.py)."""

    base_urls: list[str] = Field(default_factory=lambda: ["http://127.0.0.1:8000"])
    api_key: str | None = None
    timeout: float = 1200.0
    discovery: str | None = None
    discovery_port: int = 8000
    sync_interval: float = 10.0


class OrchestratorCheckpointConfig(BaseConfig):
    interval: int = 50
    resume_step: int | None = None


class OrchestratorConfig(BaseConfig):
    output_dir: str = "outputs"
    model_name: str = "Qwen/Qwen3-0.6B"
    tokenizer: TokenizerConfig = TokenizerConfig()
    client: ClientConfig = ClientConfig()
    transport: TransportConfig = Field(default_factory=lambda: {"type": "zmq"})
    monitor: MonitorConfig = Field(default_factory=lambda: {"type": "file"})
    log: LogConfig = LogConfig()
    ckpt: OrchestratorCheckpointConfig = OrchestratorCheckpointConfig()
    # uptime heartbeat (reference: utils/heartbeat.py Better Stack pings)
    heartbeat_url: str | None = None
    heartbeat_interval: float = 30.0

    train_envs: list[EnvSourceConfig] = Field(default_factory=list)
    eval_envs: list[EvalSourceConfig] = Field(default_factory=list)
    filters: list[FilterConfig] = Field(default_factory=lambda: [{"type": "zero_advantage"}])

    # Batch assembly: by rollout count or token budget with whole-rollout
    # overflow carry (reference: train_sink.py:253-291)
    batch_size: int = 128  # rollouts per training batch
    max_batch_tokens: int | None = None
    seq_len: int = 4096
    # observability: persist full rollout transcripts per step under
    # <output>/traces/ (reference: orchestrator.py:546-550); pipeline
    # snapshot line interval in seconds
    save_rollout_traces: bool = False
    pipeline_log_interval: float = 30.0

    # How new policy versions are detected: "filesystem" polls weights/ and
    # pushes /update_weights to each engine; "liveness" polls the engines'
    # /liveness policy_version (colocated mode — the trainer swaps weights
    # in-process and just bumps the version)
    watch: Literal["filesystem", "liveness"] = "filesystem"

    # Multi-tenant runs (reference: trainer/runs.py + docs/advanced.md
    # multi-run): this orchestrator's batches train tenant ``run_{run_idx}``
    # on a shared multi_run trainer. ``serve_adapter``: instead of swapping
    # the engines' base weights at each version, (re)load this LoRA adapter
    # from the snapshot's adapter/ dir and sample rollouts through it —
    # many tenants share one engine, each decoding with its own adapter.
    # Point output_dir at the trainer's runs/run_{run_idx}/ dir so the
    # watcher sees the per-tenant publishes.
    run_idx: int | None = None
    serve_adapter: str | None = None

    # Async pipeline control (reference: orchestrator.py:103-107,912-942)
    target_lag: int = 1
    max_off_policy_steps: int = 8
    max_inflight_episodes: int = 64
    # eval has its own permit pool so an eval epoch never starves train
    # dispatch (reference: dispatcher.py PREFER_* permit policies)
    max_inflight_eval_episodes: int = 32
    # dispatch throttle: at most this many rollout starts per minute
    # (0 = unlimited; reference: dispatcher.py AsyncLimiter tasks_per_minute)
    tasks_per_minute: int = 0
    max_steps: int | None = None
    max_empty_batches: int = 10

    seed: int = 0

    @model_validator(mode="after")
    def _check_envs(self):
        names = [e.name for e in self.train_envs]
        if len(names) != len(set(names)):
            raise ValueError(f"duplicate train env names: {names}")
        return self

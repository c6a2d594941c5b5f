"""Inference (sampling engine) config.

The same fields as the JAX package's ``configs/inference.py``, plus
``device``: the PyTorch engine runs on a CUDA card unless the caller asks
for the CPU. KV cache layout, continuous batching and HTTP serving are
configured here.
"""

from __future__ import annotations

from typing import Literal

from pydantic import Field

from prime_rl_tpu_torch.configs.shared import BaseConfig, LogConfig, MeshConfig, ModelConfig, MonitorConfig, TokenizerConfig


class KVCacheConfig(BaseConfig):
    """Paged KV cache layout (sampler/cache.py): a page-table cache read by
    the paged decode-attention kernel."""

    page_size: int = 64
    num_pages: int | None = None  # None = size from free device memory
    hbm_utilization: float = 0.85


class SchedulerConfig(BaseConfig):
    """Continuous-batching scheduler knobs."""

    max_batch_size: int = 64  # concurrent decode slots
    max_prefill_tokens: int = 8192  # per prefill step
    prefill_chunk: int = 512
    # in-flight decode TOKENS per batched drain: higher hides host<->device
    # latency behind more device work (throughput), lower tightens
    # per-token streaming latency
    lookahead: int = 8
    # decode steps per dispatched block (with in-block EOS/length masking):
    # the host drains one packed result per decode_block tokens. 1 = drain
    # per token (tightest admission latency; the engine already shrinks the
    # block 4x while blocked admissions wait)
    decode_block: int = 8
    # dummy requests run at startup (builds the kernels and warms the
    # allocator before live traffic). 0 = warm lazily on first traffic.
    warmup_requests: int = 0


class ServerConfig(BaseConfig):
    host: str = "0.0.0.0"
    port: int = 8000
    api_key: str | None = None
    # P/D deployment role, exposed in /metrics so the orchestrator can roll
    # engine scrapes up per role (reference: inference_metrics.py:136 node/
    # role rollup). "mixed" = a normal engine doing both phases.
    role: Literal["mixed", "prefill", "decode"] = "mixed"


class ServingLoRAConfig(BaseConfig):
    """Multi-LoRA serving bank (vLLM punica analogue): up to ``max_adapters``
    adapters live on device; requests pick one by name (`model` field or
    sampling_params.adapter). Rank/targets must match the adapters being
    loaded (reference: inference/vllm/server.py:98-147)."""

    max_adapters: int = 4
    rank: int = 8
    alpha: float = 16.0
    target_modules: list[str] = Field(
        default_factory=lambda: ["q", "k", "v", "o", "gate", "up", "down"])


class WeightPlaneConfig(BaseConfig):
    """Receive per-step policy weights straight from the learner process
    (no disk): shm arena on the same host, or ZMQ tensor streaming across
    hosts. The engine's policy_version bumps on apply — pair with the
    orchestrator's watch="liveness" (transport/weights.py)."""

    mode: Literal["shm", "zmq_stream", "dcn_pull"] = "shm"
    host: str = "127.0.0.1"  # zmq_stream: trainer host
    pub_port: int = 5561
    rep_port: int = 5562


class InferenceConfig(BaseConfig):
    output_dir: str = "outputs"
    # where the engine runs: "cuda" needs a card and raises without one (it
    # never falls back to the CPU); "cpu" runs the kernels' plain versions
    device: Literal["cuda", "cpu"] = "cuda"
    model: ModelConfig = ModelConfig()
    tokenizer: TokenizerConfig = TokenizerConfig()
    mesh: MeshConfig = Field(default_factory=lambda: MeshConfig(fsdp=1, tensor=-1))
    kv: KVCacheConfig = KVCacheConfig()
    scheduler: SchedulerConfig = SchedulerConfig()
    server: ServerConfig = ServerConfig()
    monitor: MonitorConfig = Field(default_factory=lambda: {"type": "file"})
    log: LogConfig = LogConfig()
    max_model_len: int = 4096
    enforce_eager: bool = False
    seed: int = 0
    # int8 weight-only serving quantization (halves decode weight bandwidth)
    quantization: Literal["int8"] | None = None
    # MoE router replay: record per-token expert routing during decode and
    # return it with each completion (reference: routed_experts wire field)
    collect_routed_experts: bool = False
    # disaggregated weight plane subscription (None = HTTP /update_weights only)
    weight_plane: WeightPlaneConfig | None = None
    # multi-LoRA serving bank (None = base model only; /load_lora_adapter 501s)
    lora: ServingLoRAConfig | None = None

"""Shared config models: base class, model/tokenizer, mesh, monitor, logging.

The port keeps its own copy of the config surface the serving and training
paths need, field for field with the JAX package's ``configs/shared.py``, so
the same TOML files and dotted CLI flags drive both packages.
"""

from __future__ import annotations

from typing import Annotated, Literal

from pydantic import BaseModel, BeforeValidator, ConfigDict, Field, field_validator


class BaseConfig(BaseModel):
    model_config = ConfigDict(extra="forbid", validate_assignment=True, validate_default=True)


def default_tag(tag: str) -> BeforeValidator:
    """Inject ``type = tag`` into a partial dict so CLI overrides like
    ``--monitor.path=x`` validate against a discriminated union without
    requiring the user to restate the default variant."""

    def inject(v: object) -> object:
        if isinstance(v, dict) and "type" not in v:
            return {**v, "type": tag}
        return v

    return BeforeValidator(inject)


class MeshConfig(BaseConfig):
    """Logical device mesh. Axes (outermost first): ``replica``, ``fsdp``,
    ``expert``, ``context``, ``tensor``. -1 on exactly one axis means "absorb
    all remaining devices". The server and the trainer run on one card: the
    mesh is resolved against one device, and any other size raises."""

    replica: int = 1
    fsdp: int = -1
    expert: int = 1
    context: int = 1
    tensor: int = 1

    def resolve(self, n_devices: int) -> dict[str, int]:
        sizes = {
            "replica": self.replica,
            "fsdp": self.fsdp,
            "expert": self.expert,
            "context": self.context,
            "tensor": self.tensor,
        }
        wild = [k for k, v in sizes.items() if v == -1]
        if len(wild) > 1:
            raise ValueError(f"at most one mesh axis may be -1, got {wild}")
        fixed = 1
        for k, v in sizes.items():
            if v != -1:
                fixed *= v
        if wild:
            if n_devices % fixed != 0:
                raise ValueError(f"{n_devices} devices not divisible by fixed axes product {fixed}")
            sizes[wild[0]] = n_devices // fixed
        total = 1
        for v in sizes.values():
            total *= v
        if total != n_devices:
            raise ValueError(f"mesh {sizes} covers {total} devices, have {n_devices}")
        return sizes


class AttentionConfig(BaseConfig):
    """Attention route, for serving and training alike. ``auto`` runs the
    hand-written CUDA kernels (K1 forward, K2a/K2b backward) on a CUDA device
    and plain einsum attention on the CPU; ``pallas`` (the JAX package's name
    for its kernel route, kept so one TOML drives both) forces the flash
    route, which on the CPU runs the kernels' plain versions; ``xla`` forces
    the einsum path. The kernels tile by themselves: ``block_q``/``block_kv``
    are accepted and change nothing."""

    impl: Literal["auto", "pallas", "xla"] = "auto"
    block_q: int = 1024
    block_kv: int = 1024


class ActivationCheckpointConfig(BaseConfig):
    """Rematerialization policy of the training forward, per layer through
    ``torch.utils.checkpoint``: ``none`` keeps every activation, ``full``
    recomputes the layer in the backward (K1 runs twice), ``save_attn`` (and
    its stride form ``save_attn/K``: every K-th layer, the rest ``full``)
    recomputes all but the attention kernel's outputs, so K1 runs once;
    ``offload_attn`` keeps those outputs in pinned host memory instead;
    ``selective`` keeps the products with no batch dims and recomputes the
    rest (K1 among it), ``offload_dots`` keeps those in pinned host memory.
    Each family takes the modes its JAX function names and runs any other as
    ``none`` (``models/qwen3.parse_remat``)."""

    mode: str = "full"
    save_dots: bool = True

    @field_validator("mode")
    @classmethod
    def _check_mode(cls, v: str) -> str:
        base, _, k = v.partition("/")
        allowed = {"none", "full", "save_attn", "offload_attn",
                   "offload_dots", "selective"}
        if base not in allowed:
            raise ValueError(f"ac.mode {v!r}: base must be one of {sorted(allowed)}")
        if k and (base not in ("save_attn", "offload_attn")
                  or not k.isdigit() or int(k) < 1):
            raise ValueError(
                f"ac.mode {v!r}: stride form is save_attn/K or offload_attn/K "
                "with integer K >= 1")
        return v


class LoRAConfig(BaseConfig):
    rank: int = 16
    alpha: float = 32.0
    dropout: float = 0.0
    target_modules: list[str] = Field(
        default_factory=lambda: ["q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj"]
    )
    experts: bool = False


class DebugModelConfig(BaseConfig):
    """Tiny-model debug knobs: layer truncation, vocab truncation (>= 260,
    the byte tokenizer's vocab) and random init."""

    num_layers: int | None = None
    vocab_size: int | None = None
    random_init: bool = False


class ModelConfig(BaseConfig):
    """Which model to train or serve, in which dtypes, and how the training
    forward rematerializes and chunks its LM head."""

    name: str = "Qwen/Qwen3-0.6B"
    attn: AttentionConfig = AttentionConfig()
    ac: ActivationCheckpointConfig = ActivationCheckpointConfig()
    lora: LoRAConfig | None = None
    debug: DebugModelConfig = DebugModelConfig()
    compute_dtype: Literal["bfloat16", "float32"] = "bfloat16"
    param_dtype: Literal["bfloat16", "float32"] = "float32"
    grad_accum_dtype: Literal["float32", "bfloat16"] = "float32"
    quantized_compute: Literal["int8"] | None = None
    gdn_mxu_precision: Literal["highest", "bfloat16"] = "highest"
    cp_style: Literal["ulysses", "ring"] = "ulysses"
    lm_head_chunk_size: int = 1024
    seq_len: int = 4096
    moe_aux_coef: float = 0.0
    freeze: list[str] = Field(default_factory=list)


class TokenizerConfig(BaseConfig):
    name: str | None = None  # defaults to model name
    trust_remote_code: bool = False


class FileMonitorConfig(BaseConfig):
    type: Literal["file"] = "file"
    path: str | None = None  # default: <output_dir>/metrics.jsonl


class WandbMonitorConfig(BaseConfig):
    type: Literal["wandb"] = "wandb"
    project: str = "prime-rl-tpu"
    name: str | None = None
    group: str | None = None
    offline: bool = False


MonitorConfig = Annotated[
    FileMonitorConfig | WandbMonitorConfig,
    Field(discriminator="type"),
    default_tag("file"),
]


class LogConfig(BaseConfig):
    level: Literal["debug", "info", "warning", "error"] = "info"
    json_logs: bool = False


class MetricsServerConfig(BaseConfig):
    enable: bool = False
    host: str = "0.0.0.0"
    port: int = 9100


class CheckpointConfig(BaseConfig):
    """Train-state checkpoints (``torch.save`` of the state) + retention."""

    interval: int = 50
    keep_last: int | None = 2
    keep_interval: int | None = None
    resume_step: int | None = None  # -1 = latest


class WeightCheckpointConfig(BaseConfig):
    """HF-compatible safetensors snapshots for serving."""

    interval: int = 100
    keep_last: int | None = 1
    save_format: Literal["safetensors"] = "safetensors"


class ConstantSchedulerConfig(BaseConfig):
    type: Literal["constant"] = "constant"
    warmup_steps: int = 0


class LinearSchedulerConfig(BaseConfig):
    type: Literal["linear"] = "linear"
    warmup_steps: int = 0
    decay_steps: int = 1000
    min_lr_ratio: float = 0.0


class CosineSchedulerConfig(BaseConfig):
    type: Literal["cosine"] = "cosine"
    warmup_steps: int = 0
    decay_steps: int = 1000
    min_lr_ratio: float = 0.1


SchedulerConfig = Annotated[
    ConstantSchedulerConfig | LinearSchedulerConfig | CosineSchedulerConfig,
    Field(discriminator="type"),
    default_tag("constant"),
]


class AdamWConfig(BaseConfig):
    type: Literal["adamw"] = "adamw"
    lr: float = 1e-6
    weight_decay: float = 0.01
    betas: tuple[float, float] = (0.9, 0.999)
    eps: float = 1e-8


class SGDConfig(BaseConfig):
    type: Literal["sgd"] = "sgd"
    lr: float = 1e-6
    momentum: float = 0.0
    nesterov: bool = False
    weight_decay: float = 0.0


class MuonConfig(BaseConfig):
    type: Literal["muon"] = "muon"
    lr: float = 2e-2
    weight_decay: float = 0.01
    momentum: float = 0.95
    adamw_lr: float = 1e-6  # for non-matrix params


class SignSGDConfig(BaseConfig):
    type: Literal["sign_sgd"] = "sign_sgd"
    lr: float = 1e-6
    weight_decay: float = 0.0


class AdamW8bitConfig(BaseConfig):
    """AdamW with blockwise 8-bit moments (~1 byte/param/moment instead of
    4). Optionally pairs with bf16 master weights + stochastic rounding
    (master_dtype) for another 2x on the params."""

    type: Literal["adamw_8bit"] = "adamw_8bit"
    lr: float = 1e-6
    weight_decay: float = 0.01
    betas: tuple[float, float] = (0.9, 0.999)
    eps: float = 1e-8
    block: int = 2048  # params per quantization block
    master_dtype: Literal["float32", "bfloat16"] = "float32"


class AdafactorMomConfig(BaseConfig):
    """Adafactor with bf16 momentum (Adam-like recipe: no relative step,
    no param scaling): the second moment is rank-1 factored — O(N+M) instead
    of O(NM) — and the first moment is half-width. The biggest state shrink
    available; quality within noise of Adam for LLM training at these
    scales."""

    type: Literal["adafactor_mom"] = "adafactor_mom"
    lr: float = 1e-6
    weight_decay: float = 0.0
    momentum: float = 0.9
    decay_rate: float = 0.8  # adafactor's step-dependent 2nd-moment decay
    clipping_threshold: float = 1.0
    master_dtype: Literal["float32", "bfloat16"] = "float32"


OptimizerConfig = Annotated[
    AdamWConfig | SGDConfig | MuonConfig | SignSGDConfig
    | AdamW8bitConfig | AdafactorMomConfig,
    Field(discriminator="type"),
    default_tag("adamw"),
]

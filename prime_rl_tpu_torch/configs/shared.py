"""Shared config models: base class, model/tokenizer, mesh, monitor, logging.

The port keeps its own copy of the config surface the serving path needs,
field for field with the JAX package's ``configs/shared.py``, so the same
TOML files and dotted CLI flags drive both packages.
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
    all remaining devices". The serving slice runs on one card; the mesh is
    parsed for config compatibility and resolved to one device."""

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
    """Attention kernel selection: ``auto`` runs the hand-written CUDA
    kernels on a CUDA device and the plain PyTorch versions on the CPU."""

    impl: Literal["auto", "pallas", "xla"] = "auto"
    block_q: int = 1024
    block_kv: int = 1024


class ActivationCheckpointConfig(BaseConfig):
    """Rematerialization policy (training; parsed for config compatibility)."""

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
    """Which model to serve."""

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

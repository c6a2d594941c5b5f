"""Merged RL launch config, split into per-process configs by the launcher
(the port of the JAX package's ``configs/rl.py``): the port's trainer and
inference configs, with the orchestrator's and the env servers' as they are."""

from __future__ import annotations

from pydantic import Field

from prime_rl_tpu_torch.configs.env_server import EnvServerConfig
from prime_rl_tpu_torch.configs.inference import InferenceConfig
from prime_rl_tpu_torch.configs.orchestrator import OrchestratorConfig
from prime_rl_tpu_torch.configs.shared import BaseConfig
from prime_rl_tpu_torch.configs.trainer import TrainerConfig


class DeployConfig(BaseConfig):
    """Cluster deployment templating, field for field with the JAX package's,
    so a TOML that sets it parses; the launcher raises for it (the cluster
    templates belong to the multi-card slice)."""

    type: str = "slurm_single"  # slurm_single | slurm_multi | slurm_pd | gke
    submit: bool = False
    template: str | None = None  # override path; None = built-in template
    job_name: str = "prime-rl-tpu"
    partition: str = "tpu"
    time_limit: str = "24:00:00"
    trainer_hosts: int = 1
    sampler_hosts: int = 1
    prefill_hosts: int = 1
    decode_hosts: int = 2
    engine_port: int = 8100
    router_port: int = 8000
    pd_threshold: int = 512  # prompt tokens at/above this prefill remotely
    coordinator_port: int = 8476
    image: str = "prime-rl-tpu:latest"
    trainer_tpu_type: str = "tpu-v5-lite-podslice"
    trainer_topology: str = "4x4"
    sampler_tpu_type: str = "tpu-v5-lite-device"
    chips_per_host: int = 4
    env_vars: dict = Field(default_factory=dict)


class RLConfig(BaseConfig):
    output_dir: str = "outputs"
    trainer: TrainerConfig = TrainerConfig()
    orchestrator: OrchestratorConfig = OrchestratorConfig()
    inference: InferenceConfig = InferenceConfig()
    env_servers: list[EnvServerConfig] = Field(default_factory=list)
    # colocated: sampler + learner share one process and one device
    colocated: bool = True
    # trainer processes on one machine: more than one raises until the
    # multi-card slice
    trainer_procs: int = 1
    trainer_devices_per_proc: int | None = None
    dry_run: bool = False
    # cluster deployment: parsed, and the launcher raises for it
    deploy: DeployConfig | None = None

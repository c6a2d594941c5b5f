"""Env server config (reference: configs/env_server.py)."""

from __future__ import annotations

from pydantic import Field

from prime_rl_tpu_torch.configs.shared import BaseConfig, LogConfig


class EnvServerConfig(BaseConfig):
    output_dir: str = "outputs"
    # registry name (envs/builtin) or "module:Class" import path
    env: str = "reverse_text"
    address: str = "tcp://127.0.0.1:5600"
    max_workers: int = 64
    log: LogConfig = LogConfig()
    args: dict = Field(default_factory=dict)

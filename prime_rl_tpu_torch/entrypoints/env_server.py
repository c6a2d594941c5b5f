"""``python -m prime_rl_tpu_torch.entrypoints.env_server --env reverse_text
--address tcp://127.0.0.1:5600`` (reference: entrypoints/env_server.py:14-30)."""

from __future__ import annotations

import asyncio

from prime_rl_tpu_torch.configs import EnvServerConfig, parse_config


def main() -> None:
    config = parse_config(EnvServerConfig)
    from prime_rl_tpu_torch.envs.base import load_env
    from prime_rl_tpu_torch.envs.server import serve_env
    from prime_rl_tpu_torch.utils.logger import setup_logger

    setup_logger(config.log.level, config.log.json_logs)
    env = load_env(config.env, **config.args)
    asyncio.run(serve_env(env, config.address, max_workers=config.max_workers))


if __name__ == "__main__":
    main()

"""``python -m prime_rl_tpu_torch.entrypoints.orchestrator @ config.toml``
(reference: entrypoints/orchestrator.py)."""

from __future__ import annotations

from prime_rl_tpu_torch.configs import OrchestratorConfig, parse_config


def main() -> None:
    from prime_rl_tpu_torch.orchestrator.orchestrator import run_orchestrator

    run_orchestrator(parse_config(OrchestratorConfig))


if __name__ == "__main__":
    main()

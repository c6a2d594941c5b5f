"""``python -m prime_rl_tpu_torch.entrypoints.sft @ config.toml [--flags]``:
the SFT trainer process on one CUDA card (``--device cpu`` runs the kernels'
plain versions on the CPU instead; without a card and without that flag it
raises)."""

from __future__ import annotations

from prime_rl_tpu_torch.configs import SFTConfig, parse_config


def main() -> None:
    import os

    # a train state of several gigabytes of parameters comes close to the card's
    # memory: keep the caching allocator from stranding it in fragments (the
    # setting is read when the allocator is first used; the caller's own wins)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    from prime_rl_tpu_torch.trainer.sft.train import train

    train(parse_config(SFTConfig))


if __name__ == "__main__":
    main()

"""``python -m prime_rl_tpu_torch.entrypoints.inference @ config.toml [--flags]``:
the standalone sampling server on one CUDA card (``--device cpu`` runs the
kernels' plain versions on the CPU instead)."""

from __future__ import annotations

from prime_rl_tpu_torch.configs import InferenceConfig, parse_config


def check_supported(config: InferenceConfig) -> None:
    """Raise for what the port's engine does not serve yet."""
    unsupported = [name for name, on in (
        ("the weight plane", config.weight_plane is not None),
        ("P/D roles", config.server.role != "mixed")) if on]
    if unsupported:
        raise NotImplementedError(f"not ported yet: {', '.join(unsupported)}")
    if config.model.debug.vocab_size is not None and not config.model.debug.random_init:
        # a truncated vocabulary cannot load a real checkpoint's embeddings
        raise ValueError("model.debug.vocab_size truncates the vocabulary and needs "
                         "model.debug.random_init")


def build_server(config: InferenceConfig):
    import torch

    from prime_rl_tpu_torch.models import get_family
    from prime_rl_tpu_torch.models.base import get_spec
    from prime_rl_tpu_torch.models.qwen3 import load_hf_weights
    from prime_rl_tpu_torch.renderers.tokenizer import get_tokenizer
    from prime_rl_tpu_torch.sampler.cache import CacheConfig, page_nbytes, recurrent_nbytes
    from prime_rl_tpu_torch.sampler.engine import Engine
    from prime_rl_tpu_torch.sampler.server import InferenceServer
    from prime_rl_tpu_torch.utils.device import memory_info, resolve_device
    from prime_rl_tpu_torch.utils.logger import get_logger, setup_logger
    from prime_rl_tpu_torch.utils.pathing import logs_dir

    setup_logger(config.log.level, config.log.json_logs,
                 logs_dir(config.output_dir) / "inference.log")
    logger = get_logger()
    check_supported(config)
    device = resolve_device(config.device)
    spec = get_spec(config.model.name, num_layers=config.model.debug.num_layers,
                    vocab_size=config.model.debug.vocab_size)
    dtype = torch.bfloat16
    if config.model.debug.random_init:
        gen = torch.Generator(device=device)
        gen.manual_seed(config.seed)
        params = get_family(spec).init(spec, gen, dtype=dtype, device=device)
    else:
        from pathlib import Path

        if not (Path(config.model.name) / "config.json").exists():
            raise FileNotFoundError(
                f"{config.model.name} is not a local checkpoint dir; use "
                f"--model.debug.random-init for offline smoke tests")
        params = load_hf_weights(config.model.name, spec, dtype=dtype, device=device)

    num_pages = config.kv.num_pages
    page_bytes = page_nbytes(spec, config.kv.page_size)
    if num_pages is None:
        if device.type != "cuda":
            raise ValueError("kv.num_pages is required on the CPU (the pool is sized "
                             "from free device memory on the card)")
        # size the pool from what the card has left under the utilization
        # cap, the weights already resident
        torch.cuda.empty_cache()
        free, total = memory_info(device)
        budget = min(free, total * config.kv.hbm_utilization - (total - free))
        # a hybrid's recurrent rows come out of the same memory
        budget -= recurrent_nbytes(spec, config.scheduler.max_batch_size)
        num_pages = max(16, int(budget // page_bytes))
    cache_cfg = CacheConfig(
        num_pages=num_pages,
        page_size=config.kv.page_size,
        max_slots=config.scheduler.max_batch_size,
        max_seq_len=config.max_model_len,
    )
    logger.info(f"engine: model={config.model.name} device={device} "
                f"pages={num_pages}x{config.kv.page_size} ({num_pages * page_bytes / 2**30:.1f} GiB) "
                f"slots={cache_cfg.max_slots} max_len={config.max_model_len}")
    engine = Engine(params, spec, cache_cfg, device=str(device), compute_dtype=dtype,
                    seed=config.seed, lookahead=config.scheduler.lookahead,
                    decode_block=config.scheduler.decode_block,
                    collect_routed_experts=config.collect_routed_experts,
                    gdn_precision=config.model.gdn_mxu_precision,
                    lora_config=config.lora, quantize=config.quantization)
    del params  # the engine holds its own serving layout
    if config.scheduler.warmup_requests > 0:
        engine.warmup(config.scheduler.warmup_requests)
    tokenizer = get_tokenizer(config.tokenizer.name or config.model.name)
    return InferenceServer(engine, config.model.name, tokenizer, role=config.server.role)


def main() -> None:
    config = parse_config(InferenceConfig)
    server = build_server(config)
    server.run(config.server.host, config.server.port)


if __name__ == "__main__":
    main()

"""Colocated learner + sampler process: one card, serving and training
time-sliced on it (``python -m prime_rl_tpu_torch.entrypoints.colocated @
rl.toml``; the launcher ``entrypoints.rl`` spawns it when ``colocated =
true``).

The per-step weight "broadcast" is an in-process swap of the trainer's
parameter tensors into the live engine (``ColocatedBroadcast``): nothing
leaves the card. The orchestrator (a CPU process of its own) watches the
policy version over ``/liveness``.

The trainer and the sampler must name the same device: ``--trainer.device
cpu --inference.device cpu`` runs both on the CPU through the kernels' plain
versions; without a card and without those flags it raises.
"""

from __future__ import annotations

import asyncio
import json
import threading

from prime_rl_tpu_torch.configs import RLConfig, parse_config


def placeholder_params(spec, device, dtype) -> dict:
    """Zeros of the model's parameter shapes: the engine is built on them,
    and the trainer's startup publish (v0) replaces them before the
    orchestrator dispatches (it waits for version >= 0)."""
    import torch

    from prime_rl_tpu_torch.models import get_family
    from prime_rl_tpu_torch.trainer.optim import tree_map

    shapes = get_family(spec).init(spec, None, dtype=dtype, device="meta")
    return tree_map(lambda m: torch.zeros(m.shape, dtype=m.dtype, device=device), shapes)


def run_colocated(config: RLConfig):
    """Build the engine on placeholder weights, paused; serve it from a
    daemon thread; train with the in-process swap as the weight sink. Stops
    the server and returns the trainer's ``TrainResult``."""
    import torch

    from prime_rl_tpu_torch.entrypoints.inference import check_supported
    from prime_rl_tpu_torch.models.base import get_spec
    from prime_rl_tpu_torch.ops import _build
    from prime_rl_tpu_torch.renderers.tokenizer import get_tokenizer
    from prime_rl_tpu_torch.sampler.cache import CacheConfig
    from prime_rl_tpu_torch.sampler.engine import Engine
    from prime_rl_tpu_torch.sampler.server import InferenceServer
    from prime_rl_tpu_torch.trainer.rl.broadcast import ColocatedBroadcast
    from prime_rl_tpu_torch.trainer.rl.train import train
    from prime_rl_tpu_torch.utils.device import resolve_device
    from prime_rl_tpu_torch.utils.logger import get_logger, setup_logger
    from prime_rl_tpu_torch.utils.pathing import logs_dir

    tcfg, icfg = config.trainer, config.inference
    if tcfg.device != icfg.device:
        raise ValueError(f"the colocated process runs on one device, but trainer.device is "
                         f"{tcfg.device!r} and inference.device is {icfg.device!r}")
    check_supported(icfg)
    tcfg.output_dir = icfg.output_dir = config.output_dir
    setup_logger(tcfg.log.level, tcfg.log.json_logs,
                 logs_dir(config.output_dir) / "colocated.log")
    logger = get_logger()
    device = resolve_device(tcfg.device)

    spec = get_spec(tcfg.model.name, num_layers=tcfg.model.debug.num_layers,
                    vocab_size=tcfg.model.debug.vocab_size)
    cache_cfg = CacheConfig(
        # the trainer shares the card: the pool is sized here, never from
        # the free memory the trainer is about to take
        num_pages=icfg.kv.num_pages or 512,
        page_size=icfg.kv.page_size,
        max_slots=icfg.scheduler.max_batch_size,
        max_seq_len=icfg.max_model_len,
    )
    engine = Engine(placeholder_params(spec, device, torch.bfloat16), spec, cache_cfg,
                    device=str(device), compute_dtype=torch.bfloat16, seed=icfg.seed,
                    lookahead=icfg.scheduler.lookahead,
                    decode_block=icfg.scheduler.decode_block,
                    collect_routed_experts=icfg.collect_routed_experts,
                    gdn_precision=tcfg.model.gdn_mxu_precision)
    if icfg.scheduler.warmup_requests > 0:
        engine.warmup(icfg.scheduler.warmup_requests)
    engine.pause()  # no serving until real weights land
    tokenizer = get_tokenizer(icfg.tokenizer.name or icfg.model.name)
    server = InferenceServer(engine, tcfg.model.name, tokenizer)
    stop = threading.Event()

    def serve() -> None:
        async def _run():
            runner = await server.start_async(icfg.server.host, icfg.server.port)
            try:
                while not stop.is_set():
                    await asyncio.sleep(0.1)
            finally:
                await server.stop_async(runner)

        asyncio.run(_run())

    thread = threading.Thread(target=serve, daemon=True, name="inference-server")
    thread.start()
    logger.info(f"colocated: serving on :{icfg.server.port}, engine pages="
                f"{cache_cfg.num_pages}x{cache_cfg.page_size}, training starts now")
    try:
        result = train(tcfg, weight_sink=ColocatedBroadcast(engine))
    finally:
        stop.set()
        thread.join(timeout=30)
    logger.info(f"colocated engine host seconds: "
                f"{json.dumps({k: v for k, v in engine.stats.items() if k.startswith('host_')})}")
    logger.info(f"colocated kernel launches: {json.dumps(dict(_build.launches), sort_keys=True)}")
    return result


def main() -> None:
    import os

    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    run_colocated(parse_config(RLConfig))
    # bounded teardown: daemon threads hold zmq and aiohttp state that can
    # abort at interpreter shutdown
    os._exit(0)


if __name__ == "__main__":
    main()

"""SFT trainer process (the port of the JAX package's ``trainer/sft/train.py``
for one process): SFT is the RL train step with only the CE component on
(``ce_weights`` = the loss mask, ``rl_weights`` = 0), so it shares the
model, the step, the checkpoints and the weight snapshots with the RL
trainer. A held-out stream gives ``val_nll`` every ``val.interval`` steps.

Divergence from the JAX package, on purpose: SFT takes the RL trainer's
``model.debug.vocab_size`` guard (a truncated vocabulary needs random init),
which the JAX SFT trainer lacks. LoRA and a mesh larger than one device
raise until their slices."""

from __future__ import annotations

import time
from pathlib import Path

import torch

from prime_rl_tpu_torch.configs.trainer import DefaultLossConfig, SFTConfig
from prime_rl_tpu_torch.models.base import get_spec
from prime_rl_tpu_torch.models.qwen3 import load_hf_weights
from prime_rl_tpu_torch.trainer.ckpt import CheckpointManager, Progress
from prime_rl_tpu_torch.trainer.optim import make_optimizer
from prime_rl_tpu_torch.trainer.perf import PerfCounter
from prime_rl_tpu_torch.trainer.rl.train import TrainResult, reject_unported_model
from prime_rl_tpu_torch.trainer.sft.data import setup_sft_loader
from prime_rl_tpu_torch.trainer.step import (
    MicroBatchArrays,
    Scales,
    init_train_state,
    make_loss_fn,
    make_train_step,
    put_batch,
)
from prime_rl_tpu_torch.trainer.weights import WeightCheckpointManager
from prime_rl_tpu_torch.utils.device import resolve_device
from prime_rl_tpu_torch.utils.logger import get_logger, setup_logger
from prime_rl_tpu_torch.utils.monitor import setup_monitor
from prime_rl_tpu_torch.utils.pathing import logs_dir


def _reject_unported(config: SFTConfig) -> None:
    if config.data.max_mm_patches > 0:
        raise NotImplementedError("SFT on vision inputs waits for the VLM slice (ROADMAP.md, "
                                  "Queue 1 item 9)")
    reject_unported_model(config)


def train(config: SFTConfig) -> TrainResult:
    """Run SFT to ``max_steps`` (or the bench window). Returns the final state
    and the metrics records it logged, one per step (the validation records,
    ``{"val_nll": ...}``, go to the monitor only)."""
    _reject_unported(config)
    setup_logger(config.log.level, config.log.json_logs,
                 logs_dir(config.output_dir) / "sft.log")
    logger = get_logger()
    device = resolve_device(config.device)
    spec = get_spec(config.model.name, num_layers=config.model.debug.num_layers,
                    vocab_size=config.model.debug.vocab_size)
    logger.info(f"SFT: model={config.model.name} device={device} "
                f"params≈{spec.num_params()/1e6:.0f}M seq_len={config.data.seq_len}")

    # the default loss config is unused by SFT (CE-only batches), but the
    # shared step still needs one for its rl component
    loss_cfg = DefaultLossConfig()
    optimizer, schedule = make_optimizer(config.optimizer, config.scheduler, config.grad_clip)
    init_params = None
    if not config.model.debug.random_init:
        if (Path(config.model.name) / "config.json").exists():
            init_params = load_hf_weights(config.model.name, spec, dtype=torch.float32,
                                          device=device)
    state = init_train_state(spec, device, optimizer, seed=config.seed, params=init_params,
                             master_dtype=getattr(config.optimizer, "master_dtype", "float32"))
    train_step = make_train_step(spec, config.model, loss_cfg, optimizer, device)

    ckpt_mgr = CheckpointManager(config.output_dir, config.ckpt)
    weight_mgr = WeightCheckpointManager(config.output_dir, config.weight_ckpt, spec)
    monitor = setup_monitor(config.monitor, config.output_dir)
    progress = Progress()
    if config.ckpt.resume_step is not None:
        state, progress = ckpt_mgr.load(state, config.ckpt.resume_step)
        logger.info(f"resumed from step {progress.step}")

    tokenizer = None
    if config.data.type != "fake":
        from transformers import AutoTokenizer

        tokenizer = AutoTokenizer.from_pretrained(config.tokenizer.name or config.model.name)
    # fake data must stay inside the model's vocabulary
    config.data.fake_vocab = min(config.data.fake_vocab, spec.vocab_size)
    loader = setup_sft_loader(config.data, tokenizer)

    val_loader = val_loss_fn = None
    if config.val is not None:
        val_data = config.data.model_copy(update={"seed": config.val.seed,
                                                  "split": config.val.split})
        val_loader = setup_sft_loader(val_data, tokenizer)
        val_loss_fn = make_loss_fn(spec, config.model, loss_cfg)

    def sync() -> None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def run_validation(step: int) -> None:
        totals, counts = 0.0, 0.0
        for _ in range(config.val.num_batches):
            vb, vcounts = val_loader.next_batch()
            vb = put_batch(vb, device)
            sc = Scales(1.0, float(max(vcounts["ce"], 1)), 1.0)
            with torch.no_grad():
                for i in range(vb.input_ids.shape[0]):
                    mb = MicroBatchArrays(*[None if x is None else x[i] for x in vb])
                    nll = val_loss_fn(state.params, mb, sc)[1]["nll"]
                    totals += float(nll.total)
                    counts += float(nll.count)
        val_nll = totals / max(counts, 1.0)
        monitor.log({"val_nll": val_nll}, step)
        logger.info(f"validation @ step {step}: nll={val_nll:.4f}")

    perf = PerfCounter(spec.flops_per_token(config.data.seq_len), 1, device=device)
    records: list[dict] = []
    max_steps = config.max_steps or 10**9
    bench = config.bench
    while progress.step < max_steps:
        batch, counts = loader.next_batch()
        tokens = int(batch.loss_mask.size)
        # the rl component carries zero weights
        scales = Scales(rl=1.0, ce=float(max(counts["ce"], 1)), ref_kl=1.0)
        sync()
        t0 = time.perf_counter()
        state, metrics = train_step(state, batch, scales)
        loss = float(metrics["loss"])  # reads the device: the step has finished
        sync()
        dt = time.perf_counter() - t0
        progress.step += 1
        progress.total_tokens += tokens
        perf.record(dt, tokens)

        record = {
            "loss": loss,
            "nll": float(metrics["nll"].mean) if "nll" in metrics else None,
            "grad_norm": float(metrics["grad_norm"]),
            "lr": float(schedule(progress.step)),
            "tokens_per_sec": perf.tokens_per_sec,
            "mfu": perf.mfu(),
            "step_time_s": dt,
            "total_tokens": progress.total_tokens,
        }
        if device.type == "cuda":
            record["device_mem_peak_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
        monitor.log(record, progress.step)
        records.append(record)
        logger.info(f"step {progress.step}: loss={loss:.4f} nll={record['nll']:.4f} "
                    f"tps={perf.tokens_per_sec:,.0f} ({dt*1e3:.0f} ms)")

        if val_loader is not None and progress.step % config.val.interval == 0:
            run_validation(progress.step)
        if bench is None and progress.step % config.ckpt.interval == 0:
            ckpt_mgr.save(state, progress)
        if bench is None and progress.step % config.weight_ckpt.interval == 0:
            weight_mgr.save(state.params, progress.step)
        if bench is not None and progress.step >= bench.warmup_steps + bench.steps:
            break

    if bench is None:
        ckpt_mgr.save(state, progress)
    monitor.finalize()
    logger.info("SFT done")
    return TrainResult(state, records)

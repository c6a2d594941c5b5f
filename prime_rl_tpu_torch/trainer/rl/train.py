"""RL trainer process (the port of the JAX package's ``trainer/rl/train.py``
for one process): build the train state on the device, take each batch from
the transport (the orchestrator's TrainingBatches) or from the fake loader,
run the learner step, publish the new policy through the weight sink (an HF
snapshot + STABLE marker that the orchestrator's watcher applies to the
sampler pool, or the colocated in-process swap), write the metrics record and
checkpoints.

Version protocol: policy v0 = initial weights published at startup; after
consuming batch ``s`` the trainer publishes v``s+1``. The orchestrator gates
dispatch and shipment on these versions.

More than one process (the micro-batch packer), multi-tenant LoRA runs,
token export, the metrics server and the heartbeat raise until their
slices."""

from __future__ import annotations

import time
from pathlib import Path
from typing import NamedTuple

import torch

from prime_rl_tpu_torch.configs.trainer import TrainerConfig
from prime_rl_tpu_torch.models.base import get_spec
from prime_rl_tpu_torch.models.qwen3 import load_hf_weights
from prime_rl_tpu_torch.trainer.batch import prepare_batch, token_counts
from prime_rl_tpu_torch.trainer.ckpt import CheckpointManager, Progress
from prime_rl_tpu_torch.trainer.optim import make_optimizer
from prime_rl_tpu_torch.trainer.perf import PerfCounter
from prime_rl_tpu_torch.trainer.rl.broadcast import FilesystemBroadcast, make_broadcast
from prime_rl_tpu_torch.trainer.rl.data import FakeDataLoader
from prime_rl_tpu_torch.trainer.step import (
    Scales,
    TrainState,
    init_train_state,
    make_train_step,
)
from prime_rl_tpu_torch.trainer.weights import WeightCheckpointManager
from prime_rl_tpu_torch.transport import setup_training_batch_receiver
from prime_rl_tpu_torch.utils.device import resolve_device
from prime_rl_tpu_torch.utils.logger import get_logger, setup_logger
from prime_rl_tpu_torch.utils.monitor import setup_monitor
from prime_rl_tpu_torch.utils.pathing import logs_dir

class TrainResult(NamedTuple):
    state: TrainState  # the state after the last step
    records: list[dict]  # the metrics record of every step, as logged


def reject_unported_model(config) -> None:
    """The refusals the RL and SFT trainers share (``config``: a
    ``TrainerConfig`` or an ``SFTConfig``): LoRA, a truncated vocabulary
    without random init, and a mesh larger than one device."""
    if config.model.lora is not None:
        raise NotImplementedError("LoRA training waits for the LoRA slice (ROADMAP.md, Queue 1 "
                                  "item 8)")
    if config.model.debug.vocab_size is not None and not config.model.debug.random_init:
        # a truncated vocabulary cannot load a checkpoint's embeddings and head
        raise ValueError("model.debug.vocab_size truncates the vocabulary and needs "
                         "model.debug.random_init")
    mesh = config.mesh.model_dump()  # one process, one card: any other mesh raises
    if any(v not in (1, -1) for v in mesh.values()):
        raise NotImplementedError(f"mesh {mesh}: more than one device waits for the "
                                  "multi-card slice (ROADMAP.md, Queue 1 item 11)")


def _reject_unported(config: TrainerConfig) -> None:
    waiting = [name for name, on in (
        ("multi_run", config.multi_run),
        ("token_export_rows", config.token_export_rows > 0),
        ("metrics_server", config.metrics_server.enable),
        ("heartbeat_url", config.heartbeat_url is not None)) if on]
    if waiting:
        raise NotImplementedError(f"{', '.join(waiting)}: not ported yet (ROADMAP.md, "
                                  "Queue 1: item 8 for multi_run, item 10 for the rest)")
    reject_unported_model(config)


def train(config: TrainerConfig, weight_sink=None) -> TrainResult:
    """Run the trainer to ``max_steps`` (or the bench window). Returns the
    final state and the metrics records it logged, one per step. ``weight_sink``: a
    ``WeightBroadcastSink`` override; None = the configured broadcast."""
    _reject_unported(config)
    setup_logger(config.log.level, config.log.json_logs,
                 logs_dir(config.output_dir) / "trainer.log")
    logger = get_logger()
    device = resolve_device(config.device)
    spec = get_spec(config.model.name, num_layers=config.model.debug.num_layers,
                    vocab_size=config.model.debug.vocab_size)
    logger.info(
        f"RL trainer: model={config.model.name} device={device} "
        f"params≈{spec.num_params()/1e6:.0f}M seq_len={config.batch.seq_len}"
    )

    optimizer, schedule = make_optimizer(config.optimizer, config.scheduler, config.grad_clip)
    init_params = None
    if not config.model.debug.random_init:
        if (Path(config.model.name) / "config.json").exists():
            init_params = load_hf_weights(config.model.name, spec, dtype=torch.float32,
                                          device=device)
    state = init_train_state(spec, device, optimizer, seed=config.seed, params=init_params,
                             offload_optimizer=config.offload_optimizer,
                             offload_params=config.offload_params,
                             master_dtype=getattr(config.optimizer, "master_dtype", "float32"))
    # config.dispatch_micro_batches is accepted and inert: the step's host
    # loop over the micro-batches is its only form
    train_step = make_train_step(spec, config.model, config.loss, optimizer, device)

    ckpt_mgr = CheckpointManager(config.output_dir, config.ckpt)
    weight_mgr = WeightCheckpointManager(config.output_dir, config.weight_ckpt, spec)
    monitor = setup_monitor(config.monitor, config.output_dir, "trainer")
    progress = Progress()
    if config.ckpt.resume_step is not None:
        state, progress = ckpt_mgr.load(state, config.ckpt.resume_step)
        logger.info(f"resumed from step {progress.step}")

    fake_loader = receiver = None
    if config.data.type == "fake":
        fake_loader = FakeDataLoader(
            spec.vocab_size, config.data.seq_len, config.data.micro_batch_size,
            config.data.num_micro_batches, seed=config.data.seed,
        )
    else:
        receiver = setup_training_batch_receiver(config.transport, config.output_dir,
                                                 progress.step)

    # startup broadcast: publish the current policy so the sampler starts from
    # trainer weights
    if weight_sink is None:
        weight_sink = make_broadcast(config.broadcast, weight_mgr, config.output_dir)
    # non-filesystem planes still snapshot to disk on the weight_ckpt interval
    snapshot_interval = (
        None if isinstance(weight_sink, FilesystemBroadcast) else config.weight_ckpt.interval
    )
    version = progress.step
    weight_sink.publish(state.params, version)
    logger.info(f"published initial weights v{version}")
    skipped_publishes = False  # set when the shutdown carve-out elides publishes

    profiler = None
    if config.trace_path:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=acts)
        profiler.start()

    def sync() -> None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    perf = PerfCounter(spec.flops_per_token(config.batch.seq_len), 1, device=device)
    bench = config.bench
    records: list[dict] = []
    max_steps = config.max_steps or 10**9
    while progress.step < max_steps:
        t_wait = time.perf_counter()
        if fake_loader is not None:
            batch, counts = fake_loader.next_batch()
        else:
            while (tb := receiver.receive(timeout=1.0)) is None:
                pass  # the orchestrator has not shipped this step yet
            batch = prepare_batch(tb.examples, config.batch.seq_len,
                                  config.batch.micro_batch_size,
                                  num_micro_batches=config.batch.num_micro_batches)
            counts = token_counts(batch)
        wait_s = time.perf_counter() - t_wait

        tokens = int(batch.loss_mask.size)
        scales = Scales(rl=float(max(counts["rl"], 1)), ce=float(max(counts["ce"], 1)),
                        ref_kl=float(max(counts["ref_kl"], 1)))
        sync()
        t0 = time.perf_counter()
        state, metrics = train_step(state, batch, scales)
        loss = float(metrics["loss"])  # reads the device: the step has finished
        sync()
        dt = time.perf_counter() - t0
        progress.step += 1
        progress.total_tokens += tokens
        perf.record(dt, tokens)

        # weight broadcast: v{step}
        version = progress.step
        skip_final = (
            config.final_publish_skip > 0
            and config.max_steps is not None
            and progress.step > config.max_steps - config.final_publish_skip
        )
        if skip_final and progress.step == config.max_steps - config.final_publish_skip + 1:
            skipped_publishes = True
            logger.info(f"skipping the final {config.final_publish_skip} publishes "
                        "(one-step-off shutdown carve-out)")
        pub_s = 0.0
        if bench is None and not skip_final:
            t_pub = time.perf_counter()
            weight_sink.publish(state.params, version)
            if snapshot_interval is not None and progress.step % snapshot_interval == 0:
                weight_mgr.save(state.params, version)
            pub_s = time.perf_counter() - t_pub

        record = {
            "loss": loss,
            "grad_norm": float(metrics["grad_norm"]),
            "mismatch_kl": (float(metrics["mismatch_kl"].mean)
                            if "mismatch_kl" in metrics else None),
            "entropy": float(metrics["entropy"].mean),
            "lr": float(schedule(progress.step)),
            "tokens_per_sec": perf.tokens_per_sec,
            "mfu": perf.mfu(),
            "step_time_s": dt,
            "wait_for_batch_s": wait_s,
            "publish_s": pub_s,
            "rl_tokens": counts["rl"],
        }
        if device.type == "cuda" and progress.step % 50 == 0:
            record["device_mem_peak_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
        monitor.log(record, progress.step)
        records.append(record)
        logger.info(
            f"step {progress.step}: loss={loss:.4f} kl={record['mismatch_kl']} "
            f"ent={record['entropy']:.3f} tps={perf.tokens_per_sec:,.0f} "
            f"(step {dt*1e3:.0f} ms, wait {wait_s*1e3:.0f} ms)"
        )

        if bench is None and progress.step % config.ckpt.interval == 0:
            ckpt_mgr.save(state, progress)
        if bench is not None and progress.step >= bench.warmup_steps + bench.steps:
            break

    if profiler is not None:
        profiler.stop()
        Path(config.trace_path).mkdir(parents=True, exist_ok=True)
        profiler.export_chrome_trace(str(Path(config.trace_path) / "trainer_trace.json"))
        logger.info(f"profiler trace written to {config.trace_path}")
    if bench is None and skipped_publishes:
        # the carve-out skipped only the broadcast: the final trained weights
        # are still persisted, so the newest snapshot is v{max_steps}
        weight_mgr.save(state.params, progress.step)
        logger.info(f"persisted final weights v{progress.step} "
                    "(broadcast elided by the shutdown carve-out)")
    if bench is None:
        ckpt_mgr.save(state, progress)
    if hasattr(weight_sink, "close"):
        weight_sink.close()
    if receiver is not None:
        receiver.close()
    monitor.finalize()
    logger.info("trainer done")
    return TrainResult(state, records)

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

LoRA (``model.lora``): the base is frozen in the compute dtype
(``init_base_params``), the state holds the adapter tree, and each publish
hands the sampler the merge of the two (``merge_lora``: new tensors for the
merged projections, so that neither the colocated swap nor a snapshot writes
into the trainer's base); each weight snapshot also gets the standalone PEFT
adapter under ``adapter/`` (``export_adapter``). ``multi_run``: batches are
routed to the tenant ``run_{run_idx}`` of a ``MultiRunManager``, whose
adapter state the step then trains; a tenant's merged weights and adapter are
published under ``runs/run_{i}/weights/step_N`` on its own step count.

Host offload (``offload_optimizer``, ``offload_params``) goes to
``init_train_state`` and ``make_train_step`` (``trainer/step.py``). Python's
automatic collector is off while ``train`` runs, with a collection every 50
steps (``utils/memory.GarbageCollection``, as the JAX trainer does), and
turned back on when it returns or raises (the JAX trainer never turns it
back on; the colocated process and the tests call ``train`` in interpreters
that live on). Each step record carries ``device_memory_stats``.

``metrics_server`` serves each step's record as Prometheus gauges
(``utils/metrics_server.py``), ``heartbeat_url`` is pinged every
``heartbeat_interval`` seconds (``utils/heartbeat.py``) and
``token_export_rows`` writes each step's batch to
``token_export/step_N.jsonl`` before the step (``token_export.py``); the
server and the heartbeat stop when ``train`` returns or raises.

More than one process (the micro-batch packer) raises until its slice."""

from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
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
from prime_rl_tpu_torch.trainer.rl.token_export import TokenExporter
from prime_rl_tpu_torch.trainer.step import (
    Scales,
    TrainState,
    init_train_state,
    make_train_step,
    params_fingerprint,
)
from prime_rl_tpu_torch.trainer.weights import WeightCheckpointManager
from prime_rl_tpu_torch.transport import setup_training_batch_receiver
from prime_rl_tpu_torch.utils.device import resolve_device
from prime_rl_tpu_torch.utils.logger import get_logger, setup_logger
from prime_rl_tpu_torch.utils import pathing
from prime_rl_tpu_torch.utils.memory import GarbageCollection, device_memory_stats
from prime_rl_tpu_torch.utils.metrics_server import maybe_start_metrics_server
from prime_rl_tpu_torch.utils.monitor import setup_monitor
from prime_rl_tpu_torch.utils.pathing import logs_dir

class TrainResult(NamedTuple):
    state: TrainState  # the state after the last step
    records: list[dict]  # the metrics record of every step, as logged


def reject_unported_model(config) -> None:
    """The refusals the RL and SFT trainers share (``config``: a
    ``TrainerConfig`` or an ``SFTConfig``): LoRA on a family the port does not
    train yet (every ported family's forward takes an adapter), a truncated
    vocabulary without random init,
    and a mesh larger than one device."""
    if config.model.lora is not None:
        from prime_rl_tpu_torch.models import FAMILIES

        spec = get_spec(config.model.name, num_layers=config.model.debug.num_layers,
                        vocab_size=config.model.debug.vocab_size)
        if spec.family not in FAMILIES:
            raise NotImplementedError(
                f"LoRA on the {spec.family!r} family waits for that family's slice "
                "(ROADMAP.md, Queue 1 item 9)")
    if config.model.debug.vocab_size is not None and not config.model.debug.random_init:
        # a truncated vocabulary cannot load a checkpoint's embeddings and head
        raise ValueError("model.debug.vocab_size truncates the vocabulary and needs "
                         "model.debug.random_init")
    mesh = config.mesh.model_dump()  # one process, one card: any other mesh raises
    if any(v not in (1, -1) for v in mesh.values()):
        raise NotImplementedError(f"mesh {mesh}: more than one device waits for the "
                                  "multi-card slice (ROADMAP.md, Queue 1 item 11)")


def _reject_unported(config: TrainerConfig) -> None:
    if config.multi_run and config.model.lora is None:
        raise ValueError("multi_run trains one LoRA adapter a tenant and needs model.lora")
    reject_unported_model(config)


def lora_setup(config, spec, device, optimizer, init_params):
    """(base_params, adapter state) of LoRA mode: the frozen base in the
    compute dtype (the given weights, or a random init from ``seed``) and
    the adapter's train state."""
    from prime_rl_tpu_torch.trainer.step import init_base_params, init_lora_train_state

    dtype = torch.bfloat16 if config.model.compute_dtype == "bfloat16" else torch.float32
    base = init_base_params(spec, device, config.seed, init_params, dtype=dtype)
    state = init_lora_train_state(spec, config.model.lora, device, optimizer, config.seed)
    return base, state


def export_adapter(lora_params, spec, weights_dir) -> bool:
    """Write the standalone PEFT adapter under ``weights_dir/adapter/``, next
    to a merged snapshot, servable without a merge through
    ``/load_lora_adapter``. Nothing where the snapshot directory does not
    exist (a non-filesystem plane outside its snapshot interval)."""
    from prime_rl_tpu_torch.models.lora import save_adapter

    d = Path(weights_dir)
    if not d.exists():
        return False
    save_adapter(lora_params, spec, d / "adapter")
    return True


def train(config: TrainerConfig, weight_sink=None) -> TrainResult:
    """Run the trainer to ``max_steps`` (or the bench window). Returns the
    final state and the metrics records it logged, one per step. ``weight_sink``: a
    ``WeightBroadcastSink`` override; None = the configured broadcast."""
    _reject_unported(config)
    gc_gate = GarbageCollection(interval=50)
    with contextlib.ExitStack() as on_exit:
        on_exit.callback(gc_gate.restore)
        return _train(config, weight_sink, gc_gate, on_exit)


def _train(config: TrainerConfig, weight_sink, gc_gate: GarbageCollection,
           on_exit: contextlib.ExitStack) -> TrainResult:
    """``on_exit``: what ``train`` releases when it returns or raises (the
    metrics server and the heartbeat are stopped there)."""
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
    base_params = run_mgr = None
    if config.model.lora is not None:
        base_params, state = lora_setup(config, spec, device, optimizer, init_params)
        del init_params
        base_print = params_fingerprint(base_params)
        logger.info(f"LoRA r{config.model.lora.rank}: training adapters only; frozen base "
                    f"fingerprint {base_print}")
        if config.multi_run:
            from prime_rl_tpu_torch.trainer.runs import MultiRunManager

            run_mgr = MultiRunManager(config.output_dir, spec, config.model.lora, device,
                                      optimizer, max_runs=config.max_runs, seed=config.seed)
            logger.info(f"multi-run: up to {config.max_runs} concurrent LoRA tenants")
    else:
        state = init_train_state(spec, device, optimizer, seed=config.seed, params=init_params,
                                 offload_optimizer=config.offload_optimizer,
                                 offload_params=config.offload_params,
                                 master_dtype=getattr(config.optimizer, "master_dtype",
                                                      "float32"))
    # config.dispatch_micro_batches is accepted and inert: the step's host
    # loop over the micro-batches is its only form
    train_step = make_train_step(spec, config.model, config.loss, optimizer, device,
                                 base_params=base_params,
                                 offload_optimizer=config.offload_optimizer,
                                 offload_params=config.offload_params)

    def publish_params():
        """The policy to serve: the state's params, or in LoRA mode the base
        with the adapter merged into new tensors."""
        if base_params is None:
            return state.params
        from prime_rl_tpu_torch.models.lora import merge_lora

        return merge_lora(base_params, state.params, config.model.lora, spec=spec)

    def publish_adapter(version: int) -> None:
        if base_params is not None:
            export_adapter(state.params, spec, pathing.weights_dir(config.output_dir, version))

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
    weight_sink.publish(publish_params(), version)
    if snapshot_interval is None:
        publish_adapter(version)
    logger.info(f"published initial weights v{version}")
    if run_mgr is not None:
        # every tenant found on disk publishes its starting adapter, so that
        # its orchestrator (watching runs/<id>/weights) finds a v0 before the
        # first batch. The JAX trainer publishes a tenant only after its first
        # step, and the tenant's orchestrator then waits out its 300 s sync.
        for rid in run_mgr.discover():
            run = run_mgr.get_or_create(rid)
            run_mgr.publish(run, base_params, run.progress.step)
    skipped_publishes = False  # set when the shutdown carve-out elides publishes

    metrics_server = maybe_start_metrics_server(config.metrics_server)
    if metrics_server is not None:
        on_exit.callback(metrics_server.stop)
    exporter = None
    if config.token_export_rows > 0:
        exporter = TokenExporter(config.output_dir, config.token_export_rows)
    if config.heartbeat_url:
        from prime_rl_tpu_torch.utils.heartbeat import Heartbeat  # imports httpx

        on_exit.callback(Heartbeat(config.heartbeat_url, config.heartbeat_interval).start().stop)

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
        run = None
        if fake_loader is not None:
            batch, counts = fake_loader.next_batch()
        else:
            while (tb := receiver.receive(timeout=1.0)) is None:
                pass  # the orchestrator has not shipped this step yet
            batch = prepare_batch(tb.examples, config.batch.seq_len,
                                  config.batch.micro_batch_size,
                                  num_micro_batches=config.batch.num_micro_batches,
                                  vlm_spec=spec if spec.vision is not None else None,
                                  max_mm_patches=config.batch.max_mm_patches)
            counts = token_counts(batch)
            if run_mgr is not None:
                run = run_mgr.get_or_create(f"run_{tb.run_idx or 0}")
                state = run.state  # the tenant's adapter: the same step, another state
        wait_s = time.perf_counter() - t_wait

        if exporter is not None:
            exporter.export(progress.step, batch)
        tokens = int(batch.loss_mask.size)
        mm_seg = batch.mm_vis_seg_ids
        mm_patches = None if mm_seg is None else int((np.asarray(mm_seg) > 0).sum())
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
        if run is not None:
            run.state = state
            run.progress.step += 1
            if run.progress.step % config.weight_ckpt.interval == 0:
                run_mgr.publish(run, base_params, run.progress.step)
            if run.progress.step % config.ckpt.interval == 0:
                run_mgr.save(run)

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
            served = publish_params()
            weight_sink.publish(served, version)
            if snapshot_interval is None:
                publish_adapter(version)  # the filesystem plane wrote the snapshot
            elif progress.step % snapshot_interval == 0:
                weight_mgr.save(served, version)
                publish_adapter(version)
            del served
            pub_s = time.perf_counter() - t_pub

        record = {
            "loss": loss,
            "grad_norm": float(metrics["grad_norm"]),
            **({"run_id": run.run_id, "run_step": run.progress.step} if run is not None else {}),
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
        if mm_patches is not None:
            record["mm_patches"] = mm_patches  # real (non-pad) vision patches
        record.update(device_memory_stats(device))
        monitor.log(record, progress.step)
        records.append(record)
        gc_gate.maybe_collect(progress.step)
        if metrics_server is not None:
            metrics_server.update({"step": progress.step, **record})
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
    if run_mgr is not None:
        run_mgr.save_all()
    if base_params is not None:
        end_print = params_fingerprint(base_params)
        logger.info(f"LoRA frozen base fingerprint at the end: {end_print}")
        if end_print != base_print:
            raise RuntimeError(f"the frozen LoRA base changed during training ({base_print} -> "
                               f"{end_print})")
    if bench is None and skipped_publishes:
        # the carve-out skipped only the broadcast: the final trained weights
        # are still persisted, so the newest snapshot is v{max_steps}
        weight_mgr.save(publish_params(), progress.step)
        publish_adapter(progress.step)
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

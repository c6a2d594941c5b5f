"""Filesystem transport (reference: transport/filesystem.py:171): batches land
under rollouts/step_N with STABLE markers; survives process restarts."""

from __future__ import annotations

import os
import time
from pathlib import Path

from prime_rl_tpu_torch.transport.base import (
    MicroBatchReceiver,
    MicroBatchSender,
    TrainingBatchReceiver,
    TrainingBatchSender,
)
from prime_rl_tpu_torch.transport.types import MicroBatch, TrainingBatch, decode, encode
from prime_rl_tpu_torch.utils.pathing import rollout_dir


def _atomic_write(path: Path, data: bytes) -> None:
    tmp = path.with_suffix(".tmp")
    tmp.write_bytes(data)
    os.replace(tmp, path)


class FSTrainingBatchSender(TrainingBatchSender):
    def __init__(self, output_dir: str | Path):
        self.output_dir = Path(output_dir)

    def send(self, batch: TrainingBatch) -> None:
        d = rollout_dir(self.output_dir, batch.step)
        d.mkdir(parents=True, exist_ok=True)
        _atomic_write(d / "batch.msgpack", encode(batch))


class FSTrainingBatchReceiver(TrainingBatchReceiver):
    def __init__(self, output_dir: str | Path, start_step: int = 0):
        self.output_dir = Path(output_dir)
        self.next_step = start_step

    def receive(self, timeout: float | None = None) -> TrainingBatch | None:
        path = rollout_dir(self.output_dir, self.next_step) / "batch.msgpack"
        deadline = None if timeout is None else time.monotonic() + timeout
        while not path.exists():
            if deadline is not None and time.monotonic() > deadline:
                return None
            time.sleep(0.2)
        batch = decode(path.read_bytes())
        self.next_step += 1
        return batch


class FSMicroBatchSender(MicroBatchSender):
    def __init__(self, output_dir: str | Path):
        self.output_dir = Path(output_dir)

    def send(self, step: int, per_rank: list[list[MicroBatch]],
             counts: dict | None = None) -> None:
        d = rollout_dir(self.output_dir, step)
        d.mkdir(parents=True, exist_ok=True)
        for rank, mbs in enumerate(per_rank):
            _atomic_write(d / f"micro_rank{rank}.msgpack",
                          encode({"step": step, "micro_batches": mbs,
                                  "counts": counts or {}}))


class FSMicroBatchReceiver(MicroBatchReceiver):
    def __init__(self, output_dir: str | Path, rank: int, start_step: int = 0):
        self.output_dir = Path(output_dir)
        self.rank = rank
        self.next_step = start_step

    def receive(self, timeout: float | None = None) -> tuple[int, list[MicroBatch]] | None:
        path = rollout_dir(self.output_dir, self.next_step) / f"micro_rank{self.rank}.msgpack"
        deadline = None if timeout is None else time.monotonic() + timeout
        while not path.exists():
            if deadline is not None and time.monotonic() > deadline:
                return None
            time.sleep(0.2)
        msg = decode(path.read_bytes())
        self.next_step += 1
        return msg["step"], msg["micro_batches"], msg.get("counts") or {}

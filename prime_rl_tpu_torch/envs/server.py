"""Env server: ZMQ ROUTER + asyncio worker pool
(reference contract: verifiers ``serve_env`` — entrypoints/env_server.py:3-4,
SURVEY.md §2.6).

Protocol (msgpack over ROUTER/DEALER):
  request:  {"id": str, "method": "info"|"taskset"|"run", ...}
  run:      {"task_data": {...} | "task_idx": int, "sampling": {...},
             "base_url": str}
  response: {"id": str, "result": {...}} | {"id": str, "error": str}

Rollouts execute concurrently as asyncio tasks (bounded by ``max_workers``);
each drives the policy through the token-level InferenceClient.
"""

from __future__ import annotations

import asyncio
from dataclasses import asdict

import zmq
import zmq.asyncio

from prime_rl_tpu_torch.envs.base import Environment
from prime_rl_tpu_torch.envs.client import InferenceClient
from prime_rl_tpu_torch.envs.types import Episode, SamplingConfig, episode_to_wire
from prime_rl_tpu_torch.transport.types import pack, unpack
from prime_rl_tpu_torch.utils.logger import get_logger


async def serve_env(
    env: Environment,
    address: str,
    *,
    max_workers: int = 64,
    stop_event: asyncio.Event | None = None,
) -> None:
    logger = get_logger()
    ctx = zmq.asyncio.Context.instance()
    sock = ctx.socket(zmq.ROUTER)
    sock.bind(address)
    logger.info(f"env server '{env.name}' on {address} ({max_workers} workers)")
    taskset = env.load_taskset()
    sem = asyncio.Semaphore(max_workers)
    clients: dict[str, InferenceClient] = {}

    def client_for(base_url: str) -> InferenceClient:
        if base_url not in clients:
            clients[base_url] = InferenceClient(base_url)
        return clients[base_url]

    async def handle(identity: bytes, msg: dict) -> None:
        rid = msg.get("id")
        try:
            method = msg["method"]
            if method == "info":
                result = {"name": env.name, "num_tasks": len(taskset)}
            elif method == "taskset":
                result = {"tasks": taskset}
            elif method == "run":
                task_data = msg.get("task_data")
                if task_data is None:
                    task_data = taskset[msg["task_idx"]]
                sampling = SamplingConfig(**msg.get("sampling", {}))
                async with sem:
                    episode = await env.rollout(
                        client_for(msg["base_url"]), task_data, sampling
                    )
                result = {"episode": episode_to_wire(episode)}
            else:
                raise ValueError(f"unknown method {method!r}")
            await sock.send_multipart([identity, pack({"id": rid, "result": result})])
        except Exception as e:
            logger.exception(f"env request {rid} failed")
            await sock.send_multipart([identity, pack({"id": rid, "error": f"{type(e).__name__}: {e}"})])

    stop_event = stop_event or asyncio.Event()
    while not stop_event.is_set():
        try:
            identity, payload = await asyncio.wait_for(sock.recv_multipart(), timeout=0.5)
        except asyncio.TimeoutError:
            continue
        asyncio.create_task(handle(identity, unpack(payload)))

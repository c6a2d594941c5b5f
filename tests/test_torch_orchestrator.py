"""The port's orchestrator against the JAX package's: both run over the same
stubbed inference client (fixed completions and logprobs, no server), the
same envs, algorithms and filters, from the same seed, and ship
TrainingBatches whose encoded bytes are equal, step for step.

The orchestrator's pieces run in lockstep here (schedule a group, await its
rollouts, finalize, filter, cut and ship), so that asyncio's interleaving of
concurrent rollouts cannot reorder a batch; the launcher's loop test drives
``Orchestrator.run`` itself."""

import asyncio

import numpy as np
import pytest

from prime_rl_tpu.configs import OrchestratorConfig as JOrchestratorConfig
from prime_rl_tpu.envs import client as jclient
from prime_rl_tpu.orchestrator import orchestrator as jorch
from prime_rl_tpu_torch.configs import OrchestratorConfig
from prime_rl_tpu_torch.envs import client as tclient
from prime_rl_tpu_torch.orchestrator import orchestrator as torch_orch
from prime_rl_tpu_torch.renderers.tokenizer import ByteTokenizer
from prime_rl_tpu_torch.transport.types import decode
from prime_rl_tpu_torch.utils import pathing

_CANDIDATES = ["ok", "o", "okay", "no", "kk", "tac", "god", "dnas", "xyz", ""]
STEPS = 3


def _stub_client(monkeypatch, module, seed: int) -> None:
    """Patch the package's InferenceClient: the n-th generate call returns a
    completion drawn from a fixed list by a generator seeded with n, and the
    engine reports a policy version far ahead, so no gate ever waits."""
    tok = ByteTokenizer()
    calls = [0]

    async def generate(self, token_ids, sampling, **kw):
        rng = np.random.default_rng([seed, calls[0]])
        calls[0] += 1
        await asyncio.sleep(0)  # a real request yields to the loop
        ids = tok.encode(_CANDIDATES[int(rng.integers(len(_CANDIDATES)))])
        if rng.random() < 0.7:
            ids = ids + [tok.eos_token_id]
        ids = ids[: sampling.max_tokens]
        return module.TokenCompletion(
            token_ids=ids, logprobs=[float(x) for x in -rng.random(len(ids))],
            finish_reason="stop", prompt_len=len(token_ids), policy_version=100)

    async def liveness(self):
        return {"status": "ok", "policy_version": 100}

    monkeypatch.setattr(module.InferenceClient, "generate", generate)
    monkeypatch.setattr(module.InferenceClient, "liveness", liveness)


async def _drive(module, config) -> None:
    orch = module.Orchestrator(config)

    async def no_scrape():
        return {}

    orch._scrape_engine_metrics = no_scrape  # no server to scrape
    await orch.setup()
    try:
        while orch.progress.step < STEPS:
            group = await orch._schedule_group()
            await asyncio.gather(*group.tasks)
            while not orch._group_done.empty():
                done = orch._group_done.get_nowait()
                kept = orch._process_group(done)
                orch._note_group_yield(done, kept)
                orch.completed_rollouts.extend(kept)
                if orch._batch_ready() and orch.progress.step < STEPS:
                    await orch._ship_batch()
    finally:
        orch.sender.close()
        orch.monitor.finalize()
        for client in orch.pool.clients:
            await client.close()


CASES = [
    ("reverse_text", "grpo", "enforce"),
    ("fixed_completion", "grpo", "monitor"),
    ("fixed_completion", "max_rl", "enforce"),
    ("reverse_text", "rae", "monitor"),
    ("fixed_completion", "hierarchical_grpo", "monitor"),
]


@pytest.mark.parametrize("env,algo,mode", CASES)
def test_orchestrators_ship_equal_batches(env, algo, mode, tmp_path, monkeypatch):
    raw = {
        "model_name": "debug", "batch_size": 8, "seq_len": 256, "seed": 5,
        "max_inflight_episodes": 64, "transport": {"type": "filesystem"},
        "watch": "liveness", "client": {"base_urls": ["http://127.0.0.1:9"]},
        "tokenizer": {"name": "byte"},
        "train_envs": [{"name": env, "group_size": 4, "algo": {"type": algo},
                        "sampling": {"max_tokens": 8, "temperature": 1.0},
                        "args": {"num_examples": 16, "seed": 3}}],
        "filters": [{"type": "zero_advantage", "mode": mode}],
    }
    outputs = {}
    for name, cfg_cls, module, client_module in (
            ("jax", JOrchestratorConfig, jorch, jclient),
            ("port", OrchestratorConfig, torch_orch, tclient)):
        _stub_client(monkeypatch, client_module, seed=11)
        out = tmp_path / name
        asyncio.run(_drive(module, cfg_cls(**raw, output_dir=str(out))))
        outputs[name] = out
    for step in range(STEPS):
        jbytes = (pathing.rollout_dir(outputs["jax"], step) / "batch.msgpack").read_bytes()
        tbytes = (pathing.rollout_dir(outputs["port"], step) / "batch.msgpack").read_bytes()
        assert tbytes == jbytes, f"step {step}"
        batch = decode(tbytes)
        assert batch.step == step and len(batch.examples) == raw["batch_size"]
        assert any(np.any(s.advantages != 0) for s in batch.examples)
    assert not pathing.rollout_dir(outputs["port"], STEPS).exists()


def test_env_server_runs_rollouts_over_zmq(tmp_path):
    """``entrypoints.env_server`` in its own process: the port's remote env
    client reads the JAX env's taskset from it and runs a rollout whose
    episode equals the in-process env's against the same stub sampler."""
    import socket
    import subprocess
    import sys
    from pathlib import Path

    from aiohttp import web

    from prime_rl_tpu.envs.base import load_env as j_load_env
    from prime_rl_tpu_torch.envs.envclient import LocalEnvClient, RemoteEnvClient
    from prime_rl_tpu_torch.envs.types import SamplingConfig

    def free_port() -> int:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]

    tok = ByteTokenizer()

    async def generate(request):  # a fixed completion: the reversed word and eos
        body = await request.json()
        ids = tok.encode("tac") + [tok.eos_token_id]
        return web.json_response({
            "choices": [{"token_ids": ids, "logprobs": [-0.5] * len(ids),
                         "finish_reason": "stop"}],
            "usage": {"prompt_tokens": len(body["token_ids"])}, "policy_version": 7})

    env_port, http_port = free_port(), free_port()
    address = f"tcp://127.0.0.1:{env_port}"
    proc = subprocess.Popen(
        [sys.executable, "-m", "prime_rl_tpu_torch.entrypoints.env_server", "--env",
         "reverse_text", "--address", address, "--output-dir", str(tmp_path)],
        cwd=Path(__file__).resolve().parents[1], stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL)

    async def run():
        app = web.Application()
        app.add_routes([web.post("/inference/v1/generate", generate)])
        runner = web.AppRunner(app)
        await runner.setup()
        await web.TCPSite(runner, "127.0.0.1", http_port).start()
        remote, local = RemoteEnvClient("reverse_text", address, timeout=60), \
            LocalEnvClient("reverse_text")
        try:
            tasks = await remote.taskset()
            assert tasks == j_load_env("reverse_text").load_taskset() == await local.taskset()
            task = next(t for t in tasks if t["target"] == "tac")
            url = f"http://127.0.0.1:{http_port}"
            sampling = SamplingConfig(max_tokens=8)
            got, want = await remote.run(task, sampling, url), await local.run(task, sampling, url)
        finally:
            await remote.close()
            await local.close()
            await runner.cleanup()
        assert got.reward == want.reward == 1.0 and got.metrics == want.metrics
        assert [t.token_ids for t in got.traces] == [t.token_ids for t in want.traces]

    try:
        asyncio.run(run())
    finally:
        proc.terminate()
        proc.wait(timeout=10)

"""Multi-tenant LoRA through the port's loop on the CPU: one ``multi_run``
trainer, one inference server with the adapter bank, and two orchestrators
with ``run_idx`` and ``serve_adapter``, as separate processes over the zmq
transport (the JAX package's ``tests/integration/test_multi_tenant_and_distill.py``
scenario, cut to 2 steps a tenant). Each tenant's batches must reach the
trainer under its own ``run_idx``, each tenant publishes its merged weights
and its adapter under ``runs/run_{i}``, the server loads each adapter by name,
and the two adapters diverge."""

from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
STEPS = 2

INFER_CFG = """
device = "cpu"
max_model_len = 512
[model]
name = "debug"
[model.debug]
random_init = true
num_layers = 2
[tokenizer]
name = "byte"
[server]
port = {port}
[kv]
num_pages = 256
page_size = 32
[scheduler]
max_batch_size = 32
[lora]
max_adapters = 4
rank = 8
alpha = 16.0
target_modules = ["q", "k", "v", "o", "gate", "up", "down"]
"""

TRAINER_CFG = """
output_dir = "{out}"
device = "cpu"
max_steps = {steps}
multi_run = true
max_runs = 4
[model]
name = "debug"
lm_head_chunk_size = 0
[model.attn]
impl = "xla"
[model.debug]
random_init = true
num_layers = 2
[model.lora]
rank = 8
alpha = 16.0
[optimizer]
type = "adamw"
lr = 2e-2
[batch]
seq_len = 256
micro_batch_size = 4
[weight_ckpt]
interval = 1
[ckpt]
interval = 50
[transport]
batch_port = {port_b}
"""

ORCH_CFG = """
output_dir = "{out}/runs/run_{idx}"
model_name = "debug"
batch_size = 16
seq_len = 256
max_steps = {steps}
run_idx = {idx}
serve_adapter = "run_{idx}"
target_lag = 1
max_inflight_episodes = 32
[transport]
batch_port = {port_b}
[client]
base_urls = ["http://127.0.0.1:{port_h}"]
[[train_envs]]
name = "fixed_completion"
group_size = 8
[train_envs.args]
target = "{target}"
[train_envs.sampling]
temperature = 1.0
max_tokens = 8
[train_envs.algo]
type = "grpo"
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(mod: str, cfg: Path, log: Path):
    env = dict(os.environ, OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    f = open(log, "w")
    return subprocess.Popen([sys.executable, "-m", f"prime_rl_tpu_torch.entrypoints.{mod}",
                             f"@{cfg}"], cwd=REPO, env=env, stdout=f,
                            stderr=subprocess.STDOUT), f


def _wait_live(port: int, timeout: float = 60) -> None:
    deadline = time.time() + timeout
    while time.time() < deadline:
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/health", timeout=2) as r:
                if r.status == 200:
                    return
        except OSError:
            time.sleep(0.5)
    raise TimeoutError(f"server on :{port} never became live")


def test_two_tenants_train_and_serve_through_one_trainer_and_one_server(tmp_path):
    from prime_rl_tpu_torch.models import lora as tlora
    from prime_rl_tpu_torch.models.base import get_spec

    out = tmp_path / "mt"
    (out / "logs").mkdir(parents=True)
    for idx in (0, 1):
        (out / "runs" / f"run_{idx}").mkdir(parents=True)
    port_h, port_b = _free_port(), _free_port()
    (tmp_path / "inference.toml").write_text(INFER_CFG.format(port=port_h))
    (tmp_path / "trainer.toml").write_text(TRAINER_CFG.format(out=out, steps=2 * STEPS,
                                                              port_b=port_b))
    for idx, target in ((0, "abcd"), (1, "wxyz")):
        (tmp_path / f"orch_{idx}.toml").write_text(ORCH_CFG.format(
            out=out, idx=idx, steps=STEPS, port_b=port_b, port_h=port_h, target=target))
    procs = []
    try:
        procs.append(_spawn("inference", tmp_path / "inference.toml",
                            out / "logs" / "inference.out"))
        procs.append(_spawn("trainer", tmp_path / "trainer.toml", out / "logs" / "trainer.out"))
        _wait_live(port_h)
        orchs = [_spawn("orchestrator", tmp_path / f"orch_{i}.toml",
                        out / "logs" / f"orch_{i}.out") for i in (0, 1)]
        procs.extend(orchs)
        deadline = time.time() + 120
        while time.time() < deadline and any(p.poll() is None for p, _ in procs[1:]):
            time.sleep(0.5)
        for p, _ in procs[1:]:
            assert p.poll() == 0, "a trainer or orchestrator did not finish cleanly"
    finally:
        for p, f in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        for p, f in procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
            f.close()
    for log in (out / "logs").glob("*.out"):
        assert "Traceback" not in log.read_text(), f"{log.name}:\n{log.read_text()[-3000:]}"

    # every tenant's batches reached the trainer under its own run_idx
    rows = [json.loads(line) for line in (out / "trainer.jsonl").read_text().splitlines()]
    by_run = {}
    for r in rows:
        by_run.setdefault(r["run_id"], []).append(r["run_step"])
    assert by_run == {"run_0": [1, 2], "run_1": [1, 2]}, by_run
    assert all(np.isfinite(r["loss"]) for r in rows)
    # each tenant published its own adapter, which the server loaded by name
    spec = get_spec("debug", num_layers=2)
    adapters = []
    for idx in (0, 1):
        snap = out / "runs" / f"run_{idx}" / "weights" / f"step_{STEPS}"
        assert (snap / "STABLE").exists() and (snap / "model.safetensors").exists()
        adapters.append(tlora.load_adapter_file(snap / "adapter", spec))
    served = (out / "logs" / "inference.out").read_text()
    assert "loaded LoRA adapter 'run_0'" in served and "loaded LoRA adapter 'run_1'" in served
    # the tenants trained apart: their adapters diverged
    assert float(np.abs(adapters[0]["q_b"]).sum()) > 0
    assert not np.allclose(adapters[0]["q_b"], adapters[1]["q_b"])
    for idx in (0, 1):
        orows = [json.loads(line) for line in
                 (out / "runs" / f"run_{idx}" / "orchestrator.jsonl").read_text().splitlines()]
        assert [r["step"] for r in orows if "reward_mean" in r] == list(range(STEPS))

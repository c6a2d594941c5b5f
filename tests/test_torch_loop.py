"""The RL loop of the port on the CPU at debug size.

- The trainer fed by the transport: the JAX trainer and the port's load one
  HF snapshot and read the same three TrainingBatches from the filesystem
  transport; their per-step loss and grad_norm agree within the tolerance of
  ``test_train_step_matches_jax_step_one`` (rtol 1e-4).
- The colocated swap: after ``ColocatedBroadcast.publish`` the engine serves
  the trainer's parameters (its logprobs match the trainer's forward), it
  shares their storage, and a later train step leaves the served v1 intact.
- ``run_colocated`` in process, fed through the filesystem and zmq transports.
- The launcher end to end, colocated and with the filesystem weight plane
  (``/update_weights``), the colocated loop on ``debug_moe`` with router
  replay (the sampler's routing reaches the trainer's batches), and the JAX
  package's ``test_rl_end_to_end`` and ``test_rl_moe_end_to_end`` scenarios
  (marked slow).
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from prime_rl_tpu.configs import TrainerConfig as JTrainerConfig
from prime_rl_tpu.models import qwen3 as jqwen3
from prime_rl_tpu.models.base import debug_spec as j_debug_spec
from prime_rl_tpu.trainer.rl.train import train as jtrain
from prime_rl_tpu.trainer.weights import save_hf_weights as j_save_hf_weights
from prime_rl_tpu_torch.configs import RLConfig, TrainerConfig
from prime_rl_tpu_torch.entrypoints.colocated import placeholder_params, run_colocated
from prime_rl_tpu_torch.models import qwen3 as tqwen3
from prime_rl_tpu_torch.models.base import debug_spec
from prime_rl_tpu_torch.sampler.cache import CacheConfig
from prime_rl_tpu_torch.sampler.engine import Engine, SamplingParams
from prime_rl_tpu_torch.trainer import optim as toptim
from prime_rl_tpu_torch.trainer import step as tstep
from prime_rl_tpu_torch.trainer.batch import prepare_batch, token_counts
from prime_rl_tpu_torch.trainer.rl.broadcast import ColocatedBroadcast
from prime_rl_tpu_torch.trainer.rl.train import train as ttrain
from prime_rl_tpu_torch.transport import setup_training_batch_sender
from prime_rl_tpu_torch.transport.types import TrainingBatch, TrainingSample
from prime_rl_tpu_torch.utils import logger as tlogger

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _batch(step: int, vocab: int, n: int = 12) -> TrainingBatch:
    """``n`` rollouts of a prompt and a sampled completion, with advantages
    and the sampler's logprobs, from a generator seeded with the step."""
    rng = np.random.default_rng(100 + step)
    examples = []
    for _ in range(n):
        n_p, n_c = int(rng.integers(4, 16)), int(rng.integers(4, 20))
        adv = np.zeros(n_p + n_c, np.float32)
        adv[n_p:] = rng.standard_normal()
        examples.append(TrainingSample(
            token_ids=rng.integers(0, vocab, n_p + n_c),
            mask=np.r_[np.zeros(n_p, bool), np.ones(n_c, bool)],
            logprobs=np.r_[np.zeros(n_p), -rng.random(n_c) * 4 - 4].astype(np.float32),
            temperatures=np.ones(n_p + n_c, np.float32), env_name="fixed_completion",
            advantages=adv))
    return TrainingBatch(examples=examples, step=step)


def _trainer_raw(model_name: str, transport=None, **kw) -> dict:
    return dict(
        model={"name": model_name, "attn": {"impl": "xla"}, "compute_dtype": "float32",
               "lm_head_chunk_size": 48},
        optimizer={"type": "adamw", "lr": 1e-3, "weight_decay": 0.1},
        data={"type": "transport"}, transport=transport or {"type": "filesystem"},
        batch={"seq_len": 64, "micro_batch_size": 8, "num_micro_batches": 2},
        weight_ckpt={"keep_last": 1}, **kw)


def test_trainers_agree_through_the_transport(tmp_path):
    """Per-step loss and grad_norm of the JAX trainer and the port's, both
    fed three TrainingBatches through the filesystem transport from one HF
    snapshot: rtol 1e-4, the tolerance of ``test_train_step_matches_jax_step_one``."""
    jspec = j_debug_spec()
    snap = tmp_path / "snapshot"
    j_save_hf_weights(jax.device_get(jqwen3.init_params(jspec, jax.random.key(0))), jspec, snap)
    jout, tout = tmp_path / "jax", tmp_path / "port"
    sender = setup_training_batch_sender(TrainerConfig(transport={"type": "filesystem"}).transport,
                                         str(jout))
    for step in range(3):
        sender.send(_batch(step, jspec.vocab_size))
    tout.mkdir()
    os.symlink(jout / "rollouts", tout / "rollouts")  # both read the batches written once

    jtrain(JTrainerConfig(**_trainer_raw(str(snap), max_steps=3), output_dir=str(jout)))
    try:
        result = ttrain(TrainerConfig(**_trainer_raw(str(snap), max_steps=3), device="cpu",
                                      output_dir=str(tout)))
    finally:
        tlogger.reset_logger()
    rows = {name: [json.loads(line) for line in (out / "trainer.jsonl").read_text().splitlines()]
            for name, out in (("jax", jout), ("port", tout))}
    assert [r["step"] for r in rows["port"]] == [1, 2, 3] == [r["step"] for r in rows["jax"]]
    assert [r["loss"] for r in result.records] == [r["loss"] for r in rows["port"]]
    for t, j in zip(rows["port"], rows["jax"]):
        assert t["rl_tokens"] == j["rl_tokens"] > 0
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(t[key], j[key], rtol=1e-4, err_msg=f"step {t['step']} {key}")
    assert rows["port"][0]["loss"] != rows["port"][2]["loss"]


def _scaled_params(spec, scale: float = 3.0) -> dict:
    """Random weights scaled up so that the model's distributions are far
    from uniform (a near-uniform model would agree with anything)."""
    gen = torch.Generator().manual_seed(0)
    params = tqwen3.init_params(spec, gen)
    return toptim.tree_map(lambda x: x * scale, params)


def _engine(spec, dtype) -> Engine:
    cache = CacheConfig(num_pages=64, page_size=16, max_slots=4, max_seq_len=256)
    engine = Engine(placeholder_params(spec, "cpu", dtype), spec, cache, device="cpu",
                    compute_dtype=dtype, decode_block=2)
    engine.pause()
    return engine


def test_colocated_swap_serves_the_trainer_params():
    """After the swap the engine is at the published version and serving;
    its logprobs of the prompt and of the sampled tokens match the trainer's
    forward over the same tokens, 1e-2 + 1e-2 |ref| in float32."""
    spec = debug_spec()
    params = _scaled_params(spec)
    engine = _engine(spec, torch.float32)
    ColocatedBroadcast(engine).publish(params, 5)
    assert engine.policy_version == 5 and not engine.paused

    prompts = [[int(x) for x in np.random.default_rng(n).integers(1, 250, n)] for n in (7, 20)]
    results = engine.generate(prompts, SamplingParams(max_tokens=6, temperature=1.0,
                                                      prompt_logprobs=True, ignore_eos=True))
    model_cfg = TrainerConfig(model={"attn": {"impl": "xla"}, "compute_dtype": "float32",
                                     "lm_head_chunk_size": 0}).model
    for prompt, res in zip(prompts, results):
        tokens = prompt + res.token_ids
        n = len(tokens)
        batch = prepare_batch([TrainingSample(token_ids=tokens, mask=np.ones(n, bool),
                                              logprobs=np.zeros(n), temperatures=np.ones(n))],
                              64, 1, num_micro_batches=1)
        mb = tstep.put_batch(tstep.MicroBatchArrays(*[None if x is None else x[0]
                                                      for x in batch]), "cpu")
        with torch.no_grad():
            ref, _, _ = tstep.model_logprobs(params, spec, mb, model_cfg)
        ref = ref[0, :n].numpy()
        got = np.r_[res.prompt_logprobs[1:], res.logprobs]
        np.testing.assert_allclose(got, ref[1:], atol=1e-2, rtol=1e-2)
        assert np.ptp(ref[1:]) > 1.0  # far from a uniform model


def test_colocated_swap_shares_the_masters_and_a_step_leaves_them():
    """bf16 masters on the engine's device in its dtype are served as they
    are (no copy), and the train step is functional: after a step the engine
    still serves v1 bit for bit."""
    spec = debug_spec()
    cfg = TrainerConfig(model={"attn": {"impl": "xla"}, "compute_dtype": "bfloat16",
                               "lm_head_chunk_size": 0},
                        optimizer={"type": "adamw_8bit", "lr": 1e-2, "block": 256,
                                   "master_dtype": "bfloat16"})
    opt, _ = toptim.make_optimizer(cfg.optimizer, cfg.scheduler, 1.0)
    state = tstep.init_train_state(spec, "cpu", opt, seed=0, master_dtype="bfloat16")
    engine = _engine(spec, torch.bfloat16)
    ColocatedBroadcast(engine).publish(state.params, 1)
    assert engine.params["embed"].data_ptr() == state.params["embed"].data_ptr()
    stacked = state.params["layers"]
    for layer in engine.params["layers"]:  # per-layer views of the stacked masters
        for name, view in layer.items():
            assert view.untyped_storage().data_ptr() == stacked[name].untyped_storage().data_ptr()

    def served():
        return [("embed", engine.params["embed"]), ("final_norm", engine.params["final_norm"])] + [
            (f"layers/{i}/{k}", v) for i, layer in enumerate(engine.params["layers"])
            for k, v in layer.items()]

    v1 = [(p, t.clone()) for p, t in served()]

    batch = prepare_batch(_batch(0, spec.vocab_size).examples, 64, 8, num_micro_batches=2)
    counts = token_counts(batch)
    step = tstep.make_train_step(spec, cfg.model, cfg.loss, opt, "cpu")
    new_state, _ = step(state, batch, tstep.Scales(float(counts["rl"]), 1.0, 1.0))
    assert not torch.equal(new_state.params["layers"]["q"], state.params["layers"]["q"])
    for (path, want), (_, got) in zip(v1, served()):
        assert torch.equal(got, want), path


@pytest.mark.parametrize("kind", ["filesystem", "zmq"])
def test_run_colocated_trains_from_the_transport(kind, tmp_path, monkeypatch):
    """``run_colocated`` in process on the CPU: three batches through the
    transport, three steps, and the engine's version following every publish
    (v0 at startup, then one a step)."""
    transport = {"type": kind} if kind == "filesystem" else {"type": kind,
                                                             "batch_port": _free_port()}
    spec = debug_spec()
    config = RLConfig(
        output_dir=str(tmp_path),
        trainer={**_trainer_raw("debug", max_steps=3, transport=transport), "device": "cpu",
                 "model": {"name": "debug", "attn": {"impl": "xla"},
                           "lm_head_chunk_size": 0, "debug": {"random_init": True}}},
        inference={"device": "cpu", "max_model_len": 256,
                   "model": {"name": "debug", "debug": {"random_init": True}},
                   "tokenizer": {"name": "byte"},
                   "server": {"host": "127.0.0.1", "port": _free_port()},
                   "kv": {"num_pages": 64, "page_size": 16},
                   "scheduler": {"max_batch_size": 4, "warmup_requests": 0}})
    versions = []
    update = Engine.update_params

    def record(self, params, version=None):
        update(self, params, version)
        versions.append(self.policy_version)

    monkeypatch.setattr(Engine, "update_params", record)
    sender = setup_training_batch_sender(config.trainer.transport, str(tmp_path))
    for step in range(3):  # zmq queues them until the trainer binds
        sender.send(_batch(step, spec.vocab_size))
    try:
        result = run_colocated(config)
    finally:
        sender.close()
        tlogger.reset_logger()
    assert len(result.records) == 3 and result.state.step == 3
    assert all(np.isfinite(r["loss"]) for r in result.records)
    assert versions == [0, 1, 2, 3]


def test_run_colocated_with_host_offload_swaps_in_copies(tmp_path, monkeypatch):
    """``run_colocated`` on the CPU with ``offload_optimizer`` and
    ``offload_params``: two batches through the filesystem transport, two
    steps, the engine at v0, v1, v2; each swap hands it copies of the
    masters (the next step writes the host-tier buffers in place), which it
    serves in its compute dtype."""
    spec = debug_spec()
    config = RLConfig(
        output_dir=str(tmp_path),
        trainer={**_trainer_raw("debug", max_steps=2, transport={"type": "filesystem"}),
                 "device": "cpu", "offload_optimizer": True, "offload_params": True,
                 "model": {"name": "debug", "attn": {"impl": "xla"},
                           "lm_head_chunk_size": 0, "debug": {"random_init": True}}},
        inference={"device": "cpu", "max_model_len": 256,
                   "model": {"name": "debug", "debug": {"random_init": True}},
                   "tokenizer": {"name": "byte"},
                   "server": {"host": "127.0.0.1", "port": _free_port()},
                   "kv": {"num_pages": 64, "page_size": 16},
                   "scheduler": {"max_batch_size": 4, "warmup_requests": 0}})
    handed = []
    update = Engine.update_params

    def record(self, params, version=None):
        handed.append(params)
        update(self, params, version)

    monkeypatch.setattr(Engine, "update_params", record)
    sender = setup_training_batch_sender(config.trainer.transport, str(tmp_path))
    for step in range(2):
        sender.send(_batch(step, spec.vocab_size))
    try:
        result = run_colocated(config)
    finally:
        sender.close()
        tlogger.reset_logger()
    assert result.state.step == 2 and len(handed) == 3
    assert all(np.isfinite(r["loss"]) for r in result.records)
    masters = dict(toptim.tree_paths(result.state.params))
    for path, served in toptim.tree_paths(handed[-1]):
        assert served.data_ptr() != masters[path].data_ptr(), path
        assert torch.equal(served.float(), masters[path].to(served.dtype).float()), path


def test_colocated_process_runs_on_one_named_device(tmp_path):
    config = RLConfig(output_dir=str(tmp_path), trainer={"device": "cpu"},
                      inference={"device": "cuda"})
    with pytest.raises(ValueError, match="one device"):
        run_colocated(config)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):  # no card and no cpu asked for: no fallback
            run_colocated(RLConfig(output_dir=str(tmp_path)))
    tlogger.reset_logger()


def test_launcher_raises_for_the_multi_card_slice(tmp_path):
    """Deploy templates, more than one trainer process and the device weight
    planes raise before anything is spawned, naming their ROADMAP.md item;
    a TOML that sets them still parses."""
    from prime_rl_tpu_torch.entrypoints.rl import rl

    for raw in ({"deploy": {"type": "slurm_single"}}, {"trainer_procs": 2},
                {"colocated": False, "trainer": {"broadcast": {"type": "device", "mode": "shm"}}}):
        with pytest.raises(NotImplementedError, match="item 11"):
            rl(RLConfig(output_dir=str(tmp_path / "x"), **raw))
    assert not (tmp_path / "x").exists()


LOOP_TOML = """
output_dir = "{out}"
colocated = {colocated}
[trainer]
max_steps = {steps}
device = "cpu"
[trainer.model]
name = "{model}"
seq_len = 256
lm_head_chunk_size = 0
[trainer.model.attn]
impl = "xla"
[trainer.model.debug]
random_init = true
[trainer.optimizer]
type = "adamw"
lr = {lr}
[trainer.batch]
seq_len = 256
micro_batch_size = 4
[trainer.weight_ckpt]
interval = 1
keep_last = 3
[trainer.transport]
{transport}
[orchestrator]
model_name = "{model}"
batch_size = {batch_size}
seq_len = 256
max_steps = {steps}
[orchestrator.transport]
{transport}
[orchestrator.client]
base_urls = ["http://127.0.0.1:{port_h}"]
[[orchestrator.train_envs]]
name = "fixed_completion"
group_size = 8
[orchestrator.train_envs.sampling]
temperature = 1.0
max_tokens = {max_tokens}
[orchestrator.train_envs.algo]
type = "grpo"
[inference]
max_model_len = 512
device = "cpu"
collect_routed_experts = {collect}
[inference.model]
name = "{model}"
[inference.model.debug]
random_init = true
[inference.tokenizer]
name = "byte"
[inference.server]
port = {port_h}
[inference.kv]
num_pages = 512
page_size = 32
[inference.scheduler]
max_batch_size = 32
"""


def _launch(tmp_path, timeout: float, extra: str = "", model: str = "debug",
            transport: str | None = None, collect: bool = False, **fmt) -> Path:
    out = tmp_path / "run"
    cfg = tmp_path / "rl.toml"
    cfg.write_text(LOOP_TOML.format(
        out=out, port_h=_free_port(), model=model, collect=str(collect).lower(),
        transport=transport or f"batch_port = {_free_port()}", **fmt) + extra)
    # one intra-op thread a child: the debug model gains nothing from more,
    # and the test runs beside other test workers on the same cores
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-m", "prime_rl_tpu_torch.entrypoints.rl", f"@{cfg}"],
                          cwd=REPO, env=env, timeout=timeout, capture_output=True, text=True)
    logs = "\n".join(p.read_text()[-3000:] for p in (out / "logs").glob("*.out"))
    assert proc.returncode == 0, f"launcher rc={proc.returncode}\n{proc.stdout}\n{logs}"
    for p in (out / "logs").glob("*.out"):  # no process failed
        assert "Traceback" not in p.read_text(), f"error in {p.name}:\n{p.read_text()[-3000:]}"
    return out


def _versions(log: Path, marker: str) -> list[int]:
    import re

    return [int(m) for m in re.findall(marker + r"v(\d+)", log.read_text())]


@pytest.mark.parametrize("colocated", [True, False], ids=["colocated", "filesystem"])
def test_launcher_runs_the_loop(colocated, tmp_path):
    """4 steps of fixed_completion through ``entrypoints.rl`` on the CPU:
    colocated (the in-process swap, the orchestrator watching /liveness) and
    not (the filesystem weight plane: the orchestrator's watcher posts each
    snapshot to the server's /update_weights)."""
    out = _launch(tmp_path, timeout=150, colocated=str(colocated).lower(), steps=4, lr="3e-3",
                  batch_size=16, max_tokens=8)
    trows = [json.loads(line) for line in (out / "trainer.jsonl").read_text().splitlines()]
    assert [r["step"] for r in trows] == [1, 2, 3, 4]
    assert all(np.isfinite(r["loss"]) for r in trows)
    kls = [r["mismatch_kl"] for r in trows]
    assert float(np.mean(kls)) < 0.5, kls  # the bound of the JAX package's e2e test
    orows = [json.loads(line) for line in (out / "orchestrator.jsonl").read_text().splitlines()]
    batches = [r for r in orows if "reward_mean" in r]
    assert [r["step"] for r in batches] == [0, 1, 2, 3]
    # What the loop guarantees (target_lag 1). The batch of step k waits for
    # policy v(k - 2), so the last batch needs only v1; the launcher's
    # carve-out skips the trainer's last target_lag + 1 = 2 publishes, so the
    # trainer still publishes v2, which no batch requires: whether v2 reaches
    # the sampler and the orchestrator before the orchestrator ends is timing.
    assert all(r["policy_version"] >= r["step"] - 2 for r in batches), batches
    if colocated:
        applied = _versions(out / "logs" / "colocated.out", "the engine serves ")
    else:
        applied = _versions(out / "logs" / "inference.out", r"updated weights from \S+ \(")
    assert applied in ([0, 1], [0, 1, 2]), applied  # an unbroken run from v0
    assert _versions(out / "logs" / "orchestrator.out", "policy -> ")[-1] in applied


@pytest.mark.slow
def test_rl_end_to_end(tmp_path):
    """The JAX package's ``tests/integration/test_rl_e2e.py::test_rl_end_to_end``
    on the port: 30 colocated steps of fixed_completion, the reward rising,
    the mismatch KL in range, eval cohorts logged, snapshots and checkpoints."""
    out = _launch(tmp_path, timeout=900, extra="""
[[orchestrator.eval_envs]]
name = "fixed_completion"
group_size = 2
num_examples = 4
interval = 10
[orchestrator.eval_envs.sampling]
temperature = 0.0
max_tokens = 8
""", colocated="true", steps=30, lr="3e-3", batch_size=32, max_tokens=12)
    rows = [json.loads(line) for line in (out / "orchestrator.jsonl").read_text().splitlines()]
    rewards = [r["reward_mean"] for r in rows if "reward_mean" in r]
    print("reward_mean by step:", json.dumps([round(r, 4) for r in rewards]))
    assert len(rewards) >= 25, rewards
    first, last = np.mean(rewards[:5]), np.mean(rewards[-8:])
    assert last > first + 0.015 and last > first * 1.25, f"no learning: {rewards}"
    trows = [json.loads(line) for line in (out / "trainer.jsonl").read_text().splitlines()]
    kls = [r["mismatch_kl"] for r in trows if r.get("mismatch_kl") is not None]
    assert kls and float(np.mean(kls)) < 0.5, kls
    eval_rows = [r for r in rows if any(k.startswith("eval/") for k in r)]
    assert eval_rows, "no eval metrics logged"
    assert any("eval/agg/all/reward/mean" in r for r in eval_rows)
    assert (out / "weights").exists()
    assert any((out / "checkpoints").glob("step_*")), "no trainer checkpoint"


def test_colocated_moe_loop_carries_the_sampler_routing(tmp_path):
    """2 colocated steps on ``debug_moe`` with ``collect_routed_experts``: the
    batches shipped to the trainer (the filesystem transport, read back here)
    carry the sampler's routing, [L, NL, K] a sample with ids in [0, E) on
    every completion token but the last and -1 on the prompt; the trainer
    trains on them. A completion that stopped at its first token (eos first:
    about 1 in 550 a sample at this seed's weights, 32 samples a run) has no
    "every completion token but the last"; the engine may have recorded no
    row for it (its contract, as the JAX engine's), and then its sample
    carries no routing and the trainer routes it itself."""
    from prime_rl_tpu_torch.models.base import get_spec
    from prime_rl_tpu_torch.transport.filesystem import FSTrainingBatchReceiver

    spec = get_spec("debug_moe")
    out = _launch(tmp_path, timeout=150, model="debug_moe", transport='type = "filesystem"',
                  collect=True, colocated="true", steps=2, lr="3e-3", batch_size=16,
                  max_tokens=8)
    trows = [json.loads(line) for line in (out / "trainer.jsonl").read_text().splitlines()]
    assert [r["step"] for r in trows] == [1, 2] and all(np.isfinite(r["loss"]) for r in trows)
    receiver = FSTrainingBatchReceiver(out)
    for _ in range(2):
        batch = receiver.receive(timeout=1.0)
        assert batch is not None and batch.examples
        for sample in batch.examples:
            r = sample.routed_experts
            sampled = np.flatnonzero(sample.mask)
            assert sampled.size >= 1
            if r is None:  # nothing recorded: only a completion of one token
                assert sampled.size == 1
                continue
            assert r.shape == (len(sample.token_ids), spec.num_layers, spec.num_experts_per_tok)
            assert bool((r[sampled[:-1]] >= 0).all() and (r[sampled[:-1]] < spec.num_experts).all())
            assert bool((r[:sampled[0]] == -1).all())


def test_one_token_completion_ships_and_trains():
    """The case the loop test above allows for: a completion of one token
    from a MoE engine that records the routing (eos sampled first, here
    ``max_tokens`` 1) carries the rows recorded for it, if any (a decode
    step may have run with its token as input before the slot stopped), as
    the JAX engine's contract says; its sample and a routed sample of four
    tokens pack into one batch with -1 on the prompts, and the trainer's
    forward runs on the replayed routing."""
    from prime_rl_tpu_torch.envs.types import Trace
    from prime_rl_tpu_torch.models import get_family
    from prime_rl_tpu_torch.models.base import get_spec
    from prime_rl_tpu_torch.orchestrator.trajectories import trace_to_sample

    spec = get_spec("debug_moe")
    params = get_family(spec).init(spec, torch.Generator().manual_seed(0))
    engine = Engine(params, spec, CacheConfig(num_pages=32, page_size=16, max_slots=4,
                                              max_seq_len=128),
                    device="cpu", compute_dtype=torch.float32, decode_block=2,
                    collect_routed_experts=True)
    prompts = [[5, 6, 7], [8, 9, 10]]
    results = engine.generate(prompts, [SamplingParams(max_tokens=1, temperature=0.0),
                                        SamplingParams(max_tokens=4, temperature=0.0,
                                                       ignore_eos=True)])
    shape = (spec.num_layers, spec.num_experts_per_tok)
    one, four = results
    assert len(one.token_ids) == 1 and (one.routed_experts is None
                                        or one.routed_experts.shape == (1, *shape))
    assert four.routed_experts.shape == (4, *shape)
    samples = []
    for prompt, res in zip(prompts, results):
        n_p, n_c = len(prompt), len(res.token_ids)
        trace = Trace(token_ids=prompt + res.token_ids, sampled_mask=[False] * n_p + [True] * n_c,
                      logprobs=[0.0] * n_p + res.logprobs, temperatures=[1.0] * (n_p + n_c),
                      routed_experts=(None if res.routed_experts is None
                                      else [None] * n_p + list(res.routed_experts)))
        samples.append(trace_to_sample(trace, "fixed_completion"))
    batch = prepare_batch(samples, 16, 1, num_micro_batches=1)
    routed = np.asarray(batch.routed_experts)[0, 0]
    seg = np.asarray(batch.segment_ids)[0, 0]
    for s in (1, 2):
        rows = routed[seg == s]
        n_p = len(prompts[s - 1])
        assert bool((rows[:n_p] == -1).all()) and bool((rows < spec.num_experts).all())
    assert bool((routed[seg == 2][3:6] >= 0).all())  # the 4-token completion's first three
    model_cfg = TrainerConfig(model={"attn": {"impl": "xla"}, "compute_dtype": "float32",
                                     "lm_head_chunk_size": 0}).model
    mb = tstep.put_batch(tstep.MicroBatchArrays(*[None if x is None else x[0] for x in batch]),
                         "cpu")
    with torch.no_grad():
        logprobs, _, _ = tstep.model_logprobs(params, spec, mb, model_cfg)
    assert bool(torch.isfinite(logprobs).all())


def test_colocated_lora_loop_serves_the_merge_and_keeps_the_base(tmp_path):
    """3 colocated steps with ``trainer.model.lora`` (rank 4 on all seven
    targets): the trainer trains the adapter over the frozen base, each swap
    hands the engine the merge (new tensors, so the trainer's base keeps its
    bits: its fingerprint at the end equals the start's, and the trainer
    would raise otherwise), every published version is served, the
    snapshots carry the adapter, and mismatch_kl stays below the loop's
    bound."""
    out = _launch(tmp_path, timeout=150, colocated="true", steps=3, lr="3e-3", batch_size=16,
                  max_tokens=8, extra="\n[trainer.model.lora]\nrank = 4\nalpha = 8.0\n")
    trows = [json.loads(line) for line in (out / "trainer.jsonl").read_text().splitlines()]
    assert [r["step"] for r in trows] == [1, 2, 3] and all(np.isfinite(r["loss"]) for r in trows)
    assert float(np.mean([r["mismatch_kl"] for r in trows])) < 0.5
    log = (out / "logs" / "colocated.out").read_text()
    import re

    start = re.findall(r"frozen base fingerprint (\w+)", log)
    end = re.findall(r"fingerprint at the end: (\w+)", log)
    assert start and end and start[0] == end[-1], (start, end)
    assert _versions(out / "logs" / "colocated.out", "the engine serves ")[:2] == [0, 1]


def test_vlm_loop_ships_and_trains_vision_inputs(tmp_path):
    """``configs/debug/rl_vlm.toml`` (``debug_vlm`` and the dominant_color
    image env, sync GRPO) through the port's launcher on the CPU, colocated,
    for 3 steps over the filesystem transport: every shipped batch carries its
    samples' ``mm_kwargs`` (pixels of ``patch_dim`` columns and their
    ``image_grid_thw``, one vision block a sample), the trainer's records
    hold the real patches it trained on (``mm_patches``), and the sampler
    served every published version."""
    from prime_rl_tpu_torch.models.base import get_spec
    from prime_rl_tpu_torch.transport.filesystem import FSTrainingBatchReceiver

    spec = get_spec("debug_vlm")
    out, port = tmp_path / "run", _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    overlay = tmp_path / "overlay.toml"
    overlay.write_text(f"""[trainer.transport]
type = "filesystem"
[orchestrator.transport]
type = "filesystem"
[orchestrator.client]
base_urls = ["http://127.0.0.1:{port}"]
[inference.server]
port = {port}
""")
    args = [sys.executable, "-m", "prime_rl_tpu_torch.entrypoints.rl",
            f"@{REPO / 'configs' / 'debug' / 'rl_vlm.toml'}", f"@{overlay}", "--trainer.device",
            "cpu", "--inference.device", "cpu", "--trainer.max-steps", "3",
            "--orchestrator.max-steps", "3", "--output-dir", str(out)]
    proc = subprocess.run(args, cwd=REPO, env=env, timeout=240, capture_output=True, text=True)
    logs = "\n".join(p.read_text()[-3000:] for p in (out / "logs").glob("*.out"))
    assert proc.returncode == 0, f"launcher rc={proc.returncode}\n{proc.stdout}\n{logs}"
    for p in (out / "logs").glob("*.out"):
        assert "Traceback" not in p.read_text(), f"error in {p.name}:\n{p.read_text()[-3000:]}"
    trows = [json.loads(line) for line in (out / "trainer.jsonl").read_text().splitlines()]
    assert [r["step"] for r in trows] == [1, 2, 3] and all(np.isfinite(r["loss"]) for r in trows)
    assert all(r["mm_patches"] > 0 for r in trows)
    assert _versions(out / "logs" / "colocated.out", "the engine serves ")[:2] == [0, 1]
    receiver = FSTrainingBatchReceiver(out)
    shipped = 0
    while (batch := receiver.receive(timeout=1.0)) is not None:
        for sample in batch.examples:
            mm = sample.mm_kwargs
            assert mm is not None and mm["pixel_values"].shape[1] == spec.vision.patch_dim
            grid = np.asarray(mm["image_grid_thw"])
            assert grid.shape == (1, 3) and mm["pixel_values"].shape[0] == int(grid.prod())
            assert (np.asarray(sample.token_ids) == spec.image_token_id).sum() >= int(
                grid.prod()) // spec.vision.merge_unit
        shipped += 1
    assert shipped == 3


def test_vlm_hybrid_loop_ships_and_trains_vision_inputs(tmp_path):
    """``configs/debug/rl_vlm.toml`` with the hybrid VLM ``debug_qwen3_next_vl``
    (the GatedDeltaNet trunk with the tower) in place of ``debug_vlm``, through
    the launcher on the CPU, colocated, for 2 steps over the filesystem
    transport: the image prompts take the single-shot vision prefill and the
    recurrent decode, every shipped batch carries its samples' pixels and
    grids, the trainer trains on the patches (``mm_patches``), and the
    sampler served v0 (the launcher skips the trainer's last target_lag + 1 =
    2 publishes, so 2 steps publish none)."""
    from prime_rl_tpu_torch.models.base import get_spec
    from prime_rl_tpu_torch.transport.filesystem import FSTrainingBatchReceiver

    name = "debug_qwen3_next_vl"
    spec = get_spec(name)
    out, port = tmp_path / "run", _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    overlay = tmp_path / "overlay.toml"
    overlay.write_text(f"""[trainer.model]
name = "{name}"
[trainer.transport]
type = "filesystem"
[orchestrator]
model_name = "{name}"
[orchestrator.transport]
type = "filesystem"
[orchestrator.client]
base_urls = ["http://127.0.0.1:{port}"]
[inference.model]
name = "{name}"
[inference.server]
port = {port}
""")
    args = [sys.executable, "-m", "prime_rl_tpu_torch.entrypoints.rl",
            f"@{REPO / 'configs' / 'debug' / 'rl_vlm.toml'}", f"@{overlay}", "--trainer.device",
            "cpu", "--inference.device", "cpu", "--trainer.max-steps", "2",
            "--orchestrator.max-steps", "2", "--output-dir", str(out)]
    proc = subprocess.run(args, cwd=REPO, env=env, timeout=240, capture_output=True, text=True)
    logs = "\n".join(p.read_text()[-3000:] for p in (out / "logs").glob("*.out"))
    assert proc.returncode == 0, f"launcher rc={proc.returncode}\n{proc.stdout}\n{logs}"
    for p in (out / "logs").glob("*.out"):
        assert "Traceback" not in p.read_text(), f"error in {p.name}:\n{p.read_text()[-3000:]}"
    trows = [json.loads(line) for line in (out / "trainer.jsonl").read_text().splitlines()]
    assert [r["step"] for r in trows] == [1, 2] and all(np.isfinite(r["loss"]) for r in trows)
    assert all(r["mm_patches"] > 0 for r in trows)
    assert _versions(out / "logs" / "colocated.out", "the engine serves ") == [0]
    receiver = FSTrainingBatchReceiver(out)
    shipped = 0
    while (batch := receiver.receive(timeout=1.0)) is not None:
        for sample in batch.examples:
            mm = sample.mm_kwargs
            assert mm is not None and mm["pixel_values"].shape[1] == spec.vision.patch_dim
            grid = np.asarray(mm["image_grid_thw"])
            assert grid.shape == (1, 3) and mm["pixel_values"].shape[0] == int(grid.prod())
            assert (np.asarray(sample.token_ids) == spec.image_token_id).sum() >= int(
                grid.prod()) // spec.vision.merge_unit
        shipped += 1
    assert shipped == 2


@pytest.mark.slow
def test_rl_moe_end_to_end(tmp_path):
    """The JAX package's ``tests/integration/test_rl_e2e.py::test_rl_moe_end_to_end``
    on the port: the loop of ``test_rl_end_to_end`` on the debug MoE spec (the
    grouped expert products and the router-replay wire), the reward rising."""
    out = _launch(tmp_path, timeout=900, model="debug_moe", collect=True, colocated="true",
                  steps=30, lr="3e-3", batch_size=32, max_tokens=12)
    rows = [json.loads(line) for line in (out / "orchestrator.jsonl").read_text().splitlines()]
    rewards = [r["reward_mean"] for r in rows if "reward_mean" in r]
    print("reward_mean by step:", json.dumps([round(r, 4) for r in rewards]))
    assert len(rewards) >= 20, rewards
    first, last = np.mean(rewards[:5]), np.mean(rewards[-8:])
    assert last > first + 0.01, f"no MoE learning: {rewards}"

"""The port's trainer on the CPU against the JAX package: schedules,
optimizers from a carried-across state, stochastic rounding, batch packing
and the fake loader, the train step as a whole, and the entry point. Inputs
come from a numpy seed and go to both packages; everything runs in float32
at a small size (2 layers, hidden 64, vocab 512, L 64).

Tolerances are stated per test.
"""

import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prime_rl_tpu.configs import TrainerConfig as JTrainerConfig
from prime_rl_tpu.configs.shared import MeshConfig as JMeshConfig
from prime_rl_tpu.models import qwen3 as jqwen3
from prime_rl_tpu.models.base import debug_spec as j_debug_spec
from prime_rl_tpu.parallel.mesh import build_mesh
from prime_rl_tpu.trainer import batch as jbatch
from prime_rl_tpu.trainer import optim as joptim
from prime_rl_tpu.trainer import step as jstep
from prime_rl_tpu.trainer.rl.data import FakeDataLoader as JFakeDataLoader
from prime_rl_tpu.transport.types import TrainingSample as JTrainingSample
from prime_rl_tpu_torch.configs import TrainerConfig, parse_config
from prime_rl_tpu_torch.configs import shared as tshared
from prime_rl_tpu_torch.models import qwen3 as tqwen3
from prime_rl_tpu_torch.models.base import debug_spec, get_spec
from prime_rl_tpu_torch.trainer import batch as tbatch
from prime_rl_tpu_torch.trainer import optim as toptim
from prime_rl_tpu_torch.trainer import step as tstep
from prime_rl_tpu_torch.trainer.perf import PerfCounter, device_peak_flops
from prime_rl_tpu_torch.trainer.rl.broadcast import make_broadcast
from prime_rl_tpu_torch.trainer.rl.data import FakeDataLoader
from prime_rl_tpu_torch.trainer.rl.train import train
from prime_rl_tpu_torch.transport.types import TrainingSample, decode, encode
from prime_rl_tpu_torch.utils import logger as tlogger
from prime_rl_tpu_torch.utils import pathing
from prime_rl_tpu_torch.utils.monitor import setup_monitor

torch.set_num_threads(1)


def _np(t):
    return t.detach().numpy()


def _to_torch(tree):
    return jax.tree.map(lambda x: torch.from_numpy(np.array(x)), tree)


# ---------------------------------------------------------------------------
# schedules and optimizers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sched", [
    {"type": "constant"}, {"type": "constant", "warmup_steps": 3},
    {"type": "linear", "warmup_steps": 2, "decay_steps": 7, "min_lr_ratio": 0.2},
    {"type": "cosine", "warmup_steps": 4, "decay_steps": 9, "min_lr_ratio": 0.1},
    {"type": "cosine", "decay_steps": 5},
])
def test_schedules_match_optax_point_for_point(sched):
    """lr(step) for steps 0..19, relative 1e-6 (optax computes in f32)."""
    jcfg = JTrainerConfig(scheduler=sched).scheduler
    tcfg = TrainerConfig(scheduler=sched).scheduler
    j_sched, t_sched = joptim.make_schedule(jcfg, 3e-4), toptim.make_schedule(tcfg, 3e-4)
    for step in range(20):
        np.testing.assert_allclose(t_sched(step), float(j_sched(step)), rtol=1e-6, atol=1e-12)


def _adam_state(state):
    """The first optax state with moments in a chain's state, as numpy."""
    found = []

    def walk(node):
        if hasattr(node, "mu") and hasattr(node, "nu"):
            found.append({"count": int(node.count), "mu": jax.tree.map(np.asarray, node.mu),
                          "nu": jax.tree.map(np.asarray, node.nu)})
        elif isinstance(node, dict) and "m" in node and "count" in node:
            found.append({"count": int(node["count"]), "m": jax.tree.map(np.asarray, node["m"])})
        elif hasattr(node, "trace"):
            found.append({"trace": jax.tree.map(np.asarray, node.trace)})
        elif isinstance(node, (tuple, list)):
            for c in node:
                walk(c)

    walk(state)
    return found[0] if found else {}


@pytest.mark.parametrize("opt", [
    {"type": "adamw", "lr": 1e-2, "weight_decay": 0.1},
    {"type": "adamw_8bit", "lr": 1e-2, "weight_decay": 0.1, "block": 64},
    {"type": "sgd", "lr": 1e-2, "momentum": 0.9, "nesterov": True, "weight_decay": 0.05},
    {"type": "sgd", "lr": 1e-2},
    {"type": "sign_sgd", "lr": 1e-2, "weight_decay": 0.05},
])
def test_optimizers_match_jax_from_a_carried_state(opt):
    """Two JAX updates build a state; it is carried across (numpy); updates
    3..7 then run in both packages from the same params, state and gradients.
    Updates and params: rtol 2e-5, atol 1e-7. The 8-bit codes are equal, or
    differ by one code where a value sits on a rounding boundary (XLA may fuse
    b1 * mu + (1 - b1) * g into one rounding), on at most 0.5% of the entries."""
    rng = np.random.default_rng(0)
    shapes = {"embed": (50, 8), "layers": {"q": (2, 8, 16), "norm": (2, 8)}}
    sched = {"type": "cosine", "warmup_steps": 2, "decay_steps": 6}
    params = jax.tree.map(lambda s: rng.standard_normal(s).astype(np.float32), shapes,
                          is_leaf=lambda x: isinstance(x, tuple))
    grads = [jax.tree.map(lambda p: (rng.standard_normal(p.shape) * 3).astype(np.float32), params)
             for _ in range(7)]
    j_opt, _ = joptim.make_optimizer(JTrainerConfig(optimizer=opt).optimizer,
                                     JTrainerConfig(scheduler=sched).scheduler, 1.0)
    t_opt, _ = toptim.make_optimizer(TrainerConfig(optimizer=opt).optimizer,
                                     TrainerConfig(scheduler=sched).scheduler, 1.0)
    import optax

    j_params = jax.tree.map(jnp.asarray, params)
    j_state = j_opt.init(j_params)
    for g in grads[:2]:
        upd, j_state = j_opt.update(jax.tree.map(jnp.asarray, g), j_state, j_params)
        j_params = optax.apply_updates(j_params, upd)

    t_params = _to_torch(jax.tree.map(np.asarray, j_params))
    t_state = tstep.opt_state_from_jax(t_opt, t_params, {"count": 2, **_adam_state(j_state)})
    for g in grads[2:]:
        j_upd, j_state = j_opt.update(jax.tree.map(jnp.asarray, g), j_state, j_params)
        j_params = optax.apply_updates(j_params, j_upd)
        t_upd, t_state = t_opt.update(_to_torch(g), t_state, t_params)
        t_params = toptim.tree_map(lambda p, u: p + u, t_params, t_upd)
        for (path, t), j in zip(toptim.tree_paths(t_upd), jax.tree.leaves(j_upd)):
            np.testing.assert_allclose(_np(t), np.asarray(j), rtol=2e-5, atol=1e-7,
                                       err_msg=path)
    for t, j in zip(toptim.tree_leaves(t_params), jax.tree.leaves(j_params)):
        np.testing.assert_allclose(_np(t), np.asarray(j), rtol=2e-5, atol=1e-7)
    if opt["type"] == "adamw_8bit":
        j_m = _adam_state(j_state)["m"]
        t_m = next(s["m"] for s in t_state if "m" in s)
        for key in ("embed",):
            for code in ("mu_q", "nu_q"):
                diff = np.abs(_np(t_m[key][code]).astype(np.int32)
                              - j_m[key][code].astype(np.int32))
                assert diff.max() <= 1 and (diff != 0).mean() <= 0.005, (code, diff.max())
            np.testing.assert_allclose(_np(t_m[key]["mu_s"]), j_m[key]["mu_s"], rtol=1e-6)
            np.testing.assert_allclose(_np(t_m[key]["nu_s"]), j_m[key]["nu_s"], rtol=1e-6)


def test_quantizers_match_jax_code_for_code():
    """_quant_q8 / _quant_nu on the same values: identical codes and scales."""
    rng = np.random.default_rng(1)
    x = (rng.standard_normal(1000) * np.exp(rng.normal(0, 3, 1000))).astype(np.float32)
    tq, ts, n = toptim._quant_q8(torch.from_numpy(x), 128)
    jq, js, jn = joptim._quant_q8(jnp.asarray(x), 128)
    assert n == jn and np.array_equal(_np(tq), np.asarray(jq))
    np.testing.assert_array_equal(_np(ts), np.asarray(js))
    tq, ts, _ = toptim._quant_nu(torch.from_numpy(np.abs(x)), 128)
    jq, js, _ = joptim._quant_nu(jnp.asarray(np.abs(x)), 128)
    assert np.array_equal(_np(tq), np.asarray(jq))
    np.testing.assert_array_equal(_np(toptim._dequant_nu(tq, ts, 1000, (1000,))),
                                  np.asarray(joptim._dequant_nu(jq, js, 1000, (1000,))))


def test_unported_optimizers_raise():
    """``muon`` and ``adafactor_mom`` raised until their slice; now both build
    and take a train step of the debug model (finite loss, every parameter
    tensor of the stacks moved, the state's count advanced). Their updates
    are held against optax and the JAX package in tests/test_torch_optimizers.py."""
    spec = debug_spec()
    batch, counts = FakeDataLoader(spec.vocab_size, 64, 2, 2, seed=1).next_batch()
    for opt in ({"type": "muon"}, {"type": "adafactor_mom", "lr": 1e-3}):
        cfg = TrainerConfig(model={"attn": {"impl": "xla"}, "compute_dtype": "float32",
                                   "lm_head_chunk_size": 48}, optimizer=opt)
        tx, _ = toptim.make_optimizer(cfg.optimizer, cfg.scheduler, 1.0)
        state = tstep.init_train_state(spec, "cpu", tx, seed=0)
        before = [t.clone() for t in toptim.tree_leaves(state.params)]
        step = tstep.make_train_step(spec, cfg.model, cfg.loss, tx, "cpu")
        state, metrics = step(state, batch, tstep.Scales(float(counts["rl"]), 1.0, 1.0))
        assert np.isfinite(float(metrics["loss"])) and float(metrics["grad_norm"]) > 0
        assert all(not torch.equal(a, b) for (path, a), b in
                   zip(toptim.tree_paths(state.params), before) if path.startswith("layers/"))
        assert all(st["count"] == 1 for st in state.opt_state if "count" in st)


def test_stochastic_round_is_bit_equal_on_the_same_bits_and_unbiased():
    rng = np.random.default_rng(2)
    x = (rng.standard_normal(4096) * np.exp(rng.normal(0, 4, 4096))).astype(np.float32)
    x[:4] = [np.inf, -np.inf, np.nan, 0.0]
    key = jax.random.key(5)
    bits = np.asarray(jax.random.bits(key, x.shape, jnp.uint32))
    want = np.asarray(joptim.stochastic_round_to(jnp.bfloat16, jnp.asarray(x), key)
                      .astype(jnp.float32))
    got = toptim.stochastic_round_to(torch.bfloat16, torch.from_numpy(x),
                                     bits=torch.from_numpy(bits.astype(np.int64)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(got.float()), want)  # NaN == NaN here
    # unbiased on its own generator: the mean of 4000 roundings of one value
    # between two bf16 neighbours (1 and 1 + 2^-7) recovers it to 3 sigma
    val = 1.0 + 0.3 * 2.0 ** -7
    draws = toptim.stochastic_round_to(torch.bfloat16, torch.full((4000,), val),
                                       torch.Generator().manual_seed(0)).float()
    assert set(draws.tolist()) == {1.0, 1.0 + 2.0 ** -7}
    sigma = 2.0 ** -7 * np.sqrt(0.3 * 0.7 / 4000)
    assert abs(float(draws.mean()) - val) < 3 * sigma
    assert toptim.stochastic_round_to(torch.float32, torch.from_numpy(x)).dtype == torch.float32


# ---------------------------------------------------------------------------
# batches
# ---------------------------------------------------------------------------

def _samples(rng, cls, n=9):
    out = []
    for i in range(n):
        length = int(rng.integers(5, 80))
        out.append(cls(
            token_ids=rng.integers(0, 500, length), mask=rng.random(length) < 0.6,
            logprobs=rng.normal(-2, 0.5, length), temperatures=np.full(length, 0.7 + 0.1 * i),
            advantages=np.full(length, rng.normal()),
            ref_logprobs=rng.normal(-2, 0.5, length) if i % 2 else None,
            rl_weights=rng.choice([0.0, 1.0], length) if i % 3 == 0 else None))
    return out


def _assert_batches_equal(t_batch, j_batch):
    assert t_batch._fields == j_batch._fields
    for name, t, j in zip(t_batch._fields, t_batch, j_batch):
        assert (t is None) == (j is None), name
        if t is not None:
            assert t.dtype == j.dtype and np.array_equal(t, j), name


def test_prepare_batch_matches_jax():
    t_samples = _samples(np.random.default_rng(3), TrainingSample)
    j_samples = _samples(np.random.default_rng(3), JTrainingSample)
    for n_mb in (None, 4):
        t_batch = tbatch.prepare_batch(t_samples, 64, 2, n_mb)
        j_batch = jbatch.prepare_batch(j_samples, 64, 2, n_mb)
        _assert_batches_equal(t_batch, j_batch)
        assert tbatch.token_counts(t_batch) == jbatch.token_counts(j_batch)
    rows = tbatch.pack_rows(t_samples, 64)
    assert all(r.tokens() <= 64 for r in rows)
    with pytest.raises(ValueError):
        tbatch.balance_rows(rows, 1, capacity=1)
    # with a VLM spec a text-only batch carries the vision streams too: an
    # empty patch buffer, no image slot, sequential mRoPE positions
    from prime_rl_tpu.models.base import get_spec as j_get_spec

    t_vlm = tbatch.prepare_batch(t_samples, 64, 2, 4, vlm_spec=get_spec("debug_vlm"))
    _assert_batches_equal(t_vlm, jbatch.prepare_batch(j_samples, 64, 2, 4,
                                                      vlm_spec=j_get_spec("debug_vlm")))
    assert t_vlm.mm_patches.shape[1] == 256 and (t_vlm.mm_img_slot == -1).all()
    # the wire format is the JAX package's
    back = decode(encode(t_samples[1]))
    assert np.array_equal(back.token_ids, t_samples[1].token_ids)
    assert back.rl_weights is None and np.array_equal(back.ref_logprobs,
                                                      t_samples[1].ref_logprobs)


def test_fake_data_loader_matches_jax():
    t_loader = FakeDataLoader(512, 64, 2, 3, seed=7)
    j_loader = JFakeDataLoader(512, 64, 2, 3, seed=7)
    for _ in range(2):
        (t_batch, t_counts), (j_batch, j_counts) = t_loader.next_batch(), j_loader.next_batch()
        _assert_batches_equal(t_batch, j_batch)
        assert t_counts == j_counts
    assert t_batch.input_ids.shape == (3, 2, 64)


# ---------------------------------------------------------------------------
# the slice as a whole
# ---------------------------------------------------------------------------

def _model_cfg(cls, **kw):
    return cls(model={"attn": {"impl": "xla"}, "compute_dtype": "float32",
                      "lm_head_chunk_size": 48, "ac": {"mode": kw.pop("ac", "full")}, **kw},
               optimizer={"type": "adamw", "lr": 1e-3, "weight_decay": 0.1})


@pytest.mark.parametrize("ac", ["full", "save_attn"])
def test_train_step_matches_jax_step_one(ac):
    """One fake batch, the same parameters: step 1's loss, grad_norm, entropy
    and every other metric (rtol 1e-4), and the parameters after the adamw
    update with f32 masters (atol 2e-5: the first Adam update is lr * sign-like,
    so a gradient near zero may differ in its last digits)."""
    jspec, spec = j_debug_spec(), debug_spec()
    j_cfg, t_cfg = _model_cfg(JTrainerConfig, ac=ac), _model_cfg(TrainerConfig, ac=ac)
    np_params = jax.tree.map(np.asarray, jqwen3.init_params(jspec, jax.random.key(0)))
    batch, counts = FakeDataLoader(spec.vocab_size, 64, 2, 2, seed=0).next_batch()
    scale = float(counts["rl"])

    j_opt, _ = joptim.make_optimizer(j_cfg.optimizer, j_cfg.scheduler, 1.0)
    mesh_info = build_mesh(JMeshConfig(fsdp=-1))
    j_state = jstep.init_train_state(jspec, mesh_info, j_opt,
                                     params=jax.tree.map(jnp.asarray, np_params))
    j_step = jstep.make_train_step(jspec, j_cfg.model, j_cfg.loss, j_opt, mesh_info)
    j_batch = jstep.MicroBatchArrays(*[None if x is None else jnp.asarray(x) for x in batch])
    j_state, j_metrics = j_step(j_state, j_batch, jstep.Scales(
        jnp.float32(scale), jnp.float32(1.0), jnp.float32(1.0)))

    t_opt, _ = toptim.make_optimizer(t_cfg.optimizer, t_cfg.scheduler, 1.0)
    t_state = tstep.init_train_state(spec, "cpu", t_opt,
                                     params=tqwen3.params_from_jax(np_params, spec))
    t_step = tstep.make_train_step(spec, t_cfg.model, t_cfg.loss, t_opt, "cpu")
    t_state, t_metrics = t_step(t_state, batch, tstep.Scales(scale, 1.0, 1.0))

    assert t_state.step == 1 == int(j_state.step)
    assert set(t_metrics) == set(j_metrics)
    for name in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(t_metrics[name]), float(j_metrics[name]), rtol=1e-4)
    for name, stat in t_metrics.items():
        if name not in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(stat.total), float(j_metrics[name].total),
                                       rtol=1e-4, atol=1e-5, err_msg=name)
            assert float(stat.count) == float(j_metrics[name].count), name
    j_leaves = jax.tree.leaves(j_state.params)
    for (path, t), j in zip(toptim.tree_paths(t_state.params), j_leaves):
        np.testing.assert_allclose(_np(t), np.asarray(j), atol=2e-5, rtol=0, err_msg=path)
        assert not np.array_equal(_np(t), np.asarray(dict(toptim.tree_paths(
            tqwen3.params_from_jax(np_params, spec)))[path])) or "norm" in path


def test_train_step_options():
    """bf16 accumulation, frozen paths, bf16 masters with stochastic rounding
    (deterministic in the step), and host offload: the state's host-tier
    leaves are CPU tensors here, where the host tier is the device itself
    (the steps' bits: tests/test_torch_offload.py)."""
    spec = debug_spec()
    cfg = TrainerConfig(model={"compute_dtype": "float32", "grad_accum_dtype": "bfloat16",
                               "freeze": ["^embed$", "layers/q$"]},
                        optimizer={"type": "adamw_8bit", "lr": 1e-2, "block": 256,
                                   "master_dtype": "bfloat16"})
    opt, _ = toptim.make_optimizer(cfg.optimizer, cfg.scheduler, 1.0)
    batch, counts = FakeDataLoader(spec.vocab_size, 64, 2, 2, seed=1).next_batch()
    scales = tstep.Scales(float(counts["rl"]), 1.0, 1.0)
    step = tstep.make_train_step(spec, cfg.model, cfg.loss, opt, "cpu")
    finals = []
    for _ in range(2):
        state = tstep.init_train_state(spec, "cpu", opt, seed=3, master_dtype="bfloat16")
        before = {p: t.clone() for p, t in toptim.tree_paths(state.params)}
        state, metrics = step(state, batch, scales)
        finals.append(state)
    after = dict(toptim.tree_paths(finals[0].params))
    assert all(t.dtype == torch.bfloat16 for t in after.values())
    assert np.isfinite(float(metrics["loss"])) and float(metrics["grad_norm"]) > 0
    # frozen: only weight decay moves them (lr * wd * p), the Adam direction is 0
    for path in ("layers/q",):
        moved = (after[path].float() - before[path].float()).abs().max()
        assert float(moved) <= 1e-2 * 0.01 * float(before[path].float().abs().max()) + 1e-2
    assert not torch.equal(after["layers/k"], before["layers/k"])
    for a, b in zip(toptim.tree_leaves(finals[0].params), toptim.tree_leaves(finals[1].params)):
        assert torch.equal(a, b)
    off = tstep.init_train_state(spec, "cpu", opt, seed=3, master_dtype="bfloat16",
                                 offload_optimizer=True)
    p_host, o_host = tstep.host_leaves(off, True, False)
    assert not any(p_host) and all(f for leaf in o_host for st in leaf for entry in st.values()
                                   for f in entry.values())  # every 8-bit tensor is 2-D
    off, _ = tstep.make_train_step(spec, cfg.model, cfg.loss, opt, "cpu",
                                   offload_optimizer=True)(off, batch, scales)
    for a, b in zip(toptim.tree_leaves(off.params), toptim.tree_leaves(finals[0].params)):
        assert torch.equal(a, b)
    # LoRA mode needs model.lora (its training is held in tests/test_torch_lora.py)
    with pytest.raises(ValueError, match="model.lora"):
        tstep.make_loss_fn(spec, TrainerConfig().model, cfg.loss, base_params=finals[0].params)


def test_perf_counter_and_peaks(monkeypatch):
    assert device_peak_flops("cpu") == 1e12
    perf = PerfCounter(6e9, device="cpu", window=2)
    for d, n in ((1.0, 100), (1.0, 300), (2.0, 500)):
        perf.record(d, n)
    assert perf.tokens_per_sec == pytest.approx(800 / 3)
    assert perf.mfu() == pytest.approx(800 / 3 * 6e9 / 1e12)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "NVIDIA H100 80GB HBM3")
    assert device_peak_flops("cuda") == 989e12
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "Some Other Card")
    with pytest.raises(ValueError):
        device_peak_flops("cuda")


def test_configs_accept_what_the_jax_package_accepts(tmp_path):
    """The bench TOML of the JAX package parses into the port's TrainerConfig
    field for field, and every RL TOML of ``configs/debug`` and
    ``configs/bench`` into the port's RLConfig; the port adds only the
    trainer's and the sampler's ``device``."""
    import tomllib

    from prime_rl_tpu.configs import RLConfig as JRLConfig
    from prime_rl_tpu.configs.shared import ModelConfig as JModelConfig
    from prime_rl_tpu_torch.configs import RLConfig

    configs = Path(__file__).resolve().parents[1] / "configs"
    toml = configs / "bench" / "northstar_rl_tpu.toml"
    raw = tomllib.loads(toml.read_text())["trainer"]
    raw.pop("transport")
    t_cfg, j_cfg = TrainerConfig(**raw), JTrainerConfig(**raw)
    t_dump, j_dump = t_cfg.model_dump(), j_cfg.model_dump()
    assert t_dump.pop("device") == "cuda"
    assert t_dump == j_dump
    tomls = sorted((configs / "debug").glob("*.toml")) + sorted((configs / "bench").glob("*.toml"))
    assert len(tomls) >= 5
    for path in tomls:
        raw = tomllib.loads(path.read_text())
        t_dump, j_dump = RLConfig(**raw).model_dump(), JRLConfig(**raw).model_dump()
        assert t_dump["trainer"].pop("device") == t_dump["inference"].pop("device") == "cuda"
        assert t_dump == j_dump, path.name
    assert set(tshared.ModelConfig.model_fields) == set(JModelConfig.model_fields)
    for mode in ("none", "full", "save_attn", "save_attn/7", "offload_attn/2", "selective"):
        assert tshared.ModelConfig(ac={"mode": mode}).ac.mode == mode
    for impl in ("auto", "pallas", "xla"):
        assert tshared.ModelConfig(attn={"impl": impl}).attn.impl == impl
    with pytest.raises(NotImplementedError):
        setup_monitor(tshared.WandbMonitorConfig(), tmp_path)
    with pytest.raises(ValueError, match="colocated entry point"):  # the default mode
        make_broadcast(TrainerConfig(broadcast={"type": "device"}).broadcast, None, str(tmp_path))
    for mode in ("shm", "zmq_stream", "dcn_pull"):
        with pytest.raises(NotImplementedError, match="item 11"):
            make_broadcast(TrainerConfig(broadcast={"type": "device", "mode": mode}).broadcast,
                           None, str(tmp_path))


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------

_ARGS = ["--device", "cpu", "--data.type", "fake", "--model.name", "debug",
         "--model.compute-dtype", "float32", "--data.seq-len", "64", "--batch.seq-len", "64",
         "--data.micro-batch-size", "2", "--data.num-micro-batches", "2",
         "--optimizer.type", "adamw_8bit", "--optimizer.master-dtype", "bfloat16",
         "--optimizer.lr", "1e-3", "--ckpt.interval", "1"]


def _run(monkeypatch, out, *extra):
    monkeypatch.setattr(sys, "argv", ["trainer", *_ARGS, "--output-dir", str(out), *extra])
    try:
        return train(parse_config(TrainerConfig))
    finally:
        tlogger.reset_logger()


def test_entrypoint_trains_snapshots_and_resumes(tmp_path, monkeypatch):
    out = tmp_path / "run"
    first = _run(monkeypatch, out, "--max-steps", "2")
    records = [json.loads(line) for line in (out / "trainer.jsonl").read_text().splitlines()]
    assert [r["step"] for r in records] == [1, 2]
    for r in records:
        for key in ("loss", "grad_norm", "entropy", "mismatch_kl", "lr", "tokens_per_sec",
                    "mfu", "step_time_s"):
            assert np.isfinite(r[key]), key
        assert r["grad_norm"] > 0
    assert [r["loss"] for r in first.records] == [r["loss"] for r in records]

    # the newest snapshot is v2, STABLE, and reads back as the state's parameters
    spec = get_spec("debug")
    snap = pathing.weights_dir(out, 2)
    assert pathing.is_stable(snap) and pathing.list_step_dirs(out / "weights") == [2]
    assert json.loads((snap / "config.json").read_text())["num_hidden_layers"] == spec.num_layers
    loaded = dict(toptim.tree_paths(tqwen3.load_hf_weights(snap, spec, dtype=torch.bfloat16)))
    for path, want in toptim.tree_paths(first.state.params):
        assert torch.equal(loaded[path], want), path

    # resume from the latest checkpoint: steps 3 and 4 follow, and a straight
    # run of 4 steps from the same seed gives the same losses
    assert pathing.latest_step(out / "checkpoints") == 2
    resumed = _run(monkeypatch, out, "--max-steps", "4", "--ckpt.resume-step", "-1")
    assert resumed.state.step == 4 and len(resumed.records) == 2
    lines = (out / "trainer.jsonl").read_text().splitlines()
    assert [json.loads(line)["step"] for line in lines] == [1, 2, 3, 4]
    assert pathing.list_step_dirs(out / "checkpoints") == [3, 4]  # keep_last = 2


def test_trainer_is_deterministic_and_bench_mode_skips_publishing(tmp_path, monkeypatch):
    a = _run(monkeypatch, tmp_path / "a", "--max-steps", "2")
    b = _run(monkeypatch, tmp_path / "b", "--max-steps", "2")
    assert [r["loss"] for r in a.records] == [r["loss"] for r in b.records]
    bench = _run(monkeypatch, tmp_path / "bench", "--bench.warmup-steps", "1",
                 "--bench.steps", "1")
    assert len(bench.records) == 2
    assert pathing.list_step_dirs(tmp_path / "bench" / "weights") == [0]  # only v0
    assert not (tmp_path / "bench" / "checkpoints").exists()


def test_trainer_refuses_a_truncated_vocabulary_without_random_init(tmp_path, monkeypatch):
    """``model.debug.vocab_size`` cuts the embedding and head, which a
    checkpoint's cannot fill: the trainer raises before it builds anything,
    as the port's inference entry point does (the JAX trainer does not)."""
    with pytest.raises(ValueError, match="random_init"):
        _run(monkeypatch, tmp_path / "v", "--max-steps", "1", "--model.debug.vocab-size", "384")
    out = _run(monkeypatch, tmp_path / "w", "--max-steps", "1", "--model.debug.vocab-size", "384",
               "--model.debug.random-init")
    assert len(out.records) == 1 and np.isfinite(out.records[0]["loss"])


def test_trainer_raises_for_what_waits_for_the_loop_slice(tmp_path, monkeypatch):
    assert TrainerConfig().device == "cuda"
    # the default data plane, the transport, trains: one batch from the
    # filesystem transport, one step
    from prime_rl_tpu_torch.transport import setup_training_batch_sender
    from prime_rl_tpu_torch.transport.types import TrainingBatch

    fed = TrainerConfig(device="cpu", output_dir=str(tmp_path / "t"), max_steps=1,
                        transport={"type": "filesystem"},
                        model={"name": "debug", "attn": {"impl": "xla"}},
                        batch={"seq_len": 64, "micro_batch_size": 2})
    assert fed.data.type == "transport"
    rng = np.random.default_rng(0)
    samples = [TrainingSample(token_ids=rng.integers(0, 500, 20),
                              mask=np.r_[np.zeros(8, bool), np.ones(12, bool)],
                              logprobs=-rng.random(20), temperatures=np.ones(20),
                              advantages=rng.standard_normal(20)) for _ in range(3)]
    setup_training_batch_sender(fed.transport, fed.output_dir).send(
        TrainingBatch(examples=samples, step=0))
    try:
        out = train(fed)
    finally:
        tlogger.reset_logger()
    assert out.state.step == 1 and out.records[0]["rl_tokens"] == 36
    assert np.isfinite(out.records[0]["loss"])
    for extra in (["--mesh.fsdp", "2"], ["--model.lora.rank", "4", "--mesh.fsdp", "2"]):
        with pytest.raises(NotImplementedError):
            _run(monkeypatch, tmp_path / "x", "--max-steps", "1", *extra)  # a later flag wins
    # token export and the metrics server run since their slice (held against
    # JAX in tests/test_torch_trainer_features.py)
    _run(monkeypatch, tmp_path / "e", "--max-steps", "1", "--token-export-rows", "2",
         "--metrics-server.enable", "true", "--metrics-server.host", "127.0.0.1",
         "--metrics-server.port", "0")
    assert (tmp_path / "e" / "token_export" / "step_0.STABLE").exists()
    # the offload flags run since their slice: the same record as without
    # them (the host tier is the CPU itself here), the collector on again
    import gc

    plain = _run(monkeypatch, tmp_path / "p", "--max-steps", "1", "--bench.steps", "1",
                 "--bench.warmup-steps", "0")
    offloaded = _run(monkeypatch, tmp_path / "o", "--max-steps", "1", "--bench.steps", "1",
                     "--bench.warmup-steps", "0", "--offload-optimizer", "true")
    assert offloaded.records[0]["loss"] == plain.records[0]["loss"] and gc.isenabled()
    # multi_run trains one adapter a tenant: without model.lora it is refused
    with pytest.raises(ValueError, match="model.lora"):
        _run(monkeypatch, tmp_path / "x", "--max-steps", "1", "--multi-run", "true")
    if not torch.cuda.is_available():
        monkeypatch.setattr(sys, "argv", ["trainer", "--data.type", "fake", "--model.name",
                                          "debug", "--output-dir", str(tmp_path / "y")])
        with pytest.raises(RuntimeError):  # no card and no --device cpu: it never falls back
            train(parse_config(TrainerConfig))
        tlogger.reset_logger()

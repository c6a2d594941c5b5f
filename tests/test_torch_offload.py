"""Host offload of the train state and the trainer's memory utilities on the
CPU, against the port's own plain step and the JAX package.

On the CPU the host tier is the device itself: the offloaded leaves are CPU
tensors (unpinned) and the streamed code runs as it does on the card, the
copies being CPU copies. JAX's offloaded step keeps every leaf on the
device there: its ``init_train_state(offload_optimizer=True)`` does not
compile on the tests' 8-device CPU mesh (the step counter's host placement
has no sharding), so the JAX step is built from a plain state's shardings,
the device memory kinds that ``_to_host_kind``'s CPU fall-back gives, and
``params_offloaded`` is false. The CPU comparison with JAX cannot see the
bf16 cast of the masters that JAX's ``offload_params`` step makes for its
gradient program (``cast_in_jit``), nor the bf16 gradient norm it then
takes. The port's
``offload_params`` step is held instead to its own step with
``grad_accum_dtype = "bfloat16"`` (the same bf16 copy, its gradients
accumulated in bf16, then widened), bit for bit. Tolerances are stated per
test.
"""

import gc

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
from prime_rl_tpu.trainer import optim as joptim
from prime_rl_tpu.trainer import step as jstep
from prime_rl_tpu.utils import memory as jmemory
from prime_rl_tpu_torch.configs import TrainerConfig
from prime_rl_tpu_torch.models import qwen3 as tqwen3
from prime_rl_tpu_torch.models.base import debug_spec
from prime_rl_tpu_torch.trainer import optim as toptim
from prime_rl_tpu_torch.trainer import step as tstep
from prime_rl_tpu_torch.trainer.rl.data import FakeDataLoader
from prime_rl_tpu_torch.utils import memory as tmemory
from prime_rl_tpu_torch.utils import offload

jax.config.update("jax_platforms", "cpu")
torch.set_num_threads(1)

OPTIMIZERS = {
    "adamw": {"type": "adamw", "lr": 1e-3, "weight_decay": 0.1},
    "adamw_8bit": {"type": "adamw_8bit", "lr": 1e-3, "block": 256, "weight_decay": 0.1},
    "sgd": {"type": "sgd", "lr": 1e-2, "momentum": 0.9, "weight_decay": 0.1},
    "sign_sgd": {"type": "sign_sgd", "lr": 1e-3},
}
FLAGS = {"optimizer": (True, False), "params": (False, True), "both": (True, True)}


def _np(t):
    return t.detach().float().numpy()


def _tensors(tree) -> list[torch.Tensor]:
    """Every tensor of a state (lists of stage dicts, nested dicts), in order."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _tensors(tree[k])]
    if isinstance(tree, list):
        return [t for x in tree for t in _tensors(x)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def _run_steps(spec, cfg, opt, batches, offload_optimizer=False, offload_params=False):
    state = tstep.init_train_state(spec, "cpu", opt, seed=1,
                                   offload_optimizer=offload_optimizer,
                                   offload_params=offload_params)
    step = tstep.make_train_step(spec, cfg.model, cfg.loss, opt, "cpu",
                                 offload_optimizer=offload_optimizer,
                                 offload_params=offload_params)
    metrics = []
    for batch, counts in batches:
        state, m = step(state, batch, tstep.Scales(float(counts["rl"]), 1.0, 1.0))
        metrics.append({k: (v.total, v.count) if hasattr(v, "total") else v
                        for k, v in m.items()})
    return state, metrics


@pytest.mark.parametrize("flags", list(FLAGS))
@pytest.mark.parametrize("opt", list(OPTIMIZERS))
def test_offloaded_step_equals_the_plain_step_bit_for_bit(opt, flags):
    """Two steps (2 micro-batches each, grad clip 1.0, f32 masters): the
    parameters, every optimizer-state tensor and every metric of the
    offloaded step are the plain step's, bit for bit. Under
    ``offload_params`` the plain step is the one with ``grad_accum_dtype =
    "bfloat16"``: the gradients of a bf16 copy of the masters, accumulated in
    bf16 (the JAX offload_params step's arithmetic)."""
    oo, op = FLAGS[flags]
    spec = debug_spec()
    cfg = TrainerConfig(model={"attn": {"impl": "xla"}, "compute_dtype": "float32",
                               "lm_head_chunk_size": 48}, optimizer=OPTIMIZERS[opt])
    tc, _ = toptim.make_optimizer(cfg.optimizer, cfg.scheduler, cfg.grad_clip)
    loader = FakeDataLoader(spec.vocab_size, 64, 2, 2, seed=0)
    batches = [loader.next_batch() for _ in range(2)]
    plain_cfg = cfg.model_copy(update={"model": cfg.model.model_copy(
        update={"grad_accum_dtype": "bfloat16"})}) if op else cfg
    want, want_m = _run_steps(spec, plain_cfg, tc, batches)
    got, got_m = _run_steps(spec, cfg, tc, batches, oo, op)
    assert got.step == want.step == 2
    for a, b in zip(toptim.tree_leaves(got.params), toptim.tree_leaves(want.params)):
        assert torch.equal(a, b)
    got_t, want_t = _tensors(got.opt_state), _tensors(want.opt_state)
    assert len(got_t) == len(want_t) > 0 or opt == "sign_sgd"
    for a, b in zip(got_t, want_t):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for g, w in zip(got_m, want_m):
        assert set(g) == set(w)
        for k in g:
            pair_g = g[k] if isinstance(g[k], tuple) else (g[k],)
            pair_w = w[k] if isinstance(w[k], tuple) else (w[k],)
            assert all(torch.equal(x, y) for x, y in zip(pair_g, pair_w)), k


@pytest.mark.parametrize("opt", list(OPTIMIZERS))
def test_host_leaves_follow_the_two_dims_rule(opt):
    """What the flags put in the host tier, in the port's own layouts:
    AdamW's and the momentum's tensors of the matrices (not of the norm
    weights), every 8-bit AdamW tensor (codes and scales are 2-D), and every
    master under offload_params."""
    spec = debug_spec()
    cfg = TrainerConfig(optimizer=OPTIMIZERS[opt])
    tc, _ = toptim.make_optimizer(cfg.optimizer, cfg.scheduler, cfg.grad_clip)
    state = tstep.init_train_state(spec, "cpu", tc, offload_optimizer=True, offload_params=True)
    p_host, o_host = tstep.host_leaves(state, True, True)
    assert all(p_host)
    paths = [p for p, _ in toptim.tree_paths(state.params)]
    for path, leaf, flags in zip(paths, toptim.tree_leaves(state.params), o_host):
        for stage in flags:
            for entry, names in stage.items():
                for name, on_host in names.items():
                    want = True if opt == "adamw_8bit" else leaf.dim() >= 2
                    assert on_host == want, (path, entry, name)
    entries = {entry for leaf in o_host for stage in leaf for entry in stage}
    assert entries == {"adamw": {"mu", "nu"}, "adamw_8bit": {"m"}, "sgd": {"trace"},
                       "sign_sgd": set()}[opt]
    _, o_none = tstep.host_leaves(state, False, False)
    assert not any(f for leaf in o_none for st in leaf for e in st.values() for f in e.values())


def test_streamed_adamw_matches_the_jax_offloaded_update():
    """The same gradients through JAX's leaf-streamed AdamW step
    (``_make_streamed_adamw_step``, built from the state's shardings) and
    the port's ``_streamed_update``, five updates from the
    same state with the global-norm clip: parameters and moments at
    ``test_optimizers_match_jax_from_a_carried_state``'s tolerance (rtol 2e-5,
    atol 1e-7), the gradient norm at rtol 1e-6."""
    rng = np.random.default_rng(0)
    jspec, spec = j_debug_spec(), debug_spec()
    opt = {"type": "adamw", "lr": 1e-3, "weight_decay": 0.1}
    sched = {"type": "cosine", "warmup_steps": 2, "decay_steps": 6}
    jcfg, tcfg = JTrainerConfig(optimizer=opt, scheduler=sched), TrainerConfig(optimizer=opt,
                                                                                scheduler=sched)
    j_opt, j_sched = joptim.make_optimizer(jcfg.optimizer, jcfg.scheduler, 1.0)
    t_opt, _ = toptim.make_optimizer(tcfg.optimizer, tcfg.scheduler, 1.0)
    np_params = jax.tree.map(np.asarray, jqwen3.init_params(jspec, jax.random.key(0)))
    mesh_info = build_mesh(JMeshConfig(fsdp=-1))
    j_state = jstep.init_train_state(jspec, mesh_info, j_opt,
                                     params=jax.tree.map(jnp.asarray, np_params))
    shardings = jax.tree.map(lambda x: x.sharding, j_state)
    current = []
    j_step = jstep._make_streamed_adamw_step(
        lambda params, batch, scales: (current[0], jnp.zeros(()), {}), jcfg.optimizer,
        j_sched, 1.0, shardings)
    t_state = tstep.init_train_state(spec, "cpu", t_opt, offload_optimizer=True,
                                     params=tqwen3.params_from_jax(np_params, spec))
    for k in range(5):
        g = jax.tree.map(lambda p: (rng.standard_normal(p.shape) * (0.05 + k)).astype(np.float32),
                         np_params)
        current[:] = [jax.tree.map(jnp.asarray, g)]
        j_state, j_metrics = j_step(j_state, None, None)
        t_state, t_norm = tstep._streamed_update(
            t_state, tqwen3.params_from_jax(g, spec), t_opt, torch.device("cpu"), True, False)
        np.testing.assert_allclose(float(t_norm), float(j_metrics["grad_norm"]), rtol=1e-6)
        for (path, t), j in zip(toptim.tree_paths(t_state.params),
                                jax.tree.leaves(j_state.params)):
            np.testing.assert_allclose(_np(t), np.asarray(j), rtol=2e-5, atol=1e-7,
                                       err_msg=f"update {k + 1} {path}")
    adam = jstep._find_adam(j_state.opt_state)
    t_adam = next(s for s in t_state.opt_state if "mu" in s)
    assert t_adam["count"] == int(adam.count) == 5
    for key in ("mu", "nu"):
        for t, j in zip(toptim.tree_leaves(t_adam[key]), jax.tree.leaves(getattr(adam, key))):
            np.testing.assert_allclose(_np(t), np.asarray(j), rtol=2e-5, atol=1e-7)


def test_offloaded_step_matches_the_jax_offloaded_step():
    """One fake batch through the JAX trainer's offloaded step (the split
    programs and the leaf-streamed AdamW, ``make_train_step`` with the
    state's shardings) and the port's (``offload_optimizer``): loss and
    grad_norm at rtol 1e-4 and the parameters at atol 2e-5, the tolerances
    of ``test_train_step_matches_jax_step_one``."""
    jspec, spec = j_debug_spec(), debug_spec()
    raw = dict(model={"attn": {"impl": "xla"}, "compute_dtype": "float32",
                      "lm_head_chunk_size": 48},
               optimizer={"type": "adamw", "lr": 1e-3, "weight_decay": 0.1},
               offload_optimizer=True)
    j_cfg, t_cfg = JTrainerConfig(**raw), TrainerConfig(**raw)
    np_params = jax.tree.map(np.asarray, jqwen3.init_params(jspec, jax.random.key(0)))
    batch, counts = FakeDataLoader(spec.vocab_size, 64, 2, 2, seed=0).next_batch()
    scale = float(counts["rl"])
    j_opt, j_sched = joptim.make_optimizer(j_cfg.optimizer, j_cfg.scheduler, 1.0)
    mesh_info = build_mesh(JMeshConfig(fsdp=-1))
    j_state = jstep.init_train_state(jspec, mesh_info, j_opt,
                                     params=jax.tree.map(jnp.asarray, np_params))
    j_step = jstep.make_train_step(jspec, j_cfg.model, j_cfg.loss, j_opt, mesh_info,
                                   state_out_shardings=jax.tree.map(lambda x: x.sharding,
                                                                    j_state),
                                   optimizer_cfg=j_cfg.optimizer, schedule=j_sched,
                                   grad_clip=1.0)
    j_batch = jstep.MicroBatchArrays(*[None if x is None else jnp.asarray(x) for x in batch])
    j_state, j_metrics = j_step(j_state, j_batch, jstep.Scales(
        jnp.float32(scale), jnp.float32(1.0), jnp.float32(1.0)))

    t_opt, _ = toptim.make_optimizer(t_cfg.optimizer, t_cfg.scheduler, 1.0)
    t_state = tstep.init_train_state(spec, "cpu", t_opt, offload_optimizer=True,
                                     params=tqwen3.params_from_jax(np_params, spec))
    t_step = tstep.make_train_step(spec, t_cfg.model, t_cfg.loss, t_opt, "cpu",
                                   offload_optimizer=True)
    t_state, t_metrics = t_step(t_state, batch, tstep.Scales(scale, 1.0, 1.0))
    for name in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(t_metrics[name]), float(j_metrics[name]), rtol=1e-4)
    for (path, t), j in zip(toptim.tree_paths(t_state.params), jax.tree.leaves(j_state.params)):
        np.testing.assert_allclose(_np(t), np.asarray(j), atol=2e-5, rtol=0, err_msg=path)


def test_offload_refuses_lora_mode():
    """LoRA mode's state is the adapter tree: the offload flags are refused
    there (the JAX package never runs its offload path in LoRA mode)."""
    spec = debug_spec()
    cfg = TrainerConfig(model={"lora": {"rank": 2}})
    tc, _ = toptim.make_optimizer(cfg.optimizer, cfg.scheduler, cfg.grad_clip)
    base = tstep.init_base_params(spec, "cpu")
    with pytest.raises(ValueError, match="LoRA"):
        tstep.make_train_step(spec, cfg.model, cfg.loss, tc, "cpu", base_params=base,
                              offload_optimizer=True)


def test_stash_and_fetch_round_trip_on_the_cpu():
    """The host tier's copies on the CPU: a stash is a copy (the source may
    change afterwards), a fetch a copy of it, a prefetch a no-op."""
    t = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    kept = offload.stash(t)
    t.zero_()
    kept.prefetch()
    back = kept.fetch()
    assert torch.equal(back, torch.arange(12, dtype=torch.float32).reshape(3, 4))
    assert back.data_ptr() != kept.host.data_ptr()
    host = offload.to_host(back, torch.device("cpu"))
    assert torch.equal(host, back) and host.data_ptr() != back.data_ptr()
    assert host.device.type == "cpu" and not host.is_pinned()


def test_gc_gate_and_memory_stats_match_jax(monkeypatch):
    """``GarbageCollection`` does what the JAX class does (the collector off
    from construction, a collection at every multiple of the interval,
    ``restore`` turns it on), and ``device_memory_stats`` gives the JAX
    function's keys and values from a card's numbers (the allocator's
    current and peak bytes, the card's total), and nothing for a CPU device,
    as the JAX function gives nothing where a device has no stats."""
    was = gc.isenabled()
    try:
        for cls in (jmemory.GarbageCollection, tmemory.GarbageCollection):
            collected = []
            monkeypatch.setattr(gc, "collect", lambda *a: collected.append(1) or 0)
            gate = cls(interval=3)
            assert not gc.isenabled() and collected == [1]
            for step in range(1, 8):
                gate.maybe_collect(step)
            assert len(collected) == 3  # construction, steps 3 and 6
            gate.restore()
            assert gc.isenabled()
            monkeypatch.undo()
    finally:
        (gc.enable if was else gc.disable)()

    class FakeDevice:
        def memory_stats(self):
            return {"bytes_in_use": 3e9, "bytes_limit": 8e10, "peak_bytes_in_use": 5e9}

    monkeypatch.setattr(jax, "local_devices", lambda: [FakeDevice()])
    want = jmemory.device_memory_stats()
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda i: {
        "allocated_bytes.all.current": 3e9, "allocated_bytes.all.peak": 5e9})
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda i: (1e10, 8e10))
    got = tmemory.device_memory_stats(torch.device("cuda", 0))
    assert got == want and set(got) == {"device0/bytes_in_use_gb", "device0/bytes_limit_gb",
                                        "device0/peak_bytes_gb"}
    assert tmemory.device_memory_stats(torch.device("cpu")) == {}


def test_trainer_snapshots_host_tier_masters(tmp_path):
    """``train`` with both offloads on the CPU: the snapshot of each version
    is written from the host tier's masters and reads back equal to the
    state's parameters (rounded to the snapshot's bf16), and the collector
    is on again afterwards."""
    from prime_rl_tpu_torch.models.qwen3 import load_hf_weights
    from prime_rl_tpu_torch.trainer.rl.train import train
    from prime_rl_tpu_torch.utils import logger as tlogger
    from prime_rl_tpu_torch.utils import pathing

    cfg = TrainerConfig(
        device="cpu", max_steps=1, output_dir=str(tmp_path), offload_optimizer=True,
        offload_params=True,
        model={"name": "debug", "compute_dtype": "float32", "debug": {"random_init": True}},
        data={"type": "fake", "seq_len": 64, "micro_batch_size": 2, "num_micro_batches": 2},
        batch={"seq_len": 64, "micro_batch_size": 2, "num_micro_batches": 2})
    try:
        result = train(cfg)
    finally:
        tlogger.reset_logger()
    assert gc.isenabled() and result.state.step == 1
    from prime_rl_tpu_torch.models.base import get_spec

    spec = get_spec("debug")
    snap = pathing.weights_dir(str(tmp_path), 1)
    loaded = dict(toptim.tree_paths(load_hf_weights(snap, spec, dtype=torch.float32)))
    for path, t in toptim.tree_paths(result.state.params):
        assert torch.equal(loaded[path], t.to(torch.bfloat16).float()), path

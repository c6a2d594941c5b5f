"""The port's ``MultiRunManager`` (``trainer/runs.py``): the four cases of the
JAX package's ``tests/unit/trainer/test_runs.py`` (tenants share one step and
diverge, eviction and reload, delete, the merged publish), and one tenant's
adapter after two steps against the JAX manager's, from the same adapter,
base and batches."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prime_rl_tpu_torch.configs.shared import AdamWConfig, LoRAConfig, SGDConfig
from prime_rl_tpu_torch.configs.trainer import TrainerConfig
from prime_rl_tpu_torch.models.base import debug_spec
from prime_rl_tpu_torch.trainer.optim import make_optimizer
from prime_rl_tpu_torch.trainer.rl.data import FakeDataLoader
from prime_rl_tpu_torch.trainer.runs import MultiRunManager
from prime_rl_tpu_torch.trainer.step import Scales, init_base_params, make_train_step

torch.set_num_threads(2)


def _cfg(opt=None):
    cfg = TrainerConfig()
    cfg.model.attn.impl = "xla"
    cfg.model.lm_head_chunk_size = 0
    cfg.model.compute_dtype = "float32"
    cfg.model.ac.mode = "none"
    cfg.model.lora = LoRAConfig(rank=4)
    return cfg, make_optimizer(opt or AdamWConfig(lr=1e-2), cfg.scheduler, 1.0)[0]


@pytest.fixture(scope="module")
def setup():
    cfg, opt = _cfg()
    spec = debug_spec(num_layers=2)
    base = init_base_params(spec, "cpu", seed=0, dtype=torch.float32)
    step = make_train_step(spec, cfg.model, cfg.loss, opt, "cpu", base_params=base)
    return cfg, spec, opt, base, step


def _batch(spec, seed):
    batch, counts = FakeDataLoader(spec.vocab_size, 128, 2, 2, seed=seed).next_batch()
    return batch, Scales(float(max(counts["rl"], 1)), 1.0, 1.0)


def test_tenants_share_one_step_and_diverge(tmp_path, setup):
    cfg, spec, opt, _, step = setup
    mgr = MultiRunManager(tmp_path, spec, cfg.model.lora, "cpu", opt, max_runs=4)
    a, b = mgr.get_or_create("run_a"), mgr.get_or_create("run_b")
    assert mgr.get_or_create("run_a") is a
    for seed, run in ((1, a), (2, b)):
        run.state, _ = step(run.state, *_batch(spec, seed))
        run.progress.step += 1
    qa, qb = a.state.params["layers"]["q_b"], b.state.params["layers"]["q_b"]
    assert not torch.allclose(qa, qb)  # independent tenants diverged


def test_eviction_and_reload_are_bit_equal(tmp_path, setup):
    cfg, spec, opt, _, step = setup
    mgr = MultiRunManager(tmp_path, spec, cfg.model.lora, "cpu", opt, max_runs=2)
    a = mgr.get_or_create("run_a")
    a.state, _ = step(a.state, *_batch(spec, 3))
    a.progress.step = 5
    before = a.state
    mgr.get_or_create("run_b").progress.step = 6
    mgr.get_or_create("run_c")  # max_runs = 2: evicts (saves) the least advanced, run_a
    assert len(mgr.runs) == 2 and "run_a" not in mgr.runs
    assert set(mgr.discover()) >= {"run_a"}
    a2 = mgr.get_or_create("run_a")
    assert a2.progress.step == 5 and a2.state.step == before.step
    for k, v in before.params["layers"].items():
        assert torch.equal(a2.state.params["layers"][k], v), k
    for got, want in zip(a2.state.opt_state, before.opt_state):
        for key in ("mu", "nu"):
            if key in want:
                for k, v in want[key]["layers"].items():
                    assert torch.equal(got[key]["layers"][k], v), (key, k)
        if "count" in want:
            assert got["count"] == want["count"]
    # the reloaded tenant trains on exactly as the one that never left
    s1, _ = step(a2.state, *_batch(spec, 4))
    s2, _ = step(before, *_batch(spec, 4))
    assert torch.equal(s1.params["layers"]["q_b"], s2.params["layers"]["q_b"])


def test_delete(tmp_path, setup):
    cfg, spec, opt, _, _ = setup
    mgr = MultiRunManager(tmp_path, spec, cfg.model.lora, "cpu", opt)
    mgr.get_or_create("run_x").progress.step = 1
    mgr.save_all()
    assert "run_x" in mgr.discover()
    mgr.delete("run_x")
    assert "run_x" not in mgr.discover() and "run_x" not in mgr.runs


def test_publish_merged_weights(tmp_path, setup):
    from prime_rl_tpu_torch.models import lora as tlora

    cfg, spec, opt, base, _ = setup
    mgr = MultiRunManager(tmp_path, spec, cfg.model.lora, "cpu", opt)
    run = mgr.get_or_create("run_p")
    path = mgr.publish(run, base, version=3)
    assert path.name == "step_3"
    assert (path / "model.safetensors").exists() and (path / "STABLE").exists()
    ad = tlora.load_adapter_file(path / "adapter", spec)
    assert np.array_equal(ad["q_a"], run.state.params["layers"]["q_a"].numpy())


def test_one_tenant_after_two_steps_matches_the_jax_manager(tmp_path):
    """The same tenant in both packages' managers (the JAX tenant's initial
    adapter copied into the port's, the JAX base as float32, SGD so that an
    update is linear in its gradient), two steps on the same two fake
    batches: the adapters agree within 1e-5 (float32)."""
    from prime_rl_tpu.configs import MeshConfig
    from prime_rl_tpu.configs.shared import LoRAConfig as JLoRAConfig
    from prime_rl_tpu.configs.shared import SGDConfig as JSGDConfig
    from prime_rl_tpu.configs.trainer import TrainerConfig as JTrainerConfig
    from prime_rl_tpu.models.base import debug_spec as j_debug_spec
    from prime_rl_tpu.parallel.mesh import build_mesh
    from prime_rl_tpu.trainer import step as jstep
    from prime_rl_tpu.trainer.optim import make_optimizer as j_make_optimizer
    from prime_rl_tpu.trainer.rl.data import FakeDataLoader as JFakeDataLoader
    from prime_rl_tpu.trainer.runs import MultiRunManager as JMultiRunManager
    from prime_rl_tpu_torch.models import lora as tlora
    from prime_rl_tpu_torch.models.qwen3 import params_from_jax

    jcfg = JTrainerConfig()
    jcfg.model.attn.impl = "xla"
    jcfg.model.lm_head_chunk_size = 0
    jcfg.model.compute_dtype = "float32"
    jcfg.model.lora = JLoRAConfig(rank=4)
    jspec, spec = j_debug_spec(num_layers=2), debug_spec(num_layers=2)
    mesh_info = build_mesh(MeshConfig(fsdp=2, tensor=2, context=2))
    jopt, _ = j_make_optimizer(JSGDConfig(lr=0.5), jcfg.scheduler, 1.0)
    jbase = jstep.init_base_params(jspec, mesh_info, seed=0, dtype=jnp.float32)
    jts = jstep.make_train_step(jspec, jcfg.model, jcfg.loss, jopt, mesh_info, base_params=jbase)
    jmgr = JMultiRunManager(tmp_path / "j", jspec, jcfg.model.lora, mesh_info, jopt)
    jrun = jmgr.get_or_create("run_0")

    cfg, opt = _cfg(SGDConfig(lr=0.5))
    base = params_from_jax(jax.tree.map(np.asarray, jbase), spec)
    ts = make_train_step(spec, cfg.model, cfg.loss, opt, "cpu", base_params=base)
    mgr = MultiRunManager(tmp_path / "t", spec, cfg.model.lora, "cpu", opt)
    run = mgr.get_or_create("run_0")
    start = tlora.lora_from_jax(jax.tree.map(np.asarray, jrun.state.params))
    run.state = run.state._replace(params=start, opt_state=opt.init(start))

    loader = JFakeDataLoader(jspec.vocab_size, 128, 2, 2, seed=11)
    for _ in range(2):
        batch, counts = loader.next_batch()
        scales = (float(max(counts["rl"], 1)), 1.0, 1.0)
        jb = jstep.put_batch(jax.tree.map(jnp.asarray, batch), mesh_info)
        jrun.state, _ = jts(jrun.state, jb, jstep.Scales(*map(jnp.float32, scales)))
        run.state, _ = ts(run.state, batch, Scales(*scales))
    want = jax.tree.map(np.asarray, jrun.state.params)["layers"]
    assert float(np.abs(want["q_b"]).sum()) > 0
    for k, v in run.state.params["layers"].items():
        np.testing.assert_allclose(v.numpy(), want[k], atol=1e-5, rtol=1e-5, err_msg=k)

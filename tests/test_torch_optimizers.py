"""The port's ``adafactor_mom`` and ``muon`` on the CPU: Adafactor against the
JAX package's optax chain, Muon against optax's ``contrib.muon`` composed as
the JAX package composes it but with per-layer dimension numbers (the JAX
package's own Muon labels the leaves otherwise: pinned here, ROADMAP.md
Queue 3), and both updated a leaf at a time against the whole tree. Inputs
come from a numpy seed and go to both sides.

Tolerances: Adafactor's updates within 1e-6 + 1e-5 |ref| with f32 masters
(its means and powers are f32 reductions and ``pow`` calls that XLA and
PyTorch round differently in the last bit; with bf16 masters the test
states its own), its bf16 momentum as bits where both sides' f32 values
round alike; Muon's updates within 1e-5 + 1e-5 |ref| in f32 (Newton-
Schulz's products summed in another order); the leaf-at-a-time update equal
to the whole tree's bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from optax.contrib import MuonDimensionNumbers

from prime_rl_tpu.configs import TrainerConfig as JTrainerConfig
from prime_rl_tpu.models import qwen3 as jqwen3
from prime_rl_tpu.models.base import debug_spec as j_debug_spec
from prime_rl_tpu.trainer import optim as joptim
from prime_rl_tpu_torch.configs import TrainerConfig
from prime_rl_tpu_torch.models import qwen3 as tqwen3
from prime_rl_tpu_torch.models.base import debug_spec
from prime_rl_tpu_torch.trainer import optim as toptim
from prime_rl_tpu_torch.trainer import step as tstep

torch.set_num_threads(1)

ADAFACTOR = {"type": "adafactor_mom", "lr": 1e-2, "weight_decay": 0.01}
MUON = {"type": "muon", "lr": 2e-2, "adamw_lr": 1e-3, "weight_decay": 0.01, "momentum": 0.95}


def _np(t):
    return t.detach().float().numpy()


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    mag = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


def _adafactor_tree(rng, dtype=np.float32):
    """A factored stack (the two largest axes, the layer axis riding along),
    an equal-dims stack (the tie that ``np.argsort`` breaks), an unfactored
    norm stack (28 < 128 on Qwen3-0.6B, 2 here), a factored ``embed`` and a
    1-D leaf."""
    shapes = {"embed": (256, 128), "final_norm": (64,),
              "layers": {"gate": (2, 128, 160), "k": (2, 128, 128), "attn_norm": (2, 64)}}
    return jax.tree.map(lambda s: (rng.standard_normal(s) * 0.02).astype(dtype), shapes,
                        is_leaf=lambda x: isinstance(x, tuple))


def _state_of(state, cls_name):
    """The first optax state named ``cls_name`` in a nested state."""
    if type(state).__name__ == cls_name:
        return state
    if isinstance(state, (tuple, list)):
        for s in state:
            found = _state_of(s, cls_name)
            if found is not None:
                return found
    if hasattr(state, "inner_state"):
        return _state_of(state.inner_state, cls_name)
    return None


def _to_torch(tree, dtype=None):
    return jax.tree.map(lambda x: torch.from_numpy(np.array(x, np.float32)).to(dtype)
                        if dtype is not None else torch.from_numpy(np.array(x)), tree)


@pytest.mark.parametrize("master", ["float32", "bfloat16"])
def test_adafactor_matches_jax_for_three_steps(master):
    """Three updates of the port's ``adafactor_mom`` against the JAX
    package's ``make_optimizer(AdafactorMomConfig(weight_decay=0.01))`` (grad
    clip 1.0, lr 1e-2) on the same parameters and gradients.

    f32 masters: the updates within 1e-6 + 1e-5 |ref|, the statistics within
    1e-5 |ref|. bf16 masters keep the statistics in bf16 (optax keeps them in
    the parameters' dtype) and take the row and column factors in bf16: the
    statistics within one bf16 ulp and the updates within 1e-6 + 2^-6 |ref|
    (either factor may round the other way, by up to 2^-7 of itself).

    Either way the bf16 momentum is each side's f32 momentum rounded to
    nearest, and JAX's bit for bit on all but at most 1e-3 of a tensor's
    elements: those whose f32 values, within the updates' tolerance of each
    other, round apart (at a midpoint, or a momentum near zero where its two
    terms cancel). Each update after the first starts from JAX's state
    (``test_optimizers_match_jax_from_a_carried_state``'s way): a value
    rounded the other way differs by up to 2^-7 of itself, and would carry
    that into the next update."""
    rng = np.random.default_rng(0)
    np_params = _adafactor_tree(rng)
    bf16 = master == "bfloat16"
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32, torch.float32)
    upd_rtol = 2.0 ** -6 if bf16 else 1e-5
    j_params = jax.tree.map(lambda x: jnp.asarray(x, jdt), np_params)
    t_params = _to_torch(np_params, tdt)
    jcfg, tcfg = JTrainerConfig(optimizer=ADAFACTOR), TrainerConfig(optimizer=ADAFACTOR)
    j_opt, _ = joptim.make_optimizer(jcfg.optimizer, jcfg.scheduler, 1.0)
    t_opt, _ = toptim.make_optimizer(tcfg.optimizer, tcfg.scheduler, 1.0)
    j_state, t_state = j_opt.init(j_params), t_opt.init(t_params)
    wd_p = [np.asarray(jnp.asarray(0.01, jdt) * p, np.float64)  # in the masters' dtype
            for p in jax.tree.leaves(j_params)]
    for step in range(3):
        grads = jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(np.float32),
                             np_params)
        j_upd, j_state = j_opt.update(jax.tree.map(jnp.asarray, grads), j_state, j_params)
        t_upd, t_state = t_opt.update(_to_torch(grads), t_state, t_params)
        for (path, got), want in zip(toptim.tree_paths(t_upd), jax.tree.leaves(j_upd)):
            assert got.dtype == torch.float32
            np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), rtol=upd_rtol,
                                       atol=1e-6, err_msg=f"step {step} {path}")
        j_fac = _state_of(j_state, "FactoredState")
        t_fac = next(st for st in t_state if "v_row" in st)
        assert t_fac["count"] == int(j_fac.count) == step + 1
        for key in ("v_row", "v_col", "v"):
            for (path, got), want in zip(toptim.tree_paths(t_fac[key]),
                                         jax.tree.leaves(getattr(j_fac, key))):
                assert tuple(got.shape) == want.shape and got.dtype == tdt, (key, path)
                got, want = _np(got), np.asarray(want, np.float32)
                if bf16:
                    assert (np.abs(got - want) <= _bf16_ulp(want)).all(), (key, path)
                else:
                    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-30,
                                               err_msg=f"{key} {path}")
        j_ema = _state_of(j_state, "EmaState").ema
        t_ema = next(st for st in t_state if "ema" in st)["ema"]
        for (path, got), want, t_u, j_u, d in zip(
                toptim.tree_paths(t_ema), jax.tree.leaves(j_ema), toptim.tree_leaves(t_upd),
                jax.tree.leaves(j_upd), wd_p):
            assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
            got, want = _np(got), np.asarray(want, np.float32)
            # the f32 values each side rounded: the update is -(ema + wd * p)
            pre_t = -_np(t_u).astype(np.float64) - d
            pre_j = -np.asarray(j_u, np.float64) - d
            slack = np.spacing(np.abs(np.asarray(j_u, np.float32)))  # undoing the sum
            for mom, pre in ((got, pre_t), (want, pre_j)):
                assert (np.abs(mom - pre) <= _bf16_ulp(mom) / 2 + slack).all(), path
            differ = got != want
            assert differ.mean() <= 1e-3, f"step {step} {path}: {differ.sum()} differ"
        # the next update from JAX's state
        for st in t_state:
            if "count" in st:
                st["count"] = step + 1
            for key in ("v_row", "v_col", "v"):
                if key in st:
                    st[key] = _to_torch(getattr(j_fac, key), tdt)
            if "ema" in st:
                st["ema"] = _to_torch(j_ema, torch.bfloat16)


def _muon_reference(spec_params, cfg):
    """optax's own Muon, composed as the JAX package composes it (global-norm
    clip, then ``multi_transform`` of ``contrib.muon`` and ``adamw`` at
    ``adamw_lr``) but labelled by the port's rule, with dimension numbers
    (-2, -1) for every hidden matrix: Newton-Schulz per layer."""
    hidden = {path: toptim.is_hidden_matrix(path, torch.empty(leaf.shape))
              for path, leaf in toptim.tree_paths(spec_params)}

    def labels(params):
        return jax.tree_util.tree_map_with_path(
            lambda path, leaf: "muon" if hidden[_path(path)] else "adamw", params)

    def dim_nums(params):
        return jax.tree.map(lambda leaf: MuonDimensionNumbers(-2, -1), params)

    schedule = joptim.make_schedule(cfg.scheduler, cfg.optimizer.lr)
    adamw_schedule = joptim.make_schedule(cfg.scheduler, cfg.optimizer.adamw_lr)
    muon = optax.contrib.muon(schedule, beta=cfg.optimizer.momentum,
                              weight_decay=cfg.optimizer.weight_decay,
                              muon_weight_dimension_numbers=dim_nums)
    adamw = optax.adamw(adamw_schedule, weight_decay=cfg.optimizer.weight_decay)
    return optax.chain(optax.clip_by_global_norm(1.0),
                       optax.multi_transform({"muon": muon, "adamw": adamw}, labels)), hidden


def _path(jax_path) -> str:
    return "/".join(str(getattr(k, "key", k)) for k in jax_path)


def test_muon_matches_optax_with_per_layer_dimension_numbers():
    """Three updates of the port's Muon against ``_muon_reference`` on the
    debug Qwen3 tree, f32, grad clip 1.0: every update within 1e-5 + 1e-5
    |ref|. The port sends the seven projection stacks to Newton-Schulz and
    the embeddings, norms and the LM head's absence of them to AdamW."""
    jspec = j_debug_spec()
    np_params = jax.tree.map(np.asarray, jqwen3.init_params(jspec, jax.random.key(0)))
    cfg = JTrainerConfig(optimizer=MUON)
    ref, hidden = _muon_reference(np_params, cfg)
    assert sorted(p for p, h in hidden.items() if h) == [
        f"layers/{n}" for n in ("down", "gate", "k", "o", "q", "up", "v")]
    tcfg = TrainerConfig(optimizer=MUON)
    t_opt, _ = toptim.make_optimizer(tcfg.optimizer, tcfg.scheduler, 1.0)
    t_params = tqwen3.params_from_jax(np_params, debug_spec())
    j_params = jax.tree.map(jnp.asarray, np_params)
    j_state, t_state = ref.init(j_params), t_opt.init(t_params)
    rng = np.random.default_rng(3)
    for step in range(3):
        grads = jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(np.float32) * 0.1,
                             np_params)
        j_upd, j_state = ref.update(jax.tree.map(jnp.asarray, grads), j_state, j_params)
        t_upd, t_state = t_opt.update(_to_torch(grads), t_state, t_params)
        for (path, got), want in zip(toptim.tree_paths(t_upd), jax.tree.leaves(j_upd)):
            np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5, atol=1e-5,
                                       err_msg=f"step {step} {path}")
        # a step on both sides' parameters, so that the decay sees new weights
        j_params = jax.tree.map(lambda p, u: p + u, j_params, j_upd)
        t_params = toptim.tree_map(lambda p, u: p + u, t_params, t_upd)
    assert t_state[-1]["count"] == 3


def test_jax_muon_labels_stacked_leaves_the_other_way():
    """The JAX package's ``make_optimizer(MuonConfig())`` on the debug Qwen3
    tree: optax applies Newton-Schulz only to leaves that are exactly 2-D,
    so the stacked norms ``[NL, d]`` are orthogonalized and the projection
    stacks ``[NL, in, out]`` go to the Adam that ``contrib.muon`` keeps
    inside itself (Nesterov, at Muon's lr, no weight decay). The port does
    not carry this (``test_muon_matches_optax_with_per_layer_dimension_numbers``;
    ROADMAP.md Queue 3)."""
    params = jqwen3.init_params(j_debug_spec(), jax.random.key(0))
    opt, _ = joptim.make_optimizer(JTrainerConfig(optimizer={"type": "muon"}).optimizer,
                                   JTrainerConfig().scheduler, 1.0)
    state = opt.init(params)
    outer = state[1].inner_states
    inner = outer["muon"].inner_state.inner_states
    inner_adam = _state_of(inner["adam"], "ScaleByAdamState")
    muon = _state_of(inner["muon"], "MuonState")
    outer_adamw = _state_of(outer["adamw"], "ScaleByAdamState")

    def real(tree):
        """The paths of the leaves a state tree holds moments for."""
        flat, _ = jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, optax.MaskedNode))
        return {_path(p) for p, leaf in flat if not isinstance(leaf, optax.MaskedNode)}

    assert real(inner_adam.mu) == {f"layers/{n}" for n in
                                   ("down", "gate", "k", "o", "q", "up", "v")}
    assert real(muon.mu) == {f"layers/{n}" for n in
                             ("attn_norm", "k_norm", "mlp_norm", "q_norm")}
    assert real(outer_adamw.mu) == {"embed", "final_norm"}
    # the port: the projection stacks to Newton-Schulz, the rest to AdamW
    t_params = tqwen3.init_params(debug_spec(), torch.Generator().manual_seed(0))
    assert {p for p, leaf in toptim.tree_paths(t_params)
            if toptim.is_hidden_matrix(p, leaf)} == real(inner_adam.mu)


def _state_tensors(tree) -> list[torch.Tensor]:
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _state_tensors(tree[k])]
    if isinstance(tree, list):
        return [t for x in tree for t in _state_tensors(x)]
    return [tree] if isinstance(tree, torch.Tensor) else []


@pytest.mark.parametrize("flags", [(False, False), (True, False), (False, True), (True, True)],
                         ids=["plain", "offload_optimizer", "offload_params", "both"])
@pytest.mark.parametrize("opt", ["muon", "adafactor_mom"])
def test_leaf_at_a_time_update_equals_the_whole_tree(opt, flags):
    """Two updates of the debug Qwen3 tree: the step's streamed update (one
    parameter leaf at a time, given the whole tree's gradient norm; the host
    tier under the flags) against ``optimizer.update`` on the whole tree, bit
    for bit: the parameters and every state tensor (Muon's momentum and
    moments, Adafactor's row, column and full statistics and its bf16
    momentum) and the counts."""
    offload_optimizer, offload_params = flags
    spec = debug_spec()
    cfg = TrainerConfig(optimizer=ADAFACTOR if opt == "adafactor_mom" else MUON)
    t_opt, _ = toptim.make_optimizer(cfg.optimizer, cfg.scheduler, 1.0)
    whole = tstep.init_train_state(spec, "cpu", t_opt, seed=2)
    streamed = tstep.init_train_state(spec, "cpu", t_opt, seed=2,
                                      offload_optimizer=offload_optimizer,
                                      offload_params=offload_params)
    rng = np.random.default_rng(5)
    for _ in range(2):
        grads = toptim.tree_map(lambda p: torch.from_numpy(
            rng.standard_normal(tuple(p.shape)).astype(np.float32)), whole.params)
        upd, new_opt = t_opt.update(grads, whole.opt_state, whole.params)
        whole = tstep.TrainState(toptim.tree_map(lambda p, u: p + u, whole.params, upd),
                                 new_opt, whole.step + 1)
        streamed, _ = tstep._streamed_update(streamed, grads, t_opt, torch.device("cpu"),
                                             offload_optimizer, offload_params)
    for a, b in zip(toptim.tree_leaves(streamed.params), toptim.tree_leaves(whole.params)):
        assert torch.equal(a, b)
    got, want = _state_tensors(streamed.opt_state), _state_tensors(whole.opt_state)
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    counts = [st["count"] for st in streamed.opt_state if "count" in st]
    assert counts and counts == [st["count"] for st in whole.opt_state if "count" in st]
    assert all(c == 2 for c in counts)

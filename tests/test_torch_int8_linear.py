"""The int8-compute product (``ops/int8_linear.py``) and the dense forward
and train step with ``quantized_compute = "int8"`` on the CPU against the
JAX package. Inputs come from a numpy seed and go to both packages.

Tolerances: the codes and scales of both operands equal; the product's
output within one bf16 ulp of JAX's (bf16 operands, the product's one
rounding); the straight-through backward within 1e-2 + 1e-2 |ref| (bf16
products summed in another order); the int32 accumulator exact. The debug
model: the hidden states at the forward parity's 2e-5 and the train step's
loss, grad_norm and updated parameters at the train parity's rtol 1e-4 and
atol 2e-5 (``tests/test_torch_train_ops.py``, ``tests/test_torch_trainer.py``;
the parameters where the gradient's sign is sure: the train step's test).
The whole-model gradients cannot meet the f32 gradients' 1e-4 element by
element: the backward's bf16 products round once each, and a sum in another
order moves some of those roundings by one bf16 ulp (2^-8 relative), which
then flows on through the layers. They are held per tensor to 1e-3 of the
tensor's norm (the measured worst is 1.4e-4, against 1.1e-2 between JAX's
int8 and float32 gradients) and element by element to the op's 1e-2 + 1e-2
|ref|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prime_rl_tpu.configs import TrainerConfig as JTrainerConfig
from prime_rl_tpu.configs.shared import MeshConfig as JMeshConfig
from prime_rl_tpu.models import qwen3 as jqwen3
from prime_rl_tpu.models.base import debug_spec as j_debug_spec
from prime_rl_tpu.ops import int8_linear as jint8
from prime_rl_tpu.parallel.mesh import build_mesh
from prime_rl_tpu.trainer import optim as joptim
from prime_rl_tpu.trainer import step as jstep
from prime_rl_tpu_torch.configs import TrainerConfig
from prime_rl_tpu_torch.models import get_family
from prime_rl_tpu_torch.models import qwen3 as tqwen3
from prime_rl_tpu_torch.models.base import debug_spec
from prime_rl_tpu_torch.ops import _build
from prime_rl_tpu_torch.ops import attention as tattn
from prime_rl_tpu_torch.ops import int8_linear as tint8
from prime_rl_tpu_torch.trainer import optim as toptim
from prime_rl_tpu_torch.trainer import step as tstep
from prime_rl_tpu_torch.trainer.rl.data import FakeDataLoader

torch.set_num_threads(1)


def _np(t):
    return t.detach().float().numpy()


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """The spacing of bf16 numbers at |x| (8 significant bits)."""
    mag = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


def _operands(seed, lead, k, n):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((*lead, k)).astype(np.float32)
    x[..., :3] *= 8.0  # a few outliers set each row's scale
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    # bf16-representable, as the trainer's activations and weights are
    return (np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32)),
            np.array(jnp.asarray(w, jnp.bfloat16).astype(jnp.float32)))


@pytest.mark.parametrize("lead,k,n", [((2, 24), 64, 40), ((2, 5), 64, 24), ((1, 7), 3072, 16),
                                      ((3, 16), 3072, 48)],
                         ids=["M48 K64", "M10 K64 (padded)", "M7 K3072 (padded)", "M48 K3072"])
def test_codes_scales_and_output_match_jax(lead, k, n):
    """Both operands' int8 codes and f32 scales bit for bit; the int32
    accumulator equal to the codes' exact integer product; the bf16 output
    within one bf16 ulp of JAX's ``int8_matmul``."""
    x, w = _operands(0, lead, k, n)
    jxq, jxs = jint8._quant_rows(jnp.asarray(x))
    jwq, jws = jint8._quant_cols(jnp.asarray(w))
    txq, txs = tint8.quant_rows(torch.from_numpy(x))
    twq, tws = tint8.quant_cols(torch.from_numpy(w))
    for got, want in ((txq, jxq), (txs, jxs), (twq, jwq), (tws, jws)):
        assert got.dtype == {jnp.int8: torch.int8, jnp.float32: torch.float32}[want.dtype.type]
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    acc = tint8.int_mm(txq.reshape(-1, k), twq)
    assert acc.dtype == torch.int32
    exact = np.asarray(jxq, np.int64).reshape(-1, k) @ np.asarray(jwq, np.int64)
    np.testing.assert_array_equal(acc.numpy(), exact)

    want = np.asarray(jint8.int8_matmul(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16))
                      .astype(jnp.float32))
    got = tint8.int8_matmul(torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16())
    assert got.dtype == torch.bfloat16 and got.shape == (*lead, n)
    assert (np.abs(_np(got) - want) <= _bf16_ulp(want)).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_is_the_bf16_straight_through_of_jax(dtype):
    """gx and gw against ``jax.vjp`` of JAX's ``int8_matmul`` for one
    cotangent, within 1e-2 + 1e-2 |ref|, in the operands' dtype."""
    x, w = _operands(1, (2, 9), 96, 40)
    g = np.random.default_rng(2).standard_normal((2, 9, 40)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    _, vjp = jax.vjp(jint8.int8_matmul, jnp.asarray(x, jdt), jnp.asarray(w, jdt))
    jgx, jgw = vjp(jnp.asarray(g, jdt))
    tx = torch.from_numpy(x).to(dtype).requires_grad_()
    tw = torch.from_numpy(w).to(dtype).requires_grad_()
    tint8.int8_matmul(tx, tw).backward(torch.from_numpy(g).to(dtype))
    assert tx.grad.dtype == tw.grad.dtype == dtype
    for got, want in ((tx.grad, jgx), (tw.grad, jgw)):
        want = np.asarray(want.astype(jnp.float32))
        np.testing.assert_allclose(_np(got), want, rtol=1e-2, atol=1e-2)


def test_int32_accumulation_is_exact_at_k3072():
    """Every code ±127 over K = 3072 (Qwen3-0.6B's down projection): |acc| =
    127² x 3072 = 49,549,312, past float32's 2^24, exact in int32; the
    output equals x @ w (JAX's ``test_forward_int32_accumulation_no_overflow``
    at this K)."""
    k = 3072
    x = torch.full((4, k), 3.0)
    w = torch.full((k, 8), -2.0)
    w[:, 1::2] = 2.0
    xq, _ = tint8.quant_rows(x)
    wq, _ = tint8.quant_cols(w)
    acc = tint8.int_mm(xq, wq)
    assert int(acc.abs().max()) == 127 * 127 * k == int(acc.abs().min())
    assert acc[0, 0].item() == -127 * 127 * k
    np.testing.assert_allclose(_np(tint8.int8_matmul(x, w)), _np(x @ w), rtol=1e-6)
    want = jint8.int8_matmul(jnp.asarray(x.numpy()), jnp.asarray(w.numpy()))
    np.testing.assert_array_equal(_np(tint8.int8_matmul(x, w)), np.asarray(want))


@pytest.mark.parametrize("m,k,n", [(1, 64, 16), (16, 64, 16), (17, 60, 20), (5, 7, 3),
                                   (40, 3072, 1024)])
def test_int_mm_pads_to_what_the_card_takes_and_stays_exact(m, k, n, monkeypatch):
    """``int_mm`` hands ``torch._int_mm`` M padded up to 17 and no further,
    and K, N padded to multiples of 8 (the card's limits: M > 16, K and N
    multiples of 8), the weight column-major, and returns the exact
    [M, N] product of the unpadded codes; it never falls back to a float
    product."""
    seen = []
    real = torch._int_mm

    def spy(a, b):
        seen.append((tuple(a.shape), tuple(b.shape), b.t().is_contiguous()))
        return real(a, b)

    monkeypatch.setattr(torch, "_int_mm", spy)
    monkeypatch.setattr(torch, "matmul", None)  # no float product on this path
    rng = np.random.default_rng(m * k + n)
    a = torch.from_numpy(rng.integers(-127, 128, (m, k)).astype(np.int8))
    b = torch.from_numpy(rng.integers(-127, 128, (k, n)).astype(np.int8))
    before = _build.launches[tint8.COUNT]
    out = tint8.int_mm(a, b)
    assert _build.launches[tint8.COUNT] == before + 1
    assert out.shape == (m, n) and out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), a.numpy().astype(np.int64) @ b.numpy())
    (sa, sb, col_major), = seen
    assert sa[0] == max(m, 17) and sa[1] % 8 == 0 and sb[0] == sa[1] and sb[1] % 8 == 0
    assert col_major


# ---------------------------------------------------------------------------
# the dense family with quantized_compute = "int8"
# ---------------------------------------------------------------------------

def _model_inputs(rng, spec, b=2, l=64):
    ids = rng.integers(0, spec.vocab_size, (b, l)).astype(np.int32)
    seg = np.stack([tattn.make_segment_ids([30, 20], l), tattn.make_segment_ids([64], l)])
    pos = np.stack([tattn.make_position_ids([30, 20], l), tattn.make_position_ids([64], l)])
    return ids, seg.astype(np.int32), pos.astype(np.int32)


def _grads(np_params, spec, inputs, ct, **kw):
    params = tqwen3.params_from_jax(np_params, spec)
    leaves = dict(toptim.tree_paths(params))
    for t in leaves.values():
        t.requires_grad_()
    out = tqwen3.forward(params, spec, *inputs, compute_dtype=torch.float32,
                         quantized_compute="int8", **kw)
    (out * ct).sum().backward()
    return out.detach(), {p: t.grad for p, t in leaves.items()}


def test_forward_and_gradients_match_jax_and_every_remat_mode():
    """The 2-layer debug model in f32 with int8 MLP products: the hidden
    states against JAX's ``forward(..., quantized_compute="int8")`` (atol =
    rtol = 2e-5 on rows that are not padding), the gradients against
    ``jax.grad`` (1e-3 of each tensor's norm, and 1e-2 + 1e-2 |ref| element
    by element: the module's notes), bit-equal under every remat mode (the
    ``_int_mm`` products are recomputed, never kept), and three int8
    products a layer and forward pass."""
    rng = np.random.default_rng(11)
    jspec, spec = j_debug_spec(), debug_spec()
    jparams = jqwen3.init_params(jspec, jax.random.key(0))
    np_params = jax.tree.map(np.asarray, jparams)
    ids, seg, pos = _model_inputs(rng, spec)
    inputs = tuple(map(torch.from_numpy, (ids, seg, pos)))
    valid = seg != 0
    ct = rng.standard_normal((2, 64, spec.hidden_size)).astype(np.float32) * valid[..., None]

    def j_out(p):
        return jqwen3.forward(p, jspec, jnp.asarray(ids), jnp.asarray(seg), jnp.asarray(pos),
                              compute_dtype=jnp.float32, attn_impl="xla", remat="none",
                              quantized_compute="int8")

    want = np.asarray(j_out(jparams))
    want_g = jax.grad(lambda p: jnp.sum(j_out(p) * ct))(jparams)
    flat_want = {**{k: v for k, v in want_g.items() if k != "layers"},
                 **{f"layers/{k}": v for k, v in want_g["layers"].items()}}

    grads = {}
    for mode in ("none", "full", "save_attn", "offload_attn", "selective", "offload_dots",
                 "selective/2"):
        _build.reset_launches()
        out, grads[mode] = _grads(np_params, spec, inputs, torch.from_numpy(ct), remat=mode)
        recomputed = {"none": 0, "save_attn": 1, "offload_attn": 1}.get(mode, 1)
        if mode == "none":
            np.testing.assert_allclose(_np(out)[valid], want[valid], rtol=2e-5, atol=2e-5)
        assert _build.launches[tint8.COUNT] == 3 * spec.num_layers * (1 + recomputed), mode
    for mode, g in grads.items():
        for path, t in grads["none"].items():
            assert torch.equal(t, g[path]), (mode, path)
    for path, t in grads["none"].items():
        want_t = np.asarray(flat_want[path])
        assert np.linalg.norm(_np(t) - want_t) <= 1e-3 * np.linalg.norm(want_t), path
        np.testing.assert_allclose(_np(t), want_t, rtol=1e-2, atol=1e-2, err_msg=path)


def test_lora_runs_the_plain_products_and_other_families_refuse():
    """With an adapter the MLP runs the plain products, as JAX's
    ``_mlp_block`` does (the same hidden states as without int8); the
    families without the int8 wiring raise JAX's ValueError."""
    from prime_rl_tpu_torch.configs.shared import LoRAConfig
    from prime_rl_tpu_torch.models.lora import init_lora

    spec = debug_spec()
    params = tqwen3.init_params(spec, torch.Generator().manual_seed(0))
    ids = torch.zeros(1, 8, dtype=torch.int64)
    seg = torch.ones(1, 8, dtype=torch.int32)
    lora = init_lora(spec, LoRAConfig(rank=2), torch.Generator().manual_seed(1))
    _build.reset_launches()
    with_int8 = tqwen3.forward(params, spec, ids, seg, ids, lora=lora, quantized_compute="int8")
    assert _build.launches[tint8.COUNT] == 0
    assert torch.equal(with_int8, tqwen3.forward(params, spec, ids, seg, ids, lora=lora))
    assert not torch.equal(with_int8, tqwen3.forward(params, spec, ids, seg, ids,
                                                     quantized_compute="int8"))
    assert _build.launches[tint8.COUNT] == 3 * spec.num_layers
    for family in ("qwen3_moe", "gpt_oss"):
        other = debug_spec(family=family) if family != "qwen3_moe" else None
        if other is None:
            from prime_rl_tpu_torch.models.base import get_spec

            other = get_spec("debug_moe")
        p = get_family(other).init(other, torch.Generator().manual_seed(0))
        with pytest.raises(ValueError, match="only wired for the qwen3/llama dense"):
            get_family(other).forward(p, other, ids, seg, ids, quantized_compute="int8")


def _step_cfg(cls):
    return cls(model={"attn": {"impl": "xla"}, "compute_dtype": "float32",
                      "lm_head_chunk_size": 48, "quantized_compute": "int8"},
               optimizer={"type": "adamw", "lr": 1e-3, "weight_decay": 0.1})


def test_train_step_with_int8_matches_jax_step_one():
    """One fake batch through both packages' RL train step with int8 MLP
    products: the loss and grad_norm at the train parity's rtol 1e-4; the
    step's gradients (the port's ``accum_grads`` against ``jax.grad`` of
    JAX's loss summed over the micro-batches) at the module's bf16
    tolerances; the parameters after the adamw update at the train parity's
    atol 2e-5 wherever JAX's gradient lies outside the gradient tolerance
    around zero. Adam's first update is lr * g / (|g| + eps), so inside that
    band the sign the bf16 backward rounds to decides the step: there, within
    2 lr + 2e-5."""
    jspec, spec = j_debug_spec(), debug_spec()
    j_cfg, t_cfg = _step_cfg(JTrainerConfig), _step_cfg(TrainerConfig)
    np_params = jax.tree.map(np.asarray, jqwen3.init_params(jspec, jax.random.key(0)))
    batch, counts = FakeDataLoader(spec.vocab_size, 64, 2, 2, seed=0).next_batch()
    scale = float(counts["rl"])
    j_scales = jstep.Scales(jnp.float32(scale), jnp.float32(1.0), jnp.float32(1.0))

    j_opt, _ = joptim.make_optimizer(j_cfg.optimizer, j_cfg.scheduler, 1.0)
    mesh_info = build_mesh(JMeshConfig(fsdp=-1))
    j_state = jstep.init_train_state(jspec, mesh_info, j_opt,
                                     params=jax.tree.map(jnp.asarray, np_params))
    j_step = jstep.make_train_step(jspec, j_cfg.model, j_cfg.loss, j_opt, mesh_info)
    j_batch = jstep.MicroBatchArrays(*[None if x is None else jnp.asarray(x) for x in batch])
    j_state, j_metrics = j_step(j_state, j_batch, j_scales)
    j_loss = jstep.make_loss_fn(jspec, j_cfg.model, j_cfg.loss)
    j_grad = jax.jit(jax.grad(lambda p, mb: j_loss(p, mb, j_scales)[0]))
    j_grads = [jax.tree.map(np.asarray, j_grad(jax.tree.map(jnp.asarray, np_params),
                                               jax.tree.map(lambda x: x[i], j_batch)))
               for i in range(batch.input_ids.shape[0])]
    j_grads = jax.tree.map(lambda *g: sum(g), *j_grads)

    t_opt, _ = toptim.make_optimizer(t_cfg.optimizer, t_cfg.scheduler, 1.0)
    p0 = tqwen3.params_from_jax(np_params, spec)
    t_state = tstep.init_train_state(spec, "cpu", t_opt, params=p0)
    t_step = tstep.make_train_step(spec, t_cfg.model, t_cfg.loss, t_opt, "cpu")
    _build.reset_launches()
    t_state, t_metrics = t_step(t_state, batch, tstep.Scales(scale, 1.0, 1.0))
    # full remat (the default): each product runs again in the backward
    assert _build.launches[tint8.COUNT] == 3 * spec.num_layers * 2 * batch.input_ids.shape[0]
    for name in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(t_metrics[name]), float(j_metrics[name]), rtol=1e-4)
    t_grads, _, _ = t_step.accum_grads(p0, tstep.put_batch(batch, "cpu"),
                                       tstep.Scales(scale, 1.0, 1.0))
    lr = t_cfg.optimizer.lr
    for (path, t), j, g, jg, before in zip(
            toptim.tree_paths(t_state.params), jax.tree.leaves(j_state.params),
            toptim.tree_leaves(t_grads), jax.tree.leaves(j_grads), toptim.tree_leaves(p0)):
        assert np.linalg.norm(_np(g) - jg) <= 1e-3 * np.linalg.norm(jg), path
        np.testing.assert_allclose(_np(g), jg, rtol=1e-2, atol=1e-2, err_msg=path)
        diff = np.abs(_np(t) - np.asarray(j))
        outside = np.abs(jg) > 1e-2 / (1 - 1e-2)  # |g| > atol + rtol |g|: its sign is sure
        assert diff[outside].max(initial=0) <= 2e-5 and diff.max() <= 2 * lr + 2e-5, path
        assert not np.array_equal(_np(t), _np(before)), path

"""The remat modes of every family on the CPU, against the JAX package.

For each family, every ``ac.mode`` its JAX function names (and one it does
not, which both packages run as no remat): the port's gradients of
sum(hidden * ct) equal its own ``none`` ones bit for bit and JAX's under the
same mode within the family tests' tolerance (atol = rtol = 2e-4; on the
MLA family 4e-3 of each leaf's largest gradient, rtol 4e-3, the tolerance
of its gradient test in tests/test_torch_mla_moe.py; the JAX
side runs its XLA attention, the port the kernels' plain versions, and on
the MLA family its chunked-gather op, which JAX's XLA route is, as the
kernel route stays within 2e-2 of it in tests/test_torch_mla_moe.py); the
attention (K1's plain version, the MLA family's gather op) runs once a layer
under ``none``, ``save_attn`` and ``offload_attn`` and twice under ``full``,
``selective`` and ``offload_dots``, as the JAX policies recompute a Pallas
call; and no product with no batch dims (``aten.mm``, ``aten.addmm``) runs
in the backward's recomputation under ``selective`` and ``offload_dots``,
where ``full`` runs them all again. Small specs, inputs from a numpy seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from prime_rl_tpu.models import get_family as j_get_family
from prime_rl_tpu.models.base import ModelSpec as JModelSpec
from prime_rl_tpu.models.base import get_spec as j_get_spec
from prime_rl_tpu_torch.models import get_family
from prime_rl_tpu_torch.models import mla_moe as tmla
from prime_rl_tpu_torch.models import qwen3 as tqwen3
from prime_rl_tpu_torch.models.base import ModelSpec, get_spec
from prime_rl_tpu_torch.ops import flash_attention as tflash
from prime_rl_tpu_torch.ops import remat as tremat
from prime_rl_tpu_torch.ops import sparse_mla as tsparse
from prime_rl_tpu_torch.trainer import optim as toptim

jax.config.update("jax_platforms", "cpu")
torch.set_num_threads(1)

TOL = dict(atol=2e-4, rtol=2e-4)
GPT_OSS = dict(
    family="gpt_oss", vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
    num_kv_heads=2, head_dim=16, intermediate_size=48, rope_theta=150000.0, rms_eps=1e-5,
    tie_embeddings=False, qk_norm=False, max_position_embeddings=512, eos_token_id=255,
    pad_token_id=0, num_experts=4, num_experts_per_tok=2, moe_intermediate_size=48,
    sliding_window=8, sliding_window_pattern=2, attn_sinks=True, attn_bias=True,
    swiglu_alpha=1.702, swiglu_limit=7.0, expert_bias=True, router_bias=True,
    router_softmax_topk=True)
DSA = dict(
    family="glm_moe_dsa", vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
    num_kv_heads=4, head_dim=32, intermediate_size=128, moe_intermediate_size=48,
    num_experts=8, num_experts_per_tok=2, n_shared_experts=1, first_k_dense_replace=1,
    router_sigmoid=True, routed_scaling_factor=1.0, q_lora_rank=48, kv_lora_rank=32,
    qk_rope_head_dim=8, qk_nope_head_dim=24, v_head_dim=16, index_n_heads=4,
    index_head_dim=16, index_topk=16, rope_interleave=True, tie_embeddings=False,
    qk_norm=False, eos_token_id=255, pad_token_id=0)

# (case, the spec in both packages, the modes the JAX function names, one it
# does not, and what the plain kernel counter counts)
CASES = {
    "qwen3": ("debug", ("full", "save_attn", "offload_attn", "offload_dots", "selective",
                        "offload_attn/2", "offload_dots/2"), "k1"),
    "gpt_oss": (GPT_OSS, ("full", "save_attn", "offload_attn", "selective", "save_attn/2"),
                "k1"),
    "nemotron_h": ("debug_nemotron", ("full", "save_attn", "offload_attn", "selective",
                                      "offload_dots"), "k1"),
    "qwen3_next": ("debug_qwen3_next", ("full", "save_attn", "offload_attn", "selective",
                                        "offload_dots"), "k1"),
    "glm4_moe (minimax_m2)": ("debug_minimax", ("full", "save_attn", "selective",
                                                "offload_attn"), "k1"),
    "qwen3_moe": ("debug_moe", ("full", "selective", "save_attn"), "k1"),
    "mla_moe": (DSA, ("full", "selective", "save_attn"), "gather"),
    "qwen3_vl": ("debug_vlm", ("full", "selective", "offload_attn"), "k1"),
}
# the runs of the attention kernel a layer, by mode, as each family runs it
TWICE = {"full", "selective", "offload_dots"}


def _specs(which):
    if isinstance(which, dict):
        return JModelSpec(**which), ModelSpec(**which)
    return j_get_spec(which), get_spec(which)


def _mode_runs(spec_modes: dict | None, mode: str) -> str:
    """The mode a family runs for ``mode`` (its REMAT table, the dense
    family's with strides)."""
    return tqwen3.parse_remat(mode, 4, spec_modes)[0]


def _inputs(spec, rng):
    b, l = 2, 64
    ids = rng.integers(1, spec.vocab_size - 1, (b, l)).astype(np.int32)
    seg = np.zeros((b, l), np.int32)
    pos = np.zeros((b, l), np.int32)
    seg[0, :40], seg[0, 40:60] = 1, 2  # two sequences, then padding
    pos[0, :40], pos[0, 40:60] = np.arange(40), np.arange(20)
    seg[1, :] = 1
    pos[1, :] = np.arange(l)
    return ids, seg, pos


class _RecomputedDots(TorchDispatchMode):
    """Counts the products with no batch dims that run with gradients on
    while it is active: in a backward, those of the recomputation."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += tremat._is_dot(func)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("case", list(CASES))
def test_every_named_mode_matches_none_and_jax(case, monkeypatch):
    which, modes, kernel = CASES[case]
    jspec, spec = _specs(which)
    rng = np.random.default_rng(3)
    np_params = jax.tree.map(lambda x: np.asarray(x, np.float32),
                             j_get_family(jspec).init(jspec, jax.random.key(1)))
    convert = tmla.params_from_jax if spec.family in tmla.FAMILIES else tqwen3.params_from_jax
    ids, seg, pos = _inputs(spec, rng)
    ct = rng.standard_normal((*ids.shape, spec.hidden_size)).astype(np.float32)
    ct *= (seg > 0)[..., None]  # padding rows differ between the routes by construction
    family_modes = getattr(__import__(get_family(spec).forward.__module__,
                                      fromlist=["REMAT"]), "REMAT", None)

    calls = {"n": 0}
    if kernel == "k1":
        owner, name, impl = tflash, "flash_attention_reference", "pallas"
    else:
        owner, name, impl = tsparse, "sparse_mla_attention", "xla"
    plain = getattr(owner, name)

    def counting(*a, **k):
        calls["n"] += 1
        return plain(*a, **k)

    monkeypatch.setattr(owner, name, counting)

    def t_grads(mode):
        """(gradients, the kernel's runs in the forward, in the backward, the
        products with no batch dims recomputed in the backward)."""
        leaves = toptim.tree_map(lambda x: x.clone().requires_grad_(), convert(np_params, spec))
        calls["n"] = 0
        out = get_family(spec).forward(leaves, spec, *map(torch.from_numpy, (ids, seg, pos)),
                                       compute_dtype=torch.float32, attn_impl=impl,
                                       remat=mode)
        fwd_runs = calls["n"]
        counter = _RecomputedDots()
        with counter:
            (out * torch.from_numpy(ct)).sum().backward()
        # a leaf the hidden states do not reach (an untied head) gets zeros, as from jax.grad
        return ([torch.zeros_like(x) if x.grad is None else x.grad
                 for x in toptim.tree_leaves(leaves)], fwd_runs, calls["n"] - fwd_runs, counter.n)

    def j_grads(mode):
        def loss(p):
            out = j_get_family(jspec).forward(p, jspec, *map(jnp.asarray, (ids, seg, pos)),
                                              compute_dtype=jnp.float32, attn_impl="xla",
                                              remat=mode)
            return jnp.sum(out * ct)

        return jax.tree.leaves(jax.jit(jax.grad(loss))(jax.tree.map(jnp.asarray, np_params)))

    base, n_layers, again, dots = t_grads("none")
    assert n_layers > 0 and again == 0 and dots == 0
    for mode in modes:
        runs = _mode_runs(family_modes, mode)
        grads, fwd_runs, again, dots = t_grads(mode)
        for g, want in zip(grads, base):
            assert torch.equal(g, want), (case, mode)
        stride = int(mode.partition("/")[2] or 1) if runs != "none" else 1
        twice = n_layers if runs in TWICE else (n_layers - n_layers // stride
                                                if runs != "none" else 0)
        assert (fwd_runs, again) == (n_layers, twice), (case, mode, runs)
        if runs in ("selective", "offload_dots") and stride == 1:
            assert dots == 0, (case, mode, dots)
        elif runs != "none":  # the layers recomputed in full run their products again
            assert dots > 0, (case, mode)
        for g, j in zip(grads, j_grads(mode)):
            j = np.asarray(j)
            tol = TOL if kernel == "k1" else dict(atol=4e-3 * float(np.abs(j).max()), rtol=4e-3)
            np.testing.assert_allclose(g.numpy(), j, err_msg=f"{case} {mode}", **tol)


def test_unnamed_modes_run_as_no_remat_and_unknown_names_raise():
    """A mode the family's JAX function does not name, or any stride outside
    the dense family, runs as ``none`` (as the JAX functions fall through to
    the unwrapped block); a name no family knows raises."""
    from prime_rl_tpu_torch.models import qwen3_moe, qwen3_next

    assert tqwen3.parse_remat("save_attn", 2, qwen3_moe.REMAT) == ("none", 1)
    assert tqwen3.parse_remat("selective/2", 2, qwen3_moe.REMAT) == ("none", 1)
    assert tqwen3.parse_remat("offload_attn", 4, qwen3_next.REMAT) == ("save_attn", 1)
    assert tqwen3.parse_remat("offload_dots/2", 4) == ("offload_dots", 2)
    with pytest.raises(ValueError, match="unknown ac.mode"):
        tqwen3.parse_remat("offload_all", 4)
    with pytest.raises(ValueError, match="must divide"):
        tqwen3.parse_remat("selective/3", 4)


def test_offload_attn_keeps_its_outputs_in_the_host_tier_and_links_the_layers():
    """An ``offload_attn`` slot holds host-tier copies (``utils/offload.Stashed``)
    after the forward, gives them back once for the recompute and starts the
    previous layer's copy back; the port's chain runs newest layer first."""
    from prime_rl_tpu_torch.ops.flash_attention import AttnSaved
    from prime_rl_tpu_torch.utils.offload import Stashed

    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((1, 16, 2, 8)).astype(np.float32))
    seg = torch.ones(1, 16, dtype=torch.int32)
    first = AttnSaved(offload=True)
    import weakref

    second = AttnSaved(offload=True, prev=weakref.ref(first))
    for slot in (first, second):
        out = tflash.flash_attention(q, q, q, seg, saved=slot)
        assert isinstance(slot.out, Stashed) and torch.equal(slot.out.host, out)
    again = tflash.flash_attention(q, q, q, seg, saved=second)
    assert torch.equal(again, out) and second.out is None and first.out is not None


@pytest.mark.parametrize("mode", ["selective", "offload_dots"])
def test_kept_products_pair_with_their_places_and_lora_products_are_kept(mode):
    """The products a layer keeps, in order: the dense projections, LoRA's x·A
    and (x·A)·B among them, and the recompute hands each it reaches back in
    its place (the adapters' gradients equal ``none``'s bit for bit)."""
    from prime_rl_tpu_torch.configs.shared import LoRAConfig
    from prime_rl_tpu_torch.models.lora import init_lora

    spec = get_spec("debug")
    params = tqwen3.init_params(spec, torch.Generator().manual_seed(0))
    lora = init_lora(spec, LoRAConfig(rank=2), torch.Generator().manual_seed(1))
    lora = toptim.tree_map(lambda x: x + 0.01, lora)  # B != 0: the adapters count
    rng = np.random.default_rng(1)
    ids, seg, pos = map(torch.from_numpy, _inputs(spec, rng))
    ct = torch.from_numpy(rng.standard_normal((2, 64, spec.hidden_size)).astype(np.float32))
    kept = []
    real = tremat.DotsKept.contexts

    def spy(self):
        kept.append(self)
        return real(self)

    results = {}
    for m in ("none", mode):
        ad = toptim.tree_map(lambda x: x.clone().requires_grad_(), lora)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tremat.DotsKept, "contexts", spy)
            out = tqwen3.forward(params, spec, ids, seg, pos, compute_dtype=torch.float32,
                                 remat=m, lora=ad, lora_scale=2.0)
            (out * ct).sum().backward()
        results[m] = [x.grad for x in toptim.tree_leaves(ad)]
    for a, b in zip(results["none"], results[mode]):
        assert torch.equal(a, b)
    # a layer: q, k, v, o, gate, up, down and each target's x·A, (x·A)·B
    targets = len({k[:-2] for k in lora["layers"] if k.endswith("_a")})
    assert len(kept) == spec.num_layers
    assert all(len(k.kept) == 7 + 2 * targets for k in kept)
    # the recompute stops once the backward has what it saves (the checkpoint's
    # early stop): the products it reached went back in order and were let go
    assert all(0 < k.taken <= len(k.kept)
               and all(item[3] is None for item in k.kept[:k.taken]) for k in kept)
    assert all(item[0] in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
               for k in kept for item in k.kept)


@pytest.mark.parametrize("mode", ["selective", "offload_dots"])
def test_a_replay_that_strays_raises(mode):
    """A recomputation that asks for a product the forward did not keep in
    that place (another shape, or more products than were kept) raises
    instead of handing the kept tensor to the wrong place."""
    dots = tremat.DotsKept(offload=mode == "offload_dots")
    keep, replay = dots.contexts()
    a, w1, w2 = (torch.randn(4, 8, requires_grad=True), torch.randn(8, 3),
                 torch.randn(8, 5))
    with keep:
        first = a @ w1
    with replay:
        with pytest.raises(RuntimeError, match="remat replay 0"):
            a @ w2
    dots.taken = 0
    with replay:
        assert torch.equal(a @ w1, first)
        with pytest.raises(RuntimeError, match="remat replay 1"):
            a @ w1


def test_moe_expert_loop_is_recomputed_as_a_batched_product():
    """On the CPU the experts' grouped product is a loop of ``torch.mm``
    inside ``batched_products``: under ``selective`` those products are not
    kept (they carry the expert batch dim, as JAX's grouped product does),
    while the router's and the attention's projections are."""
    spec = get_spec("debug_moe")
    params = get_family(spec).init(spec, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(2)
    ids, seg, pos = map(torch.from_numpy, _inputs(spec, rng))
    kept = tremat.DotsKept()
    with kept.contexts()[0]:
        with torch.enable_grad():
            leaves = toptim.tree_map(lambda x: x.clone().requires_grad_(), params)
            get_family(spec).forward(leaves, spec, ids, seg, pos, compute_dtype=torch.float32,
                                     remat="none")
    # a layer: q, k, v, o and the router; the experts' loop is not among them
    assert len(kept.kept) == spec.num_layers * 5

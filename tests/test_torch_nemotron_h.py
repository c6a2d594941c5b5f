"""Nemotron-H (``nemotron_h``, the Mamba-2 hybrid) on the CPU against the JAX
package, on the debug spec both packages name ``debug_nemotron`` (the M*-E
pattern: one Mamba-2 layer of 4 heads of 32, one bare attention layer at
4/2 heads, one relu^2 MLP, one LatentMoE layer of 4 experts top-2 at latent
width 64): ``moe_mlp``'s non-gated experts over a latent input, the init
layout, the training forward (hidden states, load-balance aux, remat modes,
router replay, the refusals), packed rows against separate ones, the HF
conversion through both packages and the config round trip, the pools, the
sampler's prefill, chunked prefill and decode, the engine's greedy tokens,
recorded routing and state tier, and one train step. Weights are the JAX
init's from a seed, every leaf moved off its init value by 0.05 * N(0, 1),
carried across as numpy; float32 throughout. Every JAX call runs under
``jax.jit``.

The JAX serving mixers of a Mamba-2 layer pass the prompt's segment ids to
the SSD, whose reset at the first padded position zeroes the state they
return whenever a prefill or a chunk ends inside a chunk of the SSD
(``mamba_chunk_size``) or before its bucket's end; the port's serving SSD
takes no segment ids (a pad neither writes nor decays), so its state is the
training forward's. The comparisons with the JAX sampler and engine
therefore use prompts and chunks whose lengths are whole chunks of the SSD,
where the JAX state is exact, and the other lengths are held against the
training forwards of both packages
(``test_served_state_is_exact_where_the_jax_sampler_zeroes_it``).

Tolerances: 1e-4 (atol and rtol) on hidden states, logits and recurrent
rows, 2e-5 on ``moe_mlp``, 1e-5 relative on the aux, 1e-4 relative on the
step's loss and metrics, and each parameter's gradient within 1e-3 of its
norm; routing ids and tokens equal.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prime_rl_tpu.configs import TrainerConfig as JTrainerConfig
from prime_rl_tpu.configs.shared import MeshConfig as JMeshConfig
from prime_rl_tpu.models import nemotron_h as jnem
from prime_rl_tpu.models.base import get_spec as j_get_spec
from prime_rl_tpu.ops import moe as jmoe
from prime_rl_tpu.parallel.mesh import build_mesh
from prime_rl_tpu.sampler import model as jmodel
from prime_rl_tpu.sampler.cache import CacheConfig as JCacheConfig
from prime_rl_tpu.sampler.engine import Engine as JEngine
from prime_rl_tpu.sampler.engine import SamplingParams as JSamplingParams
from prime_rl_tpu.trainer import optim as joptim
from prime_rl_tpu.trainer import step as jstep
from prime_rl_tpu_torch.configs import TrainerConfig
from prime_rl_tpu_torch.models import get_family
from prime_rl_tpu_torch.models import nemotron_h as tnem
from prime_rl_tpu_torch.models.base import get_spec, spec_from_hf_config
from prime_rl_tpu_torch.models.qwen3 import params_from_jax
from prime_rl_tpu_torch.ops import moe as tmoe
from prime_rl_tpu_torch.sampler import model as tmodel
from prime_rl_tpu_torch.sampler.cache import (
    CacheConfig,
    KVPool,
    RecurrentPool,
    page_nbytes,
    recurrent_nbytes,
)
from prime_rl_tpu_torch.sampler.engine import Engine, SamplingParams
from prime_rl_tpu_torch.trainer import optim as toptim
from prime_rl_tpu_torch.trainer import step as tstep
from prime_rl_tpu_torch.trainer.rl.data import FakeDataLoader
from prime_rl_tpu_torch.trainer.weights import save_hf_weights, spec_to_hf_config

torch.set_num_threads(1)

NAME = "debug_nemotron"
TOL = dict(atol=1e-4, rtol=1e-4)


def _np(t):
    return t.detach().float().numpy()


_weights: dict = {}


def _jit(fn):
    """``fn(params, spec, ...)`` under jax.jit, the spec and the keyword
    flags static."""
    static = tuple(n for n in ("compute_dtype", "attn_impl", "collect_routing", "remat",
                               "collect_aux") if n in inspect.signature(fn).parameters)
    return jax.jit(fn, static_argnums=(1,), static_argnames=static)


j_forward = _jit(jnem.forward)
j_prefill, j_chunk, j_decode = map(_jit, (jmodel.prefill, jmodel.prefill_chunk, jmodel.decode))


@pytest.fixture(scope="module")
def model():
    """(JAX spec, port spec, JAX params as numpy, the same params in the port)."""
    if not _weights:
        jspec, spec = j_get_spec(NAME), get_spec(NAME)
        rng = np.random.default_rng(0)
        np_params = jax.tree.map(
            lambda x: np.asarray(x) + np.float32(0.05) * rng.standard_normal(x.shape, np.float32),
            jax.jit(jnem.init_params, static_argnums=0)(jspec, jax.random.key(0)))
        _weights["m"] = (jspec, spec, np_params, params_from_jax(np_params, spec))
    return _weights["m"]


def _packed(L=40, rows=2, seed=1):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, 250, size=(rows, L)).astype(np.int32)
    a, b = 21, 13
    seg = np.array([[1] * a + [2] * b + [0] * (L - a - b)] * rows, np.int32)
    pos = np.array([list(range(a)) + list(range(b)) + [0] * (L - a - b)] * rows, np.int32)
    return ids, seg, pos


def _t_forward(params, spec, ids, seg, pos, **kw):
    kw.setdefault("remat", "none")
    return tnem.forward(params, spec, torch.from_numpy(ids), torch.from_numpy(seg),
                        torch.from_numpy(pos), compute_dtype=torch.float32, **kw)


def test_moe_mlp_non_gated_latent_experts_match_jax():
    """``moe_mlp`` with ``w_gate=None`` (relu^2 experts) over ``x_experts``
    at a latent width of 6 (routing at 8, sigmoid noaux-tc with a correction
    bias): output and the gradients of x, the latent input, the router and
    both expert stacks within 2e-5."""
    rng = np.random.default_rng(3)
    f = np.float32
    t, d, lat, e, m = 12, 8, 6, 5, 7
    x, xl = rng.standard_normal((t, d)).astype(f), rng.standard_normal((t, lat)).astype(f)
    rw = rng.standard_normal((d, e)).astype(f)
    up, down = rng.standard_normal((e, lat, m)).astype(f), rng.standard_normal((e, m, lat)).astype(f)
    bias = (0.1 * rng.standard_normal(e)).astype(f)
    ct = rng.standard_normal((t, lat)).astype(f)
    kw = dict(sigmoid_noaux=True, routed_scaling=1.5)

    @jax.jit
    def j_fn(x_, xl_, rw_, up_, down_):
        def loss(*a):
            out, r = jmoe.moe_mlp(a[0], a[2], None, a[3], a[4], 2, True, x_experts=a[1],
                                  correction_bias=bias, **kw)
            return jnp.sum(out * ct), (out, r.expert_ids)

        (_, aux), g = jax.value_and_grad(loss, argnums=tuple(range(5)), has_aux=True)(
            x_, xl_, rw_, up_, down_)
        return aux, g

    (want, want_ids), want_g = j_fn(x, xl, rw, up, down)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, xl, rw, up, down)]
    out, r = tmoe.moe_mlp(leaves[0], leaves[2], None, leaves[3], leaves[4], 2, True,
                          x_experts=leaves[1], correction_bias=torch.from_numpy(bias), **kw)
    np.testing.assert_array_equal(r.expert_ids.numpy(), np.asarray(want_ids))
    np.testing.assert_allclose(_np(out), np.asarray(want), rtol=2e-5, atol=2e-5)
    got_g = torch.autograd.grad((out * torch.from_numpy(ct)).sum(), leaves)
    for name, g, w in zip(("x", "x_experts", "router", "up", "down"), got_g, want_g):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=2e-5, atol=2e-5, err_msg=name)


def test_init_matches_the_jax_layout(model):
    """The port's init gives the JAX init's leaves at its shapes and dtypes'
    kinds, and the JAX package's own dt_bias, A_log and D values."""
    jspec, spec, _, _ = model
    got = get_family(spec).init(spec, torch.Generator().manual_seed(0), dtype=torch.bfloat16)
    want = dict(toptim.tree_paths(jax.tree.map(
        np.asarray, jax.jit(jnem.init_params, static_argnums=0)(jspec, jax.random.key(0)))))
    have = dict(toptim.tree_paths(got))
    assert set(have) == set(want)
    for path, t in have.items():
        assert tuple(t.shape) == want[path].shape, path
    for path in ("mamba_layers/dt_bias", "mamba_layers/A_log", "mamba_layers/D"):
        assert have[path].dtype == torch.float32
        np.testing.assert_allclose(_np(have[path]), want[path], rtol=1e-6, err_msg=path)
    assert have["moe_layers/expert_up"].dtype == torch.bfloat16
    assert tnem.stack_counts(spec) == {"M": 1, "*": 1, "-": 1, "E": 1}


def test_forward_aux_remat_and_router_replay(model):
    """Hidden states (1e-4) and the load-balance aux of the LatentMoE layer
    (1e-5) on a packed batch with two segments and padding against JAX; full,
    save_attn and save_attn/2 remat give the same states; replaying the own
    routing gives the same states, another selection other states, rows of -1
    the own routing (JAX's forward has no replay); the refusals name their
    ROADMAP items."""
    jspec, spec, np_params, params = model
    ids, seg, pos = _packed()
    jp = jax.tree.map(jnp.asarray, np_params)
    want_h, want_aux = j_forward(jp, jspec, *map(jnp.asarray, (ids, seg, pos)),
                                 compute_dtype=jnp.float32, remat="none", attn_impl="xla",
                                 collect_aux=True)
    got_h, got_aux = _t_forward(params, spec, ids, seg, pos, collect_aux=True)
    real = seg > 0
    np.testing.assert_allclose(_np(got_h)[real], np.asarray(want_h)[real], **TOL)
    np.testing.assert_allclose(float(got_aux), float(want_aux), rtol=1e-5)
    leaves = toptim.tree_map(lambda x: x.clone().requires_grad_(), params)
    for mode in ("full", "save_attn", "save_attn/2"):
        np.testing.assert_allclose(_np(_t_forward(leaves, spec, ids, seg, pos, remat=mode)),
                                   _np(got_h), atol=1e-6, rtol=1e-6, err_msg=mode)

    # the "E" layer's own routing, from its input (the first three layers)
    k = spec.num_experts_per_tok
    layers = tnem.layer_params(params, spec)
    tseg = torch.from_numpy(seg)
    with torch.no_grad():
        pre = params["embed"][torch.from_numpy(ids)]
        pre = tnem.mamba_block(pre, layers[0][1], spec, tseg, torch.float32)
        pre = tnem.attn_block(pre, layers[1][1], spec, tseg, "xla", torch.float32)
        pre = tnem.mlp_block(pre, layers[2][1], spec, torch.float32)
        lp = layers[3][1]
        _, routing = tnem.latent_moe(tnem.rms_norm(pre, lp["norm"], spec.rms_eps), lp, spec)
    own = routing.expert_ids.reshape(*ids.shape, 1, k)
    same = _t_forward(params, spec, ids, seg, pos, routed_experts=own)
    np.testing.assert_allclose(_np(same), _np(got_h), atol=1e-5, rtol=1e-5)
    other = (own + 1) % spec.num_experts
    other[:, ::2] = -1
    moved = _t_forward(params, spec, ids, seg, pos, routed_experts=other)
    assert not np.allclose(_np(moved)[real], _np(got_h)[real], atol=1e-3)
    np.testing.assert_allclose(_np(moved)[:, ::2], _np(got_h)[:, ::2], atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError, match="MoE layers"):
        _t_forward(params, spec, ids, seg, pos,
                   routed_experts=torch.full((*ids.shape, 2, k), -1, dtype=torch.int32))
    with pytest.raises(NotImplementedError, match="item 11"):
        _t_forward(params, spec, ids, seg, pos, mesh=object())
    # the offload and selective remat modes run since their slice (their
    # gradients: tests/test_torch_remat.py)
    for mode in ("offload_attn", "selective"):
        np.testing.assert_allclose(_np(_t_forward(leaves, spec, ids, seg, pos, remat=mode)),
                                   _np(got_h), atol=1e-6, rtol=1e-6, err_msg=mode)
    # LoRA runs since its slice (held against JAX in tests/test_torch_lora.py)
    from prime_rl_tpu_torch.configs.shared import LoRAConfig
    from prime_rl_tpu_torch.models.lora import init_lora

    lora = init_lora(spec, LoRAConfig(rank=2, experts=True), torch.Generator().manual_seed(1))
    assert {"q_a", "moe_up_a", "moe_down_a"} <= set(lora["layers"])
    assert _t_forward(params, spec, ids, seg, pos, lora=lora).shape == got_h.shape


def test_packed_rows_equal_separate_rows(model):
    """Two sequences packed in one row give the states of each run alone:
    the SSD's resets, the conv's segment mask and the attention's are
    exact."""
    _, spec, _, params = model
    ids, seg, pos = _packed(rows=1)
    packed = _np(_t_forward(params, spec, ids, seg, pos))
    for s in (1, 2):
        cols = np.nonzero(seg[0] == s)[0]
        alone = _np(_t_forward(params, spec, ids[:, cols], np.ones((1, len(cols)), np.int32),
                               pos[:, cols]))
        np.testing.assert_allclose(packed[0, cols], alone[0], atol=2e-5, rtol=2e-5)


def test_hf_round_trip_and_config(tmp_path, model):
    """to_hf names every key of the JAX package's table with equal values;
    from_hf gives the params back, and the JAX from_hf reads the port's state
    to the same values; the fused 3-D expert form reads too;
    spec_to_hf_config writes NemotronHForCausalLM with the pattern, the
    Mamba-2 widths and the LatentMoE fields, and a snapshot reads back as the
    same spec (the named 8B spec's config too)."""
    jspec, spec, np_params, params = model
    want = jnem.params_to_hf_state_dict(jax.tree.map(jnp.asarray, np_params), jspec)
    family = get_family(spec)
    state = family.to_hf(params, spec)
    assert set(state) == set(want)
    for key, v in state.items():
        np.testing.assert_allclose(np.asarray(v), np.asarray(want[key]), atol=1e-7, err_msg=key)
    back = family.from_hf(state, spec)
    for (pa, a), (pb, b) in zip(toptim.tree_paths(params), toptim.tree_paths(back)):
        assert pa == pb
        np.testing.assert_allclose(_np(b), _np(a), atol=1e-7, err_msg=str(pa))
    j_back = dict(toptim.tree_paths(jax.tree.map(np.asarray, jnem.params_from_hf_state_dict(
        dict(state), jspec))))
    for path, t in toptim.tree_paths(params):
        np.testing.assert_allclose(_np(t), j_back[path], atol=1e-7, err_msg=str(path))
    pre = "backbone.layers.3.mixer."
    fused = {k: v for k, v in state.items() if ".experts." not in k}
    for ours, theirs in (("expert_up", "up_proj"), ("expert_down", "down_proj")):
        fused[pre + f"experts.{theirs}"] = _np(params["moe_layers"][ours][0]).transpose(0, 2, 1)
    np.testing.assert_array_equal(_np(family.from_hf(fused, spec)["moe_layers"]["expert_up"]),
                                  _np(params["moe_layers"]["expert_up"]))
    with pytest.raises(ValueError, match="pattern"):
        family.from_hf(state, spec_from_hf_config({**spec_to_hf_config(spec),
                                                   "hybrid_override_pattern": "*M-E"}))
    cfg = spec_to_hf_config(spec)
    assert cfg["architectures"] == ["NemotronHForCausalLM"]
    assert cfg["hybrid_override_pattern"] == "M*-E" and cfg["moe_latent_size"] == 64
    assert spec_from_hf_config(cfg) == spec
    big = get_spec("nvidia/Nemotron-H-8B-Base-8K")
    assert spec_from_hf_config(spec_to_hf_config(big)) == big
    save_hf_weights(params, spec, tmp_path / "snap")
    assert get_spec(str(tmp_path / "snap")) == spec
    # the trainer's FLOPs (PerfCounter's) count each layer kind: only the "*"
    # layer's term grows with seq_len, the SSD's does not
    assert spec.flops_per_token(4096) > 0
    grown = spec.flops_per_token(8192) - spec.flops_per_token(4096)
    assert grown == 3 * 2 * 2 * 4096 * spec.q_dim


def test_pools_page_only_the_attention_layers():
    """KVPool pages the "*" layers only, RecurrentPool holds the "M" rows
    (conv [slots, conv_dim, K] in the compute dtype, state [slots, H, P, N]
    float32), and the byte counts the engine sizes with count both; the
    named 8B spec at 64 slots holds 24 Mamba layers' rows."""
    spec = get_spec(NAME)
    cfg = CacheConfig(num_pages=8, page_size=16, max_slots=3)
    pool = KVPool(spec, cfg, dtype=torch.float32)
    assert [t is None for t in pool.k] == [c != "*" for c in spec.layer_pattern]
    assert pool.nbytes() == 8 * page_nbytes(spec, 16, itemsize=4)
    rec = RecurrentPool(spec, cfg, dtype=torch.bfloat16)
    assert [t is None for t in rec.state] == [c != "M" for c in spec.layer_pattern]
    assert rec.conv[0].shape == (3, spec.mamba_conv_dim, spec.mamba_conv_kernel)
    assert rec.conv[0].dtype == torch.bfloat16 and rec.state[0].dtype == torch.float32
    assert rec.state[0].shape == (3, spec.mamba_num_heads, spec.mamba_head_dim,
                                  spec.mamba_state_size)
    assert rec.nbytes() == recurrent_nbytes(spec, 3)
    big = get_spec("nvidia/Nemotron-H-8B-Base-8K")
    per_slot = (big.mamba_conv_dim * 4 * 2 + 128 * 64 * 128 * 4) * 24
    assert recurrent_nbytes(big, 64) == 64 * per_slot
    assert page_nbytes(big, 64) == 4 * 2 * big.kv_dim * 64 * 2


def _pools(spec, n_pages=24, ps=16):
    shape = (spec.num_kv_heads, n_pages, ps, spec.head_dim)
    kinds = spec.layer_pattern
    return ([jnp.zeros(shape, jnp.float32) if c == "*" else None for c in kinds],
            [torch.zeros(shape) if c == "*" else None for c in kinds])


def _rows_close(got, want, msg):
    for li, (g, w) in enumerate(zip(got, want)):
        assert (g is None) == (w is None), li
        if g is not None:
            for part, a, b in zip(("conv", "state"), g, w):
                np.testing.assert_allclose(_np(a), np.asarray(b), **TOL,
                                           err_msg=f"{msg} layer {li} {part}")


def test_sampler_prefill_chunk_and_decode_match_jax(model):
    """A prefill of 64 tokens (two SSD chunks, its bucket full), the same
    prompt in chunks of 32 from zero rows (pages 16), then three decode steps
    of both slots with the routing collected: hidden states, logits and the
    Mamba rows (1e-4), the routing ids, against the JAX sampler; the "*"
    layer never takes K3."""
    jspec, spec, np_params, params = model
    jp = jmodel.unstack_params(jax.tree.map(jnp.asarray, np_params), jspec)
    tp = tmodel.unstack_params(params, spec)
    jk, tk = _pools(spec)
    jv, tv = list(jk), [None if t is None else torch.zeros_like(t) for t in tk]
    rng = np.random.default_rng(1)
    ids = rng.integers(1, 250, (1, 64)).astype(np.int32)
    pages = np.arange(1, 5, dtype=np.int32)
    jk, jv, j_h, _, j_rows = j_prefill(jp, jspec, jk, jv, jnp.asarray(ids), jnp.int32(64),
                                       jnp.asarray(pages), compute_dtype=jnp.float32,
                                       attn_impl="xla")
    _, _, t_h, _, t_rows = tmodel.prefill(tp, spec, tk, tv, torch.from_numpy(ids.astype(np.int64)),
                                          64, torch.from_numpy(pages), compute_dtype=torch.float32)
    np.testing.assert_allclose(_np(t_h), np.asarray(j_h), **TOL)
    _rows_close(t_rows, j_rows, "prefill")

    row = np.zeros((8,), np.int32)
    row[:4] = np.arange(7, 11)
    kinds = spec.layer_pattern
    dims = (spec.mamba_num_heads, spec.mamba_head_dim, spec.mamba_state_size)
    jr = [(jnp.zeros((spec.mamba_conv_dim, 4)), jnp.zeros(dims)) if c == "M" else None
          for c in kinds]
    tr = [(torch.zeros(spec.mamba_conv_dim, 4), torch.zeros(dims)) if c == "M" else None
          for c in kinds]
    for off in (0, 32):
        chunk = ids[:, off:off + 32]
        pch = row[off // 16: off // 16 + 2]
        jk, jv, j_h2, jr = j_chunk(
            jp, jspec, jk, jv, jnp.asarray(chunk), jnp.int32(off), jnp.int32(32),
            jnp.asarray(pch), jnp.asarray(row), compute_dtype=jnp.float32, r_rows=jr)
        _, _, t_h2, tr = tmodel.prefill_chunk(
            tp, spec, tk, tv, torch.from_numpy(chunk.astype(np.int64)), off, 32,
            torch.from_numpy(pch), torch.from_numpy(row), compute_dtype=torch.float32, r_rows=tr)
        np.testing.assert_allclose(_np(t_h2), np.asarray(j_h2), **TOL, err_msg=f"chunk {off}")
        _rows_close(tr, jr, f"chunk {off}")
    np.testing.assert_allclose(_np(t_h2), _np(t_h), **TOL)  # chunked equals whole

    rc = [None if r is None else torch.stack([a[0], b[0]]) for a, b, r in zip(t_rows, tr, tr)]
    rs = [None if r is None else torch.stack([a[1], b[1]]) for a, b, r in zip(t_rows, tr, tr)]
    jrc = [None if r is None else jnp.array(_np(r)) for r in rc]
    jrs = [None if r is None else jnp.array(_np(r)) for r in rs]
    table = np.zeros((2, 8), np.int32)
    table[0, :4] = pages
    table[1] = row
    lens = np.asarray([64, 64], np.int32)
    toks = np.asarray([int(ids[0, 63])] * 2, np.int32)
    for _ in range(3):
        jk, jv, j_logits, j_routed, jrc, jrs = j_decode(
            jp, jspec, jk, jv, jnp.asarray(toks), jnp.asarray(lens), jnp.asarray(table),
            attn_impl="xla", compute_dtype=jnp.float32, collect_routing=True, r_conv=jrc,
            r_state=jrs)
        _, _, t_logits, t_routed = tmodel.decode(
            tp, spec, tk, tv, torch.from_numpy(toks), torch.from_numpy(lens),
            torch.from_numpy(table), compute_dtype=torch.float32, collect_routing=True,
            r_conv=rc, r_state=rs)
        np.testing.assert_allclose(_np(t_logits), np.asarray(j_logits), **TOL)
        assert t_routed.shape == (2, 1, spec.num_experts_per_tok)
        np.testing.assert_array_equal(t_routed.numpy(), np.asarray(j_routed))
        toks = np.asarray(j_logits).argmax(-1).astype(np.int32)
        lens = lens + 1
    _rows_close([None if a is None else (a, b) for a, b in zip(rc, rs)],
                [None if a is None else (a, b) for a, b in zip(jrc, jrs)], "decode")
    assert not any(tmodel.takes_k3(spec, lp) for lp in tp["layers"] if "q" in lp)
    assert tmodel.layer_kinds(spec) == ["M", "*", "-", "E"]


def test_served_state_is_exact_where_the_jax_sampler_zeroes_it(model):
    """A prompt of 45 tokens in a bucket of 64 (the prefill ends inside an
    SSD chunk): the port's prefill gives the training forward's last hidden
    state, and its decode of the next token the training forwards' logits
    (the port's and the JAX package's, 1e-4); its chunked prefill (chunks of
    16: each a part of an SSD chunk) gives the same rows. The JAX prefill's
    Mamba state there is all zeros (the reset at its first pad), so its
    decode is not the model's: the fault the port does not carry."""
    jspec, spec, np_params, params = model
    jp = jax.tree.map(jnp.asarray, np_params)
    tp = tmodel.unstack_params(params, spec)
    rng = np.random.default_rng(2)
    prompt = rng.integers(1, 250, 46).astype(np.int32)
    ids = np.zeros((1, 64), np.int32)
    ids[0, :45] = prompt[:45]
    jk, tk = _pools(spec)
    tv = [None if t is None else torch.zeros_like(t) for t in tk]
    pages = np.arange(1, 5, dtype=np.int32)
    _, _, t_h, _, t_rows = tmodel.prefill(tp, spec, tk, tv, torch.from_numpy(ids.astype(np.int64)),
                                          45, torch.from_numpy(pages), compute_dtype=torch.float32)
    seq = prompt[None]
    one = np.ones_like(seq)
    posn = np.arange(46, dtype=np.int32)[None]
    want_t = _np(_t_forward(params, spec, seq, one, posn))
    want_j = np.asarray(j_forward(jp, jspec, *map(jnp.asarray, (seq, one, posn)),
                                  compute_dtype=jnp.float32, remat="none", attn_impl="xla"))
    np.testing.assert_allclose(want_t, want_j, **TOL)
    np.testing.assert_allclose(_np(t_h), want_j[0, 44], **TOL)
    rc = [None if r is None else r[0][None].clone() for r in t_rows]
    rs = [None if r is None else r[1][None].clone() for r in t_rows]
    table = np.zeros((1, 8), np.int32)
    table[0, :4] = pages
    _, _, logits = tmodel.decode(tp, spec, tk, tv, torch.from_numpy(prompt[45:46]),
                                 torch.tensor([45], dtype=torch.int32), torch.from_numpy(table),
                                 compute_dtype=torch.float32, r_conv=rc, r_state=rs)
    head = _np(get_family(spec).get_lm_head(params, spec))
    np.testing.assert_allclose(_np(logits[0]), want_j[0, 45] @ head, **TOL)

    tr = [None if r is None else (torch.zeros_like(r[0]), torch.zeros_like(r[1]))
          for r in t_rows]
    tk2 = [None if t is None else torch.zeros_like(t) for t in tk]
    tv2 = [None if t is None else torch.zeros_like(t) for t in tk]
    row = np.zeros((8,), np.int32)
    row[:4] = pages
    for off in (0, 16, 32):
        valid = min(16, 45 - off)
        chunk = np.zeros((1, 16), np.int64)
        chunk[0, :valid] = prompt[off:off + valid]
        _, _, h2, tr = tmodel.prefill_chunk(tp, spec, tk2, tv2, torch.from_numpy(chunk), off, valid,
                                            torch.from_numpy(row[off // 16:off // 16 + 1]),
                                            torch.from_numpy(row), compute_dtype=torch.float32,
                                            r_rows=tr)
    np.testing.assert_allclose(_np(h2), _np(t_h), **TOL)
    _rows_close(tr, t_rows, "chunked")

    jpu = jmodel.unstack_params(jp, jspec)
    jv = list(jk)
    *_, j_rows = j_prefill(jpu, jspec, jk, jv, jnp.asarray(ids), jnp.int32(45),
                           jnp.asarray(pages), compute_dtype=jnp.float32, attn_impl="xla")
    assert float(jnp.abs(j_rows[0][1]).max()) == 0.0
    assert float(t_rows[0][1].abs().max()) > 0.0


def _cache(**kw):
    return dict(num_pages=64, page_size=16, max_slots=2, max_seq_len=256, **kw)


def _engine(params, spec, **kw):
    return Engine(params, spec, CacheConfig(**_cache(**kw)), device="cpu",
                  compute_dtype=torch.float32)


def _greedy(engine, prompt, n=6, **kw):
    return engine.generate([prompt], [SamplingParams(max_tokens=n, temperature=0.0,
                                                     ignore_eos=True, **kw)])[0]


def test_engine_greedy_and_routing_match_jax(model):
    """Greedy serving with the routing recorded and the state tier on (pages
    and prefill chunks of 32, one SSD chunk, so that every JAX chunk ends on
    an SSD chunk): the JAX engine's tokens and routing ids ([n_gen, 1, K],
    the last row -1) for a prompt of 64 and then one that shares its first
    page, whose admission restores the checkpoint (the same cached tokens,
    snapshots and restores counted as JAX); the training forward's greedy
    tokens."""
    jspec, spec, np_params, params = model
    cache = dict(num_pages=32, page_size=32, max_slots=2, max_seq_len=256, state_cache_mb=64,
                 prefill_chunk=32)
    rng = np.random.default_rng(7)
    prompts = [[int(x) for x in rng.integers(1, 200, 64)]]
    prompts.append(prompts[0][:32] + [int(x) for x in rng.integers(1, 200, 32)])
    n_gen = 6
    sp = dict(max_tokens=n_gen, temperature=0.0, ignore_eos=True)
    engine = Engine(params, spec, CacheConfig(**cache), device="cpu",
                    compute_dtype=torch.float32, decode_block=4, collect_routed_experts=True)
    # copies: the JAX engine donates its parameter buffers
    jengine = JEngine(jax.tree.map(jnp.array, np_params), jspec, JCacheConfig(**cache),
                      compute_dtype=jnp.float32, collect_routed_experts=True)
    for prompt in prompts:
        got = engine.generate([prompt], SamplingParams(**sp))[0]
        want = jengine.generate([prompt], JSamplingParams(**sp))[0]
        assert got.token_ids == want.token_ids
        assert got.routed_experts.shape == (n_gen, 1, spec.num_experts_per_tok)
        np.testing.assert_array_equal(got.routed_experts, want.routed_experts)
        assert bool((got.routed_experts[-1] == -1).all())
    for key in ("prefill_tokens_cached", "state_restores", "state_snapshots"):
        assert engine.stats[key] == jengine.stats[key] > 0, key
    seq = np.asarray([prompts[1] + got.token_ids], np.int32)
    h = _t_forward(params, spec, seq, np.ones_like(seq),
                   np.arange(seq.shape[1], dtype=np.int32)[None])
    head = get_family(spec).get_lm_head(params, spec)
    assert (h[0] @ head)[len(prompts[1]) - 1:-1].argmax(-1).tolist() == got.token_ids


def test_hybrid_chunked_prefill_prefix_cache_and_flush(model):
    """With the state tier on, prefills run in chunks (of 16 here, inside SSD
    chunks of 32) threading the rows from zeros: the fused prefill's greedy
    tokens and the training forward's; a second identical prompt restores
    the boundary state, skips two pages and decodes the same tokens; a
    prompt past the largest bucket serves chunked; a weight update empties
    the tier."""
    _, spec, _, params = model
    rng = np.random.default_rng(0)
    prompt = [int(x) for x in rng.integers(1, 500, 45)]  # 2 full pages and a tail
    fused = _engine(params, spec, enable_prefix_cache=False)
    chunked = _engine(params, spec, state_cache_mb=64, prefill_chunk=16)
    r1 = _greedy(chunked, prompt)
    assert r1.token_ids == _greedy(fused, prompt).token_ids
    assert chunked.stats["prefill_tokens_cached"] == 0 and chunked.stats["state_snapshots"] >= 1
    seq = np.asarray([prompt + r1.token_ids], np.int32)
    h = _t_forward(params, spec, seq, np.ones_like(seq),
                   np.arange(seq.shape[1], dtype=np.int32)[None])
    head = get_family(spec).get_lm_head(params, spec)
    assert (h[0] @ head)[len(prompt) - 1:-1].argmax(-1).tolist() == r1.token_ids
    assert _greedy(chunked, prompt).token_ids == r1.token_ids
    assert chunked.stats["state_restores"] >= 1 and chunked.stats["prefill_tokens_cached"] == 32
    long = [int(x) for x in rng.integers(1, 500, 150)]
    small = _engine(params, spec, state_cache_mb=64)
    small.buckets = [64, 128]  # the prompt of 150 exceeds the largest bucket
    assert _greedy(small, long).token_ids == _greedy(fused, long).token_ids
    chunked.update_params(toptim.tree_map(lambda x: x * 1.5, params), version=1)
    assert not chunked._state_tier


def test_train_step_matches_jax_step_one(model):
    """One fake batch through ``make_train_step`` with a trained load-balance
    term and full remat: loss, grad_norm and every metric (rtol 1e-4), and
    every parameter's gradient (the update of sgd at lr 1 without weight
    decay) within 1e-3 of its norm."""
    jspec, spec, np_params, params = model
    cfg = dict(model={"attn": {"impl": "xla"}, "compute_dtype": "float32",
                      "lm_head_chunk_size": 48, "ac": {"mode": "full"}, "moe_aux_coef": 0.01},
               optimizer={"type": "sgd", "lr": 1.0, "weight_decay": 0.0})
    j_cfg, t_cfg = JTrainerConfig(**cfg), TrainerConfig(**cfg)
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
                                     params=toptim.tree_map(lambda x: x.clone(), params))
    t_step = tstep.make_train_step(spec, t_cfg.model, t_cfg.loss, t_opt, "cpu")
    t_state, t_metrics = t_step(t_state, batch, tstep.Scales(scale, 1.0, 1.0))
    assert set(t_metrics) == set(j_metrics) and "moe_load_balance" in t_metrics
    for name in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(t_metrics[name]), float(j_metrics[name]), rtol=1e-4)
    for name, stat in t_metrics.items():
        if name not in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(stat.total), float(j_metrics[name].total),
                                       rtol=1e-4, atol=1e-5, err_msg=name)
    before = dict(toptim.tree_paths(np_params))
    j_flat = dict(toptim.tree_paths(jax.tree.map(np.asarray, j_state.params)))
    for path, t in toptim.tree_paths(t_state.params):
        t_grad, j_grad = before[path] - _np(t), before[path] - j_flat[path]
        assert np.linalg.norm(t_grad - j_grad) <= 1e-3 * np.linalg.norm(j_grad) + 1e-7, path

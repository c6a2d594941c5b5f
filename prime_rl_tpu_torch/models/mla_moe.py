"""DeepSeek-V3 / GLM-MoE-DSA families: MLA (multi-head latent) attention with
optional DSA sparse top-k attention, over the noaux-tc MoE stack (the port of
the JAX package's ``models/mla_moe.py``, training path).

- Attention always runs the **absorbed** MLA form: q_nope is folded through
  kv_b's key half so scores are dot products against the [S, kv_lora + rope]
  latent stream: one shared KV per token, no per-head K/V.
- DSA (``index_topk > 0``, family ``glm_moe_dsa``): the indexer's top-k
  selection (plain PyTorch, gradient-free) and the sparse attention over the
  selected rows, which on the card runs the hand-written kernels K5a/K5b
  (``ops/sparse_mla_kernel.py``). ``index_topk == 0`` (``deepseek_v3``) is
  dense causal MLA in plain PyTorch.
- MoE reuses the glm4_moe block (sigmoid noaux-tc routing, group-limited
  top-k, shared experts, first-k dense layers).

Params: ``{"embed", "dense_layers": {name: [k, ...]}, "layers": {name:
[NL - k, ...]}, "final_norm", "lm_head"}`` in the JAX package's layout.
Serving these families (the latent KV cache, the paged indexer keys) and LoRA
on the latent projections are not ported yet and raise.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from prime_rl_tpu_torch.models import glm4_moe, qwen3
from prime_rl_tpu_torch.models.base import ModelSpec
from prime_rl_tpu_torch.models.glm4_moe import glm_moe_block
from prime_rl_tpu_torch.models.lora import apply_lora_proj, layer_slices
from prime_rl_tpu_torch.models.qwen3 import parse_remat
from prime_rl_tpu_torch.ops import sparse_mla, sparse_mla_kernel
from prime_rl_tpu_torch.ops.remat import DotsKept
from prime_rl_tpu_torch.ops.layers import (
    apply_rope,
    layer_norm,
    rms_norm,
    rope_frequencies,
    swiglu,
)

Params = dict
FAMILIES = ("deepseek_v3", "glm_moe_dsa")
# the ac.modes the JAX function names (prime_rl_tpu/models/mla_moe.py:308-315) and the mode
# each runs as; any other keeps every activation (``qwen3.parse_remat``)
REMAT = {"full": "full", "selective": "selective"}


def _qk_head_dim(spec: ModelSpec) -> int:
    return spec.qk_nope_head_dim + spec.qk_rope_head_dim


def init_params(spec: ModelSpec, generator: torch.Generator, dtype=torch.float32,
                device: torch.device | str = "cpu") -> Params:
    """Random init (truncated normal, std 0.02 cut at 2 sigma) on ``device``,
    drawn from ``generator`` (which must live on that device). The numbers
    differ from the JAX package's ``jax.random`` init."""
    if spec.family not in FAMILIES:
        raise ValueError(f"mla_moe.init_params: family {spec.family!r} is not an MLA family")

    def w(*shape):
        t = torch.empty(shape, dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(t, std=0.02, a=-0.04, b=0.04, generator=generator)
        return t.to(dtype)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    d, H = spec.hidden_size, spec.num_heads
    qk, rope_d = _qk_head_dim(spec), spec.qk_rope_head_dim
    kvl, ql, vh = spec.kv_lora_rank, spec.q_lora_rank, spec.v_head_dim
    k_dense = spec.first_k_dense_replace
    n_moe = spec.num_layers - k_dense

    def attn_leaves(n):
        lp = {
            "attn_norm": ones(n, d),
            "mlp_norm": ones(n, d),
            "kv_a": w(n, d, kvl + rope_d),
            "kv_a_norm": ones(n, kvl),
            "kv_b": w(n, kvl, H * (spec.qk_nope_head_dim + vh)),
            "o": w(n, H * vh, d),
        }
        if ql:
            lp["q_a"] = w(n, d, ql)
            lp["q_a_norm"] = ones(n, ql)
            lp["q_b"] = w(n, ql, H * qk)
        else:
            lp["q"] = w(n, d, H * qk)
        if spec.index_topk:
            hi, di = spec.index_n_heads, spec.index_head_dim
            lp["idx_wq_b"] = w(n, ql, hi * di)
            lp["idx_wk"] = w(n, d, di)
            lp["idx_k_norm_w"] = ones(n, di)
            lp["idx_k_norm_b"] = torch.zeros((n, di), dtype=dtype, device=device)
            lp["idx_w_proj"] = w(n, d, hi)
        return lp

    dense_layers = attn_leaves(k_dense)
    for f in ("gate", "up", "down"):
        ins, outs = ((d, spec.intermediate_size) if f != "down"
                     else (spec.intermediate_size, d))
        dense_layers[f] = w(k_dense, ins, outs)

    moe_layers = attn_leaves(n_moe)
    e, m = spec.num_experts, spec.moe_intermediate_size
    moe_layers["router"] = w(n_moe, d, e)
    moe_layers["router_correction_bias"] = torch.zeros((n_moe, e), dtype=torch.float32,
                                                       device=device)
    moe_layers["expert_gate"] = w(n_moe, e, d, m)
    moe_layers["expert_up"] = w(n_moe, e, d, m)
    moe_layers["expert_down"] = w(n_moe, e, m, d)
    if spec.n_shared_experts:
        ms = m * spec.n_shared_experts
        moe_layers["shared_gate"] = w(n_moe, d, ms)
        moe_layers["shared_up"] = w(n_moe, d, ms)
        moe_layers["shared_down"] = w(n_moe, ms, d)

    params: Params = {
        "embed": w(spec.vocab_size, d),
        "layers": moe_layers,
        "final_norm": ones(d),
    }
    if k_dense:
        params["dense_layers"] = dense_layers
    if not spec.tie_embeddings:
        params["lm_head"] = w(d, spec.vocab_size)
    return params


def _rope(x, position_ids, inv_freq, interleave: bool):
    """x: [B, L, H, d] or [B, L, d]; per-row positions [B, L]."""
    if interleave:
        flat = sparse_mla.interleaved_rope(x.flatten(0, 1), position_ids.flatten(), inv_freq)
        return flat.reshape(x.shape)
    squeeze = x.dim() == 3
    if squeeze:
        x = x[:, :, None, :]
    out = apply_rope(x, position_ids, inv_freq)
    return out[:, :, 0, :] if squeeze else out


def mla_absorbed_qkv(x, lp, spec: ModelSpec, position_ids, inv_freq, ll=None,
                     lora_scale: float = 1.0):
    """Absorbed MLA projections. x: [B, L, D] (post input-norm). Returns
    (q_lat [B,L,ql]|None, absorbed query [B,L,H,kvl+rope], latent kv
    [B,L,kvl+rope], w_kv_b [kvl,H,nope+vh]). ``ll``: the layer's adapter
    slices on the latent projections q_b (or q), kv_a and kv_b; the kv_b
    delta is folded into the weight before the absorbed split (W + scale·A·B
    absorbs as W does)."""
    B, L, _ = x.shape
    H, qk = spec.num_heads, _qk_head_dim(spec)
    nope, kvl, vh = spec.qk_nope_head_dim, spec.kv_lora_rank, spec.v_head_dim

    if "q_a" in lp:
        q_lat = rms_norm(apply_lora_proj(x, lp["q_a"], None, "q_a", 1.0), lp["q_a_norm"],
                         spec.rms_eps)
        q = apply_lora_proj(q_lat, lp["q_b"], ll, "q_b", lora_scale).reshape(B, L, H, qk)
    else:
        q_lat = None
        q = apply_lora_proj(x, lp["q"], ll, "q", lora_scale).reshape(B, L, H, qk)
    q_nope, q_rope = q[..., :nope], q[..., nope:]

    ckv = apply_lora_proj(x, lp["kv_a"], ll, "kv_a", lora_scale)  # [B, L, kvl + rope_d]
    c_kv = rms_norm(ckv[..., :kvl], lp["kv_a_norm"], spec.rms_eps)
    k_rope = ckv[..., kvl:]

    q_rope = _rope(q_rope, position_ids, inv_freq, spec.rope_interleave)
    k_rope = _rope(k_rope, position_ids, inv_freq, spec.rope_interleave)

    w_kv_b = lp["kv_b"]
    if ll is not None and "kv_b_a" in ll:
        w_kv_b = w_kv_b + lora_scale * (ll["kv_b_a"].to(w_kv_b.dtype)
                                        @ ll["kv_b_b"].to(w_kv_b.dtype))
    w_kv_b = w_kv_b.reshape(kvl, H, nope + vh)
    q_abs = torch.einsum("blhn,khn->blhk", q_nope, w_kv_b[..., :nope])
    sparse_q = torch.cat([q_abs, q_rope], dim=-1)  # [B, L, H, kvl+rope]
    kv = torch.cat([c_kv, k_rope], dim=-1)  # [B, L, kvl+rope]
    return q_lat, sparse_q, kv, w_kv_b


def mla_indexer_qk(x, lp, spec: ModelSpec, position_ids, inv_freq, q_lat):
    """DSA indexer projections (rope tail at the FRONT of the index head).
    Returns (q_idx [B,L,hi,di], w_idx [B,L,hi], k_idx [B,L,di])."""
    B, L, _ = x.shape
    hi, di = spec.index_n_heads, spec.index_head_dim
    rope_d = spec.qk_rope_head_dim
    q_idx = torch.matmul(q_lat, lp["idx_wq_b"]).reshape(B, L, hi, di)
    k_idx = layer_norm(torch.matmul(x, lp["idx_wk"]), lp["idx_k_norm_w"], lp["idx_k_norm_b"])
    w_idx = torch.matmul(x, lp["idx_w_proj"])  # [B, L, hi]
    q_pe = _rope(q_idx[..., :rope_d], position_ids, inv_freq, spec.rope_interleave)
    k_pe = _rope(k_idx[..., :rope_d], position_ids, inv_freq, spec.rope_interleave)
    q_idx = torch.cat([q_pe, q_idx[..., rope_d:]], dim=-1)
    k_idx = torch.cat([k_pe, k_idx[..., rope_d:]], dim=-1)
    return q_idx, w_idx, k_idx


def mla_attention(h, lp, spec: ModelSpec, segment_ids, position_ids, inv_freq,
                  attn_impl: str = "auto", ll=None, lora_scale: float = 1.0):
    """Pre-norm MLA attention block with residual (absorbed compute).

    h: [B, L, D]; per-token positions restart per packed segment, and the
    DSA indexer's [ks, ke) bounds derive from them: ks = token - position is
    the start of the token's segment in the packed row, ke = token + 1, and
    padding rows (segment 0) select nothing (ke = 0).

    ``attn_impl``: ``auto`` sends CUDA tensors through K5a/K5b and CPU
    tensors through the chunked-gather op of ``ops/sparse_mla.py``; ``pallas``
    (the JAX package's name for its kernel route) forces the kernel module,
    which on the CPU runs the kernels' plain versions; ``xla`` forces the
    chunked-gather op. ``ll``: the layer's adapter slices on q_b (or q),
    kv_a, kv_b (``mla_absorbed_qkv``) and o."""
    if attn_impl not in ("auto", "pallas", "xla"):
        raise ValueError(f"unknown attention impl {attn_impl!r}")
    B, L, _ = h.shape
    H, qk = spec.num_heads, _qk_head_dim(spec)
    nope, kvl, vh = spec.qk_nope_head_dim, spec.kv_lora_rank, spec.v_head_dim
    x = rms_norm(h, lp["attn_norm"], spec.rms_eps)

    q_lat, sparse_q, kv, w_kv_b = mla_absorbed_qkv(x, lp, spec, position_ids, inv_freq, ll,
                                                   lora_scale)
    scale = qk ** -0.5

    if spec.index_topk:
        with torch.no_grad():
            q_idx, w_idx, k_idx = mla_indexer_qk(x, lp, spec, position_ids, inv_freq, q_lat)
            tok = torch.arange(L, dtype=torch.int32, device=h.device)[None, :]
            ks = tok - position_ids.to(torch.int32)
            ke = torch.where(segment_ids > 0, tok + 1, 0)
            indices = torch.stack([
                sparse_mla.mla_topk_indices(q_idx[b], k_idx[b], w_idx[b], ks[b], ke[b],
                                            spec.index_topk)
                for b in range(B)])
        if attn_impl == "pallas" or (attn_impl == "auto" and h.is_cuda):
            out_lat = sparse_mla_kernel.sparse_mla_attention(sparse_q, kv, indices, scale, kvl)
        else:
            out_lat = torch.stack([
                sparse_mla.sparse_mla_attention(sparse_q[b], kv[b], indices[b], scale, kvl)
                for b in range(B)])
    else:
        out_lat = torch.stack([
            sparse_mla.dense_mla_attention(sparse_q[b], kv[b], segment_ids[b], scale, kvl)
            for b in range(B)])

    v_out = torch.einsum("blhk,khv->blhv", out_lat, w_kv_b[..., nope:])
    return h + apply_lora_proj(v_out.reshape(B, L, H * vh), lp["o"], ll, "o", lora_scale)


def forward(
    params: Params,
    spec: ModelSpec,
    input_ids: torch.Tensor,  # [B, L] int
    segment_ids: torch.Tensor,  # [B, L] int (0 = pad)
    position_ids: torch.Tensor,  # [B, L] int
    compute_dtype=torch.bfloat16,
    attn_impl: str = "auto",
    block_q: int = 512,
    block_kv: int = 512,
    remat: str = "full",
    mesh=None,
    lora: Params | None = None,
    lora_scale: float = 1.0,
    cp_style: str = "ulysses",
    collect_aux: bool = False,
    routed_experts: torch.Tensor | None = None,  # [B, L, NL_moe, K]; -1 = own
    quantized_compute: str | None = None,
):
    """Token ids -> final hidden states [B, L, D] (pre-LM-head, normed), or
    (hidden, summed load-balance aux) with ``collect_aux``.

    ``remat``: the modes the JAX function names (``REMAT``): ``full``
    recomputes each layer in the backward through ``torch.utils.checkpoint``
    (so K5a runs twice a layer); ``selective`` keeps the products with no
    batch dims and recomputes the rest, K5a among it (``ops/remat.py``); any
    other mode (``save_attn`` among them) and any ``mode/K`` keeps every
    activation, as in the JAX function.
    ``routed_experts`` replays the sampler's expert selection in the MoE
    layers. ``block_q``/``block_kv`` are accepted and unused."""
    if spec.family not in FAMILIES:
        raise ValueError(f"mla_moe.forward: family {spec.family!r} is not an MLA family")
    if mesh is not None:
        raise NotImplementedError("context parallelism waits for the multi-card slice")
    if quantized_compute:
        raise ValueError(f"quantized_compute={quantized_compute!r} is only wired for the "
                         f"qwen3/llama dense families, not {spec.family!r}")
    mode = parse_remat(remat, spec.num_layers, REMAT)[0]
    use_ckpt = mode != "none" and torch.is_grad_enabled()

    inv_freq = rope_frequencies(spec.qk_rope_head_dim, spec.rope_theta, device=input_ids.device)
    h = params["embed"].to(compute_dtype)[input_ids]
    k_dense = spec.first_k_dense_replace

    def cast_lp(lp):
        return {k: (v.to(compute_dtype) if v.dim() >= 2 and "router" not in k else v)
                for k, v in lp.items()}

    # LoRA: the latent projections of every layer (and the moe_* targets per
    # expert); the dense layers' MLP takes no adapter, as in the JAX package
    def dense_block(h, lp, ll):
        cast = cast_lp(lp)
        h = mla_attention(h, cast, spec, segment_ids, position_ids, inv_freq, attn_impl, ll,
                          lora_scale)
        x = rms_norm(h, cast["mlp_norm"], spec.rms_eps)
        return h + torch.matmul(
            swiglu(torch.matmul(x, cast["gate"]), torch.matmul(x, cast["up"])), cast["down"])

    def moe_block(h, lp, forced, ll):
        cast = cast_lp(lp)  # once: glm_moe_block's own cast then finds nothing to do
        h = mla_attention(h, cast, spec, segment_ids, position_ids, inv_freq, attn_impl, ll,
                          lora_scale)
        return glm_moe_block(h, cast, spec, compute_dtype, forced_experts=forced, lora=ll,
                             lora_scale=lora_scale)

    def run(fn, *args):
        if not use_ckpt:
            return fn(*args)
        kw = {"context_fn": DotsKept().contexts} if mode == "selective" else {}
        return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False, **kw)

    forced = None
    if routed_experts is not None:
        # [B, L, NL_moe, K] -> layer-major [NL_moe, B*L, K]
        b_, l_ = routed_experts.shape[:2]
        forced = routed_experts.permute(2, 0, 1, 3).reshape(
            routed_experts.shape[2], b_ * l_, spec.num_experts_per_tok)

    # unbind once: its backward stacks the per-layer gradients in one copy
    lora_layers = layer_slices(lora, spec.num_layers)
    if k_dense:
        dense = {k: v.unbind(0) for k, v in params["dense_layers"].items()}
        for i in range(k_dense):
            h = run(dense_block, h, {k: v[i] for k, v in dense.items()}, lora_layers[i])
    moe = {k: v.unbind(0) for k, v in params["layers"].items()}
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(spec.num_layers - k_dense):
        h, lb = run(moe_block, h, {k: v[i] for k, v in moe.items()},
                    None if forced is None else forced[i], lora_layers[k_dense + i])
        aux = aux + lb
    h = rms_norm(h, params["final_norm"], spec.rms_eps)
    return (h, aux) if collect_aux else h


get_lm_head = qwen3.get_lm_head


# ---------------------------------------------------------------------------
# HF interchange. Attention keys follow HF DeepseekV3 / GLM-DSA naming
# (q_a_proj/q_b_proj/kv_a_proj_with_mqa/kv_b_proj/o_proj +
# self_attn.indexer.{wq_b,wk,k_norm,weights_proj}); the MoE half shares the
# glm4_moe layout exactly.
# ---------------------------------------------------------------------------

def _attn_keys(spec: ModelSpec):
    keys = [
        ("attn_norm", "input_layernorm.weight", False),
        ("mlp_norm", "post_attention_layernorm.weight", False),
        ("kv_a", "self_attn.kv_a_proj_with_mqa.weight", True),
        ("kv_a_norm", "self_attn.kv_a_layernorm.weight", False),
        ("kv_b", "self_attn.kv_b_proj.weight", True),
        ("o", "self_attn.o_proj.weight", True),
    ]
    if spec.q_lora_rank:
        keys += [("q_a", "self_attn.q_a_proj.weight", True),
                 ("q_a_norm", "self_attn.q_a_layernorm.weight", False),
                 ("q_b", "self_attn.q_b_proj.weight", True)]
    else:
        keys += [("q", "self_attn.q_proj.weight", True)]
    if spec.index_topk:
        keys += [("idx_wq_b", "self_attn.indexer.wq_b.weight", True),
                 ("idx_wk", "self_attn.indexer.wk.weight", True),
                 ("idx_k_norm_w", "self_attn.indexer.k_norm.weight", False),
                 ("idx_k_norm_b", "self_attn.indexer.k_norm.bias", False),
                 ("idx_w_proj", "self_attn.indexer.weights_proj.weight", True)]
    return keys


def params_from_hf_state_dict(state: dict, spec: ModelSpec, dtype=torch.float32,
                              device: torch.device | str = "cpu") -> Params:
    return glm4_moe.params_from_hf_state_dict(state, spec, dtype=dtype, device=device,
                                              attn_keys=_attn_keys(spec))


def params_to_hf_state_dict(params: Params, spec: ModelSpec) -> dict:
    return glm4_moe.params_to_hf_state_dict(params, spec, attn_keys=_attn_keys(spec))


def params_from_jax(np_params: dict, spec: ModelSpec, device: torch.device | str = "cpu",
                    dtype=torch.float32) -> Params:
    """The JAX package's training pytree of these families, fetched as numpy
    arrays (``jax.device_get``), as this package's params: the same layout
    (``dense_layers`` and ``layers`` stacks) and values. The selection-only
    ``router_correction_bias`` stays float32 whatever ``dtype`` is."""
    if spec.family not in FAMILIES:
        raise ValueError(f"mla_moe.params_from_jax: family {spec.family!r} is not an MLA family")

    def conv(x, name=""):
        if isinstance(x, dict):
            return {k: conv(v, k) for k, v in x.items()}
        dt = torch.float32 if name == "router_correction_bias" else dtype
        return torch.as_tensor(np.asarray(x, np.float32)).to(device=device, dtype=dt)

    return conv(np_params)

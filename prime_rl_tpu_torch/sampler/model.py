"""Sampler-side model functions: prefill and decode against the paged KV
cache (the port of the JAX package's ``sampler/model.py``: the qwen3/llama
block, gpt-oss, whose layers carry a sliding window, attention sinks,
q/k/v/o biases and routed experts, qwen3_moe, glm4_moe with its partial
rotary, noaux-tc routing, shared experts and dense first layers, the
gated-MoE families minimax_m2, afmoe and laguna with their layer-scope
qk-norm, attention-output gates and sandwich norms, the MLA families
deepseek_v3 and glm_moe_dsa over a latent cache, the GatedDeltaNet hybrid
qwen3_next and the Mamba-2 hybrid nemotron_h). Parameters use the serving
layout (``unstack_params``: a list of per-layer dicts).

Router replay: with ``collect_routing`` ``decode`` also returns the expert
ids each slot's input token was routed to, ``[S, NL_moe, K]`` in the order of
the MoE layers (the engine records them).

Where the JAX functions take donated pools and return new ones, these write
the per-layer pool tensors IN PLACE and return the same lists, so callers
read the same way in both packages.

Hybrid (``gdn_pattern``): a GatedDeltaNet ("L") layer has no KV pages (its
pool entries are None) and carries a slot's conv window [conv_dim, K] and
fast-weight state [Hv, Dk, Dv] f32 instead. ``prefill`` then returns a fifth
element, the per-layer (conv_row, state_row) at the prompt's length (None
for an attention layer), as the JAX function does; ``prefill_chunk`` takes
``r_rows`` at its offset and returns them advanced; ``decode`` takes the
engine's ``RecurrentPool`` lists ``r_conv``/``r_state`` and advances them in
place (JAX returns new ones). Their math is ``models/qwen3_next``'s, in
plain PyTorch as it is XLA in the JAX package. Nemotron-H (``layer_pattern``)
likewise: a Mamba-2 ("M") layer carries a conv window [conv_dim, K] and an
SSM state [H, P, N] f32 (``ops/mamba.py``'s math; the serving SSD takes no
segment ids, so a padded tail neither decays nor resets the state it
returns), its attention ("*") layers page their K/V, and its "-" and "E"
layers hold nothing.

MLA (``kv_lora_rank > 0``): the pool holds one latent row of ``kv_lora_rank
+ qk_rope_head_dim`` a token, shared by every head; for DSA the V pool holds
the indexer keys. The prefill runs the training attention block
(``models/mla_moe.mla_attention``) and pages the latent rows (and indexer
keys); decode and chunked prefill attend with the absorbed query over the
gathered latent history, DSA masked to the indexer's exact top-k (ties
broken as ``jax.lax.top_k`` breaks them: lower index first).

Kernels on this path (for CUDA tensors; CPU tensors take the plain versions):
- prefill attention: K1 ``ops/flash_attention.py`` through ``ops.attention``
  (banded for a windowed layer, with the layer's sinks; Nemotron-H's "*"
  layers without rope); for DSA, K5a
  ``ops/sparse_mla_kernel.py`` through ``mla_attention``;
- decode q/k/v preparation: K3 ``ops/decode_qkv.py``, where the JAX package
  takes its kernel: not for a layer-scope qk-norm or a gated layer, whose
  q/k/v are plain PyTorch on the card as they are XLA on the TPU;
- decode attention + KV append: K4 ``ops/decode_attention.py`` (window and
  sinks likewise; Nemotron-H's "*" layers, whose q/k/v are plain PyTorch, as
  the JAX decode never sends them to K3).
Chunked prefill attention (``_chunk_attention_xla``), MLA decode and chunked
prefill, the GatedDeltaNet and Mamba-2 layers and the MoE layers
(``ops/moe.py``) are plain PyTorch, as they are XLA in the JAX package.

Multi-LoRA (the engine's bank, ``lp["lora"]``): the prefill, the chunk and
decode take ``adapter_idx``, the bank row of the prompt or of each slot, and
add ``_lora_delta`` to q, k, v, o, gate, up and down of the dense paths, as
the JAX sampler does (plain PyTorch, as it is XLA there); with a bank K3
never runs (``takes_k3``).

Vision (qwen3_vl, qwen3_vl_moe, and qwen3_next_vl, whose recurrent rows an
image prefill returns as a text one does): ``prefill`` takes ``mm``, the
tower's merged embeddings and DeepStack features (the engine runs the tower, plain
PyTorch on the card as it is XLA on the TPU), the image slots and the
per-frequency mRoPE positions; the embeddings replace the tokens' at the
slots, and after each of the first ``n_ds`` layers the matching feature map
is added there. ``decode`` takes ``pos_delta``, each slot's rope-position
offset (``lengths + pos_delta`` rotates q and k, in K3 too; the cache rows
stay indexed by ``lengths``).

Int8 weight-only serving (``quantize_params``): the projections of
``_QUANT_TARGETS`` and an untied head become ``{"q8", "scale"}`` records,
and every product with one (``_mm``, ``ops/layers.weight_mm``, the head in
``logits_from_hidden``) casts the int8 weight to the compute dtype and
scales the result, as the JAX package does; a layer with int8 q/k/v
prepares them in plain PyTorch, never in K3 (``takes_k3``).
"""

from __future__ import annotations

import torch

from prime_rl_tpu_torch.models.base import ModelSpec
from prime_rl_tpu_torch.models.mla_moe import mla_absorbed_qkv, mla_attention, mla_indexer_qk
from prime_rl_tpu_torch.models.nemotron_h import STACKS as NEMOTRON_STACKS
from prime_rl_tpu_torch.models.nemotron_h import bare_qkv, latent_moe, relu2
from prime_rl_tpu_torch.models.qwen3_next import gdn_heads, gdn_inputs, gdn_output
from prime_rl_tpu_torch.models.qwen3 import (
    apply_attn_gate,
    get_lm_head,
    layer_rope_frequencies,
    layer_windows_list,
    post_attn,
    post_mlp,
    rope_setup,
)
from prime_rl_tpu_torch.ops.attention import attention
from prime_rl_tpu_torch.ops.decode_attention import (
    decode_attention_xla as _decode_attention_xla,
    decode_paged_attention,
    decode_paged_attention_reference,
    write_tokens as _write_tokens,
)
from prime_rl_tpu_torch.ops.decode_qkv import decode_qkv_prep
from prime_rl_tpu_torch.ops.gated_delta import chunk_gated_delta_rule, recurrent_gated_delta_rule
from prime_rl_tpu_torch.ops.layers import apply_rope, rms_norm, rope_frequencies, swiglu, weight_mm
from prime_rl_tpu_torch.ops.mamba import causal_conv1d, gated_rms_norm, split_in_proj, ssd_chunked
from prime_rl_tpu_torch.ops.moe import moe_mlp
from prime_rl_tpu_torch.sampler.cache import RECURRENT_KINDS, layer_kinds

Params = dict


SERVED_FAMILIES = ("qwen3", "llama", "gpt_oss", "qwen3_moe", "glm4_moe", "minimax_m2", "afmoe",
                   "laguna", "deepseek_v3", "glm_moe_dsa", "qwen3_next", "nemotron_h", "qwen3_vl",
                   "qwen3_vl_moe", "qwen3_next_vl")
VISION_FAMILIES = ("qwen3_vl", "qwen3_vl_moe", "qwen3_next_vl")


def check_supported(spec: ModelSpec) -> None:
    """Raise ``NotImplementedError`` for any feature outside the serving path
    ported so far (``SERVED_FAMILIES``): a vision tower on another family."""
    missing = []
    if spec.family not in SERVED_FAMILIES:
        missing.append(f"family {spec.family!r}")
    if spec.vision is not None and spec.family not in VISION_FAMILIES:
        missing.append(f"vision inputs on {spec.family!r}")
    if missing:
        raise NotImplementedError("not ported yet: " + ", ".join(missing)
                                  + f" (served: {', '.join(SERVED_FAMILIES)})")


_mm = weight_mm  # a raw weight or an int8 weight-only record (``quantize_params``)


def _lora_delta(x, lora: dict | None, name: str, idx):
    """The multi-LoRA delta of projection ``name``. ``lora`` (``lp["lora"]``):
    this layer's bank, ``{t}_a`` [in, NA, r] and ``{t}_b`` [NA, r, out] (row 0
    the zero adapter), and its ``scale``. ``idx``: one bank row (a 0-dim
    tensor: a prefill's), or the decode step's pick ([S, NA * r],
    ``lora_pick``: each slot's row as a mask over the bank's columns, times
    the scale). x: [B, T, in] -> [B, T, out], or None without a bank or an
    adapter on ``name``.

    The JAX function gathers each slot's A and B (``a[idx]``): at 64 slots of
    Qwen3-0.6B's rank-16 adapters that is about 1.3 GB copied a decode step.
    Here x·A runs over every bank row in one product ([S·T, in] by the
    bank's [in, NA·r], a view), the pick keeps each slot's own r columns,
    and the kept columns go through every row's B in a second product
    ([NA·r, out], a view): the same function (the other rows add exact
    zeros), four launches a projection, no per-slot copy of a weight and no
    read back to the host (a CUDA graph can hold it)."""
    if lora is None or f"{name}_a" not in lora or idx is None:
        return None
    a, b_ = lora[f"{name}_a"], lora[f"{name}_b"]
    if idx.dim() == 0:
        row = idx.reshape(1).long()
        delta = (x @ a.index_select(1, row)[:, 0].to(x.dtype)) @ b_.index_select(0, row)[0].to(
            x.dtype)
        return delta * lora["scale"]
    din, na, r = a.shape
    xa = (x @ a.reshape(din, na * r).to(x.dtype)) * idx[:, None, :]
    return xa @ b_.reshape(na * r, -1).to(x.dtype)


def lora_pick(params: Params, adapter_idx: torch.Tensor, dtype) -> torch.Tensor | None:
    """The decode step's bank pick from each slot's bank row ``adapter_idx``
    [S]: [S, NA * r] in ``dtype``, the bank's scale at the r columns of the
    slot's row and 0 elsewhere (None without a bank). Made once a step, by a
    comparison (``one_hot``'s CUDA form reads the ids' range back)."""
    bank = next((lp["lora"] for lp in params["layers"] if "lora" in lp), None)
    if bank is None:
        return None
    _, na, r = next(v for k, v in bank.items() if k.endswith("_a")).shape
    keep = adapter_idx.long()[:, None] == torch.arange(na, device=adapter_idx.device)[None, :]
    return keep.repeat_interleave(r, dim=1).to(dtype) * bank["scale"]


def _mm_l(x, w, lora, name, idx):
    """``_mm`` plus the multi-LoRA delta of ``name`` for the rows ``idx``."""
    out = _mm(x, w)
    d = _lora_delta(x, lora, name, idx)
    return out if d is None else out + d


def _qkv(x, lp, spec, positions, inv_freq, rope_scaling: float = 1.0, adapter_idx=None):
    """Shared q/k/v projection (+ optional biases + multi-LoRA) + qk-norm
    (per head, or over the flat width of the layer before the head reshape)
    + rope. x: [B, T, D]."""
    b, t, _ = x.shape
    lora = lp.get("lora")
    qf = _mm_l(x, lp["q"], lora, "q", adapter_idx)
    kf = _mm_l(x, lp["k"], lora, "k", adapter_idx)
    if spec.qk_norm and spec.qk_norm_scope == "layer":
        qf = rms_norm(qf, lp["q_norm"], spec.rms_eps)
        kf = rms_norm(kf, lp["k_norm"], spec.rms_eps)
    q = qf.reshape(b, t, spec.num_heads, spec.head_dim)
    k = kf.reshape(b, t, spec.num_kv_heads, spec.head_dim)
    v = _mm_l(x, lp["v"], lora, "v", adapter_idx).reshape(b, t, spec.num_kv_heads, spec.head_dim)
    if lp.get("q_bias") is not None:
        q = q + lp["q_bias"].to(q.dtype).reshape(1, 1, spec.num_heads, spec.head_dim)
        k = k + lp["k_bias"].to(k.dtype).reshape(1, 1, spec.num_kv_heads, spec.head_dim)
        v = v + lp["v_bias"].to(v.dtype).reshape(1, 1, spec.num_kv_heads, spec.head_dim)
    if spec.qk_norm and spec.qk_norm_scope != "layer":
        q = rms_norm(q, lp["q_norm"], spec.rms_eps)
        k = rms_norm(k, lp["k_norm"], spec.rms_eps)
    q = apply_rope(q, positions, inv_freq, rope_scaling)
    k = apply_rope(k, positions, inv_freq, rope_scaling)
    return q, k, v


def _mlp(x, lp, spec, routed: list | None = None, adapter_idx=None):
    """Dense SwiGLU or the routed experts (plus the shared expert where the
    layer has one), decided per layer (``"router"`` in the layer's dict), so
    glm4_moe's dense first layers take the dense path. x: [B, T, D].
    ``routed``: a list that a MoE layer appends its expert ids [B*T, K] to
    (router replay). ``adapter_idx``: the multi-LoRA bank rows of the dense
    path (the bank serves no expert, as in the JAX package)."""
    if "router" in lp:
        b, t, d = x.shape
        xf = x.reshape(b * t, d)
        out, routing = moe_mlp(
            xf, lp["router"],
            lp["expert_gate"], lp["expert_up"], lp["expert_down"],
            spec.num_experts_per_tok, spec.norm_topk_prob,
            router_b=lp.get("router_bias"),
            b_gate=lp.get("expert_gate_bias"), b_up=lp.get("expert_up_bias"),
            b_down=lp.get("expert_down_bias"),
            softmax_topk=spec.router_softmax_topk,
            activation_alpha=spec.swiglu_alpha, activation_limit=spec.swiglu_limit,
            sigmoid_noaux=spec.router_sigmoid,
            correction_bias=lp.get("router_correction_bias"),
            n_group=spec.n_group, topk_group=spec.topk_group,
            routed_scaling=spec.routed_scaling_factor,
        )
        if "shared_gate" in lp:
            shared = _mm(swiglu(_mm(xf, lp["shared_gate"]), _mm(xf, lp["shared_up"])),
                         lp["shared_down"])
            if "shared_expert_gate_w" in lp:  # qwen3_next's scalar sigmoid gate
                shared = torch.sigmoid(_mm(xf, lp["shared_expert_gate_w"])) * shared
            out = out + shared
        if routed is not None:
            routed.append(routing.expert_ids)
        return post_mlp(out.reshape(b, t, d), lp, spec)
    lora = lp.get("lora")
    h = swiglu(_mm_l(x, lp["gate"], lora, "gate", adapter_idx),
               _mm_l(x, lp["up"], lora, "up", adapter_idx))
    return post_mlp(_mm_l(h, lp["down"], lora, "down", adapter_idx), lp, spec)


def _stack_routing(routed: list, lead: tuple[int, ...]) -> torch.Tensor:
    """Per-MoE-layer expert ids [N, K] -> int32 [*lead, NL_moe, K] (N =
    prod(lead)); [*lead, 0, 0] for a model without MoE layers."""
    if not routed:
        return torch.zeros((*lead, 0, 0), dtype=torch.int32)
    return torch.stack(routed, dim=1).reshape(*lead, len(routed), routed[0].shape[-1])


def _obias(lp: dict, dtype):
    b = lp.get("o_bias")
    return 0.0 if b is None else b.to(dtype)


def _cast_layer(lp: dict, dtype) -> dict:
    return {k: (v if isinstance(v, dict) else (v.to(dtype) if v.dim() >= 2 else v))
            for k, v in lp.items()}


_QUANT_TARGETS = (
    "q", "k", "v", "o", "gate", "up", "down",
    # MLA latent projections (kv_b stays raw: the absorbed attention reshapes
    # it per head)
    "q_a", "q_b", "kv_a",
    # GDN / Mamba mixer projections
    "in_q", "in_k", "in_v", "in_z", "in_proj", "out_proj",
    # attention-output gates / shared experts
    "attn_gate", "shared_gate", "shared_up", "shared_down",
)


def quantize_params(params: Params, spec: ModelSpec) -> Params:
    """int8 weight-only quantization (per output channel, symmetric) of the
    serving params (the serving layout: ``unstack_params``): each weight of
    ``_QUANT_TARGETS`` becomes ``{"q8": int8 [in, out], "scale": f32
    [out]}``, ``scale = max(|w|, axis 0) / 127`` (at least 1e-8 / 127), q8
    = round-half-even(w / scale) clipped to +-127, as the JAX function
    computes it (the float32 division, not a product with 1 / scale, so
    the bits agree). Norms, the router, MoE experts and ``kv_b`` stay raw;
    an untied ``lm_head`` quantizes too."""

    def quant(w: torch.Tensor) -> dict:
        wf = w.float()
        scale = wf.abs().amax(dim=0).clamp_min(1e-8) / 127.0
        q8 = torch.round(wf / scale).clamp(-127, 127).to(torch.int8)
        return {"q8": q8, "scale": scale}

    out = dict(params)
    out["layers"] = [
        {k: (quant(v) if k in _QUANT_TARGETS and not isinstance(v, dict) else v)
         for k, v in lp.items()}
        for lp in params["layers"]
    ]
    if "lm_head" in params:
        out["lm_head"] = quant(params["lm_head"])
    return out


def _rope(spec: ModelSpec, device) -> tuple[torch.Tensor, float]:
    return rope_setup(spec, device=device)


def unstack_params(params: Params, spec: ModelSpec) -> Params:
    """Training layout (stacked [NL, ...] layers) -> serving layout (a list
    of per-layer dicts of views: no tensor is copied). The serving forward
    unrolls the layer loop so each layer's KV tensors are written in place.
    glm4_moe's dense first layers (``dense_layers``) come first, in order;
    qwen3_next interleaves its ``lin_layers`` / ``attn_layers`` stacks by the
    ``gdn_pattern``, nemotron_h its four stacks by the ``layer_pattern``; a
    VLM's ``"vision"`` tower is kept as it is (the engine runs it)."""
    check_supported(spec)
    if spec.layer_pattern:
        rank = dict.fromkeys(NEMOTRON_STACKS, 0)
        layers = []
        for ch in spec.layer_pattern:
            layers.append({k: v[rank[ch]] for k, v in params[NEMOTRON_STACKS[ch]].items()})
            rank[ch] += 1
        out = {k: v for k, v in params.items() if k not in NEMOTRON_STACKS.values()}
        out["layers"] = layers
        return out
    if spec.gdn_pattern:
        rank = {"L": 0, "A": 0}
        layers = []
        for ch in spec.gdn_pattern:
            stack = params["lin_layers" if ch == "L" else "attn_layers"]
            layers.append({k: v[rank[ch]] for k, v in stack.items()})
            rank[ch] += 1
        out = {k: v for k, v in params.items() if k not in ("lin_layers", "attn_layers")}
        out["layers"] = layers
        return out
    dense = params.get("dense_layers")
    k_dense = 0 if dense is None else next(iter(dense.values())).shape[0]
    out = {k: v for k, v in params.items() if k not in ("layers", "dense_layers")}
    out["layers"] = ([{k: v[l] for k, v in dense.items()} for l in range(k_dense)]
                     + [{k: v[l] for k, v in params["layers"].items()}
                        for l in range(spec.num_layers - k_dense)])
    return out


def _mla_freqs(spec: ModelSpec, device) -> torch.Tensor:
    return rope_frequencies(spec.qk_rope_head_dim, spec.rope_theta, device=device)


def _matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with a float32 result from operands of one dtype (the JAX
    ``preferred_element_type=float32`` product). a: [..., M, K]; b: [K, N],
    shared by every row of a, or [R, K, N] against a [R, M, K]."""
    fused = a.is_cuda and a.dtype == torch.bfloat16
    if b.dim() == 2:
        a2 = a.reshape(-1, a.shape[-1])
        out = torch.mm(a2, b, out_dtype=torch.float32) if fused else a2.float() @ b.float()
        return out.reshape(*a.shape[:-1], b.shape[1])
    return torch.bmm(a, b, out_dtype=torch.float32) if fused else torch.bmm(a.float(), b.float())


def _mla_topk_mask(logits: torch.Tensor, topk: int) -> torch.Tensor:
    """[R, T] bool: each row's ``topk`` largest logits above -1e29, ties
    taken lower index first, as ``jax.lax.top_k`` takes them (relu-zeroed
    scores tie often; a threshold would over-select them)."""
    k_eff = min(topk, logits.shape[1])
    val, sel = torch.sort(logits, dim=-1, descending=True, stable=True)
    val, sel = val[:, :k_eff], sel[:, :k_eff]
    return torch.zeros_like(logits, dtype=torch.bool).scatter_(1, sel, val > -1e29)


def _mla_attend(q_abs, hist, mask, w_kv_b, lp, spec: ModelSpec, compute_dtype):
    """Absorbed attention of R queries over the latent history: q_abs
    [R, H, kvl+rope]; hist [T, kvl+rope] shared by the queries, or
    [R, T, kvl+rope] a query; mask [R, T]. The scores take bfloat16 operands
    and sum in float32, the softmax is float32. Returns the output projection
    [R, D]."""
    kvl = spec.kv_lora_rank
    r = q_abs.shape[0]
    scale = (spec.qk_nope_head_dim + spec.qk_rope_head_dim) ** -0.5
    bf = torch.bfloat16
    sc = _matmul_f32(q_abs.to(bf), hist.to(bf).transpose(-1, -2)) * scale  # [R, H, T]
    p = torch.softmax(torch.where(mask[:, None, :], sc, -1e30), dim=-1)
    out_lat = _matmul_f32(p.to(hist.dtype), hist[..., :kvl])  # [R, H, kvl]
    v_out = torch.einsum("rhk,khv->rhv", out_lat.to(compute_dtype),
                         w_kv_b[..., spec.qk_nope_head_dim:])
    return _mm(v_out.reshape(r, spec.num_heads * spec.v_head_dim), lp["o"])


def _mla_index_logits(q_idx, w_idx, ihist, mask):
    """DSA indexer scores: q_idx [R, Hi, Di], w_idx [R, Hi], the indexer keys
    ihist [T, Di] (shared) or [R, T, Di] -> [R, T] float32, the sum over
    heads of w * relu(q . k), -1e30 where ``mask`` is False."""
    bf = torch.bfloat16
    lg = _matmul_f32(q_idx.to(bf), ihist.to(bf).transpose(-1, -2))  # [R, Hi, T]
    lg = (w_idx[:, :, None].float() * lg.clamp_min(0.0)).sum(dim=1)
    return torch.where(mask, lg, -1e30)


def _mla_prefill_block(h, lp, spec: ModelSpec, seg, positions, inv_freq):
    """MLA serving prefill over one padded sequence [1, L, D]: the training
    attention block (the DSA indexer included, so the selection is exact;
    K5a on the card), plus the latent rows, and for DSA the indexer-key rows,
    to page into the cache. Returns (h, latent [1, L, kvl+rope], indexer keys
    [1, L, Di] | None)."""
    x = rms_norm(h, lp["attn_norm"], spec.rms_eps)
    q_lat, _, latent, _ = mla_absorbed_qkv(x, lp, spec, positions, inv_freq)
    idx_rows = None
    if spec.index_topk > 0:
        _, _, idx_rows = mla_indexer_qk(x, lp, spec, positions, inv_freq, q_lat)
    h = mla_attention(h, lp, spec, seg, positions, inv_freq)
    return h, latent, idx_rows


def _mla_chunk_block(h, lp, spec: ModelSpec, k_l, v_l, positions, inv_freq, n_pages,
                     pages_chunk, page_row, valid_hi, compute_dtype):
    """One chunk of an MLA prefill [1, C, D]: its latent rows (and DSA's
    indexer keys) paged, then each chunk query attends the slot's whole
    latent history, DSA masked to the query's own top-k over it. Exact, so
    prefix caching and chunked prefill stay on. Returns h after attention."""
    page_size = k_l.shape[2]
    x = rms_norm(h, lp["attn_norm"], spec.rms_eps)
    q_lat, q_abs, latent, w_kv_b = mla_absorbed_qkv(x, lp, spec, positions, inv_freq)
    _write_pages(k_l, latent[0].reshape(1, n_pages, page_size, -1), pages_chunk)
    row = page_row.long()
    t = row.shape[0] * page_size
    hist = k_l[0, row].reshape(t, -1)
    q_pos = positions[0]
    pos_k = torch.arange(t, device=h.device)[None, :]
    mask = (pos_k <= q_pos[:, None]) & (pos_k < valid_hi)  # [C, T]
    if spec.index_topk > 0 and v_l is not None:
        q_idx, w_idx, k_idx = mla_indexer_qk(x, lp, spec, positions, inv_freq, q_lat)
        _write_pages(v_l, k_idx[0].reshape(1, n_pages, page_size, -1), pages_chunk)
        ihist = v_l[0, row].reshape(t, -1)
        lg = _mla_index_logits(q_idx[0], w_idx[0], ihist, mask)
        mask = mask & _mla_topk_mask(lg, spec.index_topk)
    return h + _mla_attend(q_abs[0], hist, mask, w_kv_b, lp, spec, compute_dtype)[None]


def _mla_decode_block(h, lp, spec: ModelSpec, k_l, v_l, lengths, page_table, positions,
                      inv_freq, flat_idx, compute_dtype):
    """MLA decode step for all S slots against the latent cache: the new
    token's latent row (and DSA's indexer key) written at ``flat_idx``, then
    the absorbed query attends the slot's latent history: all of it
    (deepseek_v3), or the indexer's exact top-k over it (DSA). ``lengths``
    INCLUDE the new token. h: [S, 1, D]; k_l [1, NP, PS, kvl+rope]; v_l
    [1, NP, PS, Di] | None. Returns h after attention."""
    s = h.shape[0]
    x = rms_norm(h, lp["attn_norm"], spec.rms_eps)
    q_lat, q_abs, latent_t, w_kv_b = mla_absorbed_qkv(x, lp, spec, positions, inv_freq)
    np_, ps = k_l.shape[1], k_l.shape[2]
    flat = k_l[0].view(np_ * ps, -1)
    flat[flat_idx] = latent_t[:, 0].to(flat.dtype)
    idx = (page_table.long()[:, :, None] * ps
           + torch.arange(ps, device=h.device)[None, None, :]).reshape(s, -1)
    hist = flat[idx]  # [S, T, kvl+rope]
    mask = torch.arange(idx.shape[1], device=h.device)[None, :] < lengths[:, None]
    if spec.index_topk > 0 and v_l is not None:
        q_idx, w_idx, k_idx_t = mla_indexer_qk(x, lp, spec, positions, inv_freq, q_lat)
        iflat = v_l[0].view(np_ * ps, -1)
        iflat[flat_idx] = k_idx_t[:, 0].to(iflat.dtype)
        lg = _mla_index_logits(q_idx[:, 0], w_idx[:, 0], iflat[idx], mask)
        mask = mask & _mla_topk_mask(lg, spec.index_topk)
    return h + _mla_attend(q_abs[:, 0], hist, mask, w_kv_b, lp, spec, compute_dtype)[:, None]


def _gdn_prefill_mixer(h, lp, spec: ModelSpec, seg, length: int, compute_dtype,
                       precision: str = "highest"):
    """GatedDeltaNet serving prefill over one padded sequence [1, L, D]
    (``models/qwen3_next.gdn_mixer``'s math). Returns (h, conv_row
    [conv_dim, K] the raw conv inputs at positions [length - K, length),
    state_row [Hv, Dk, Dv] f32 the fast-weight state at ``length``)."""
    kk = spec.gdn_conv_kernel
    x = rms_norm(h, lp["attn_norm"], spec.rms_eps)
    raw, beta, g, z = gdn_inputs(x, lp, spec)
    qkv = torch.nn.functional.silu(causal_conv1d(raw, lp["conv_w"], None, seg))
    q, k, v = gdn_heads(qkv, spec)
    core, state = chunk_gated_delta_rule(q, k, v, g, beta, segment_ids=seg, precision=precision)
    h = gdn_output(h, core, z, lp, spec, compute_dtype)
    padded = torch.nn.functional.pad(raw[0], (0, 0, kk, 0))  # [K + L, conv_dim]
    return h, padded[length:length + kk].T.to(compute_dtype), state[0]


def _gdn_decode_mixer(h, lp, spec: ModelSpec, conv_st, rec_st, compute_dtype):
    """GatedDeltaNet decode step for all S slots. h [S, 1, D]; conv_st
    [S, conv_dim, K] the rolling raw inputs; rec_st [S, Hv, Dk, Dv] f32.
    Returns (h, conv_st', rec_st'), new tensors."""
    x = rms_norm(h, lp["attn_norm"], spec.rms_eps)[:, 0]  # [S, D]
    raw, beta, g, z = gdn_inputs(x, lp, spec)
    conv_st = torch.cat([conv_st[..., 1:], raw.to(conv_st.dtype)[..., None]], dim=-1)
    qkv = torch.nn.functional.silu((conv_st.float() * lp["conv_w"].float()[None]).sum(-1))
    q, k, v = gdn_heads(qkv.to(compute_dtype), spec)
    core, rec_st = recurrent_gated_delta_rule(q, k, v, g, beta, rec_st)
    return gdn_output(h, core[:, None], z[:, None], lp, spec, compute_dtype), conv_st, rec_st


def _gdn_chunk_mixer(h, lp, spec: ModelSpec, seg, valid: int, conv_row, state_row,
                     compute_dtype, precision: str = "highest"):
    """GatedDeltaNet chunk of an incremental serving prefill. h [1, C, D];
    ``conv_row`` [conv_dim, K] the raw conv inputs at positions [off - K,
    off); ``state_row`` [Hv, Dk, Dv] f32 the state at ``off``. Returns (h,
    conv_row', state_row') advanced to off + valid. The conv reads the
    carried window (zeros at a fresh start add nothing) and the scan starts
    from the carried state with the reset at position 0 suppressed, so a
    fresh chunk and a continued one run the same code."""
    b, c, _ = h.shape
    kk = spec.gdn_conv_kernel
    x = rms_norm(h, lp["attn_norm"], spec.rms_eps)
    raw, beta, g, z = gdn_inputs(x, lp, spec)
    raw_ext = torch.cat([conv_row.T[None, 1:].to(raw.dtype), raw], dim=1)
    seg_ext = torch.cat([torch.ones((b, kk - 1), dtype=seg.dtype, device=seg.device), seg], 1)
    qkv = torch.nn.functional.silu(causal_conv1d(raw_ext, lp["conv_w"], None, seg_ext))[:, kk - 1:]
    q, k, v = gdn_heads(qkv, spec)
    core, state = chunk_gated_delta_rule(
        q, k, v, g, beta, segment_ids=seg, initial_state=state_row[None].float(),
        prev_seg_tail=torch.ones((b,), dtype=seg.dtype, device=seg.device), precision=precision)
    h = gdn_output(h, core, z, lp, spec, compute_dtype)
    # the new window: raw_ext row valid - 1 is position off + valid - K
    return h, raw_ext[0, valid - 1:valid - 1 + kk].T.to(conv_row.dtype), state[0]


def _mamba_proj(x, lp) -> torch.Tensor:
    """in_proj of the normed x [..., D]: [gate | x B C | dt] [..., inter +
    conv_dim + H]."""
    proj = _mm(x, lp["in_proj"])
    if lp.get("in_proj_bias") is not None:
        proj = proj + lp["in_proj_bias"]
    return proj


def _mamba_ssd(h, lp, spec: ModelSpec, proj, seg, raw_ext, state_row=None):
    """The Mamba-2 mixer of a serving prefill or chunk over h [1, C, D]
    (``proj`` its in_proj): the conv over ``raw_ext`` (the carried window's
    K - 1 rows before the chunk's raw inputs, or the raw inputs alone), the
    SSD from ``state_row`` (zeros when None) with dt zeroed at the padding,
    so that a pad neither writes nor decays. No segment ids reach the SSD: a
    padded tail must not reset the state that leaves it (the JAX serving
    mixers pass them, and the reset at the first pad zeroes the state they
    return: see ROADMAP.md Queue 3). Returns (h, the state [H, P, N] f32 at
    the last true token)."""
    b, c, _ = h.shape
    nh, p, g = spec.mamba_num_heads, spec.mamba_head_dim, spec.mamba_n_groups
    inter, gn = nh * p, spec.mamba_n_groups * spec.mamba_state_size
    gate, _, dt = split_in_proj(proj, lp, nh, p, spec.mamba_state_size, g)
    dt = dt * (seg != 0)[..., None]
    pre = raw_ext.shape[1] - c
    seg_ext = torch.cat([torch.ones((b, pre), dtype=seg.dtype, device=seg.device), seg], 1)
    xbc = torch.nn.functional.silu(
        causal_conv1d(raw_ext, lp["conv_w"], lp.get("conv_b"), seg_ext))[:, pre:]
    y, state = ssd_chunked(
        xbc[..., :inter].reshape(b, c, nh, p), dt, lp["A_log"],
        xbc[..., inter:inter + gn].reshape(b, c, g, -1), xbc[..., inter + gn:].reshape(b, c, g, -1),
        lp["D"], chunk_size=spec.mamba_chunk_size,
        initial_state=None if state_row is None else state_row[None].float(),
        return_final_state=True)
    y = gated_rms_norm(y.reshape(b, c, inter).to(h.dtype), gate, lp["ssm_norm"])
    return h + _mm(y, lp["out_proj"]), state[0]


def _mamba_prefill_mixer(h, lp, spec: ModelSpec, seg, length: int, compute_dtype):
    """Mamba-2 serving prefill over one padded sequence [1, L, D]
    (``ops/mamba.mamba2_mixer``'s math). Returns (h, conv_row [conv_dim, K]
    the raw conv inputs at positions [length - K, length), state_row [H, P,
    N] f32 the SSM state at ``length``)."""
    kk, inter = spec.mamba_conv_kernel, spec.mamba_inter
    proj = _mamba_proj(rms_norm(h, lp["norm"], spec.rms_eps), lp)
    raw = proj[..., inter:inter + spec.mamba_conv_dim]
    h, state = _mamba_ssd(h, lp, spec, proj, seg, raw)
    padded = torch.nn.functional.pad(raw[0], (0, 0, kk, 0))  # [K + L, conv_dim]
    return h, padded[length:length + kk].T.to(compute_dtype), state


def _mamba_chunk_mixer(h, lp, spec: ModelSpec, seg, valid: int, conv_row, state_row,
                       compute_dtype):
    """Mamba-2 chunk of an incremental serving prefill (the continuation
    contract of ``_gdn_chunk_mixer``): ``conv_row`` [conv_dim, K] the raw
    conv inputs at [off - K, off), ``state_row`` [H, P, N] f32 the state at
    ``off``. Returns (h, conv_row', state_row') advanced to off + valid."""
    kk, inter = spec.mamba_conv_kernel, spec.mamba_inter
    proj = _mamba_proj(rms_norm(h, lp["norm"], spec.rms_eps), lp)
    raw = proj[..., inter:inter + spec.mamba_conv_dim]
    raw_ext = torch.cat([conv_row.T[None, 1:].to(raw.dtype), raw], dim=1)
    h, state = _mamba_ssd(h, lp, spec, proj, seg, raw_ext, state_row)
    return h, raw_ext[0, valid - 1:valid - 1 + kk].T.to(conv_row.dtype), state


def _mamba_decode_mixer(h, lp, spec: ModelSpec, conv_st, ssm_st, compute_dtype):
    """Mamba-2 decode step for all S slots (HF Mamba2Mixer's cached step): h
    [S, 1, D]; conv_st [S, conv_dim, K]; ssm_st [S, H, P, N] f32. Returns (h,
    conv_st', ssm_st'), new tensors."""
    s = h.shape[0]
    nh, p = spec.mamba_num_heads, spec.mamba_head_dim
    g, n = spec.mamba_n_groups, spec.mamba_state_size
    inter, gn = nh * p, g * n
    proj = _mamba_proj(rms_norm(h, lp["norm"], spec.rms_eps)[:, 0], lp)  # [S, ...]
    gate, raw_t, dt = split_in_proj(proj, lp, nh, p, n, g)  # dt [S, H] f32
    conv_st = torch.cat([conv_st[..., 1:], raw_t.to(conv_st.dtype)[..., None]], dim=-1)
    xbc = (conv_st.float() * lp["conv_w"].float()[None]).sum(-1)
    if lp.get("conv_b") is not None:
        xbc = xbc + lp["conv_b"].float()
    xbc = torch.nn.functional.silu(xbc)
    xs = xbc[:, :inter].reshape(s, nh, p)
    b_in = xbc[:, inter:inter + gn].reshape(s, g, n).repeat_interleave(nh // g, dim=1)
    c_in = xbc[:, inter + gn:].reshape(s, g, n).repeat_interleave(nh // g, dim=1)
    decay = torch.exp(-torch.exp(lp["A_log"].float()) * dt)  # [S, H]
    ssm_st = ssm_st * decay[..., None, None] + (xs * dt[..., None])[..., :, None] * b_in[..., None, :]
    y = torch.einsum("shpn,shn->shp", ssm_st, c_in) + lp["D"].float()[None, :, None] * xs
    y = gated_rms_norm(y.reshape(s, inter).to(compute_dtype), gate, lp["ssm_norm"])
    return h + _mm(y, lp["out_proj"])[:, None], conv_st, ssm_st


def _bare_attn(h, lp, spec: ModelSpec):
    """Nemotron-H's attention q/k/v (no rope, no qk-norm; the "norm" key) of
    h [B, T, D]: (q [B, T, NH, HD], k, v [B, T, NKV, HD])."""
    return bare_qkv(rms_norm(h, lp["norm"], spec.rms_eps), lp, spec)


def _tokenwise_block(h, lp, spec: ModelSpec, routed: list | None = None):
    """Nemotron-H's cache-free layers with their residual: "-" the relu^2
    MLP, "E" LatentMoE (``models/nemotron_h``'s math), any leading shape.
    ``routed``: a list a LatentMoE layer appends its expert ids to."""
    x = rms_norm(h, lp["norm"], spec.rms_eps)
    if "router" not in lp:
        return h + _mm(relu2(_mm(x, lp["up"])), lp["down"])
    out, routing = latent_moe(x, lp, spec)
    if routed is not None:
        routed.append(routing.expert_ids)
    return h + out


def _page_size(k_pool: list) -> int:
    return next(t.shape[2] for t in k_pool if t is not None)


def _write_pages(pool: torch.Tensor, new_pages: torch.Tensor, pages: torch.Tensor) -> torch.Tensor:
    """In-place page writes: pool [NKV, NP, PS, HD], new_pages [NKV, n, PS, HD]
    placed at page indices ``pages [n]``. Returns the (same) pool."""
    pool[:, pages.long()] = new_pages.to(pool.dtype)
    return pool


def _layer_kv_pages(k, n_pages, page_size, spec):
    """[B, L, NKV, HD] -> [NKV, B * n_pages, PS, HD] page blocks."""
    b = k.shape[0]
    return (k.permute(2, 0, 1, 3)
            .reshape(spec.num_kv_heads, b * n_pages, page_size, spec.head_dim))


def prefill(
    params: Params,  # serving layout (unstack_params)
    spec: ModelSpec,
    k_pool: list[torch.Tensor],  # NL x [NKV, NP, PS, HD]
    v_pool: list[torch.Tensor],
    input_ids: torch.Tensor,  # [1, Lpad] (bucketed)
    length: int,  # true prompt length
    pages: torch.Tensor,  # [Lpad // page_size]: this slot's pages
    *,
    compute_dtype=torch.bfloat16,
    want_prompt_logprobs: bool = False,
    gdn_precision: str = "highest",
    adapter_idx: torch.Tensor | None = None,  # 0-dim: the LoRA bank row (0 = none)
    mm: dict | None = None,
):
    """Returns (k_pool, v_pool, last_hidden [D], prompt_logprobs [Lpad]|None),
    the pools written in place, and for a hybrid spec a fifth element: the
    per-layer (conv_row, state_row) at ``length`` (None for an attention
    layer). ``prompt_logprobs[i] = logp(token_i | tokens_<i)``; position 0
    holds the uniform -log(V).

    ``mm`` (a VLM prompt; tensors on the device): vis_embed [R, D] the merged
    image embeddings, ds_feats [n_ds, R, D] the DeepStack feature maps,
    img_slot [1, Lpad] the row of each vision-token position (-1 elsewhere),
    positions [1, Lpad, rot//2] the per-frequency mRoPE positions."""
    _, lpad = input_ids.shape
    device = input_ids.device
    page_size = _page_size(k_pool)
    n_pages = lpad // page_size
    inv_freq, rope_scaling = _rope(spec, device)
    positions = torch.arange(lpad, device=device)[None, :]
    segment_ids = (positions < length).to(torch.int32)
    h = params["embed"].to(compute_dtype)[input_ids]
    img_slot = img_mask = None
    n_ds = 0
    if mm is not None:
        # the host-assigned slot (>= 0) gates the injection, never the token
        # id (see models/qwen3_vl.forward)
        img_slot = mm["img_slot"].long().clamp(min=0)
        img_mask = (mm["img_slot"] >= 0)[..., None]
        h = torch.where(img_mask, mm["vis_embed"].to(compute_dtype)[img_slot], h)
        positions = mm["positions"]  # [1, Lpad, rot//2] per frequency
        n_ds = mm["ds_feats"].shape[0]

    def deepstack(li, hh):
        # the li-th feature map at the image slots after layer li, whatever
        # the layer's kind (HF Qwen3VLTextModel._deepstack_process)
        if li >= n_ds:
            return hh
        return torch.where(img_mask, hh + mm["ds_feats"][li].to(compute_dtype)[img_slot], hh)

    r_rows = []
    for li, (lp, k_l, v_l, win, kind) in enumerate(zip(
            params["layers"], k_pool, v_pool, layer_windows_list(spec), layer_kinds(spec))):
        lp = _cast_layer(lp, compute_dtype)
        if kind == "L":
            # recurrent layer: no pages; the slot's rows for the decode pool
            h, conv_row, state_row = _gdn_prefill_mixer(h, lp, spec, segment_ids, int(length),
                                                        compute_dtype, gdn_precision)
            h = h + _mlp(rms_norm(h, lp["mlp_norm"], spec.rms_eps), lp, spec, None, adapter_idx)
            r_rows.append((conv_row, state_row))
            h = deepstack(li, h)
            continue
        if kind == "M":
            h, conv_row, state_row = _mamba_prefill_mixer(h, lp, spec, segment_ids, int(length),
                                                          compute_dtype)
            r_rows.append((conv_row, state_row))
            h = deepstack(li, h)
            continue
        r_rows.append(None)
        if kind in ("-", "E"):
            h = _tokenwise_block(h, lp, spec)
            h = deepstack(li, h)
            continue
        if kind == "*":
            # Nemotron-H's bare attention (K1 on the card), no MLP pairing
            q, k, v = _bare_attn(h, lp, spec)
            o = attention(q, k, v, segment_ids, causal=True)
            h = h + _mm(o.reshape(1, lpad, spec.q_dim), lp["o"])
            _write_pages(k_l, _layer_kv_pages(k, n_pages, page_size, spec), pages)
            _write_pages(v_l, _layer_kv_pages(v, n_pages, page_size, spec), pages)
            h = deepstack(li, h)
            continue
        if spec.kv_lora_rank > 0:
            # MLA: the training attention block (K5a for DSA on the card), the
            # latent rows (and DSA's indexer keys) paged into the pools
            h, latent, idx_rows = _mla_prefill_block(h, lp, spec, segment_ids, positions,
                                                     _mla_freqs(spec, device))
            h = h + _mlp(rms_norm(h, lp["mlp_norm"], spec.rms_eps), lp, spec, None, adapter_idx)
            _write_pages(k_l, latent[0].reshape(1, n_pages, page_size, -1), pages)
            if idx_rows is not None:
                _write_pages(v_l, idx_rows[0].reshape(1, n_pages, page_size, -1), pages)
            h = deepstack(li, h)
            continue
        x = rms_norm(h, lp["attn_norm"], spec.rms_eps)
        freqs = layer_rope_frequencies(spec, inv_freq, win)
        q, k, v = _qkv(x, lp, spec, positions, freqs, rope_scaling, adapter_idx)
        o = attention(q, k, v, segment_ids, causal=True, window=win, sinks=lp.get("sink"))
        o = apply_attn_gate(o, x, lp, spec)
        proj = _mm_l(o.reshape(1, lpad, spec.q_dim), lp["o"], lp.get("lora"), "o",
                     adapter_idx) + _obias(lp, h.dtype)
        h = h + post_attn(proj, lp, spec)
        h = h + _mlp(rms_norm(h, lp["mlp_norm"], spec.rms_eps), lp, spec, None, adapter_idx)
        _write_pages(k_l, _layer_kv_pages(k, n_pages, page_size, spec), pages)
        _write_pages(v_l, _layer_kv_pages(v, n_pages, page_size, spec), pages)
        h = deepstack(li, h)
    h = rms_norm(h, params["final_norm"], spec.rms_eps)
    last_hidden = h[0, max(int(length) - 1, 0)]
    prompt_logprobs = None
    if want_prompt_logprobs:
        lm_head = dense_lm_head(params, spec, compute_dtype)
        labels = torch.cat([input_ids[0, 1:], input_ids.new_zeros(1)]).long()
        rows = []
        for lo in range(0, lpad, 1024):
            logits = _softcap(_matmul_f32(h[0, lo:lo + 1024], lm_head), spec)
            lsm = torch.log_softmax(logits, dim=-1)
            rows.append(lsm.gather(-1, labels[lo:lo + 1024, None])[:, 0])
        lp_next = torch.cat(rows)
        first = torch.full((1,), -float(torch.log(torch.tensor(float(spec.vocab_size)))),
                           dtype=torch.float32, device=device)
        prompt_logprobs = torch.cat([first, lp_next[:-1]])
    if spec.gdn_pattern or spec.layer_pattern:
        return k_pool, v_pool, last_hidden, prompt_logprobs, r_rows
    return k_pool, v_pool, last_hidden, prompt_logprobs


def prefill_batch(
    params: Params,
    spec: ModelSpec,
    k_pool: list[torch.Tensor],
    v_pool: list[torch.Tensor],
    input_ids: torch.Tensor,  # [B, Lpad] (bucketed)
    lengths: torch.Tensor,  # [B] true prompt lengths
    pages: torch.Tensor,  # [B, Lpad // page_size] per-row page rows
    *,
    compute_dtype=torch.bfloat16,
    adapter_idx: torch.Tensor | None = None,  # 0-dim: one adapter for the batch
):
    """Batched prefill: B prompts through one pass. Rows are independent
    (per-row segment masking, per-row page writes); dummy rows (length 0,
    pages all null) are legal padding. Returns (k_pool, v_pool,
    last_hidden [B, D]), the pools written in place. MLA and hybrid prompts
    are prefilled one at a time (``prefill``), as the JAX engine does."""
    if spec.kv_lora_rank > 0 or spec.gdn_pattern or spec.layer_pattern:
        raise NotImplementedError("prefill_batch: MLA and hybrid prompts are prefilled one at "
                                  "a time")
    b, lpad = input_ids.shape
    device = input_ids.device
    page_size = k_pool[0].shape[2]
    n_pages = lpad // page_size
    inv_freq, rope_scaling = _rope(spec, device)
    positions = torch.arange(lpad, device=device)[None, :].expand(b, lpad)
    segment_ids = (positions < lengths.to(device)[:, None]).to(torch.int32)
    h = params["embed"].to(compute_dtype)[input_ids]
    flat_pages = pages.reshape(-1)
    for lp, k_l, v_l, win in zip(params["layers"], k_pool, v_pool, layer_windows_list(spec)):
        lp = _cast_layer(lp, compute_dtype)
        x = rms_norm(h, lp["attn_norm"], spec.rms_eps)
        freqs = layer_rope_frequencies(spec, inv_freq, win)
        q, k, v = _qkv(x, lp, spec, positions, freqs, rope_scaling, adapter_idx)
        o = attention(q, k, v, segment_ids, causal=True, window=win, sinks=lp.get("sink"))
        o = apply_attn_gate(o, x, lp, spec)
        proj = _mm_l(o.reshape(b, lpad, spec.q_dim), lp["o"], lp.get("lora"), "o",
                     adapter_idx) + _obias(lp, h.dtype)
        h = h + post_attn(proj, lp, spec)
        h = h + _mlp(rms_norm(h, lp["mlp_norm"], spec.rms_eps), lp, spec, None, adapter_idx)
        _write_pages(k_l, _layer_kv_pages(k, n_pages, page_size, spec), flat_pages)
        _write_pages(v_l, _layer_kv_pages(v, n_pages, page_size, spec), flat_pages)
    h = rms_norm(h, params["final_norm"], spec.rms_eps)
    idx = (lengths.to(device).long() - 1).clamp_min(0)
    last_hidden = h[torch.arange(b, device=device), idx]  # [B, D]
    return k_pool, v_pool, last_hidden


def _chunk_attention_xla(q, k_l, v_l, q_pos, page_row, valid_hi, window=0, sinks=None):
    """Chunk queries against the slot's full paged history (already written,
    including this chunk). q: [C, NH, HD]; page_row: [P] this slot's pages;
    q_pos: [C] global positions; valid_hi: highest valid global pos + 1.
    Causal over global positions (pos_k <= pos_q)."""
    c, nh, hd = q.shape
    nkv, _, ps, _ = k_l.shape
    p = page_row.shape[0]
    group = nh // nkv
    row = page_row.long()
    k_g = k_l[:, row].reshape(nkv, p * ps, hd).float()
    v_g = v_l[:, row].reshape(nkv, p * ps, hd).float()
    qf = q.reshape(c, nkv, group, hd).float()
    scores = torch.einsum("ckgd,ktd->ckgt", qf, k_g) * (hd ** -0.5)
    pos_k = torch.arange(p * ps, device=q.device)[None, :]  # flat index == position
    mask = (pos_k <= q_pos[:, None]) & (pos_k < valid_hi)
    if window and window > 0:
        mask = mask & (pos_k > (q_pos[:, None] - window))
    scores = torch.where(mask[:, None, None, :], scores, -1e30)
    if sinks is not None:
        sf = sinks.float().reshape(nkv, group)[None, :, :, None]
        m = torch.maximum(scores.amax(dim=-1, keepdim=True), sf)
        pexp = torch.exp(scores - m)
        probs = pexp / (pexp.sum(dim=-1, keepdim=True) + torch.exp(sf - m))
    else:
        probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("ckgt,ktd->ckgd", probs, v_g)
    return out.reshape(c, nh, hd)


def prefill_chunk(
    params: Params,
    spec: ModelSpec,
    k_pool: list[torch.Tensor],
    v_pool: list[torch.Tensor],
    input_ids: torch.Tensor,  # [1, C]: this chunk's tokens (C page-multiple)
    offset: int,  # global position of the chunk start (page-aligned)
    valid: int,  # true tokens in this chunk (<= C)
    pages_chunk: torch.Tensor,  # [C // page_size]: pages receiving this chunk's KV
    page_row: torch.Tensor,  # [P]: the slot's FULL page-table row
    *,
    compute_dtype=torch.bfloat16,
    r_rows: list | None = None,  # hybrid: per-layer (conv_row, state_row) at offset | None
    gdn_precision: str = "highest",
    adapter_idx: torch.Tensor | None = None,  # 0-dim: the LoRA bank row (0 = none)
):
    """One chunk of an incremental prefill: computes K/V for positions
    [offset, offset+C), writes them into the slot's pages, and attends over
    the whole cached history INCLUDING shared prefix-cache pages. Powers
    chunked prefill of long prompts and prefix-cache hits. Returns (k_pool,
    v_pool, last_hidden [D]) at local position valid-1. A hybrid model passes
    ``r_rows`` (zeros for a fresh start) and gets them back advanced to
    ``offset + valid`` as a fourth element: its recurrent layers continue
    exactly from the carried state."""
    _, c = input_ids.shape
    device = input_ids.device
    page_size = _page_size(k_pool)
    n_pages = c // page_size
    inv_freq, rope_scaling = _rope(spec, device)
    positions = offset + torch.arange(c, device=device)[None, :]  # [1, C]
    q_pos = positions[0]
    valid_hi = offset + valid
    seg = (torch.arange(c, device=device)[None, :] < valid).to(torch.int32)
    h = params["embed"].to(compute_dtype)[input_ids]
    kinds = layer_kinds(spec) if r_rows is not None else ["A"] * spec.num_layers
    r_out = []
    for li, (lp, k_l, v_l, win, kind) in enumerate(zip(params["layers"], k_pool, v_pool,
                                                       layer_windows_list(spec), kinds)):
        lp = _cast_layer(lp, compute_dtype)
        if kind == "L":
            h, conv_row, state_row = _gdn_chunk_mixer(h, lp, spec, seg, int(valid), *r_rows[li],
                                                      compute_dtype, gdn_precision)
            h = h + _mlp(rms_norm(h, lp["mlp_norm"], spec.rms_eps), lp, spec, None, adapter_idx)
            r_out.append((conv_row, state_row))
            continue
        if kind == "M":
            h, conv_row, state_row = _mamba_chunk_mixer(h, lp, spec, seg, int(valid),
                                                        *r_rows[li], compute_dtype)
            r_out.append((conv_row, state_row))
            continue
        r_out.append(None)
        if kind in ("-", "E"):
            h = _tokenwise_block(h, lp, spec)
            continue
        if kind == "*":
            # Nemotron-H's bare attention over the paged history (plain
            # PyTorch, as XLA in JAX)
            q, k, v = _bare_attn(h, lp, spec)
            _write_pages(k_l, _layer_kv_pages(k, n_pages, page_size, spec), pages_chunk)
            _write_pages(v_l, _layer_kv_pages(v, n_pages, page_size, spec), pages_chunk)
            o = _chunk_attention_xla(q[0].to(compute_dtype), k_l, v_l, q_pos, page_row, valid_hi)
            h = h + _mm(o.reshape(1, c, spec.q_dim).to(compute_dtype), lp["o"])
            continue
        if spec.kv_lora_rank > 0:
            h = _mla_chunk_block(h, lp, spec, k_l, v_l, positions, _mla_freqs(spec, device),
                                 n_pages, pages_chunk, page_row, valid_hi, compute_dtype)
            h = h + _mlp(rms_norm(h, lp["mlp_norm"], spec.rms_eps), lp, spec, None, adapter_idx)
            continue
        x = rms_norm(h, lp["attn_norm"], spec.rms_eps)
        freqs = layer_rope_frequencies(spec, inv_freq, win)
        q, k, v = _qkv(x, lp, spec, positions, freqs, rope_scaling, adapter_idx)
        _write_pages(k_l, _layer_kv_pages(k, n_pages, page_size, spec), pages_chunk)
        _write_pages(v_l, _layer_kv_pages(v, n_pages, page_size, spec), pages_chunk)
        o = _chunk_attention_xla(q[0].to(compute_dtype), k_l, v_l, q_pos, page_row, valid_hi,
                                 window=win, sinks=lp.get("sink"))
        o = apply_attn_gate(o, x[0], lp, spec)
        proj = _mm_l(o.reshape(1, c, spec.q_dim).to(compute_dtype), lp["o"], lp.get("lora"),
                     "o", adapter_idx) + _obias(lp, h.dtype)
        h = h + post_attn(proj, lp, spec)
        h = h + _mlp(rms_norm(h, lp["mlp_norm"], spec.rms_eps), lp, spec, None, adapter_idx)
    h = rms_norm(h, params["final_norm"], spec.rms_eps)
    if r_rows is not None:
        return k_pool, v_pool, h[0, max(int(valid) - 1, 0)], r_out
    return k_pool, v_pool, h[0, max(int(valid) - 1, 0)]


def takes_k3(spec: ModelSpec, lp: dict, adapter_idx=None) -> bool:
    """Whether a decode layer prepares its q/k/v in K3 on the card: the JAX
    package's choice of its kernel (``sampler/model.py`` ``decode``), not for
    a layer-scope qk-norm, a gated layer, Nemotron-H's bare attention, a
    multi-LoRA bank (``adapter_idx`` given or ``"lora"`` in the layer: every
    slot, a base one too, runs the delta) or int8 weights, whose q/k/v are
    plain PyTorch on the card as they are XLA on the TPU."""
    return (spec.qk_norm_scope != "layer" and not spec.attn_gate and not spec.layer_pattern
            and adapter_idx is None and "lora" not in lp and not isinstance(lp["q"], dict))


def takes_k4(spec: ModelSpec) -> bool:
    """Whether decode attention runs in K4 on the card: head dim 64 or a
    multiple of 128 (the JAX decode's ``hd % 128 == 0``, and 64, where the
    port runs K4 and the JAX package XLA: a divergence logged in ROADMAP.md
    Queue 3). K4 is built for 64 to 512 and raises above (the JAX kernel
    takes any multiple of 128: a limit logged in ROADMAP.md Queue 3); every
    other head dim (the debug specs' 32, 96) takes the plain paged decode
    attention, as the JAX decode sends it to XLA."""
    return spec.head_dim == 64 or spec.head_dim % 128 == 0


def _decode_attn_fused_local(q_t, k_t, v_t, k_l, v_l, lengths, page_table, window=0,
                             sinks=None, k4: bool = True):
    """Fused append + attention for one decode step (single device):
    ``lengths`` EXCLUDE the new token. K4 for CUDA tensors where ``k4`` (the
    spec's ``takes_k4``); otherwise, and for CPU tensors, ``_write_tokens`` +
    ``_decode_attention_xla`` over lengths + 1."""
    k_t, v_t = k_t.to(k_l.dtype), v_t.to(v_l.dtype)
    if k4:
        return decode_paged_attention(q_t, k_t, v_t, k_l, v_l, lengths, page_table,
                                      window=window or 0, sinks=sinks)
    return decode_paged_attention_reference(q_t, k_t, v_t, k_l, v_l, lengths, page_table,
                                            window=window or 0, sinks=sinks)


def decode(
    params: Params,
    spec: ModelSpec,
    k_pool: list[torch.Tensor],  # NL x [NKV, NP, PS, HD]
    v_pool: list[torch.Tensor],
    tokens: torch.Tensor,  # [S]: the newest token of each slot
    lengths: torch.Tensor,  # [S] int32: tokens in cache BEFORE this one
    page_table: torch.Tensor,  # [S, P] int32
    *,
    compute_dtype=torch.bfloat16,
    collect_routing: bool = False,
    r_conv: list | None = None,  # hybrid: per-layer [S, conv_dim, K] | None, in place
    r_state: list | None = None,  # hybrid: per-layer [S, Hv, Dk, Dv] f32 | None, in place
    adapter_idx: torch.Tensor | None = None,  # [S]: each slot's LoRA bank row (0 = none)
    pos_delta: torch.Tensor | None = None,  # [S] int32: each slot's rope-position offset
):
    """One decode step for all S slots: writes the new token's K/V, attends
    over lengths+1 tokens, returns (k_pool, v_pool, logits [S, V] f32) with
    the pools written in place, and with ``collect_routing`` the expert ids
    of each slot's input token, [S, NL_moe, K] int32 on the device (every
    MoE layer's, a recurrent layer's too). A hybrid model's recurrent layers
    advance ``r_conv``/``r_state`` in place.

    ``pos_delta`` shifts the ROPE position only (the cache rows stay indexed
    by ``lengths``): mRoPE compresses each image block of a VLM prompt to its
    grid, so the text after it runs at ``token index + delta``, one delta a
    request (HF get_rope_index decode semantics); text requests carry 0."""
    s = tokens.shape[0]
    device = tokens.device
    inv_freq, rope_scaling = _rope(spec, device)
    positions = lengths[:, None]  # [S, 1]: 0-based position of the new token
    if pos_delta is not None:
        positions = (positions + pos_delta[:, None]).to(lengths.dtype)
    if adapter_idx is not None:
        adapter_idx = lora_pick(params, adapter_idx, compute_dtype)
    h = params["embed"].to(compute_dtype)[tokens.long()][:, None, :]  # [S, 1, D]
    routed = [] if collect_routing else None
    if spec.kv_lora_rank > 0:
        ps = k_pool[0].shape[2]
        page_idx = page_table.gather(1, (lengths.long() // ps)[:, None])[:, 0].long()
        flat_idx = page_idx * ps + lengths.long() % ps  # [S]: the new token's row
        mla_freqs = _mla_freqs(spec, device)
    kinds = layer_kinds(spec)
    k4 = takes_k4(spec)
    for li, (lp, k_l, v_l, win, kind) in enumerate(zip(params["layers"], k_pool, v_pool,
                                                       layer_windows_list(spec), kinds)):
        lp = _cast_layer(lp, compute_dtype)
        if kind in RECURRENT_KINDS:
            mixer = _gdn_decode_mixer if kind == "L" else _mamba_decode_mixer
            h, conv_st, rec_st = mixer(h, lp, spec, r_conv[li], r_state[li], compute_dtype)
            r_conv[li].copy_(conv_st)
            r_state[li].copy_(rec_st)
            if kind == "L":
                h = h + _mlp(rms_norm(h, lp["mlp_norm"], spec.rms_eps), lp, spec, routed, adapter_idx)
            continue
        if kind in ("-", "E"):
            h = _tokenwise_block(h, lp, spec, routed)
            continue
        if kind == "*":
            # Nemotron-H's bare attention: K4 with the token's append
            q, k, v = _bare_attn(h, lp, spec)
            o, _, _ = _decode_attn_fused_local(q[:, 0].to(compute_dtype), k[:, 0], v[:, 0], k_l,
                                               v_l, lengths, page_table, k4=k4)
            h = h + _mm(o.reshape(s, 1, spec.q_dim).to(compute_dtype), lp["o"])
            continue
        if spec.kv_lora_rank > 0:
            h = _mla_decode_block(h, lp, spec, k_l, v_l, lengths + 1, page_table, positions,
                                  mla_freqs, flat_idx, compute_dtype)
            h = h + _mlp(rms_norm(h, lp["mlp_norm"], spec.rms_eps), lp, spec, routed, adapter_idx)
            continue
        freqs = layer_rope_frequencies(spec, inv_freq, win)
        if h.is_cuda and takes_k3(spec, lp, adapter_idx):
            # one launch for norm + qkv + bias + qk-norm + rope (K3)
            q3, k3, v3 = decode_qkv_prep(
                h[:, 0], lp["attn_norm"], lp["q"], lp["k"], lp["v"], positions[:, 0], freqs,
                num_heads=spec.num_heads, num_kv_heads=spec.num_kv_heads,
                head_dim=spec.head_dim, qk_norm=bool(spec.qk_norm),
                q_norm_w=lp.get("q_norm"), k_norm_w=lp.get("k_norm"),
                q_bias=lp.get("q_bias"), k_bias=lp.get("k_bias"), v_bias=lp.get("v_bias"),
                scaling=rope_scaling, eps=spec.rms_eps,
            )
        else:
            x = rms_norm(h, lp["attn_norm"], spec.rms_eps)
            q, k, v = _qkv(x, lp, spec, positions, freqs, rope_scaling, adapter_idx)
            q3, k3, v3 = q[:, 0].to(compute_dtype), k[:, 0], v[:, 0]
        o, _, _ = _decode_attn_fused_local(q3.to(compute_dtype), k3, v3, k_l, v_l, lengths,
                                           page_table, window=win, sinks=lp.get("sink"), k4=k4)
        if spec.attn_gate:
            # the gate reads the normed block input, whichever branch made q/k/v
            o = apply_attn_gate(o, rms_norm(h[:, 0], lp["attn_norm"], spec.rms_eps), lp, spec)
        proj = _mm_l(o.reshape(s, 1, spec.q_dim).to(compute_dtype), lp["o"], lp.get("lora"),
                     "o", adapter_idx) + _obias(lp, h.dtype)
        h = h + post_attn(proj, lp, spec)
        h = h + _mlp(rms_norm(h, lp["mlp_norm"], spec.rms_eps), lp, spec, routed, adapter_idx)
    h = rms_norm(h, params["final_norm"], spec.rms_eps)
    logits = logits_from_hidden(params, spec, h[:, 0], compute_dtype)
    if collect_routing:
        return k_pool, v_pool, logits, _stack_routing(routed, (s,))
    return k_pool, v_pool, logits


def _softcap(logits: torch.Tensor, spec: ModelSpec) -> torch.Tensor:
    if spec.final_logit_softcap > 0:
        return spec.final_logit_softcap * torch.tanh(logits / spec.final_logit_softcap)
    return logits


def logits_from_hidden(params: Params, spec: ModelSpec, hidden: torch.Tensor,
                       compute_dtype=torch.bfloat16) -> torch.Tensor:
    """[S, D] -> [S, V] f32 logits (f32 accumulation from compute-dtype
    inputs; an int8 head's product scaled per column after it)."""
    w = params.get("lm_head") if not spec.tie_embeddings else None
    hidden = hidden.to(compute_dtype)
    if isinstance(w, dict):
        logits = _matmul_f32(hidden, w["q8"].to(compute_dtype)) * w["scale"]
    else:
        logits = _matmul_f32(hidden, dense_lm_head(params, spec, compute_dtype))
    return _softcap(logits, spec)


def dense_lm_head(params: Params, spec: ModelSpec, dtype) -> torch.Tensor:
    """The [D, V] head in ``dtype`` (a view of embed when tied; an int8
    head dequantized in float32, then cast)."""
    w = params.get("lm_head") if not spec.tie_embeddings else None
    if isinstance(w, dict):
        return (w["q8"].float() * w["scale"]).to(dtype)
    return get_lm_head(params, spec).to(dtype)

"""Sampler-side model functions: prefill and decode against the paged KV
cache (the port of the JAX package's ``sampler/model.py``: the qwen3/llama
block, gpt-oss, whose layers carry a sliding window, attention sinks,
q/k/v/o biases and routed experts, qwen3_moe, and glm4_moe with its partial
rotary, noaux-tc routing, shared experts and dense first layers). Parameters
use the serving layout (``unstack_params``: a list of per-layer dicts).

Router replay: with ``collect_routing`` ``decode`` also returns the expert
ids each slot's input token was routed to, ``[S, NL_moe, K]`` in the order of
the MoE layers (the engine records them).

Where the JAX functions take donated pools and return new ones, these write
the per-layer pool tensors IN PLACE and return the same lists, so callers
read the same way in both packages.

Kernels on this path (for CUDA tensors; CPU tensors take the plain versions):
- prefill attention: K1 ``ops/flash_attention.py`` through ``ops.attention``
  (banded for a windowed layer, with the layer's sinks);
- decode q/k/v preparation: K3 ``ops/decode_qkv.py``;
- decode attention + KV append: K4 ``ops/decode_attention.py`` (window and
  sinks likewise).
Chunked prefill attention (``_chunk_attention_xla``) and the MoE layers
(``ops/moe.py``) are plain PyTorch, as they are XLA in the JAX package.

LoRA, MLA/DSA, hybrid recurrent layers, vision inputs, int8 weights,
attention-output gates, layer-scope qk-norm and sandwich norms are later
slices: ``check_supported`` raises ``NotImplementedError`` for them.
"""

from __future__ import annotations

import torch

from prime_rl_tpu_torch.models.base import ModelSpec
from prime_rl_tpu_torch.models.qwen3 import get_lm_head, layer_windows_list, rope_setup
from prime_rl_tpu_torch.ops.attention import attention
from prime_rl_tpu_torch.ops.decode_attention import (
    decode_attention_xla as _decode_attention_xla,
    decode_paged_attention,
    write_tokens as _write_tokens,
)
from prime_rl_tpu_torch.ops.decode_qkv import decode_qkv_prep
from prime_rl_tpu_torch.ops.layers import apply_rope, rms_norm, rope_frequencies, swiglu
from prime_rl_tpu_torch.ops.moe import moe_mlp

Params = dict


SERVED_FAMILIES = ("qwen3", "llama", "gpt_oss", "qwen3_moe", "glm4_moe")


def check_supported(spec: ModelSpec) -> None:
    """Raise ``NotImplementedError`` for any feature outside the serving path
    ported so far: the qwen3/llama block, gpt-oss (routed experts, windows,
    sinks, biases), qwen3_moe and glm4_moe (shared experts, noaux-tc routing,
    partial rotary, dense first layers)."""
    missing = []
    if spec.family not in SERVED_FAMILIES:
        missing.append(f"family {spec.family!r}")
    if spec.kv_lora_rank > 0:
        missing.append("MLA/DSA attention")
    if spec.gdn_pattern or spec.layer_pattern:
        missing.append("hybrid recurrent layers")
    if spec.vision is not None:
        missing.append("vision inputs")
    if spec.attn_gate:
        missing.append("attention-output gates")
    if spec.qk_norm and spec.qk_norm_scope == "layer":
        missing.append("layer-scope qk-norm")
    if spec.sandwich_norm:
        missing.append("sandwich norms (ROADMAP.md, Queue 1 item 5)")
    if missing:
        raise NotImplementedError("not ported yet: " + ", ".join(missing)
                                  + f" (served: {', '.join(SERVED_FAMILIES)})")


def _mm(x: torch.Tensor, w) -> torch.Tensor:
    if isinstance(w, dict):
        raise NotImplementedError("int8 weight-only layers are not ported yet")
    return x @ w


def _dot_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w with f32 output from compute-dtype inputs (the JAX
    ``preferred_element_type=float32`` product)."""
    if x.is_cuda and x.dtype == torch.bfloat16:
        return torch.mm(x, w, out_dtype=torch.float32)
    return x.float() @ w.float()


def _qkv(x, lp, spec, positions, inv_freq, rope_scaling: float = 1.0):
    """Shared q/k/v projection (+ optional biases) + qk-norm + rope.
    x: [B, T, D]."""
    b, t, _ = x.shape
    if "lora" in lp:
        raise NotImplementedError("LoRA serving is not ported yet")
    q = _mm(x, lp["q"]).reshape(b, t, spec.num_heads, spec.head_dim)
    k = _mm(x, lp["k"]).reshape(b, t, spec.num_kv_heads, spec.head_dim)
    v = _mm(x, lp["v"]).reshape(b, t, spec.num_kv_heads, spec.head_dim)
    if lp.get("q_bias") is not None:
        q = q + lp["q_bias"].to(q.dtype).reshape(1, 1, spec.num_heads, spec.head_dim)
        k = k + lp["k_bias"].to(k.dtype).reshape(1, 1, spec.num_kv_heads, spec.head_dim)
        v = v + lp["v_bias"].to(v.dtype).reshape(1, 1, spec.num_kv_heads, spec.head_dim)
    if spec.qk_norm:
        q = rms_norm(q, lp["q_norm"], spec.rms_eps)
        k = rms_norm(k, lp["k_norm"], spec.rms_eps)
    q = apply_rope(q, positions, inv_freq, rope_scaling)
    k = apply_rope(k, positions, inv_freq, rope_scaling)
    return q, k, v


def _mlp(x, lp, spec, routed: list | None = None):
    """Dense SwiGLU or the routed experts (plus the shared expert where the
    layer has one), decided per layer (``"router"`` in the layer's dict), so
    glm4_moe's dense first layers take the dense path. x: [B, T, D].
    ``routed``: a list that a MoE layer appends its expert ids [B*T, K] to
    (router replay)."""
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
            out = out + _mm(swiglu(_mm(xf, lp["shared_gate"]), _mm(xf, lp["shared_up"])),
                            lp["shared_down"])
        if routed is not None:
            routed.append(routing.expert_ids)
        return out.reshape(b, t, d)
    return _mm(swiglu(_mm(x, lp["gate"]), _mm(x, lp["up"])), lp["down"])


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


def _rope(spec: ModelSpec, device) -> tuple[torch.Tensor, float]:
    return rope_setup(spec, device=device)


def _freqs_for(spec: ModelSpec, inv_freq, window: int):
    """Per-layer rope frequencies: sliding layers with their own theta run
    their own; everyone else shares."""
    if window and spec.rope_theta_local:
        rot_dim = int(spec.head_dim * spec.partial_rotary_factor)
        return rope_frequencies(rot_dim, spec.rope_theta_local, device=inv_freq.device)
    return inv_freq


def unstack_params(params: Params, spec: ModelSpec) -> Params:
    """Training layout (stacked [NL, ...] layers) -> serving layout (a list
    of per-layer dicts of views: no tensor is copied). The serving forward
    unrolls the layer loop so each layer's KV tensors are written in place.
    glm4_moe's dense first layers (``dense_layers``) come first, in order."""
    check_supported(spec)
    dense = params.get("dense_layers")
    k_dense = 0 if dense is None else next(iter(dense.values())).shape[0]
    out = {k: v for k, v in params.items() if k not in ("layers", "dense_layers")}
    out["layers"] = ([{k: v[l] for k, v in dense.items()} for l in range(k_dense)]
                     + [{k: v[l] for k, v in params["layers"].items()}
                        for l in range(spec.num_layers - k_dense)])
    return out


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
):
    """Returns (k_pool, v_pool, last_hidden [D], prompt_logprobs [Lpad]|None),
    the pools written in place. ``prompt_logprobs[i] =
    logp(token_i | tokens_<i)``; position 0 holds the uniform -log(V)."""
    _, lpad = input_ids.shape
    device = input_ids.device
    page_size = k_pool[0].shape[2]
    n_pages = lpad // page_size
    inv_freq, rope_scaling = _rope(spec, device)
    positions = torch.arange(lpad, device=device)[None, :]
    segment_ids = (positions < length).to(torch.int32)
    h = params["embed"].to(compute_dtype)[input_ids]
    for lp, k_l, v_l, win in zip(params["layers"], k_pool, v_pool, layer_windows_list(spec)):
        lp = _cast_layer(lp, compute_dtype)
        x = rms_norm(h, lp["attn_norm"], spec.rms_eps)
        q, k, v = _qkv(x, lp, spec, positions, _freqs_for(spec, inv_freq, win), rope_scaling)
        o = attention(q, k, v, segment_ids, causal=True, window=win, sinks=lp.get("sink"))
        proj = _mm(o.reshape(1, lpad, spec.q_dim), lp["o"]) + _obias(lp, h.dtype)
        h = h + proj
        h = h + _mlp(rms_norm(h, lp["mlp_norm"], spec.rms_eps), lp, spec)
        _write_pages(k_l, _layer_kv_pages(k, n_pages, page_size, spec), pages)
        _write_pages(v_l, _layer_kv_pages(v, n_pages, page_size, spec), pages)
    h = rms_norm(h, params["final_norm"], spec.rms_eps)
    last_hidden = h[0, max(int(length) - 1, 0)]
    prompt_logprobs = None
    if want_prompt_logprobs:
        lm_head = dense_lm_head(params, spec, compute_dtype)
        labels = torch.cat([input_ids[0, 1:], input_ids.new_zeros(1)]).long()
        rows = []
        for lo in range(0, lpad, 1024):
            logits = _softcap(_dot_f32(h[0, lo:lo + 1024], lm_head), spec)
            lsm = torch.log_softmax(logits, dim=-1)
            rows.append(lsm.gather(-1, labels[lo:lo + 1024, None])[:, 0])
        lp_next = torch.cat(rows)
        first = torch.full((1,), -float(torch.log(torch.tensor(float(spec.vocab_size)))),
                           dtype=torch.float32, device=device)
        prompt_logprobs = torch.cat([first, lp_next[:-1]])
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
):
    """Batched prefill: B prompts through one pass. Rows are independent
    (per-row segment masking, per-row page writes); dummy rows (length 0,
    pages all null) are legal padding. Returns (k_pool, v_pool,
    last_hidden [B, D]), the pools written in place."""
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
        q, k, v = _qkv(x, lp, spec, positions, _freqs_for(spec, inv_freq, win), rope_scaling)
        o = attention(q, k, v, segment_ids, causal=True, window=win, sinks=lp.get("sink"))
        proj = _mm(o.reshape(b, lpad, spec.q_dim), lp["o"]) + _obias(lp, h.dtype)
        h = h + proj
        h = h + _mlp(rms_norm(h, lp["mlp_norm"], spec.rms_eps), lp, spec)
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
):
    """One chunk of an incremental prefill: computes K/V for positions
    [offset, offset+C), writes them into the slot's pages, and attends over
    the whole cached history INCLUDING shared prefix-cache pages. Powers
    chunked prefill of long prompts and prefix-cache hits. Returns (k_pool,
    v_pool, last_hidden [D]) at local position valid-1."""
    _, c = input_ids.shape
    device = input_ids.device
    page_size = k_pool[0].shape[2]
    n_pages = c // page_size
    inv_freq, rope_scaling = _rope(spec, device)
    positions = offset + torch.arange(c, device=device)[None, :]  # [1, C]
    q_pos = positions[0]
    valid_hi = offset + valid
    h = params["embed"].to(compute_dtype)[input_ids]
    for lp, k_l, v_l, win in zip(params["layers"], k_pool, v_pool, layer_windows_list(spec)):
        lp = _cast_layer(lp, compute_dtype)
        x = rms_norm(h, lp["attn_norm"], spec.rms_eps)
        q, k, v = _qkv(x, lp, spec, positions, _freqs_for(spec, inv_freq, win), rope_scaling)
        _write_pages(k_l, _layer_kv_pages(k, n_pages, page_size, spec), pages_chunk)
        _write_pages(v_l, _layer_kv_pages(v, n_pages, page_size, spec), pages_chunk)
        o = _chunk_attention_xla(q[0].to(compute_dtype), k_l, v_l, q_pos, page_row, valid_hi,
                                 window=win, sinks=lp.get("sink"))
        proj = _mm(o.reshape(1, c, spec.q_dim).to(compute_dtype), lp["o"]) + _obias(lp, h.dtype)
        h = h + proj
        h = h + _mlp(rms_norm(h, lp["mlp_norm"], spec.rms_eps), lp, spec)
    h = rms_norm(h, params["final_norm"], spec.rms_eps)
    return k_pool, v_pool, h[0, max(int(valid) - 1, 0)]


def _decode_attn_fused_local(q_t, k_t, v_t, k_l, v_l, lengths, page_table, window=0,
                             sinks=None):
    """Fused append + attention for one decode step (single device):
    ``lengths`` EXCLUDE the new token. K4 for CUDA tensors; for CPU tensors
    ``_write_tokens`` + ``_decode_attention_xla`` over lengths + 1."""
    return decode_paged_attention(q_t, k_t.to(k_l.dtype), v_t.to(v_l.dtype), k_l, v_l,
                                  lengths, page_table, window=window or 0, sinks=sinks)


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
):
    """One decode step for all S slots: writes the new token's K/V, attends
    over lengths+1 tokens, returns (k_pool, v_pool, logits [S, V] f32) with
    the pools written in place, and with ``collect_routing`` the expert ids
    of each slot's input token, [S, NL_moe, K] int32 on the device."""
    s = tokens.shape[0]
    device = tokens.device
    inv_freq, rope_scaling = _rope(spec, device)
    positions = lengths[:, None]  # [S, 1]: 0-based position of the new token
    h = params["embed"].to(compute_dtype)[tokens.long()][:, None, :]  # [S, 1, D]
    routed = [] if collect_routing else None
    for lp, k_l, v_l, win in zip(params["layers"], k_pool, v_pool, layer_windows_list(spec)):
        lp = _cast_layer(lp, compute_dtype)
        freqs = _freqs_for(spec, inv_freq, win)
        if h.is_cuda and "lora" not in lp and not isinstance(lp["q"], dict):
            # one launch for norm + qkv + bias + qk-norm + rope (K3)
            q3, k3, v3 = decode_qkv_prep(
                h[:, 0], lp["attn_norm"], lp["q"], lp["k"], lp["v"], lengths, freqs,
                num_heads=spec.num_heads, num_kv_heads=spec.num_kv_heads,
                head_dim=spec.head_dim, qk_norm=bool(spec.qk_norm),
                q_norm_w=lp.get("q_norm"), k_norm_w=lp.get("k_norm"),
                q_bias=lp.get("q_bias"), k_bias=lp.get("k_bias"), v_bias=lp.get("v_bias"),
                scaling=rope_scaling, eps=spec.rms_eps,
            )
        else:
            x = rms_norm(h, lp["attn_norm"], spec.rms_eps)
            q, k, v = _qkv(x, lp, spec, positions, freqs, rope_scaling)
            q3, k3, v3 = q[:, 0].to(compute_dtype), k[:, 0], v[:, 0]
        o, _, _ = _decode_attn_fused_local(q3.to(compute_dtype), k3, v3, k_l, v_l, lengths,
                                           page_table, window=win, sinks=lp.get("sink"))
        proj = _mm(o.reshape(s, 1, spec.q_dim).to(compute_dtype), lp["o"]) + _obias(lp, h.dtype)
        h = h + proj
        h = h + _mlp(rms_norm(h, lp["mlp_norm"], spec.rms_eps), lp, spec, routed)
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
    """[S, D] -> [S, V] f32 logits (f32 accumulation from compute-dtype inputs)."""
    return _softcap(_dot_f32(hidden.to(compute_dtype), dense_lm_head(params, spec, compute_dtype)),
                    spec)


def dense_lm_head(params: Params, spec: ModelSpec, dtype) -> torch.Tensor:
    """The [D, V] head in ``dtype`` (a view of embed when tied)."""
    w = params.get("lm_head") if not spec.tie_embeddings else None
    if isinstance(w, dict):
        raise NotImplementedError("int8 weight-only heads are not ported yet")
    return get_lm_head(params, spec).to(dtype)

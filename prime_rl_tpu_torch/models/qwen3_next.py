"""Qwen3-Next (``qwen3_next``): hybrid GatedDeltaNet linear attention and
gated full attention over MoE layers with a sigmoid-gated shared expert (the
port of the JAX package's ``models/qwen3_next.py``, trained and served).

- The layer pattern (``spec.gdn_pattern``, LLLA in the published model): L
  = GatedDeltaNet (causal conv over q|k|v, the chunked gated delta rule of
  ``ops/gated_delta.py``, a gated RMSNorm), A = full attention whose output
  is gated by sigmoid(x Wg) (``qwen3._attn_block`` with ``attn_gate =
  "sigmoid"``; partial rotary 0.25 at head dim 256: K1/K2a/K2b on the card).
- Every layer runs the MoE MLP (softmax top-k) plus a shared expert scaled
  by a scalar sigmoid gate.
- HF's norms are zero-centred ((1 + w) scaling): the conversion folds the +1
  in (``from_hf`` adds 1, ``to_hf`` subtracts it), so the forward runs plain
  RMSNorms. The GDN's gated norm is plain w and converts as it is.

Params, in the JAX package's layout: ``{"embed", "final_norm", "lm_head"
(untied), "lin_layers": {name: [n_L, ...]}, "attn_layers": {name: [n_A,
...]}}``, one stack a layer kind; a layer's index in its stack is its rank
among the layers of its kind. ``get_spec(..., num_layers=n)`` keeps the
pattern, as in JAX, so a cut depth raises here unless the caller cuts
``gdn_pattern`` too.

``qwen3_next_vl`` (the Qwen3.5 composition): this trunk with the Qwen3-VL
tower under ``params["vision"]``. ``forward`` takes ``mm`` as
``qwen3_vl.forward`` does: the tower's merged rows replace the embeddings at
the image slots, the attention layers rotate their partial-rotary half at the
per-frequency mRoPE positions (the GDN layers are position-free), and after
each layer i < n_ds, whatever its kind, the i-th DeepStack feature map is
added at the slots. The tower takes no adapter. HF layout: the text keys
under ``model.language_model.*``, the tower under ``model.visual.*``.
"""

from __future__ import annotations

import numpy as np
import torch

from prime_rl_tpu_torch.models import qwen3, qwen3_vl
from prime_rl_tpu_torch.models.base import ModelSpec
from prime_rl_tpu_torch.models.lora import layer_slices
from prime_rl_tpu_torch.models.qwen3 import layer_remat, parse_remat, rope_setup, run_layer
from prime_rl_tpu_torch.models.qwen3 import trunc_normal
from prime_rl_tpu_torch.models.qwen3_moe import check_forward_args, forced_by_layer
from prime_rl_tpu_torch.models.qwen3_vl import _mrope_positions, embed_mm
from prime_rl_tpu_torch.ops.gated_delta import chunk_gated_delta_rule
from prime_rl_tpu_torch.ops.layers import rms_norm, swiglu, weight_mm
from prime_rl_tpu_torch.ops.mamba import causal_conv1d
from prime_rl_tpu_torch.ops.moe import moe_mlp

Params = dict
FAMILY = "qwen3_next"
# the ac.modes the JAX function names (prime_rl_tpu/models/qwen3_next.py:270-281) and the mode
# each runs as; any other keeps every activation (``qwen3.parse_remat``)
REMAT = {"full": "full", "save_attn": "save_attn", "offload_attn": "save_attn",
         "selective": "selective"}
FAMILIES = (FAMILY, "qwen3_next_vl")
STACKS = (("L", "lin_layers"), ("A", "attn_layers"))


def pattern(spec: ModelSpec) -> str:
    """The layer pattern; raises unless it covers ``num_layers``."""
    pat = spec.gdn_pattern
    if len(pat) != spec.num_layers:
        raise ValueError(f"gdn_pattern length {len(pat)} != num_layers {spec.num_layers}")
    return pat


def init_params(spec: ModelSpec, generator: torch.Generator, dtype=torch.float32,
                device: torch.device | str = "cpu") -> Params:
    """Random init on ``device`` from ``generator`` (std 0.02 cut at 2 sigma,
    stacks drawn a leading slice at a time: 512 experts of Qwen3-Next hold
    537 M values a layer and projection). ``dt_bias`` and ``A_log`` take the
    JAX package's own values (a seeded numpy draw and a linspace); the rest
    differs from its ``jax.random`` init."""
    if spec.family != FAMILY:
        raise ValueError(f"qwen3_next.init_params: family {spec.family!r} is not qwen3_next")
    pat = pattern(spec)
    n_lin, n_attn = pat.count("L"), pat.count("A")
    d, e, m = spec.hidden_size, spec.num_experts, spec.moe_intermediate_size

    def w(*shape):
        return trunc_normal(shape, generator, dtype, device)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    def moe_fields(n):
        f = {
            "mlp_norm": ones(n, d),
            "router": w(n, d, e),
            "expert_gate": w(n, e, d, m),
            "expert_up": w(n, e, d, m),
            "expert_down": w(n, e, m, d),
            "shared_gate": w(n, d, spec.shared_expert_size),
            "shared_up": w(n, d, spec.shared_expert_size),
            "shared_down": w(n, spec.shared_expert_size, d),
        }
        if spec.shared_expert_gate:
            f["shared_expert_gate_w"] = w(n, d, 1)
        return f

    params: Params = {"embed": w(spec.vocab_size, d), "final_norm": ones(d)}
    if not spec.tie_embeddings:
        params["lm_head"] = w(d, spec.vocab_size)
    if n_lin:
        kd, vd, hv = spec.gdn_key_dim, spec.gdn_value_dim, spec.gdn_v_heads
        dt = np.exp(np.random.RandomState(0).uniform(
            np.log(0.001), np.log(0.1), size=(n_lin, hv))).astype(np.float32)
        a_log = np.log(np.linspace(1.0, 16.0, hv, dtype=np.float32))[None, :]
        params["lin_layers"] = {
            "attn_norm": ones(n_lin, d),
            "in_q": w(n_lin, d, kd),
            "in_k": w(n_lin, d, kd),
            "in_v": w(n_lin, d, vd),
            "in_z": w(n_lin, d, vd),
            "in_b": w(n_lin, d, hv),
            "in_a": w(n_lin, d, hv),
            "conv_w": w(n_lin, spec.gdn_conv_dim, spec.gdn_conv_kernel),
            "dt_bias": torch.from_numpy(dt + np.log(-np.expm1(-dt))).to(device),
            "A_log": torch.from_numpy(np.repeat(a_log, n_lin, axis=0)).to(device),
            "gdn_norm": ones(n_lin, spec.gdn_v_dim),
            "out_proj": w(n_lin, vd, d),
            **moe_fields(n_lin),
        }
    if n_attn:
        params["attn_layers"] = {
            "attn_norm": ones(n_attn, d),
            "q": w(n_attn, d, spec.q_dim),
            "attn_gate": w(n_attn, d, spec.q_dim),
            "k": w(n_attn, d, spec.kv_dim),
            "v": w(n_attn, d, spec.kv_dim),
            "o": w(n_attn, spec.q_dim, d),
            "q_norm": ones(n_attn, spec.head_dim),
            "k_norm": ones(n_attn, spec.head_dim),
            **moe_fields(n_attn),
        }
    return params


def gdn_inputs(x: torch.Tensor, lp: dict, spec: ModelSpec):
    """The GatedDeltaNet's projections of the normed input x [..., D]: (raw
    q|k|v [..., conv_dim] before the conv, beta [..., Hv], g [..., Hv] the
    float32 log decay, z [..., Hv, Dv] the gate of the output norm)."""
    raw = torch.cat([weight_mm(x, lp["in_q"]), weight_mm(x, lp["in_k"]),
                     weight_mm(x, lp["in_v"])], dim=-1)
    beta = torch.sigmoid(weight_mm(x, lp["in_b"]))
    g = -torch.exp(lp["A_log"].float()) * torch.nn.functional.softplus(
        weight_mm(x, lp["in_a"]).float() + lp["dt_bias"].float())
    z = weight_mm(x, lp["in_z"]).reshape(*x.shape[:-1], spec.gdn_v_heads, spec.gdn_v_dim)
    return raw, beta, g, z


def gdn_heads(qkv: torch.Tensor, spec: ModelSpec):
    """q|k|v after the conv [..., conv_dim] -> (q, k [..., Hv, Dk], v
    [..., Hv, Dv]), the key heads repeated over their value heads."""
    kd = spec.gdn_key_dim
    lead = qkv.shape[:-1]
    q = qkv[..., :kd].reshape(*lead, spec.gdn_k_heads, spec.gdn_k_dim)
    k = qkv[..., kd:2 * kd].reshape(*lead, spec.gdn_k_heads, spec.gdn_k_dim)
    v = qkv[..., 2 * kd:].reshape(*lead, spec.gdn_v_heads, spec.gdn_v_dim)
    r = spec.gdn_v_heads // spec.gdn_k_heads
    if r > 1:
        q = q.repeat_interleave(r, dim=-2)
        k = k.repeat_interleave(r, dim=-2)
    return q, k, v


def gdn_output(h: torch.Tensor, core: torch.Tensor, z: torch.Tensor, lp: dict,
               spec: ModelSpec, compute_dtype) -> torch.Tensor:
    """The gated RMSNorm (plain w, then * silu(z)) of the rule's output
    [..., Hv, Dv], projected out and added to h."""
    core = rms_norm(core.to(compute_dtype), lp["gdn_norm"], spec.rms_eps)
    core = core * torch.nn.functional.silu(z.float()).to(core.dtype)
    return h + weight_mm(core.reshape(*core.shape[:-2], spec.gdn_value_dim), lp["out_proj"])


def gdn_mixer(h: torch.Tensor, lp: dict, spec: ModelSpec, segment_ids: torch.Tensor,
              compute_dtype, precision: str = "highest") -> torch.Tensor:
    """GatedDeltaNet block with its residual: conv(q|k|v) -> silu -> the
    chunked gated delta rule -> gated RMSNorm -> out. h [B, L, D]."""
    x = rms_norm(h, lp["attn_norm"], spec.rms_eps)
    raw, beta, g, z = gdn_inputs(x, lp, spec)
    qkv = torch.nn.functional.silu(causal_conv1d(raw, lp["conv_w"], None, segment_ids))
    q, k, v = gdn_heads(qkv, spec)
    core, _ = chunk_gated_delta_rule(q, k, v, g, beta, segment_ids=segment_ids,
                                     precision=precision)
    return gdn_output(h, core, z, lp, spec, compute_dtype)


def shared_expert(x: torch.Tensor, lp: dict, spec: ModelSpec) -> torch.Tensor:
    """The shared expert's SwiGLU, scaled by sigmoid(x Wg) where the spec
    gates it. x [..., D]."""
    out = swiglu(x @ lp["shared_gate"], x @ lp["shared_up"]) @ lp["shared_down"]
    if spec.shared_expert_gate:
        out = torch.sigmoid(x @ lp["shared_expert_gate_w"]) * out
    return out


def moe_block(h: torch.Tensor, lp: dict, spec: ModelSpec,
              forced: torch.Tensor | None = None, lora: dict | None = None,
              lora_scale: float = 1.0):
    """Routed experts plus the gated shared expert, with the residual.
    Returns (h, load-balance aux). ``forced`` ([B*L, K], -1 = own routing)
    replays the sampler's selection; ``lora``: the layer's adapter slices,
    whose ``moe_*`` targets apply per expert."""
    b, l, d = h.shape
    x = rms_norm(h, lp["mlp_norm"], spec.rms_eps)
    out, routing = moe_mlp(x.reshape(b * l, d), lp["router"], lp["expert_gate"],
                           lp["expert_up"], lp["expert_down"], spec.num_experts_per_tok,
                           spec.norm_topk_prob, forced_experts=forced, lora=lora,
                           lora_scale=lora_scale)
    return h + out.reshape(b, l, d) + shared_expert(x, lp, spec), routing.load_balance_loss


def cast_layer(lp: dict, dtype) -> dict:
    """A layer's matrices in ``dtype``; the router, norms and vectors as
    stored (the JAX forward's ``cast``)."""
    return {k: (v.to(dtype) if v.dim() >= 2 and "router" not in k else v)
            for k, v in lp.items()}


def layer_params(params: Params, spec: ModelSpec) -> list[tuple[str, dict]]:
    """(kind, that layer's params) for each layer in order, views into the
    stacks (unbound once: the backward stacks the per-layer gradients in one
    copy)."""
    per = {stack: {k: v.unbind(0) for k, v in params[stack].items()}
           for _, stack in STACKS if stack in params}
    rank = {"L": 0, "A": 0}
    out = []
    for ch in pattern(spec):
        stack = dict(STACKS)[ch]
        out.append((ch, {k: v[rank[ch]] for k, v in per[stack].items()}))
        rank[ch] += 1
    return out


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
    routed_experts: torch.Tensor | None = None,  # [B, L, NL, K]; -1 = own routing
    quantized_compute: str | None = None,
    gdn_precision: str = "highest",
    mm: dict | None = None,
):
    """Token ids -> final hidden states [B, L, D] (pre-LM-head, normed), or
    (hidden, load-balance aux summed over the layers) with ``collect_aux``.
    Every layer is MoE, so ``routed_experts`` holds a row a layer, L layers
    included. ``remat``: the modes the JAX function names (``REMAT``:
    ``full``, ``save_attn``, ``offload_attn``, which keeps the K1 outputs on
    the device as ``save_attn`` does, and ``selective``, as in
    ``qwen3.forward``; a GDN layer has no K1 outputs to keep); any other
    mode, and any ``mode/K``, keeps every activation, as there. The tower's
    blocks recompute under any mode but ``none``. ``gdn_precision`` is
    ``ModelConfig.gdn_mxu_precision``. ``mm`` (``qwen3_next_vl`` only): the
    vision inputs of ``qwen3_vl.forward``; the GDN layers keep reading
    ``segment_ids``, the text rows' own."""
    if spec.family not in FAMILIES:
        raise ValueError(f"qwen3_next.forward: family {spec.family!r} is not one of "
                         f"{FAMILIES}")
    if mm is not None and spec.vision is None:
        raise ValueError(f"qwen3_next.forward: {spec.family!r} has no vision tower for mm")
    check_forward_args(spec, mesh, lora, quantized_compute)
    nl = spec.num_layers
    layers = layer_params(params, spec)
    base_remat, save_stride = parse_remat(remat, nl, REMAT)
    inv_freq, rope_scaling = rope_setup(spec, device=input_ids.device)
    h = params["embed"].to(compute_dtype)[input_ids]
    ds_feats = slot = mask = None
    rope_pos = position_ids
    if mm is not None:
        h, ds_feats, slot, mask = embed_mm(params, spec, h, mm, compute_dtype, base_remat)
        rope_pos = _mrope_positions(spec, mm["mm_position_ids"])

    # LoRA: the adapters index full depth; the attention layers take them on
    # their projections, every layer on its experts (moe_* targets)
    def lin_block(h, lp, saved, window, forced, ll):
        lp = cast_layer(lp, compute_dtype)
        h = gdn_mixer(h, lp, spec, segment_ids, compute_dtype, gdn_precision)
        return moe_block(h, lp, spec, forced, ll, lora_scale)

    def attn_block(h, lp, saved, window, forced, ll):
        lp = cast_layer(lp, compute_dtype)
        h = qwen3._attn_block(h, lp, spec, segment_ids, rope_pos, inv_freq, attn_impl,
                              rope_scaling, saved, window, ll, lora_scale)
        return moe_block(h, lp, spec, forced, ll, lora_scale)

    forced = forced_by_layer(routed_experts, nl, spec.num_experts_per_tok)
    lora_layers = layer_slices(lora, nl)
    n_ds = 0 if ds_feats is None else ds_feats.shape[0]
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for i, (kind, lp) in enumerate(layers):
        block = lin_block if kind == "L" else attn_block
        h, lb = run_layer(block, h, lp, 0, layer_remat(base_remat, save_stride, i),
                          None if forced is None else forced[i], lora_layers[i])
        aux = aux + lb
        if i < n_ds:  # DeepStack: the i-th feature map at the image slots
            h = torch.where(mask, h + ds_feats[i][slot], h)
    h = rms_norm(h, params["final_norm"], spec.rms_eps)
    return (h, aux) if collect_aux else h


get_lm_head = qwen3.get_lm_head


# ---------------------------------------------------------------------------
# HF interchange (HF ``Qwen3NextForCausalLM``; torch Linears are [out, in]:
# transposed). Fused layouts, as the JAX package reads them:
# - in_proj_qkvz rows group by key head: [dk q | dk k | r dv v | r dv z]
# - in_proj_ba rows group by key head: [r b | r a]   (r = Hv / Hk)
# - the attention q_proj rows group by head: [hd query | hd gate]
# - the zero-centred norms (input, post-attention, q/k, final): ours = theirs + 1
# ---------------------------------------------------------------------------

_EXPERT_KEYS = (("expert_gate", "gate_proj"), ("expert_up", "up_proj"),
                ("expert_down", "down_proj"))
_SHARED_KEYS = (("shared_gate", "gate_proj"), ("shared_up", "up_proj"),
                ("shared_down", "down_proj"))


def params_from_hf_state_dict(state: dict, spec: ModelSpec, dtype=torch.float32,
                              device: torch.device | str = "cpu") -> Params:
    """Stacked params from a flat HF state dict (torch tensors or numpy
    arrays), on ``device`` in ``dtype``."""
    pat = pattern(spec)
    hk, hv = spec.gdn_k_heads, spec.gdn_v_heads
    dk, dv = spec.gdn_k_dim, spec.gdn_v_dim
    r = hv // hk
    d = spec.hidden_size

    def get(key: str, transpose: bool = False) -> torch.Tensor:
        t = torch.as_tensor(state[key]).to(device=device, dtype=dtype)
        return t.T.contiguous() if transpose else t

    def moe_fields(i: int) -> dict:
        p = f"model.layers.{i}."
        lp = {"mlp_norm": get(p + "post_attention_layernorm.weight") + 1.0,
              "router": get(p + "mlp.gate.weight", True)}
        for ours, theirs in _SHARED_KEYS:
            lp[ours] = get(f"{p}mlp.shared_expert.{theirs}.weight", True)
        for ours, theirs in _EXPERT_KEYS:
            lp[ours] = torch.stack([get(f"{p}mlp.experts.{j}.{theirs}.weight", True)
                                    for j in range(spec.num_experts)])
        if spec.shared_expert_gate:
            lp["shared_expert_gate_w"] = get(p + "mlp.shared_expert_gate.weight", True)
        return lp

    stacks: dict[str, dict[str, list]] = {"L": {}, "A": {}}
    for i, ch in enumerate(pat):
        p = f"model.layers.{i}."
        if ch == "L":
            qkvz = get(p + "linear_attn.in_proj_qkvz.weight").reshape(hk, 2 * dk + 2 * r * dv, d)
            ba = get(p + "linear_attn.in_proj_ba.weight").reshape(hk, 2 * r, d)
            lp = {
                "attn_norm": get(p + "input_layernorm.weight") + 1.0,
                "in_q": qkvz[:, :dk].reshape(hk * dk, d).T.contiguous(),
                "in_k": qkvz[:, dk:2 * dk].reshape(hk * dk, d).T.contiguous(),
                "in_v": qkvz[:, 2 * dk:2 * dk + r * dv].reshape(hv * dv, d).T.contiguous(),
                "in_z": qkvz[:, 2 * dk + r * dv:].reshape(hv * dv, d).T.contiguous(),
                "in_b": ba[:, :r].reshape(hv, d).T.contiguous(),
                "in_a": ba[:, r:].reshape(hv, d).T.contiguous(),
                "conv_w": get(p + "linear_attn.conv1d.weight")[:, 0, :],
                "dt_bias": get(p + "linear_attn.dt_bias"),
                "A_log": get(p + "linear_attn.A_log"),
                "gdn_norm": get(p + "linear_attn.norm.weight"),
                "out_proj": get(p + "linear_attn.out_proj.weight", True),
            }
        else:
            qg = get(p + "self_attn.q_proj.weight").reshape(spec.num_heads, 2 * spec.head_dim, d)
            lp = {
                "attn_norm": get(p + "input_layernorm.weight") + 1.0,
                "q": qg[:, :spec.head_dim].reshape(spec.q_dim, d).T.contiguous(),
                "attn_gate": qg[:, spec.head_dim:].reshape(spec.q_dim, d).T.contiguous(),
                "k": get(p + "self_attn.k_proj.weight", True),
                "v": get(p + "self_attn.v_proj.weight", True),
                "o": get(p + "self_attn.o_proj.weight", True),
                "q_norm": get(p + "self_attn.q_norm.weight") + 1.0,
                "k_norm": get(p + "self_attn.k_norm.weight") + 1.0,
            }
        lp.update(moe_fields(i))
        for k_, v_ in lp.items():
            stacks[ch].setdefault(k_, []).append(v_)
    params: Params = {"embed": get("model.embed_tokens.weight"),
                      "final_norm": get("model.norm.weight") + 1.0}
    for ch, stack in STACKS:
        if stacks[ch]:
            params[stack] = {k: torch.stack(v) for k, v in stacks[ch].items()}
    if not spec.tie_embeddings:
        params["lm_head"] = get("lm_head.weight", True)
    return params


def params_to_hf_state_dict(params: Params, spec: ModelSpec) -> dict[str, np.ndarray]:
    """Flat HF state dict (numpy f32), a layer at a time."""
    hk, hv = spec.gdn_k_heads, spec.gdn_v_heads
    dk, dv = spec.gdn_k_dim, spec.gdn_v_dim
    r = hv // hk
    d = spec.hidden_size

    def host(t: torch.Tensor) -> np.ndarray:
        return t.detach().float().cpu().numpy()

    state: dict[str, np.ndarray] = {"model.embed_tokens.weight": host(params["embed"]),
                                    "model.norm.weight": host(params["final_norm"]) - 1.0}
    if not spec.tie_embeddings:
        state["lm_head.weight"] = host(params["lm_head"]).T.copy()
    for i, (ch, lp) in enumerate(layer_params(params, spec)):
        p = f"model.layers.{i}."
        state[p + "input_layernorm.weight"] = host(lp["attn_norm"]) - 1.0
        if ch == "L":
            q = host(lp["in_q"]).T.reshape(hk, dk, d)
            k = host(lp["in_k"]).T.reshape(hk, dk, d)
            v = host(lp["in_v"]).T.reshape(hk, r * dv, d)
            z = host(lp["in_z"]).T.reshape(hk, r * dv, d)
            state[p + "linear_attn.in_proj_qkvz.weight"] = np.concatenate(
                [q, k, v, z], axis=1).reshape(-1, d)
            b_ = host(lp["in_b"]).T.reshape(hk, r, d)
            a_ = host(lp["in_a"]).T.reshape(hk, r, d)
            state[p + "linear_attn.in_proj_ba.weight"] = np.concatenate(
                [b_, a_], axis=1).reshape(-1, d)
            state[p + "linear_attn.conv1d.weight"] = host(lp["conv_w"])[:, None, :]
            state[p + "linear_attn.dt_bias"] = host(lp["dt_bias"])
            state[p + "linear_attn.A_log"] = host(lp["A_log"])
            state[p + "linear_attn.norm.weight"] = host(lp["gdn_norm"])
            state[p + "linear_attn.out_proj.weight"] = host(lp["out_proj"]).T.copy()
        else:
            q = host(lp["q"]).T.reshape(spec.num_heads, spec.head_dim, d)
            g = host(lp["attn_gate"]).T.reshape(spec.num_heads, spec.head_dim, d)
            state[p + "self_attn.q_proj.weight"] = np.concatenate([q, g], axis=1).reshape(-1, d)
            for f in ("k", "v", "o"):
                state[f"{p}self_attn.{f}_proj.weight"] = host(lp[f]).T.copy()
            state[p + "self_attn.q_norm.weight"] = host(lp["q_norm"]) - 1.0
            state[p + "self_attn.k_norm.weight"] = host(lp["k_norm"]) - 1.0
        state[p + "post_attention_layernorm.weight"] = host(lp["mlp_norm"]) - 1.0
        state[p + "mlp.gate.weight"] = host(lp["router"]).T.copy()
        for ours, theirs in _SHARED_KEYS:
            state[f"{p}mlp.shared_expert.{theirs}.weight"] = host(lp[ours]).T.copy()
        for ours, theirs in _EXPERT_KEYS:
            stacked = host(lp[ours])
            for j in range(spec.num_experts):
                state[f"{p}mlp.experts.{j}.{theirs}.weight"] = stacked[j].T.copy()
        if spec.shared_expert_gate:
            state[p + "mlp.shared_expert_gate.weight"] = host(lp["shared_expert_gate_w"]).T.copy()
    return state


# qwen3_next_vl under the JAX package's names: qwen3_vl's init and converters,
# which take this module as the trunk
init_params_vl = qwen3_vl.init_params
params_from_hf_state_dict_vl = qwen3_vl.params_from_hf_state_dict
params_to_hf_state_dict_vl = qwen3_vl.params_to_hf_state_dict

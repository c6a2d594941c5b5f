"""MoE ops: token-choice top-k routing + sorted grouped expert products (the
port of the JAX package's ``ops/moe.py``, which is XLA code there, outside
any Pallas kernel).

Tokens are sorted by expert id (a stable sort) and pushed through one grouped
product per projection over the contiguous expert groups, then combined with
their routing weights on the way back. ``jax.lax.ragged_dot`` becomes
``torch._grouped_mm`` for bfloat16 tensors on the card where the installed
PyTorch has it, otherwise a loop over the experts of ``torch.mm`` on the
sorted slices (the CPU form; it reads the group sizes on the host).

The router runs in float32. Per-expert biases (gpt-oss) are gathered by each
sorted slot's expert id and added in float32 after the grouped product, and
``activation_alpha > 0`` selects gpt-oss's clamped GLU in place of SwiGLU, as
in the JAX function. Divergences from the JAX package, on purpose:
- the combine is not a scatter-add (``.at[token_idx].add``, an atomic sum on
  a GPU): every token has exactly K slots, so the inverse permutation and a
  sum over ``[T, K, D]`` give the same result in a fixed order;
- ``ragged_dot`` returns float32 from bfloat16 inputs; the grouped products
  here return the inputs' dtype, so on the card gate/up and the expert
  output are rounded to bfloat16 once more than in JAX. In float32 the two
  packages compute the same numbers.

``w_gate is None`` gives non-gated relu^2 experts and ``x_experts`` [T, D']
feeds the experts a different input than the router's (Nemotron-H's
LatentMoE: routing at the model width, the experts at the latent width; the
output then has width D'). Not ported yet, and raising: per-expert LoRA, and
the expert-parallel mesh (``set_ep_mesh``, ``ops/moe_ep.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from prime_rl_tpu_torch.ops.layers import clamped_glu


class RouterOutput(NamedTuple):
    expert_ids: torch.Tensor  # [T, K] int32
    weights: torch.Tensor  # [T, K] f32 combine weights
    load_balance_loss: torch.Tensor  # scalar aux (monitoring; optionally trained)
    router_entropy: torch.Tensor  # scalar monitoring stat


def set_ep_mesh(mesh, token_axes: tuple[str, ...] = ("expert",)) -> None:
    raise NotImplementedError("expert parallelism waits for the multi-card slice")


def route_topk(
    x: torch.Tensor,  # [T, D] (any dtype; router math in f32)
    router_w: torch.Tensor,  # [D, E]
    top_k: int,
    norm_topk_prob: bool = True,
    router_b: torch.Tensor | None = None,  # [E]
    softmax_topk: bool = False,  # gpt-oss: softmax over the top-k LOGITS
    sigmoid_noaux: bool = False,  # glm/deepseek-v3: sigmoid + correction bias
    correction_bias: torch.Tensor | None = None,  # [E] selection-only bias
    n_group: int = 1,
    topk_group: int = 1,
    routed_scaling: float = 1.0,
    forced_experts: torch.Tensor | None = None,  # [T, K] int; row of -1 = own routing
) -> RouterOutput:
    logits = torch.matmul(x.float(), router_w.float())  # [T, E]
    if router_b is not None:
        logits = logits + router_b.float()
    probs = torch.softmax(logits, dim=-1)
    e = router_w.shape[1]
    scores = None
    if sigmoid_noaux:
        # noaux-tc routing: sigmoid scores; SELECTION adds a correction bias
        # and (optionally) restricts to the best expert groups; combine
        # WEIGHTS come from the raw sigmoid scores, normalized, x scaling
        scores = torch.sigmoid(logits)
        probs = scores / scores.sum(-1, keepdim=True).clamp(min=1e-9)  # stats only
        choice = scores if correction_bias is None else scores + correction_bias.float()
        if n_group > 1:
            t = choice.shape[0]
            grouped = choice.reshape(t, n_group, e // n_group)
            group_scores = torch.topk(grouped, min(2, e // n_group), dim=-1).values.sum(-1)
            keep_groups = torch.topk(group_scores, topk_group, dim=-1).indices  # [T, G']
            group_mask = torch.zeros((t, n_group), dtype=torch.bool, device=x.device)
            group_mask.scatter_(1, keep_groups, True)
            choice = torch.where(group_mask.repeat_interleave(e // n_group, dim=1), choice,
                                 -torch.inf)
        expert_ids = torch.topk(choice, top_k, dim=-1).indices  # [T, K]
        weights = torch.gather(scores, -1, expert_ids)
        if norm_topk_prob:
            weights = weights / (weights.sum(-1, keepdim=True) + 1e-20)
        weights = weights * routed_scaling
    elif softmax_topk:
        top_vals, expert_ids = torch.topk(logits, top_k, dim=-1)
        weights = torch.softmax(top_vals, dim=-1)
    else:
        weights, expert_ids = torch.topk(probs, top_k, dim=-1)
        if norm_topk_prob:
            weights = weights / weights.sum(-1, keepdim=True).clamp(min=1e-9)
    if forced_experts is not None:
        # router replay: the SELECTION comes from the sampler's recorded
        # routing; combine weights are recomputed from THIS router's scores at
        # those experts. Tokens with no recording (first slot < 0) keep their
        # own routing.
        valid = forced_experts[:, :1] >= 0  # [T, 1]
        f_ids = forced_experts.clamp(min=0).long()
        if sigmoid_noaux:
            f_w = torch.gather(scores, -1, f_ids)
            if norm_topk_prob:
                f_w = f_w / (f_w.sum(-1, keepdim=True) + 1e-20)
            f_w = f_w * routed_scaling
        elif softmax_topk:
            f_w = torch.softmax(torch.gather(logits, -1, f_ids), dim=-1)
        else:
            f_w = torch.gather(probs, -1, f_ids)
            if norm_topk_prob:
                f_w = f_w / f_w.sum(-1, keepdim=True).clamp(min=1e-9)
        expert_ids = torch.where(valid, f_ids, expert_ids)
        weights = torch.where(valid, f_w, weights)
    # Switch-style load-balance aux: E * sum_e f_e * p_e
    counts = torch.bincount(expert_ids.reshape(-1), minlength=e).float()
    frac_tokens = counts / counts.sum().clamp(min=1.0)
    frac_probs = probs.mean(dim=0)
    lb = e * torch.sum(frac_tokens * frac_probs)
    entropy = -torch.mean(torch.sum(probs * torch.log(probs + 1e-9), dim=-1))
    return RouterOutput(expert_ids.to(torch.int32), weights, lb, entropy)


def grouped_product_impl(x: torch.Tensor) -> str:
    """Which grouped product ``moe_mlp`` takes for ``x``: ``grouped_mm`` or ``loop``."""
    if x.is_cuda and x.dtype == torch.bfloat16 and hasattr(torch, "_grouped_mm"):
        return "grouped_mm"
    return "loop"


def _grouped_product(xs: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor,
                     bounds: list[int] | None) -> torch.Tensor:
    """[M, N]: rows of ``xs`` [M, D], sorted by expert, times their expert's
    ``w[e]`` [D, N]. ``bounds`` (the loop form): the groups' end rows on the host."""
    if bounds is None:
        offs = torch.cumsum(group_sizes, 0).to(torch.int32)
        return torch._grouped_mm(xs, w, offs=offs)
    per_expert = w.unbind(0)  # one stacked gradient, not a zero stack per expert
    parts, start = [], 0
    for e, end in enumerate(bounds):
        if end > start:
            parts.append(torch.mm(xs[start:end], per_expert[e]))
        start = end
    if not parts:
        return xs.new_zeros((0, w.shape[2]))
    return torch.cat(parts, dim=0)


def moe_mlp(
    x: torch.Tensor,  # [T, D]
    router_w: torch.Tensor,  # [D, E]
    w_gate: torch.Tensor | None,  # [E, D, M]; None = non-gated relu^2 experts
    w_up: torch.Tensor,  # [E, D, M]
    w_down: torch.Tensor,  # [E, M, D]
    top_k: int,
    norm_topk_prob: bool = True,
    *,
    router_b: torch.Tensor | None = None,  # [E]
    b_gate: torch.Tensor | None = None,
    b_up: torch.Tensor | None = None,
    b_down: torch.Tensor | None = None,
    softmax_topk: bool = False,
    activation_alpha: float = 0.0,
    activation_limit: float = 0.0,
    sigmoid_noaux: bool = False,
    correction_bias: torch.Tensor | None = None,
    n_group: int = 1,
    topk_group: int = 1,
    routed_scaling: float = 1.0,
    x_experts: torch.Tensor | None = None,  # [T, D'] the experts' input, if not x
    forced_experts: torch.Tensor | None = None,  # [T, K] router replay (-1 row = own)
    lora: dict | None = None,
    lora_scale: float = 1.0,
    allow_ep: bool = True,
) -> tuple[torch.Tensor, RouterOutput]:
    """Returns (output [T, D], router stats). Sorted grouped dispatch:

      1. route: top-k experts per token
      2. sort the T*K (token, expert) pairs by expert id (stable)
      3. grouped products over the contiguous expert groups (+ per-expert
         biases in f32), silu-gated, clamped-GLU (``activation_alpha > 0``)
         or relu^2 (``w_gate is None``) over ``x_experts`` (default x)
      4. unsort + weighted sum over each token's K slots
    """
    if lora is not None:
        raise NotImplementedError("per-expert LoRA waits for the LoRA slice")
    x_in = x if x_experts is None else x_experts
    t, d = x_in.shape
    e = router_w.shape[1]
    routing = route_topk(x, router_w, top_k, norm_topk_prob,
                         router_b=router_b, softmax_topk=softmax_topk,
                         sigmoid_noaux=sigmoid_noaux, correction_bias=correction_bias,
                         n_group=n_group, topk_group=topk_group,
                         routed_scaling=routed_scaling, forced_experts=forced_experts)

    flat_experts = routing.expert_ids.reshape(-1).long()  # [T*K]
    order = torch.argsort(flat_experts, stable=True)  # ascending by expert
    token_idx = order // top_k  # source token of each sorted slot
    group_sizes = torch.bincount(flat_experts, minlength=e)
    bounds = None
    if grouped_product_impl(x) == "loop":
        bounds = torch.cumsum(group_sizes, 0).tolist()

    xs = x_in[token_idx]  # [T*K, D] sorted by expert
    sorted_experts = flat_experts[order]  # expert id of each sorted slot

    def biased(y, b):
        y = y.float()
        return y if b is None else y + b.float()[sorted_experts]

    up = biased(_grouped_product(xs, w_up, group_sizes, bounds), b_up)
    if w_gate is None:  # Nemotron-H's LatentMoE experts
        h = torch.square(F.relu(up)).to(x.dtype)
    else:
        gate = biased(_grouped_product(xs, w_gate, group_sizes, bounds), b_gate)
        if activation_alpha > 0:
            h = clamped_glu(gate, up, activation_alpha, activation_limit).to(x.dtype)
        else:
            h = (F.silu(gate) * up).to(x.dtype)  # [T*K, M]
    out_sorted = biased(_grouped_product(h, w_down, group_sizes, bounds), b_down)

    w_flat = routing.weights.reshape(-1)[order]  # combine weight per sorted slot
    contrib = out_sorted * w_flat[:, None]  # [T*K, D] f32
    # slot (token, k) sits at sorted position inverse[token * K + k]
    inverse = torch.empty_like(order)
    inverse[order] = torch.arange(order.shape[0], device=order.device)
    out = contrib[inverse].reshape(t, top_k, d).sum(dim=1)
    return out.to(x.dtype), routing
